"""Top-k with the reference's deterministic ordering.

Values descending, ties by descending index — exactly numpy's
``argsort(kind="stable")[::-1]`` (``easyrag_tpu/ops/topk.py:3-13``).
``torch.topk`` promises no order among equal values, so the row is flipped
and stable-sorted: among equal values the stable sort keeps flipped order,
which is descending original index.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_desc_reference_order(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the top-k along the last axis of a rank-1 or
    rank-2 ``scores``; indices are int64."""
    n = scores.shape[-1]
    k = min(k, n)
    vals, rev_idx = torch.sort(scores.flip(-1), dim=-1, descending=True, stable=True)
    return vals[..., :k], (n - 1) - rev_idx[..., :k]
