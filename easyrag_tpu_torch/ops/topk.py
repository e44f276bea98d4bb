"""Top-k with the reference's deterministic ordering (port of
``easyrag_tpu/ops/topk.py``).

Values descending, ties by descending index — exactly numpy's
``argsort(kind="stable")[::-1]`` (``easyrag_tpu/ops/topk.py:3-13``).
``torch.topk`` promises no order among equal values, so every selection here
is a stable descending sort over a row laid out in descending index order:
among equal values the stable sort keeps that order. Long rows take the JAX
package's pruned or two-stage path, gated exactly as there, with the same
results index for index:

* the chunk-max pruned path (:func:`_chunkmax_pruned_topk`) whose first step
  is ``chunkmax.chunk_max`` (K6 on a CUDA tensor);
* the two-stage path over ``_pick_chunks`` chunks (:func:`_two_stage_topk`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .chunkmax import CH as _PRUNE_CH
from .chunkmax import chunk_max

# chunked two-stage path: preferred chunk counts (first divisor of n wins)
_CHUNK_CHOICES = (16, 10, 8, 5, 4, 2)


def _pick_chunks(n: int, k: int) -> int:
    """Chunk count for the two-stage path, or 1 for a single stage (JAX's
    ``_pick_chunks``: only where chunks divide the row, so no pad entry can
    surface on an all ``-inf`` row, and hold at least ``2 * k``)."""
    if n < 4096:
        return 1
    for c in _CHUNK_CHOICES:
        if n % c == 0 and n // c >= 2 * k:
            return c
    return 1


def _sorted_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole row stable-sorted, flipped: ``(values, indices)``."""
    n = scores.shape[-1]
    vals, rev_idx = torch.sort(scores.flip(-1), dim=-1, descending=True, stable=True)
    return vals[..., :k], (n - 1) - rev_idx[..., :k]


def _chunkmax_pruned_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``[B, n]`` rows through chunk-max pruning (JAX's
    ``_chunkmax_pruned_topk``, whose docstring proves it exact):

    1. the max of each contiguous chunk of 8 (``chunk_max``, K6 on the card);
    2. the top-k chunks by (max desc, chunk index desc), the flip plus a
       stable descending sort;
    3. their k*8 candidates laid out in descending global index (the chunks
       in descending order, each chunk's 8 reversed), then one stable
       descending sort: ties come out by descending index, as JAX's two-key
       sort on (-value, -index) orders them."""
    B, n = scores.shape
    nc = n // _PRUNE_CH
    x = scores.contiguous()
    cmax = chunk_max(x)
    _, rev_ci = torch.sort(cmax.flip(-1), dim=-1, descending=True, stable=True)
    ci = torch.sort((nc - 1) - rev_ci[:, :k], dim=-1, descending=True).values
    lane = torch.arange(_PRUNE_CH - 1, -1, -1, device=x.device)
    gidx = (ci[:, :, None] * _PRUNE_CH + lane).reshape(B, k * _PRUNE_CH)
    flat = torch.gather(x, 1, gidx)
    vals, order = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[:, :k], torch.gather(gidx, 1, order[:, :k])


def _two_stage_topk(scores: torch.Tensor, k: int, chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``[B, n]`` rows in two stages (JAX's chunked path): each
    of ``chunks`` equal chunks keeps its own top-k by the flip and a stable
    sort (any global top-k element is in its chunk's), then the C*k
    candidates are ordered by (value desc, index desc) with two stable
    sorts: by index, then by value."""
    B, n = scores.shape
    w = n // chunks
    v1, rev_i1 = torch.sort(scores.reshape(B, chunks, w).flip(-1), dim=-1, descending=True, stable=True)
    base = (torch.arange(chunks, device=scores.device) * w)[:, None]
    flat_v = v1[..., :k].reshape(B, chunks * k)
    flat_i = (base + (w - 1) - rev_i1[..., :k]).reshape(B, chunks * k)
    by_idx = torch.sort(flat_i, dim=-1, descending=True).indices  # indices are distinct
    flat_v, flat_i = torch.gather(flat_v, 1, by_idx), torch.gather(flat_i, 1, by_idx)
    vals, order = torch.sort(flat_v, dim=-1, descending=True, stable=True)
    return vals[:, :k], torch.gather(flat_i, 1, order[:, :k])


def topk_desc_reference_order(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the top-k along the last axis of a rank-1 or
    rank-2 ``scores``, descending, ties by descending index; indices are
    int64. Rows of at least 4,096 take the pruned or two-stage path, with
    the same results."""
    n = scores.shape[-1]
    k = min(k, n)
    rows = scores.reshape(-1, n)
    chunks = _pick_chunks(n, k)
    if n >= 4096 and n % _PRUNE_CH == 0 and k <= n // _PRUNE_CH and 2 * k * _PRUNE_CH <= n:
        vals, idx = _chunkmax_pruned_topk(rows, k)
    elif chunks > 1:
        vals, idx = _two_stage_topk(rows, k, chunks)
    else:
        return _sorted_topk(scores, k)
    return vals.reshape(*scores.shape[:-1], k), idx.reshape(*scores.shape[:-1], k)
