"""BM25 query scoring from gathered postings (port of ``easyrag_tpu/ops/bm25.py``).

The host gathers the query's posting slices into sentinel-padded buffers
(``SparseIndex.gather_postings``); the device turns them into a dense score
vector and a filtered top-k with the reference's semantics
(``src/easyrag/custom/retrievers.py:191-210``):

* rank by ``argsort()[::-1]`` order (ties by descending doc index);
* entries with ``score <= 0`` are dropped;
* an optional ``dir`` equality filter (-1 = none, -2 = matches nothing)
  drops docs without consuming top-k slots.

Dropped entries come back as ``(-inf, num_docs)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import bm25_scatter
from .topk import topk_desc_reference_order

NEG_INF = float("-inf")


def filter_topk(
    scores: torch.Tensor,  # [B, N] f32
    k: int,
    dir_col: Optional[torch.Tensor] = None,  # [N] int32
    dir_filter: Optional[torch.Tensor] = None,  # [B] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dir filter, ``score > 0`` mask and reference-ordered top-k over rows."""
    n = scores.shape[-1]
    if dir_col is not None and dir_filter is not None:
        dir_f = dir_filter.reshape(-1, 1)
        keep = (dir_f == -1) | (dir_col.reshape(1, -1) == dir_f)
        scores = torch.where(keep, scores, NEG_INF)
    scores = torch.where(scores > 0, scores, NEG_INF)
    top_vals, top_idx = topk_desc_reference_order(scores, k)
    return top_vals, torch.where(torch.isfinite(top_vals), top_idx, n)


def bm25_score_topk(
    doc_ids: torch.Tensor,
    vals: torch.Tensor,
    num_docs: int,
    k: int,
    dir_col: Optional[torch.Tensor] = None,
    dir_filter: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score + filter + top-k. ``doc_ids``/``vals`` are ``[P]`` or ``[B, P]``;
    ``dir_filter`` a scalar or ``[B]`` int tensor. The scatter always goes
    through ``bm25_scatter.bm25_scores``: the K5 kernel for CUDA tensors (the
    same sums every run; a float-atomic scatter would reorder them and flip
    near-ties), its plain version for CPU tensors. ``use_pallas``, the TPU
    kernel switch of the shared config, selects nothing here."""
    del use_pallas
    batched = doc_ids.dim() == 2
    scores = bm25_scatter.bm25_scores(doc_ids, vals, num_docs)
    s = scores if batched else scores[None, :]
    top_vals, top_idx = filter_topk(s, k, dir_col, dir_filter)
    if not batched:
        return top_vals[0], top_idx[0]
    return top_vals, top_idx
