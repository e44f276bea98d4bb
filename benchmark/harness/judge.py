"""What decides ``correct``: the timed path's outputs against the reference.

Three numbers, each with its limit in the configuration file:

* ``retrieval_gap``: for every request of the window, the candidates the
  sparse dual route and its fusion produced (as the pipeline handed them to
  the reranker, or as ``run_retrieval_batch`` returned them) against the
  float64 reference (its ties broken towards the program's candidates):
  the widest gap between the two lists' sorted scores, and between each
  candidate's score and its reference score on the route that gave it, over
  the reference's best score. A missing, extra or repeated candidate reads
  infinity.
* ``rerank_error``: for a sample of requests drawn from the seed (the one
  with the most candidates always in it), the root mean square of the gaps
  between the program's rerank scores and the reference's (float32 with
  TF32 products) over every candidate of the sample, in units of the same
  gaps of a plain bf16 computation of the scorer on the same pairs: about 1
  for a sound bf16 program, whatever the seed's random weights make of
  rounding.
* ``top_mismatch``: for every request, the nodes the reranker returned that
  are not its top ``top_n`` by its own scores (ties aside), or that are
  missing: exact, so its limit is 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def retrieval_gap(prog: Sequence[Tuple[int, float]], ref: Sequence[Tuple[int, float]], content: np.ndarray,
                  path: np.ndarray, allowed: Optional[np.ndarray]) -> float:
    """``prog`` and ``ref``: fused candidates ``(doc, score)``; ``content``
    and ``path``: the reference's float64 route scores of every doc."""
    if len(prog) != len(ref) or len({d for d, _ in prog}) != len(prog):
        return math.inf
    if not ref:
        return 0.0
    scale = max(s for _, s in ref)
    ps = sorted((s for _, s in prog), reverse=True)
    rs = sorted((s for _, s in ref), reverse=True)
    gap = max(abs(a - b) for a, b in zip(ps, rs))
    c = content if allowed is None else np.where(allowed, content, 0.0)
    for d, s in prog:
        gap = max(gap, min(abs(s - c[d]), abs(s - path[d])))
    return gap / scale


def rerank_error(prog: Sequence[Sequence[float]], ref: Sequence[np.ndarray], plain: Sequence[np.ndarray]) -> float:
    """``rerank_error`` over the sample: per request, the program's scores,
    the reference's and the plain bf16 computation's, per candidate."""
    num = sum(float(np.sum((np.asarray(p, np.float64) - r) ** 2)) for p, r in zip(prog, ref))
    den = sum(float(np.sum((np.asarray(b, np.float64) - r) ** 2)) for b, r in zip(plain, ref))
    return math.sqrt(num / den) if den > 0 else math.inf


def top_mismatch(candidates: Sequence[int], scores: Sequence[float], top: Sequence[Tuple[int, float]],
                 top_n: int) -> int:
    """Returned nodes ``top`` ``[(idx, score)]`` not among the ``top_n``
    best of the candidates by the program's own ``scores``, or returned with
    another score than the candidate's, plus the nodes missing."""
    own = dict(zip(candidates, scores))
    want = min(top_n, len(candidates))
    kth = sorted(scores, reverse=True)[want - 1] if want else math.inf
    bad = sum(1 for i, s in top if i not in own or own[i] != s or s < kth)
    return bad + abs(want - len(top)) + (len(top) - len({i for i, _ in top}))


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every number at or under its limit; a number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k, math.nan)} for k, v in values.items()}
    ok = all(k in limits and v <= limits[k] for k, v in values.items())
    return ok, checks


def widest(values: List[float]) -> float:
    return max(values) if values else 0.0
