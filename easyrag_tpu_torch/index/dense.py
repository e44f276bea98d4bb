"""Dense flat cosine index (port of ``easyrag_tpu/index/dense.py``).

The corpus embedding matrix lives on the device, L2-normalized, ``[N, D]``
in bf16, f32 or int8 (per-row scales); a query batch is scored with one
product ``q @ E^T`` and a filtered top-k. In JAX the product and the top-k
are XLA code, not Pallas, so here they are torch: a GEMM and
``ops/topk.py``.

Numerics, as JAX's ``dense_score_topk`` defines them:

* bf16 and f32 storage: the query is rounded to the storage dtype and the
  scores are f32 sums of exact products (a bf16 product is exact in f32),
  never rounded to bf16. On the card a bf16 matrix takes
  ``torch.mm(..., out_dtype=torch.float32)``; elsewhere the operands go to
  f32. An f32 product relies on TF32 being off, PyTorch's default.
* int8 storage: each query row is quantized symmetrically
  (``max|q| * f32(1/127)``, the form XLA gives JAX's ``/ 127``), the products accumulate exactly in int32
  (``torch._int_mm``, whose CUDA form wants more than 16 rows and widths
  that are multiples of 8: the operands are zero-padded to that, which adds
  nothing; an index pads its matrix once, at load), and the result is
  rescaled in f32 as ``acc * q_scale * scale``.
* the dir filter: -1 means none, -2 matches nothing (a dir the corpus does
  not have); filtered scores are ``-inf``;
* ties by descending index; a ``-inf`` score carries the index ``N``.

The host helpers (normalization, dir ids, int8 quantization, the on-disk
artifact, the query-stream padding) are numpy copies of JAX's: both packages
read the artifact the other writes (``dense_arrays.npz`` +
``dense_meta.json``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..ops.topk import topk_desc_reference_order

NEG_INF = float("-inf")
QUERY_BATCH = 64  # rows of every dense product (see DenseIndex.query)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def pad_int8(m8: torch.Tensor) -> torch.Tensor:
    """An int8 ``[N, D]`` matrix zero-padded to row and column counts that
    are multiples of 8 (``torch._int_mm``'s CUDA form); the matrix itself
    when they already are. An index pads once, at load."""
    pad_d, pad_n = -m8.shape[1] % 8, -m8.shape[0] % 8
    return F.pad(m8, (0, pad_d, 0, pad_n)) if pad_d or pad_n else m8


def _int8_scores(q8: torch.Tensor, m8: torch.Tensor, n: int) -> torch.Tensor:
    """Exact int32 ``q8 @ m8[:n].T`` through ``torch._int_mm``, the query
    zero-padded to more than 16 rows and to the matrix's padded width."""
    b, d = q8.shape
    m8 = pad_int8(m8)
    qp = torch.zeros(max(b, 17), m8.shape[1], dtype=torch.int8, device=q8.device)
    qp[:b, :d] = q8
    return torch._int_mm(qp, m8.t())[:b, :n]


@torch.inference_mode()
def dense_score_topk(
    query: torch.Tensor,  # [B, D] f32 (normalized)
    matrix: torch.Tensor,  # [N, D] bf16/f32, or int8 with scales (maybe pad_int8's form)
    k: int,
    dir_col: Optional[torch.Tensor] = None,  # [N] int32
    dir_filter: Optional[torch.Tensor] = None,  # [B] int32, -1 = no filter
    scales: Optional[torch.Tensor] = None,  # [N] f32, int8 rows only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine scores + filtered top-k: ``(scores [B, k] f32, idx [B, k]
    int64)``, ``k`` capped at ``N``. An int8 matrix has ``N = len(scales)``
    rows; any rows and columns past them are :func:`pad_int8`'s zeros."""
    if matrix.dtype == torch.int8:
        n = scales.shape[0]
        q = query.float()
        # times the f32 reciprocal: XLA compiles JAX's `/ 127.0` so
        q_scale = q.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0)
        q8 = torch.clamp(torch.round(q / torch.clamp(q_scale, min=1e-12)), -127, 127).to(torch.int8)
        scores = _int8_scores(q8, matrix, n).float() * q_scale * scales[None, :]
    elif matrix.dtype == torch.bfloat16 and matrix.is_cuda:
        n = matrix.shape[0]
        scores = torch.mm(query.to(torch.bfloat16), matrix.t(), out_dtype=torch.float32)
    else:
        n = matrix.shape[0]
        scores = query.to(matrix.dtype).float() @ matrix.float().t()
    if dir_col is not None and dir_filter is not None:
        keep = (dir_filter[:, None] == -1) | (dir_col[None, :] == dir_filter[:, None])
        scores = torch.where(keep, scores, NEG_INF)
    tv, ti = topk_desc_reference_order(scores, k)
    return tv, torch.where(torch.isfinite(tv), ti, n)


def dense_score_topk_stream(
    query: torch.Tensor,  # [NB, B, D]
    matrix: torch.Tensor,
    k: int,
    dir_col: Optional[torch.Tensor] = None,
    dir_filter: Optional[torch.Tensor] = None,  # [NB, B] int32
    scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`dense_score_topk` over each of ``NB`` query batches (JAX scans
    them on the device): stacked ``(scores [NB, B, k], idx [NB, B, k])``."""
    outs = [
        dense_score_topk(query[i], matrix, k, dir_col=dir_col,
                         dir_filter=dir_filter[i] if dir_filter is not None else None, scales=scales)
        for i in range(query.shape[0])
    ]
    if not outs:
        kk = min(k, matrix.shape[0] if scales is None else scales.shape[0])
        return (torch.empty(0, query.shape[1], kk, device=matrix.device),
                torch.empty(0, query.shape[1], kk, dtype=torch.int64, device=matrix.device))
    return torch.stack([v for v, _ in outs]), torch.stack([i for _, i in outs])


def l2_normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, eps)


def prepare_dense_arrays(embeddings: np.ndarray, dirs: Optional[list] = None, dtype: str = "bfloat16"):
    """Normalize rows, assign dir ids, optionally int8-quantize. Returns
    ``(matrix, scales_or_None, dir_ids_or_None, dir_vocab)`` as host numpy
    arrays (int8 matrix + f32 scales when ``dtype == "int8"``, else the
    normalized f32 matrix; the caller casts)."""
    mat = l2_normalize(np.asarray(embeddings, dtype=np.float32))
    dir_ids = None
    dir_vocab: Dict[str, int] = {}
    if dirs is not None:
        dir_ids = np.zeros(len(dirs), dtype=np.int32)
        for i, d in enumerate(dirs):
            if d not in dir_vocab:
                dir_vocab[d] = len(dir_vocab)
            dir_ids[i] = dir_vocab[d]
    if dtype == "int8":
        row_scale = np.abs(mat).max(axis=1) / 127.0
        mat_q = np.clip(np.round(mat / np.maximum(row_scale[:, None], 1e-12)), -127, 127).astype(np.int8)
        return mat_q, row_scale.astype(np.float32), dir_ids, dir_vocab
    return mat, None, dir_ids, dir_vocab


def save_dense_artifact(path: str, matrix: np.ndarray, scales: Optional[np.ndarray], dir_ids: Optional[np.ndarray],
                        dir_vocab: Dict[str, int], dtype: str) -> None:
    """Write the on-disk dense artifact from host arrays."""
    os.makedirs(path, exist_ok=True)
    arrays = {"dir_ids": dir_ids if dir_ids is not None else np.zeros(0, np.int32)}
    if scales is not None:
        arrays["matrix"] = np.asarray(matrix)
        arrays["scales"] = np.asarray(scales, np.float32)
    else:
        arrays["matrix"] = np.asarray(matrix, dtype=np.float32)
    np.savez(os.path.join(path, "dense_arrays.npz"), **arrays)
    with open(os.path.join(path, "dense_meta.json"), "w", encoding="utf-8") as f:
        json.dump({"dir_vocab": dir_vocab, "has_dir_ids": dir_ids is not None, "dtype": dtype}, f)


def load_dense_arrays(path: str):
    """The on-disk dense artifact as host arrays:
    ``(matrix, scales_or_None, dir_ids_or_None, dir_vocab, dtype_str)``."""
    arrays = np.load(os.path.join(path, "dense_arrays.npz"))
    with open(os.path.join(path, "dense_meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    dir_ids = arrays["dir_ids"] if meta["has_dir_ids"] else None
    scales = arrays["scales"] if meta["dtype"] == "int8" else None
    dir_vocab = {k: int(v) for k, v in meta["dir_vocab"].items()}
    return arrays["matrix"], scales, dir_ids, dir_vocab, meta["dtype"]


def pad_dense_query_stream(query_embs, dir_values, dir_vocab, has_dir_col, batch):
    """Normalize + pad a query stream to ``[NB, B, D]`` (zero rows score 0
    everywhere and are stripped by the caller), mapping per-row dir names to
    filter ids (-1 none, -2 unknown). Returns ``(q, dir_f_or_None, Q)``."""
    q = l2_normalize(np.atleast_2d(np.asarray(query_embs, np.float32)))
    Q = q.shape[0]
    n_batches = (Q + batch - 1) // batch
    pad = n_batches * batch - Q
    if pad:
        q = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
    q = q.reshape(n_batches, batch, q.shape[1])
    dir_f = None
    if has_dir_col:
        dvals = list(dir_values or [None] * Q) + [None] * pad
        dir_f = np.array([dir_vocab.get(d, -2) if d else -1 for d in dvals], dtype=np.int32).reshape(n_batches, batch)
    return q, dir_f, Q


@dataclass
class DenseIndex:
    """Device-resident flat cosine index over one content view of the
    corpus."""

    matrix: torch.Tensor  # [N, D] normalized
    dir_ids: Optional[np.ndarray] = None  # [N] int32 metadata column
    dir_vocab: Dict[str, int] = field(default_factory=dict)
    scales: Optional[torch.Tensor] = None  # [N] f32, int8 rows only

    def __post_init__(self) -> None:
        self.dir_col = None if self.dir_ids is None else torch.from_numpy(self.dir_ids).to(self.matrix.device)
        # the operand of every product: an int8 matrix in pad_int8's form
        # (a copy only where N or D is not a multiple of 8)
        self.scored = pad_int8(self.matrix) if self.matrix.dtype == torch.int8 else self.matrix

    @classmethod
    def _from_arrays(cls, matrix, scales, dir_ids, dir_vocab, dtype: str, device) -> "DenseIndex":
        dev = resolve_device(device)
        return cls(
            matrix=torch.from_numpy(np.asarray(matrix)).to(dev, _DTYPES[dtype]),
            dir_ids=dir_ids,
            dir_vocab=dir_vocab,
            scales=None if scales is None else torch.from_numpy(np.asarray(scales, np.float32)).to(dev),
        )

    @classmethod
    def build(cls, embeddings: np.ndarray, dirs: Optional[list] = None, dtype: str = "bfloat16",
              device="cuda") -> "DenseIndex":
        """Normalized (and for int8 quantized) rows on ``device``: the card
        unless the caller asks for the CPU."""
        return cls._from_arrays(*prepare_dense_arrays(embeddings, dirs, dtype), dtype, device)

    @property
    def num_docs(self) -> int:
        return self.matrix.shape[0]

    def query(self, query_emb: np.ndarray, k: int, dir_value: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Single or batched query -> ``(scores, indices)``, host arrays. It
        runs as a stream, at the stream's batch shape: a GEMM's sums depend
        on its row count, so a query's scores then equal
        :meth:`query_stream`'s bit for bit, whatever else is in the batch."""
        q = np.atleast_2d(np.asarray(query_emb, dtype=np.float32))
        return self.query_stream(q, k, dir_values=[dir_value] * q.shape[0])

    def query_stream(self, query_embs: np.ndarray, k: int, dir_values: Optional[list] = None,
                     batch: int = QUERY_BATCH) -> Tuple[np.ndarray, np.ndarray]:
        """A whole query set in batches of ``batch`` rows (per-row dir
        names), tail padding stripped; equal to :meth:`query` row by row at
        the default batch."""
        dev = self.matrix.device
        q, dir_f, Q = pad_dense_query_stream(query_embs, dir_values, self.dir_vocab, self.dir_col is not None, batch)
        tvs, tis = dense_score_topk_stream(
            torch.from_numpy(q).to(dev), self.scored, k, dir_col=self.dir_col,
            dir_filter=None if dir_f is None else torch.from_numpy(dir_f).to(dev), scales=self.scales,
        )
        kk = tvs.shape[-1]
        return tvs.cpu().numpy().reshape(-1, kk)[:Q], tis.cpu().numpy().reshape(-1, kk)[:Q]

    # -- on-disk artifact ----------------------------------------------------

    def save(self, path: str) -> None:
        save_dense_artifact(
            path,
            self.matrix.cpu().numpy() if self.scales is not None else self.matrix.float().cpu().numpy(),
            None if self.scales is None else self.scales.cpu().numpy(),
            self.dir_ids,
            self.dir_vocab,
            _NAMES[self.matrix.dtype],
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "DenseIndex":
        matrix, scales, dir_ids, dir_vocab, dtype = load_dense_arrays(path)
        return cls._from_arrays(matrix, scales, dir_ids, dir_vocab, dtype, device)
