"""Sharded retrieval over a mesh's ``data`` axis (port of
``easyrag_tpu/parallel/sharded.py``).

The corpus axis is cut into doc ranges of ``shard_size`` docs
(:func:`shard_ranges`: ``ceil(N / D)`` rounded up to a multiple of 64, the
last range cut at ``N``); shard ``s`` holds range ``s`` on the mesh's
``s``-th data device (one copy, not repeated over a ``model`` axis). JAX
pads its ranges of ``ceil(N / D)`` to the full width and masks the pads
(dir ``-3``, score ``-inf``). The port stores no pad: a reduction's order,
and so its bits, depends on the alignment of its width (the heavy part's sum
over term slots on the card and on the CPU, the bf16 product on the card), so
each shard must start where a block of the single-chip row starts and end
where the single-chip row ends; then no pad exists to surface, and the
pruned top-k (K6, rows a multiple of 8) runs on every shard where it runs
on the single-chip row. For a small corpus the last ranges may be empty:
those shards are not built. A query
batch is uploaded to every shard, each shard scores its range and takes a
local top-k with the single-chip code (so the pruned top-k, K6 on the card,
runs per shard), and only then are the ``D * k`` candidates, with global doc
ids, copied to the first data device and merged: a two-key stable sort on
(score desc, global index desc), the single-chip tie order, so any global
top-k element is in its shard's top-k and the merge equals the single-chip
top-k. Every shard's work is issued before any candidate is copied, so on
several cards the shards run at once. ``-inf`` entries carry index ``N``.

One process drives every shard, as JAX's single controller does; a mesh may
repeat a device (``["cuda:0"] * 4``: four shards on one card).

* :class:`ShardedDenseIndex`: row ranges of the cosine matrix (f32, bf16, or
  int8 rows with per-row scales), scored by ``index/dense.py``'s
  ``dense_scores``; the int8 query is quantized per row by every shard alike.
* :class:`ShardedResidentSparseIndex`: the resident BM25 index with the
  global heavy/light split; each shard holds its columns of the heavy matrix
  (int8 scales per doc column over the global heavy set) and its range's
  light postings, re-packed with shard-local doc ids, and scores them with
  ``ResidentSparseIndex.score_rows``, the single-chip arithmetic: the heavy
  part, then one ``index_add_`` per light term slot in slot order (within a
  slot no two postings of a row share a doc, so the adds are the same on
  every run). JAX's sharded tail is one flat ``.at[].add`` over every slot;
  on CUDA that would be a float-atomic scatter over colliding docs whose
  order varies from run to run, so the port does not copy it. There is no
  K5 tail (``tail="pallas"``), as in JAX.
* :class:`ShardedSparseScorer`: the gathered-postings form; each shard
  scores its range through ``ops/bm25_scatter.bm25_scores`` (K5 on the
  card, which drops ids outside the range) with ids shifted by its start.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.dense import (
    QUERY_BATCH,
    _DTYPES,
    dense_scores,
    load_dense_arrays,
    pad_dense_query_stream,
    pad_int8,
    prepare_dense_arrays,
)
from ..ops import bm25_scatter
from ..ops.bm25 import filter_topk
from ..ops.bm25_resident import (
    HEAVY_ITEMSIZE,
    ResidentSparseIndex,
    auto_light_cap,
    quantize_heavy_int8,
)
from ..ops.topk import topk_desc_reference_order
from .mesh import Mesh

NEG_INF = float("-inf")


def merge_global_topk(parts, k: int, num_docs: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shard's ``(values [B, kk], global indices [B, kk])`` copied to
    ``device`` and merged: ``(values [B, min(k, N)], indices)``, by (value
    desc, index desc), ``-inf`` entries with index ``num_docs``. The
    candidates are ordered by index first, then stably by value, since
    ``torch.topk`` promises no order among ties."""
    vals = torch.cat([v.to(device) for v, _ in parts], dim=1)
    idx = torch.cat([i.to(device) for _, i in parts], dim=1)
    by_idx = torch.sort(idx, dim=1, descending=True, stable=True).indices
    vals, idx = vals.gather(1, by_idx), idx.gather(1, by_idx)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    k = min(k, num_docs)
    top_v = vals[:, :k]
    return top_v, torch.where(torch.isfinite(top_v), idx.gather(1, order[:, :k]), num_docs)


def shard_width(num_docs: int, n_shards: int) -> int:
    """The docs each of ``n_shards`` shards holds: ``ceil(N / D)`` rounded
    up to a multiple of 64 (the widest vector block of the CPU's reduction;
    the card's wants 4)."""
    return max(64, -(-num_docs // (64 * n_shards)) * 64)


def shard_ranges(num_docs: int, n_shards: int) -> List[Tuple[int, int]]:
    """The non-empty ``(lo, hi)`` doc ranges of :func:`shard_width`."""
    w = shard_width(num_docs, n_shards)
    return [(lo, min(lo + w, num_docs)) for lo in range(0, max(num_docs, 1), w)][:n_shards]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class _DenseShard:
    def __init__(self, lo: int, width: int, matrix, scales, dir_col) -> None:
        self.lo, self.width = lo, width  # first global row, rows
        self.matrix, self.scales, self.dir_col = matrix, scales, dir_col


class ShardedDenseIndex:
    """Row-sharded cosine index over a mesh ``data`` axis; a drop-in for
    ``DenseIndex`` behind ``DenseRetriever`` (``query(dir_value=...)``,
    ``query_stream(dir_values=...)``)."""

    def __init__(self, mesh: Mesh, matrix: np.ndarray, dtype="bfloat16", dir_ids: Optional[np.ndarray] = None,
                 dir_vocab=None, scales: Optional[np.ndarray] = None) -> None:
        """``matrix``: host rows, normalized f32 (cast to ``dtype``), or
        int8 when ``scales`` (per-row f32) is given: the arrays a
        single-chip ``DenseIndex`` holds, cut into row ranges."""
        self.mesh = mesh
        self.dir_vocab = dir_vocab or {}
        self.devices = mesh.data_devices()
        n, d = matrix.shape
        self.num_docs = n
        self.shard_size = shard_width(n, len(self.devices))
        self.has_dir_col = dir_ids is not None
        torch_dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.shards: List[_DenseShard] = []
        for (lo, hi), dev in zip(shard_ranges(n, len(self.devices)), self.devices):
            rows = np.ascontiguousarray(matrix[lo:hi])
            if scales is not None:  # int8 rows + per-row scales, in _int_mm's padded form
                m = pad_int8(torch.from_numpy(rows).to(dev))
                sct = torch.from_numpy(np.asarray(scales[lo:hi], np.float32)).to(dev)
            else:
                m, sct = torch.from_numpy(rows.astype(np.float32, copy=False)).to(dev, torch_dtype), None
            dcol = None if dir_ids is None else torch.from_numpy(np.asarray(dir_ids[lo:hi], np.int32)).to(dev)
            self.shards.append(_DenseShard(lo, hi - lo, m, sct, dcol))

    @classmethod
    def from_arrays(cls, mesh: Mesh, matrix, scales, dir_ids, dir_vocab, dtype: str) -> "ShardedDenseIndex":
        """From the host arrays ``prepare_dense_arrays`` / ``load_dense_arrays``
        give (``dtype`` is ignored for int8 rows: ``scales`` implies them)."""
        return cls(mesh, matrix, dtype=dtype, dir_ids=dir_ids, dir_vocab=dir_vocab, scales=scales)

    @classmethod
    def build(cls, mesh: Mesh, embeddings: np.ndarray, dirs=None, dtype: str = "bfloat16") -> "ShardedDenseIndex":
        """From host embeddings: each shard goes straight to its device; the
        whole matrix never lands on one."""
        return cls.from_arrays(mesh, *prepare_dense_arrays(embeddings, dirs, dtype), dtype)

    @classmethod
    def load(cls, mesh: Mesh, path: str) -> "ShardedDenseIndex":
        """The ``DenseIndex`` artifact read on the host, then sharded."""
        matrix, scales, dir_ids, dir_vocab, dtype = load_dense_arrays(path)
        return cls.from_arrays(mesh, matrix, scales, dir_ids, dir_vocab, dtype)

    @classmethod
    def from_dense(cls, mesh: Mesh, dense) -> "ShardedDenseIndex":
        """A single-chip ``DenseIndex`` sharded with its exact stored rows
        (int8 rows and scales included); copies the matrix to the host."""
        int8 = dense.scales is not None
        return cls(
            mesh,
            dense.matrix.cpu().numpy() if int8 else dense.matrix.float().cpu().numpy(),
            dtype=dense.matrix.dtype,
            dir_ids=dense.dir_ids,
            dir_vocab=dense.dir_vocab,
            scales=dense.scales.cpu().numpy() if int8 else None,
        )

    def device_bytes(self) -> List[int]:
        """Each shard's bytes on its device (rows, scales, dir column)."""
        return [_nbytes(sh.matrix, sh.scales, sh.dir_col) for sh in self.shards]

    @torch.inference_mode()
    def _batch(self, qs: List[torch.Tensor], dfs: List[Optional[torch.Tensor]], k: int):
        """One query batch (``qs[s]``, ``dfs[s]`` on shard ``s``'s device)
        scored on every shard, then merged."""
        parts = []
        for sh, q, df in zip(self.shards, qs, dfs):
            scores = dense_scores(q, sh.matrix, sh.scales)
            if sh.dir_col is not None and df is not None:
                keep = (df[:, None] == -1) | (sh.dir_col[None, :] == df[:, None])
                scores = torch.where(keep, scores, NEG_INF)
            tv, ti = topk_desc_reference_order(scores, min(k, sh.width))
            parts.append((tv, ti + sh.lo))
        return merge_global_topk(parts, k, self.num_docs, self.devices[0])

    def _stream(self, q: np.ndarray, dir_f: Optional[np.ndarray], k: int, n_rows: int):
        """``q [NB, B, D]`` (and ``dir_f [NB, B]``) uploaded once per shard,
        scored batch by batch: host ``(scores [n_rows, k], indices)``."""
        qd = [torch.from_numpy(q).to(sh.matrix.device) for sh in self.shards]
        dd = [None if dir_f is None else torch.from_numpy(dir_f).to(sh.matrix.device) for sh in self.shards]
        outs = [self._batch([x[i] for x in qd], [None if x is None else x[i] for x in dd], k)
                for i in range(q.shape[0])]
        kk = min(k, self.num_docs)
        if not outs:
            return np.zeros((0, kk), np.float32), np.zeros((0, kk), np.int64)
        tv = torch.cat([v for v, _ in outs]).cpu().numpy()
        ti = torch.cat([i for _, i in outs]).cpu().numpy()
        return tv[:n_rows], ti[:n_rows]

    def query(self, q: np.ndarray, k: int, dir_filter: Optional[np.ndarray] = None,
              dir_value: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Single or batched query: ``dir_filter`` per-row filter ints, or
        ``dir_value`` one dir name for every row (``DenseIndex.query``'s
        contract). Runs at the stream's batch shape, as ``DenseIndex.query``
        does, so a query's scores equal :meth:`query_stream`'s."""
        q = np.atleast_2d(np.asarray(q, dtype=np.float32))
        if dir_filter is None:
            return self.query_stream(q, k, dir_values=[dir_value] * q.shape[0])
        qp, _, n_rows = pad_dense_query_stream(q, None, self.dir_vocab, False, QUERY_BATCH)
        df = np.full(qp.shape[0] * qp.shape[1], -1, np.int32)
        df[:n_rows] = np.asarray(dir_filter, np.int32).reshape(-1)
        return self._stream(qp, df.reshape(qp.shape[:2]) if self.has_dir_col else None, k, n_rows)

    def query_stream(self, query_embs: np.ndarray, k: int, dir_values: Optional[list] = None,
                     batch: int = QUERY_BATCH) -> Tuple[np.ndarray, np.ndarray]:
        """A whole query set in batches of ``batch`` rows (per-row dir
        names), tail padding stripped: ``DenseIndex.query_stream``'s
        contract."""
        q, dir_f, n_rows = pad_dense_query_stream(query_embs, dir_values, self.dir_vocab, self.has_dir_col, batch)
        return self._stream(q, dir_f, k, n_rows)


class _ResidentShard:
    """One shard's resident arrays, with shard-local doc ids (``num_docs`` is
    the shard's width, the sentinel doc id too), scored by the single-chip
    ``ResidentSparseIndex`` methods themselves."""

    tail = "xla"
    heavy_part = ResidentSparseIndex.heavy_part
    light_postings = ResidentSparseIndex.light_postings
    score_rows = ResidentSparseIndex.score_rows

    def __init__(self, lo: int, device: torch.device, **arrays) -> None:
        self.lo = lo
        self.device = device
        for name, value in arrays.items():
            setattr(self, name, value)

    def device_bytes(self) -> int:
        return _nbytes(self.heavy, self.heavy_scales, self.t_heavy_row, self.t_starts, self.t_light_lens,
                       self.post_docs, self.post_vals, self.dir_col)


class ShardedResidentSparseIndex:
    """Doc-range-sharded device-resident BM25 index; a drop-in ``_resident``
    for ``BM25Retriever`` (``query_terms``, ``query_terms_batch``,
    ``light_t_bound``, ``_score_topk``, ``stream_from_arrays``)."""

    def __init__(
        self,
        mesh: Mesh,
        index,
        light_cap: Optional[int] = None,
        max_query_terms: int = 64,
        heavy_hbm_budget: int = 512 * 1024 * 1024,
        heavy_dtype: str = "float32",
        light_rows: Optional[bool] = None,
        light_rows_hbm_budget: int = 256 * 1024 * 1024,
    ) -> None:
        """Without ``light_cap`` the cap is JAX's sharded policy: the
        single-chip cost model over JAX's docs per shard (``ceil(N / D)``)
        and the per-shard budgets, with ``kappa_scale=0.5`` for the ``rows``
        layout, picked again for ``csr`` when that cap's table does not fit.
        A term is heavy when its global df exceeds the cap, on every shard
        alike."""
        if heavy_dtype not in HEAVY_ITEMSIZE:
            raise ValueError(f"unsupported heavy_dtype {heavy_dtype!r}")
        self.mesh = mesh
        self.host_index = index
        self.dir_vocab = index.dir_vocab
        self.num_docs = N = index.num_docs
        self.max_query_terms = max_query_terms
        self.heavy_dtype = heavy_dtype
        self.devices = mesh.data_devices()
        self.device = self.devices[0]  # where the merged top-k lands
        D = len(self.devices)
        self.shard_size = W = shard_width(N, D)

        offs = index.stats.term_offsets
        lens = np.diff(offs).astype(np.int64)
        self.V = V = len(lens)
        if light_cap is None:
            itemsize = HEAVY_ITEMSIZE[heavy_dtype]
            docs_per_shard = max(1, -(-N // D))
            light_cap = auto_light_cap(lens, docs_per_shard, itemsize, heavy_hbm_budget, max_query_terms,
                                       kappa_scale=0.5)
            if light_rows is False or (V + 1) * light_cap * 8 > light_rows_hbm_budget:
                light_cap = auto_light_cap(lens, docs_per_shard, itemsize, heavy_hbm_budget, max_query_terms)
        self.light_cap = C = light_cap
        if light_rows is None:
            light_rows = (V + 1) * C * 8 <= light_rows_hbm_budget
        self.light_layout = "rows" if light_rows else "csr"

        heavy_terms = np.where(lens > C)[0]
        H = ((max(len(heavy_terms), 1) + 7) // 8) * 8
        docs = index.stats.post_docs.astype(np.int64)
        vals = index.post_vals.astype(np.float32)
        heavy = np.zeros((H, N), dtype=np.float32)
        heavy_row = np.full(V + 1, -1, dtype=np.int64)  # +1: the pad term
        for row, t in enumerate(heavy_terms):
            heavy[row, docs[offs[t] : offs[t + 1]]] = vals[offs[t] : offs[t + 1]]
            heavy_row[t] = row
        light_lens = np.zeros(V + 1, dtype=np.int64)
        light_lens[:V] = lens
        light_lens[heavy_terms] = 0
        self._host_light_lens = light_lens
        scales = None
        if heavy_dtype == "int8":  # scales per doc column over the global heavy set
            heavy, scales = quantize_heavy_int8(heavy)
        dir_ids = None if index.dir_ids is None else index.dir_ids.astype(np.int32)

        # the light postings, in term order, split by doc range
        terms = np.repeat(np.arange(V, dtype=np.int64), lens)
        light = light_lens[terms] > 0
        shard_of = docs // W
        win = np.arange(C, dtype=np.int64)[None, :]
        self.shards: List[_ResidentShard] = []
        for s, ((lo, hi), dev) in enumerate(zip(shard_ranges(N, D), self.devices)):
            sel = light & (shard_of == s)
            t_s = terms[sel]
            s_lens = np.zeros(V + 1, dtype=np.int64)
            s_lens[:V] = np.bincount(t_s, minlength=V)
            starts = np.zeros(V + 1, dtype=np.int64)
            np.cumsum(s_lens[:V], out=starts[1:])
            P = len(t_s)
            # one sentinel slot at the end: the shard-local doc id hi - lo, value 0
            p_docs = np.append(docs[sel] - lo, hi - lo)
            p_vals = np.append(vals[sel], np.float32(0))
            if light_rows:
                pos = np.where(win < s_lens[:, None], starts[:, None] + win, P)
                p_docs, p_vals = p_docs[pos], p_vals[pos]
            h = torch.from_numpy(np.ascontiguousarray(heavy[:, lo:hi]))
            self.shards.append(_ResidentShard(
                lo, dev,
                num_docs=hi - lo, light_cap=C, light_layout=self.light_layout, heavy_dtype=heavy_dtype, P=P,
                heavy=(h.to(torch.bfloat16) if heavy_dtype == "bfloat16" else h).to(dev),
                heavy_scales=None if scales is None else torch.from_numpy(scales[lo:hi].copy()).to(dev),
                t_heavy_row=torch.from_numpy(heavy_row).to(dev),
                t_starts=torch.from_numpy(starts).to(dev),
                t_light_lens=torch.from_numpy(s_lens).to(dev),
                post_docs=torch.from_numpy(p_docs).to(dev),
                post_vals=torch.from_numpy(p_vals).to(dev),
                dir_col=None if dir_ids is None else torch.from_numpy(dir_ids[lo:hi].copy()).to(dev),
            ))
        self.H = H

    # -- host-side query prep: the single-chip index's ----------------------

    def query_terms(self, query_tokens):
        return ResidentSparseIndex.query_terms(self, query_tokens)

    def query_terms_batch(self, queries_tokens):
        return ResidentSparseIndex.query_terms_batch(self, queries_tokens)

    def light_t_bound(self, ids: np.ndarray) -> int:
        return ResidentSparseIndex.light_t_bound(self, ids)

    def _dir_ints(self, dir_values) -> Optional[np.ndarray]:
        if dir_values is None or self.host_index.dir_ids is None:
            return None
        return np.asarray([self.dir_vocab.get(d, -2) if d else -1 for d in dir_values], dtype=np.int32)

    def device_bytes(self) -> List[int]:
        """Each shard's bytes on its device (heavy columns, scales, light
        tables or CSR, lookup tables, dir column)."""
        return [sh.device_bytes() for sh in self.shards]

    # -- device scoring -------------------------------------------------------

    def _score_shards(self, per_shard, k: int, light_t: Optional[int], heavy_form: str = "auto"):
        """``per_shard[s] = (ids, counts, dir_filter or None)`` on shard
        ``s``'s device: every shard scored and cut to its top-k, then the
        merge."""
        parts = []
        for sh, (ids, cnts, df) in zip(self.shards, per_shard):
            tv, ti = filter_topk(sh.score_rows(ids, cnts, light_t, heavy_form), min(k, sh.num_docs), sh.dir_col, df)
            parts.append((tv, ti + sh.lo))
        return merge_global_topk(parts, k, self.num_docs, self.device)

    @torch.inference_mode()
    def _score_topk(
        self,
        term_ids: torch.Tensor,  # [B, T] int64
        counts: torch.Tensor,  # [B, T] f32
        k: int,
        dir_filter: Optional[torch.Tensor] = None,  # [B] int32
        light_t: Optional[int] = None,
        heavy_form: str = "auto",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``ResidentSparseIndex._score_topk``'s contract over the shards;
        the result lies on the first data device."""
        per_shard = [(term_ids.to(sh.device), counts.to(sh.device),
                      None if dir_filter is None else dir_filter.to(sh.device)) for sh in self.shards]
        return self._score_shards(per_shard, k, light_t, heavy_form)

    def score_topk(self, queries_tokens: Sequence[Sequence[str]], k: int,
                   dir_values: Optional[Sequence[Optional[str]]] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Batched query -> host ``(scores [B, k], indices [B, k])``."""
        ids, cnts = self.query_terms_batch(queries_tokens)
        dir_f = self._dir_ints(dir_values)
        tv, ti = self._score_topk(torch.from_numpy(ids), torch.from_numpy(cnts), k,
                                  None if dir_f is None else torch.from_numpy(dir_f), self.light_t_bound(ids))
        return tv.cpu().numpy(), ti.cpu().numpy()

    @torch.inference_mode()
    def stream_from_arrays(self, ids: np.ndarray, cnts: np.ndarray, dir_f: Optional[np.ndarray], k: int,
                           batch: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """``ResidentSparseIndex.stream_from_arrays``'s contract: the prepped
        stream uploaded once to each shard's device, scored in batches of
        ``batch`` rows, host ``(scores [Q, k], indices [Q, k])``."""
        if not len(ids):
            kk = min(k, self.num_docs)
            return np.zeros((0, kk), np.float32), np.zeros((0, kk), np.int64)
        light_t = self.light_t_bound(ids)
        t_ids = torch.from_numpy(ids)
        t_cnts = torch.from_numpy(cnts)
        t_dir = None if dir_f is None else torch.from_numpy(np.asarray(dir_f, np.int32))
        up = [(t_ids.to(sh.device), t_cnts.to(sh.device), None if t_dir is None else t_dir.to(sh.device))
              for sh in self.shards]
        parts = [
            self._score_shards([(i[lo : lo + batch], c[lo : lo + batch], None if d is None else d[lo : lo + batch])
                                for i, c, d in up], k, light_t)
            for lo in range(0, len(ids), batch)
        ]
        return torch.cat([v for v, _ in parts]).cpu().numpy(), torch.cat([i for _, i in parts]).cpu().numpy()

    def stream_score_topk(self, queries_tokens, k: int, batch: int = 64,
                          dir_values=None) -> Tuple[np.ndarray, np.ndarray]:
        """A whole query stream in batches of ``batch``, equal to
        :meth:`score_topk` row by row."""
        ids, cnts = self.query_terms_batch(queries_tokens)
        return self.stream_from_arrays(ids, cnts, self._dir_ints(dir_values), k, batch=batch)


class ShardedSparseScorer:
    """Doc-range-sharded BM25 scoring of gathered postings: the postings
    (small, replicated) go to every shard, each scores its range through
    ``bm25_scatter.bm25_scores`` (K5 on the card), then the merge."""

    def __init__(self, mesh: Mesh, num_docs: int) -> None:
        self.mesh = mesh
        self.num_docs = num_docs
        self.devices = mesh.data_devices()
        self.shard_size = shard_width(num_docs, len(self.devices))

    @torch.inference_mode()
    def score_topk(self, doc_ids: np.ndarray, vals: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """``doc_ids``/``vals`` ``[P]`` or ``[B, P]`` (sentinel id
        ``num_docs``) -> host ``(scores [B, k], indices [B, k])``."""
        ids = np.atleast_2d(np.asarray(doc_ids, np.int64))
        v = np.ascontiguousarray(np.atleast_2d(vals), dtype=np.float32)
        parts = []
        for (lo, hi), dev in zip(shard_ranges(self.num_docs, len(self.devices)), self.devices):
            local = torch.from_numpy(np.where((ids >= lo) & (ids < hi), ids - lo, -1).astype(np.int32)).to(dev)
            scores = bm25_scatter.bm25_scores(local, torch.from_numpy(v).to(dev), hi - lo)  # drops the -1s
            tv, ti = filter_topk(scores, min(k, hi - lo))
            parts.append((tv, ti + lo))
        tv, ti = merge_global_topk(parts, k, self.num_docs, self.devices[0])
        return tv.cpu().numpy(), ti.cpu().numpy()
