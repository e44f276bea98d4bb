"""Device-resident BM25 index (port of ``easyrag_tpu/ops/bm25_resident.py``).

The index lives on the device once; a query uploads only its term ids and
counts. Zipf-aware split, as in the reference:

* **heavy terms** (more than ``light_cap`` postings): their contribution rows
  form a dense ``[H, N]`` matrix, stored in ``float32``, ``bfloat16`` (each
  posting rounded once) or ``int8`` (per-doc-column symmetric scales,
  computed in numpy as the reference does). A query batch's heavy part takes
  one of the reference's two forms, by its rule (the gather when
  ``B*T < H``): the **gather** (the query's rows, widened to f32, weighted by
  the counts and summed over the term slots in slot order) or the **one-hot
  product** ``counts [B, H] @ heavy [H, N]``. The port computes the one-hot
  product as that gather for the float dtypes: on the card neither cuBLAS
  form (``bmm``, ``mm``) gives a row the same bits at another batch size, and
  a batch row must equal the row its query gets alone. For ``int8`` it is the
  exact s8 x s8 -> s32 product (``torch._int_mm``); every int8 heavy sum is
  an integer below 2**24, so both forms give the same bits, scaled once per
  doc column. ``torch._int_mm`` gets the heavy matrix as a doc-major copy
  (``models/layers.py::int8_matmul``'s layout): cuBLASLt refuses the s8
  product of two row-major operands at some shapes (K = 8 at 17 rows on the
  H100). TF32 must be off.
* **light terms**: each term's <= ``light_cap`` postings, as a padded
  term-major ``[V+1, C]`` table (``rows``) or through the CSR arrays with a
  bounded window (``csr``), gathered as ``[B, TL, C]`` (sentinel doc ``N``,
  value 0) and added to the heavy part by the ``tail``: ``"xla"`` (the
  default) adds them into the heavy scores, one ``index_add_`` per term slot
  in slot order (a term's doc ids are unique, so no launch writes one address
  twice and the float atomics never race); ``"pallas"`` sends them, as
  ``[B, TL*C]``, through ``ops/bm25_scatter.py::bm25_scores`` (K5 on the
  card, its plain version on the CPU) and adds ``heavy + tail``, as the
  reference's K5 tail does. The two tails agree up to f32 order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices import resolve_device
from ..index.sparse import SparseIndex
from ..models.layers import int8_matmul
from . import bm25_scatter
from .bm25 import filter_topk

HEAVY_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def check_no_tf32() -> None:
    """BM25's heavy part must run in full f32, like the reference's
    ``Precision.HIGHEST``: with TF32, near-tied scores reorder."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False for BM25 scoring")


def auto_light_cap(
    lens: np.ndarray,
    num_docs: int,
    itemsize: int,
    heavy_hbm_budget: int,
    max_query_terms: int,
    kappa_scale: float = 1.0,
) -> int:
    """The reference's light/heavy split: among the power-of-two caps (>= 8)
    whose ``[H, N]`` heavy matrix of ``itemsize``-byte entries fits
    ``heavy_hbm_budget``, the one of least cost, where a cap's cost weighs
    the heavy matrix's bytes against ``cap**2`` light-tail work; the walk
    stops once a cap costs twice the best. ``num_docs`` (every term light)
    when no cap fits. The two weights are the reference's, copied so that the
    port splits (and so, with ``bfloat16`` or ``int8`` storage, rounds) the
    same postings as the reference."""
    bytes_weight = 1.0 / 899e6
    kappa = 1.48e-7 * kappa_scale
    stream_b = 64  # the stream's batch rows
    best_cost, cap = None, None
    c = 8
    while c < max(num_docs, 16):
        n_heavy = int((lens > c).sum())
        if n_heavy * num_docs * itemsize <= heavy_hbm_budget:
            cost = n_heavy * num_docs * itemsize * bytes_weight + kappa * stream_b * max_query_terms * c * c
            if best_cost is None or cost < best_cost:
                best_cost, cap = cost, c
            elif cost > 2 * best_cost:
                break
        c *= 2
    return cap if cap is not None else num_docs


def quantize_heavy_int8(heavy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(q int8 [H, N], scales f32 [N])``: per-doc-column symmetric scales
    ``col_max / 127`` (1.0 for an empty column) and ``rint(heavy / scale)``,
    in numpy as the reference computes them."""
    col_max = np.abs(heavy).max(axis=0) if heavy.size else np.zeros(heavy.shape[1], np.float32)
    scales = np.where(col_max > 0, col_max / 127.0, 1.0).astype(np.float32)
    q = np.empty(heavy.shape, np.int8)
    for lo in range(0, heavy.shape[0], 1024):  # row blocks bound the f32 temporaries
        q[lo : lo + 1024] = np.rint(heavy[lo : lo + 1024] / scales[None, :])
    return q, scales


class ResidentSparseIndex:
    def __init__(
        self,
        index: SparseIndex,
        light_cap: Optional[int] = None,
        max_query_terms: int = 64,
        heavy_hbm_budget: int = 512 * 1024 * 1024,
        heavy_dtype: str = "float32",
        tail: Optional[str] = None,
        light_rows: Optional[bool] = None,
        light_rows_hbm_budget: int = 256 * 1024 * 1024,
        device: torch.device | str = "cuda",
    ) -> None:
        """``heavy_dtype``: ``float32`` (exact), ``bfloat16`` or ``int8``.
        ``tail``: ``"xla"`` (None) or ``"pallas"`` (K5; ``"pallas_interpret"``,
        the reference's CPU spelling, is the same route). ``light_rows``
        forces the light layout (None: ``rows`` when its ``(V+1)*C*8``-byte
        table fits ``light_rows_hbm_budget``). Without ``light_cap`` the cap
        is the reference's: picked for the ``rows`` layout, and picked again
        for ``csr`` when that cap's table does not fit. ``device`` is the card
        unless the caller asks for the CPU."""
        if heavy_dtype not in HEAVY_ITEMSIZE:
            raise ValueError(f"unsupported heavy_dtype {heavy_dtype!r}")
        if tail not in (None, "xla", "pallas", "pallas_interpret"):
            raise ValueError(f"unsupported tail {tail!r}")
        self.tail = "pallas" if tail in ("pallas", "pallas_interpret") else "xla"
        self.device = resolve_device(device)
        self.host_index = index
        self.num_docs = N = index.num_docs
        self.max_query_terms = max_query_terms
        self.heavy_dtype = heavy_dtype

        offs = index.stats.term_offsets
        lens = np.diff(offs).astype(np.int64)
        V = len(lens)
        if light_cap is None:
            itemsize = HEAVY_ITEMSIZE[heavy_dtype]
            light_cap = auto_light_cap(lens, N, itemsize, heavy_hbm_budget, max_query_terms, kappa_scale=0.5)
            if light_rows is False or (V + 1) * light_cap * 8 > light_rows_hbm_budget:
                light_cap = auto_light_cap(lens, N, itemsize, heavy_hbm_budget, max_query_terms)
        self.light_cap = C = light_cap
        heavy_terms = np.where(lens > C)[0]
        H = ((max(len(heavy_terms), 1) + 7) // 8) * 8

        heavy = np.zeros((H, N), dtype=np.float32)
        heavy_row = np.full(V + 1, -1, dtype=np.int64)  # +1: the pad term
        for row, t in enumerate(heavy_terms):
            lo, hi = offs[t], offs[t + 1]
            heavy[row, index.stats.post_docs[lo:hi]] = index.post_vals[lo:hi]
            heavy_row[t] = row
        starts = np.zeros(V + 1, dtype=np.int64)
        starts[:V] = offs[:-1]
        light_lens = np.zeros(V + 1, dtype=np.int64)
        light_lens[:V] = lens
        light_lens[heavy_terms] = 0
        P = len(index.stats.post_docs)
        # one sentinel slot at the end: doc id N, value 0
        post_docs = np.append(index.stats.post_docs.astype(np.int64), N)
        post_vals = np.append(index.post_vals.astype(np.float32), np.float32(0))

        self.V, self.P = V, P
        self._host_light_lens = light_lens
        if light_rows is None:
            light_rows = (V + 1) * C * 8 <= light_rows_hbm_budget
        self.light_layout = "rows" if light_rows else "csr"
        if light_rows:
            win = np.arange(C, dtype=np.int64)[None, :]
            pos = np.where(win < light_lens[:, None], starts[:, None] + win, P)
            post_docs, post_vals = post_docs[pos], post_vals[pos]

        dev = self.device
        self.heavy_scales = None
        if heavy_dtype == "int8":
            q, scales = quantize_heavy_int8(heavy)
            del heavy
            self.heavy = torch.from_numpy(q).to(dev)
            self.heavy_scales = torch.from_numpy(scales).to(dev)
        elif heavy_dtype == "bfloat16":
            self.heavy = torch.from_numpy(heavy).to(torch.bfloat16).to(dev)
        else:
            self.heavy = torch.from_numpy(heavy).to(dev)
        self.t_heavy_row = torch.from_numpy(heavy_row).to(dev)
        self.t_starts = torch.from_numpy(starts).to(dev)
        self.t_light_lens = torch.from_numpy(light_lens).to(dev)
        self.post_docs = torch.from_numpy(post_docs).to(dev)
        self.post_vals = torch.from_numpy(post_vals).to(dev)
        self.dir_col = (
            torch.from_numpy(index.dir_ids.astype(np.int32)).to(dev)
            if index.dir_ids is not None
            else None
        )
        self.dir_vocab = index.dir_vocab

    # -- host-side query prep -------------------------------------------------

    def query_terms(self, query_tokens: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Tokens -> ``(term_ids[T], counts[T])``, padded with the sentinel
        term ``V``, light terms first. Duplicate tokens become counts. Raises
        ``ValueError`` past ``max_query_terms`` distinct terms. The row is
        :meth:`query_terms_batch`'s for this query: the slot order fixes the
        order each doc's terms are added in, so a query scores to the same
        bits alone and in a batch."""
        ids, cnt = self.query_terms_batch([query_tokens])
        return ids[0], cnt[0]

    def query_terms_batch(self, queries_tokens: Sequence[Sequence[str]]) -> Tuple[np.ndarray, np.ndarray]:
        """Many queries at once: ``(ids[Q, T], counts[Q, T])``, each row's
        terms by ascending id, then light terms first (a stable sort)."""
        vocab = self.host_index.stats.vocab
        Q, T, V = len(queries_tokens), self.max_query_terms, self.V
        qidx: List[int] = []
        tids: List[int] = []
        for i, toks in enumerate(queries_tokens):
            for tok in toks:
                tid = vocab.get(tok)
                if tid is not None:
                    qidx.append(i)
                    tids.append(tid)
        ids = np.full((Q, T), V, dtype=np.int64)
        cnt = np.zeros((Q, T), dtype=np.float32)
        if qidx:
            key = np.asarray(qidx, np.int64) * (V + 1) + np.asarray(tids, np.int64)
            uniq, counts = np.unique(key, return_counts=True)
            rows = uniq // (V + 1)
            terms = uniq % (V + 1)
            pos = np.arange(len(rows)) - np.searchsorted(rows, np.arange(Q))[rows]
            if int(pos.max()) >= T:
                bad = int(rows[int(pos.argmax())])
                raise ValueError(
                    f"query has {int((rows == bad).sum())} distinct terms > max_query_terms={T}"
                )
            ids[rows, pos] = terms
            cnt[rows, pos] = counts
            order = np.argsort(self._host_light_lens[ids] == 0, axis=1, kind="stable")
            ids = np.take_along_axis(ids, order, axis=1)
            cnt = np.take_along_axis(cnt, order, axis=1)
        return ids, cnt

    def light_t_bound(self, ids: np.ndarray) -> int:
        """How many leading term slots hold light terms in any row (the
        light scatter's slot count)."""
        cols = (self._host_light_lens[np.asarray(ids).reshape(-1, ids.shape[-1])] > 0).any(axis=0)
        return int(np.nonzero(cols)[0].max()) + 1 if cols.any() else 0

    # -- device scoring ---------------------------------------------------------

    def heavy_part(self, term_ids: torch.Tensor, counts: torch.Tensor, form: str = "auto") -> torch.Tensor:
        """The heavy terms' f32 scores ``[B, N]`` of a prepped batch.
        ``form``: ``"auto"`` (the reference's rule: the gather when
        ``B*T < H``), ``"gather"`` or ``"onehot"``; see the module doc."""
        B, T = term_ids.shape
        H = self.heavy.shape[0]
        hrow = self.t_heavy_row[term_ids]
        is_heavy = hrow >= 0
        onehot = B * T >= H if form == "auto" else form == "onehot"
        if onehot and self.heavy_dtype == "int8":
            # counts <= 127 are exact in s8 (clipped as the reference does)
            a = torch.zeros(B, H + 1, dtype=torch.float32, device=self.device)
            a.index_put_((torch.arange(B, device=self.device)[:, None].expand(B, T), torch.where(is_heavy, hrow, H)),
                         torch.where(is_heavy, counts, 0.0), accumulate=True)
            a8 = a[:, :H].clamp(0, 127).to(torch.int8)
            return int8_matmul(a8, self.heavy.t().contiguous()).float() * self.heavy_scales
        w = torch.where(is_heavy, counts, 0.0)
        g = self.heavy[torch.where(is_heavy, hrow, 0)].float()  # [B, T, N]
        scores = (w[:, :, None] * g).sum(1)
        return scores * self.heavy_scales if self.heavy_scales is not None else scores

    def light_postings(self, term_ids: torch.Tensor, counts: torch.Tensor, light_t: int):
        """The first ``light_t`` term slots' light postings ``(docs [B, TL,
        C], vals [B, TL, C])``, the values weighted by the counts; a pad or
        heavy slot gathers the sentinel (doc ``N``, value 0)."""
        lt_ids, lt_counts = term_ids[:, :light_t], counts[:, :light_t]
        if self.light_layout == "rows":
            return self.post_docs[lt_ids], self.post_vals[lt_ids] * lt_counts[:, :, None]
        win = torch.arange(self.light_cap, device=self.device)
        valid = win < self.t_light_lens[lt_ids][:, :, None]
        pos = torch.where(valid, self.t_starts[lt_ids][:, :, None] + win, self.P)
        return self.post_docs[pos], self.post_vals[pos] * lt_counts[:, :, None]

    def _score_topk(
        self,
        term_ids: torch.Tensor,  # [B, T] int64
        counts: torch.Tensor,  # [B, T] f32
        k: int,
        dir_filter: Optional[torch.Tensor] = None,  # [B] int32
        light_t: Optional[int] = None,
        heavy_form: str = "auto",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scores + filter + top-k for one batch of prepped queries; a row's
        scores have the same bits at any batch size."""
        if self.device.type == "cuda":
            check_no_tf32()
        B, T = term_ids.shape
        N = self.num_docs
        scores = self.heavy_part(term_ids, counts, heavy_form)
        TL = T if light_t is None else light_t
        docs, vals = self.light_postings(term_ids, counts, TL)
        if self.tail == "pallas":
            if TL:  # no light slot: the tail adds nothing
                scores = scores + bm25_scatter.bm25_scores(
                    docs.reshape(B, -1).to(torch.int32), vals.reshape(B, -1).contiguous(), N
                )
        else:
            # flat scatter into [B*N + 1]; sentinel docs route to the last slot
            flat = torch.cat([scores.reshape(-1), scores.new_zeros(1)])
            b_off = torch.arange(B, device=self.device)[:, None] * N
            for t in range(TL):
                d = docs[:, t, :]
                flat.index_add_(0, torch.where(d < N, b_off + d, B * N).reshape(-1), vals[:, t, :].reshape(-1))
            scores = flat[: B * N].reshape(B, N)
        return filter_topk(scores, k, self.dir_col, dir_filter)

    def _upload(self, ids: np.ndarray, cnts: np.ndarray):
        return torch.from_numpy(ids).to(self.device), torch.from_numpy(cnts).to(self.device)

    def _dir_ints(self, dir_values: Optional[Sequence[Optional[str]]]) -> Optional[np.ndarray]:
        """Dir names -> filter ints (-1: no filter; -2: a dir the index does
        not know, which matches nothing); None without names or dir column."""
        if dir_values is None or self.dir_col is None:
            return None
        return np.asarray([self.dir_vocab.get(d, -2) if d else -1 for d in dir_values], dtype=np.int32)

    def score_topk(
        self,
        queries_tokens: Sequence[Sequence[str]],
        k: int,
        dir_values: Optional[Sequence[Optional[str]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched query -> ``(scores[B, k], doc indices[B, k])`` host arrays;
        dropped entries are ``(-inf, num_docs)``."""
        ids, cnts = self.query_terms_batch(queries_tokens)
        dir_f = self._dir_ints(dir_values)
        dir_t = None if dir_f is None else torch.from_numpy(dir_f).to(self.device)
        tv, ti = self._score_topk(*self._upload(ids, cnts), k, dir_t, self.light_t_bound(ids))
        return tv.cpu().numpy(), ti.cpu().numpy()

    def stream_from_arrays(
        self, ids: np.ndarray, cnts: np.ndarray, dir_f: Optional[np.ndarray], k: int, batch: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """A prepped query stream (``ids[Q, T]``, ``cnts[Q, T]``, filter ints
        ``dir_f[Q]`` or None) scored in batches of ``batch`` rows, one upload
        and one bulk copy back: ``(scores[Q, k], indices[Q, k])`` host
        arrays. JAX scans fixed batches in one dispatch and pads the tail;
        here the batches are a loop and the tail runs at its own size."""
        dev = self.device
        t_ids, t_cnts = self._upload(ids, cnts)
        t_dir = None if dir_f is None else torch.from_numpy(np.asarray(dir_f, np.int32)).to(dev)
        light_t = self.light_t_bound(ids) if len(ids) else 0
        parts = [
            self._score_topk(t_ids[lo : lo + batch], t_cnts[lo : lo + batch], k,
                             None if t_dir is None else t_dir[lo : lo + batch], light_t)
            for lo in range(0, len(ids), batch)
        ]
        if not parts:
            kk = min(k, self.num_docs)
            return np.zeros((0, kk), np.float32), np.zeros((0, kk), np.int64)
        return torch.cat([v for v, _ in parts]).cpu().numpy(), torch.cat([i for _, i in parts]).cpu().numpy()

    def stream_score_topk(
        self,
        queries_tokens: Sequence[Sequence[str]],
        k: int,
        batch: int = 64,
        dir_values: Optional[Sequence[Optional[str]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """A whole query stream in batches of ``batch`` (the reference's
        scan over batches): ``(scores[Q, k], indices[Q, k])``."""
        ids, cnts = self.query_terms_batch(queries_tokens)
        return self.stream_from_arrays(ids, cnts, self._dir_ints(dir_values), k, batch=batch)


class DualResidentScorer:
    """Both routes of the default retrieval (content with the dir filter,
    know-path without) scored for one query batch."""

    def __init__(self, content: ResidentSparseIndex, path: ResidentSparseIndex):
        if content.num_docs != path.num_docs:
            raise ValueError("dual routes must index the same node list")
        self.content = content
        self.path = path

    def score_topk(self, query_tokens_batch, k_content: int, k_path: int, dir_fs):
        """Tokenized queries -> ``((tv1, ti1), (tv2, ti2))`` host arrays.
        ``dir_fs``: per-row filter ints (-1 none, -2 never-match)."""
        c, p = self.content, self.path
        ids1, cnt1 = c.query_terms_batch(query_tokens_batch)
        ids2, cnt2 = p.query_terms_batch(query_tokens_batch)
        dir_f = torch.from_numpy(np.asarray(dir_fs, dtype=np.int32)).to(c.device)
        tv1, ti1 = c._score_topk(*c._upload(ids1, cnt1), k_content, dir_f, c.light_t_bound(ids1))
        tv2, ti2 = p._score_topk(*p._upload(ids2, cnt2), k_path, None, p.light_t_bound(ids2))
        return (tv1.cpu().numpy(), ti1.cpu().numpy()), (tv2.cpu().numpy(), ti2.cpu().numpy())

    def stream_from_arrays(self, ids1, cnt1, ids2, cnt2, dir_fs, k_content: int, k_path: int, batch: int = 64):
        """Both routes of a prepped query stream in batches of ``batch``
        (``pipeline._dual_retrieve_stream`` keeps the arrays of its overflow
        check rather than prepping twice): ``((tv1, ti1), (tv2, ti2))``
        host arrays, one row per query."""
        return (
            self.content.stream_from_arrays(ids1, cnt1, np.asarray(dir_fs, np.int32), k_content, batch=batch),
            self.path.stream_from_arrays(ids2, cnt2, None, k_path, batch=batch),
        )

    def stream_score_topk(self, query_tokens_batch, k_content: int, k_path: int, dir_fs, batch: int = 64):
        """:meth:`score_topk` over a whole query stream in batches."""
        return self.stream_from_arrays(
            *self.content.query_terms_batch(query_tokens_batch), *self.path.query_terms_batch(query_tokens_batch),
            dir_fs, k_content, k_path, batch=batch,
        )
