"""Sparse (BM25) index: term dictionary + CSR postings + eager scores, numpy.

A copy of ``easyrag_tpu/index/sparse.py``: that module is numpy-only, but
``easyrag_tpu/index/__init__.py`` imports the JAX dense index, so it cannot
be imported without JAX. The arrays are identical to that module's, from the
Python builder or the native one (``native.py``, which
``build_sparse_index(use_native=None)`` takes when it builds), and the
on-disk artifact (``save_sparse_index`` / ``load_sparse_index``) has the
same format, so an index saved by either package loads in the other.

* term ids in first-appearance order; CSR postings term-major
  (``term_offsets[V+1]``, ``post_docs[P]``, ``post_tfs[P]``), docs ascending
  within a term;
* ``post_vals[P]`` (float64) holds each posting's full BM25 contribution:
  Okapi (``bm25_type=0``, rank_bm25 with the epsilon IDF floor) or lucene
  (``bm25_type=1``, bm25s' default).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class BM25Stats:
    """Raw corpus statistics, independent of the scoring variant."""

    num_docs: int
    doc_lens: np.ndarray  # [N] int32
    avgdl: float
    vocab: Dict[str, int]  # token -> term id
    term_offsets: np.ndarray  # [V+1] int64
    post_docs: np.ndarray  # [P] int32
    post_tfs: np.ndarray  # [P] int32


def build_stats(corpus_tokens: Sequence[Sequence[str]]) -> BM25Stats:
    """Tokenized corpus -> packed statistics."""
    vocab: Dict[str, int] = {}
    doc_lens = np.zeros(len(corpus_tokens), dtype=np.int32)
    term_docs: List[List[int]] = []
    term_tfs: List[List[int]] = []
    for doc_id, tokens in enumerate(corpus_tokens):
        doc_lens[doc_id] = len(tokens)
        counts: Dict[str, int] = {}
        for tok in tokens:
            counts[tok] = counts.get(tok, 0) + 1
        for tok, tf in counts.items():
            tid = vocab.get(tok)
            if tid is None:
                tid = len(vocab)
                vocab[tok] = tid
                term_docs.append([])
                term_tfs.append([])
            term_docs[tid].append(doc_id)
            term_tfs[tid].append(tf)

    sizes = np.array([len(d) for d in term_docs], dtype=np.int64)
    term_offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
    np.cumsum(sizes, out=term_offsets[1:])
    post_docs = np.fromiter(
        (d for docs in term_docs for d in docs), dtype=np.int32, count=int(term_offsets[-1])
    )
    post_tfs = np.fromiter(
        (t for tfs in term_tfs for t in tfs), dtype=np.int32, count=int(term_offsets[-1])
    )
    n = len(corpus_tokens)
    return BM25Stats(
        num_docs=n,
        doc_lens=doc_lens,
        avgdl=float(doc_lens.sum()) / n if n else 0.0,
        vocab=vocab,
        term_offsets=term_offsets,
        post_docs=post_docs,
        post_tfs=post_tfs,
    )


def okapi_idf(stats: BM25Stats, epsilon: float = 0.25) -> np.ndarray:
    """rank_bm25 BM25Okapi IDF with the epsilon floor for negative values."""
    df = np.diff(stats.term_offsets).astype(np.float64)
    idf = np.log(stats.num_docs - df + 0.5) - np.log(df + 0.5)
    if len(idf):
        average_idf = float(idf.sum() / len(idf))
        idf = np.where(idf < 0, epsilon * average_idf, idf)
    return idf


def lucene_idf(stats: BM25Stats) -> np.ndarray:
    """bm25s default (method="lucene"): ln(1 + (N - df + 0.5)/(df + 0.5))."""
    df = np.diff(stats.term_offsets).astype(np.float64)
    return np.log(1.0 + (stats.num_docs - df + 0.5) / (df + 0.5))


def eager_scores(
    stats: BM25Stats,
    bm25_type: int = 0,
    k1: float = 1.5,
    b: float = 0.75,
    epsilon: float = 0.25,
) -> np.ndarray:
    """Per-posting score contribution ``post_vals[P]`` (float64)."""
    norm = k1 * (1.0 - b + b * stats.doc_lens.astype(np.float64) / max(stats.avgdl, 1e-12))
    tf = stats.post_tfs.astype(np.float64)
    denom = tf + norm[stats.post_docs]
    terms = np.repeat(np.arange(len(stats.vocab)), np.diff(stats.term_offsets))
    if bm25_type == 1:
        return lucene_idf(stats)[terms] * tf / denom
    return okapi_idf(stats, epsilon=epsilon)[terms] * tf * (k1 + 1.0) / denom


@dataclass
class SparseIndex:
    """A query-ready sparse index over one content view of the corpus."""

    stats: BM25Stats
    post_vals: np.ndarray  # [P] float64
    bm25_type: int = 0
    k1: float = 1.5
    b: float = 0.75
    epsilon: float = 0.25
    dir_ids: Optional[np.ndarray] = None  # [N] int32 `dir` column
    dir_vocab: Dict[str, int] = field(default_factory=dict)

    @property
    def num_docs(self) -> int:
        return self.stats.num_docs

    @property
    def num_postings(self) -> int:
        return len(self.stats.post_docs)

    def query_term_ids(self, query_tokens: Sequence[str]) -> List[int]:
        """Query tokens -> term ids; unknown tokens dropped, duplicates kept
        (rank_bm25 sums per occurrence)."""
        vocab = self.stats.vocab
        return [vocab[t] for t in query_tokens if t in vocab]

    def gather_postings(
        self,
        term_ids: Sequence[int],
        pad_to: Optional[int] = None,
        bucket: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated posting slices of the query terms as
        ``(doc_ids int32, vals f32)``, padded with the drop sentinel
        ``doc_id == num_docs`` (value 0). ``pad_to`` fixes the length; with
        ``bucket=True`` it is a soft cap and the length is the smallest power
        of two >= max(need, 1024)."""
        offs = self.stats.term_offsets
        chunks_d = [self.stats.post_docs[offs[t]:offs[t + 1]] for t in term_ids]
        chunks_v = [self.post_vals[offs[t]:offs[t + 1]] for t in term_ids]
        if chunks_d:
            doc_ids = np.concatenate(chunks_d)
            vals = np.concatenate(chunks_v).astype(np.float32)
        else:
            doc_ids = np.zeros(0, dtype=np.int32)
            vals = np.zeros(0, dtype=np.float32)
        if pad_to is not None:
            need = len(doc_ids)
            if bucket:
                size = 1024
                while size < need:
                    size *= 2
                pad_to = size
            elif need > pad_to:
                raise ValueError(
                    f"query postings ({need}) exceed pad_to ({pad_to}); "
                    "raise tpu.max_query_postings or pass bucket=True"
                )
            pad = pad_to - need
            doc_ids = np.concatenate([doc_ids, np.full(pad, self.num_docs, dtype=np.int32)])
            vals = np.concatenate([vals, np.zeros(pad, dtype=np.float32)])
        return doc_ids.astype(np.int32), vals

    def get_scores_host(self, query_tokens: Sequence[str]) -> np.ndarray:
        """Exact float64 scores over the full corpus (the oracle)."""
        scores = np.zeros(self.num_docs, dtype=np.float64)
        offs = self.stats.term_offsets
        for tid in self.query_term_ids(query_tokens):
            lo, hi = offs[tid], offs[tid + 1]
            np.add.at(scores, self.stats.post_docs[lo:hi], self.post_vals[lo:hi])
        return scores


def build_sparse_index(
    corpus_tokens: Sequence[Sequence[str]],
    bm25_type: int = 0,
    k1: float = 1.5,
    b: float = 0.75,
    epsilon: float = 0.25,
    dirs: Optional[Sequence[str]] = None,
    use_native: Optional[bool] = None,
) -> SparseIndex:
    """Build the packed index. ``use_native=None`` takes the C++ builder
    when it builds (identical arrays), True requires it (raises when it
    cannot build), False forces the Python builder."""
    stats = vals = None
    if use_native is not False:
        from ..native import build_index_native

        built = build_index_native(corpus_tokens, k1=k1, b=b, epsilon=epsilon, bm25_type=bm25_type)
        if built is not None:
            vocab, doc_lens, term_offsets, post_docs, post_tfs, vals = built
            n = len(corpus_tokens)
            stats = BM25Stats(
                num_docs=n,
                doc_lens=doc_lens,
                avgdl=float(doc_lens.sum()) / n if n else 0.0,
                vocab=vocab,
                term_offsets=term_offsets,
                post_docs=post_docs,
                post_tfs=post_tfs,
            )
        elif use_native:
            raise RuntimeError("native index builder requested but unavailable")
    if stats is None:
        stats = build_stats(corpus_tokens)
        vals = eager_scores(stats, bm25_type=bm25_type, k1=k1, b=b, epsilon=epsilon)
    dir_ids = None
    dir_vocab: Dict[str, int] = {}
    if dirs is not None:
        dir_ids = np.zeros(len(dirs), dtype=np.int32)
        for i, d in enumerate(dirs):
            dir_ids[i] = dir_vocab.setdefault(d, len(dir_vocab))
    return SparseIndex(
        stats=stats,
        post_vals=vals.astype(np.float64),
        bm25_type=bm25_type,
        k1=k1,
        b=b,
        epsilon=epsilon,
        dir_ids=dir_ids,
        dir_vocab=dir_vocab,
    )


# -- on-disk artifact (the format of easyrag_tpu/index/sparse.py:307-355) ------


def save_sparse_index(index: SparseIndex, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(
        os.path.join(path, "sparse_arrays.npz"),
        doc_lens=index.stats.doc_lens,
        term_offsets=index.stats.term_offsets,
        post_docs=index.stats.post_docs,
        post_tfs=index.stats.post_tfs,
        post_vals=index.post_vals,
        dir_ids=index.dir_ids if index.dir_ids is not None else np.zeros(0, np.int32),
    )
    meta = {
        "num_docs": index.stats.num_docs,
        "avgdl": index.stats.avgdl,
        "bm25_type": index.bm25_type,
        "k1": index.k1,
        "b": index.b,
        "epsilon": index.epsilon,
        "vocab": index.stats.vocab,
        "dir_vocab": index.dir_vocab,
        "has_dir_ids": index.dir_ids is not None,
    }
    with open(os.path.join(path, "sparse_meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)


def load_sparse_index(path: str) -> SparseIndex:
    arrays = np.load(os.path.join(path, "sparse_arrays.npz"))
    with open(os.path.join(path, "sparse_meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    stats = BM25Stats(
        num_docs=meta["num_docs"],
        doc_lens=arrays["doc_lens"],
        avgdl=meta["avgdl"],
        vocab={k: int(v) for k, v in meta["vocab"].items()},
        term_offsets=arrays["term_offsets"],
        post_docs=arrays["post_docs"],
        post_tfs=arrays["post_tfs"],
    )
    return SparseIndex(
        stats=stats,
        post_vals=arrays["post_vals"],
        bm25_type=meta["bm25_type"],
        k1=meta["k1"],
        b=meta["b"],
        epsilon=meta["epsilon"],
        dir_ids=arrays["dir_ids"] if meta["has_dir_ids"] else None,
        dir_vocab={k: int(v) for k, v in meta["dir_vocab"].items()},
    )
