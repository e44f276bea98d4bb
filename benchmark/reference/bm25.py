"""Plain NumPy reference of the pipeline's sparse dual route and its fusion.

Okapi BM25 as rank_bm25's ``BM25Okapi`` computes it (k1 1.5, b 0.75, the
IDF ``ln(N - df + 0.5) - ln(df + 0.5)`` with negative values floored to
``0.25 *`` the mean IDF over the vocabulary; a query term counts once per
occurrence), in float64, over two views of each file of the corpus:

* content: ``"###\\n" + know_path + "\\n\\n" + text`` (the know path joined
  with ``/``), with a filter on the file's product dir;
* path: the know path alone, unfiltered.

Tokens are the benchmark's sparse tokenizer's. A doc is a candidate of a
route when its score is above 0. The fusion keeps the content route's top
``k_content``, then the path route's top ``k_path`` whose doc is not in it,
sorted by score.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizers import SparseTokenizer

K1, B, EPS = 1.5, 0.75, 0.25


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` as float32 rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


class BM25View:
    """One view: per-term postings (docs, BM25 contribution), float64; with
    ``precision="tf32"`` (the control) the contributions are rounded to TF32
    and a query's sums are taken in float32."""

    def __init__(self, docs_tokens: Sequence[Sequence[str]], precision: str = "float64") -> None:
        self.precision = precision
        self.n = len(docs_tokens)
        vocab: Dict[str, int] = {}
        doc_of, term_of = [], []
        lens = np.zeros(self.n, np.float64)
        for d, toks in enumerate(docs_tokens):
            lens[d] = len(toks)
            ids = [vocab.setdefault(t, len(vocab)) for t in toks]
            term_of.extend(ids)
            doc_of.extend([d] * len(ids))
        self.vocab = vocab
        key = np.asarray(term_of, np.int64) * self.n + np.asarray(doc_of, np.int64)
        key, tf = np.unique(key, return_counts=True)  # sorted by term, then doc
        terms, docs = key // self.n, key % self.n
        df = np.bincount(terms, minlength=len(vocab)).astype(np.float64)
        idf = np.log(self.n - df + 0.5) - np.log(df + 0.5)
        idf = np.where(idf < 0, EPS * idf.mean(), idf)
        norm = K1 * (1.0 - B + B * lens / lens.mean())
        tf = tf.astype(np.float64)
        self.vals = idf[terms] * tf * (K1 + 1.0) / (tf + norm[docs])
        self.docs = docs
        self.offsets = np.searchsorted(terms, np.arange(len(vocab) + 1))

    def scores(self, tokens: Sequence[str]) -> np.ndarray:
        """``[N]`` float64 scores of one query."""
        tids = [self.vocab[t] for t in tokens if t in self.vocab]
        if not tids:
            return np.zeros(self.n, np.float64)
        sl = np.concatenate([np.arange(self.offsets[i], self.offsets[i + 1]) for i in tids])
        if self.precision == "tf32":
            out = np.zeros(self.n, np.float32)
            np.add.at(out, self.docs[sl], tf32(self.vals[sl]))
            return out.astype(np.float64)
        return np.bincount(self.docs[sl], weights=self.vals[sl], minlength=self.n)


def top(scores: np.ndarray, k: int, allowed: Optional[np.ndarray] = None,
        tie: Optional[np.ndarray] = None) -> List[Tuple[int, float]]:
    """Docs with a score above 0 (and ``allowed``), best first, at most
    ``k``; among equal scores the lower ``tie`` first, then the lower doc."""
    s = np.where(scores > 0, scores, 0.0) if allowed is None else np.where(allowed & (scores > 0), scores, 0.0)
    order = np.lexsort((np.zeros(len(s)) if tie is None else tie, -s))[:k]
    return [(int(d), float(s[d])) for d in order if s[d] > 0]


class DualRouteReference:
    """The dual route over a corpus given as, per doc, its know path, its
    product dir and its text."""

    def __init__(self, know_paths: Sequence[str], dirs: Sequence[str], texts: Sequence[str],
                 precision: str = "float64") -> None:
        tk = SparseTokenizer()
        self.dirs = np.asarray(dirs)
        self.content = BM25View([tk.cut(f"###\n{kp}\n\n{t}") for kp, t in zip(know_paths, texts)], precision)
        self.path = BM25View([tk.cut(kp) for kp in know_paths], precision)

    def routes(self, query: str, dir_filter: Optional[str]):
        """``(content scores [N], path scores [N], allowed [N] or None)``."""
        toks = SparseTokenizer().cut(query)
        allowed = None if dir_filter is None else self.dirs == dir_filter
        return self.content.scores(toks), self.path.scores(toks), allowed

    def fused(self, query: str, dir_filter: Optional[str], k_content: int, k_path: int,
              prefer: Sequence[int] = ()) -> List[Tuple[int, float]]:
        """The fused candidates ``(doc, score)``, best first. A route's top is
        defined up to equal scores; among those the ``prefer`` docs (the
        program's candidates, when judging them) are taken first; in the path
        route, those the content route took come next, before the rest. That
        decides what the fusion drops as seen in both routes."""
        c, p, allowed = self.routes(query, dir_filter)
        tie = np.ones(len(c))
        tie[list(prefer)] = 0.0
        content = top(c, k_content, allowed, tie)
        seen = [d for d, _ in content]
        # the path route: the preferred docs the content route left, then
        # those it took (the fusion drops them), then the rest
        tie = 2.0 * tie
        tie[seen] = 1.0
        out = content + [(d, s) for d, s in top(p, k_path, None, tie) if d not in set(seen)]
        return sorted(out, key=lambda x: -x[1])
