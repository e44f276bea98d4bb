"""Pipeline-facing rerankers.

``LLMRerank`` drives a pair-scoring model (the port's MiniCPM layerwise
and Gemma token-compress scorers) over the fused candidate list in batches
of ``embed_bs``, replicating ``src/easyrag/custom/rerankers.py:298-376``:

* pairs are ``(query, get_node_content(node, r_embed_type))``
* the first batch may run the early-exit *judge* protocol; with
  ``use_efficient=1`` the discovered layer is reused for remaining batches
  (``rerankers.py:311-314,343-345``); with ``use_efficient=2`` every batch
  judges independently
* ``use_efficient=3`` is an extension with no reference
  counterpart: a two-stage cascade that scores EVERY pair at the judge
  layer (the shallow score head the layerwise checkpoint already trains)
  and re-scores only the top ``cascade_keep`` at full depth — ~(j/cutoff
  + keep/n) of the full-depth work with full-depth ordering of the
  survivors. Opt-in: the final top-``top_n`` can differ from full-depth
  reranking iff a true top-n pair ranks below ``cascade_keep`` at the
  judge layer (tune ``tpu.cascade_keep``; validate on real weights).
  With ``cascade_carry`` and a scorer that has ``score_pairs_carry``,
  stage 2 resumes from stage 1's hidden states at the judge layer
* the retrieval score is preserved in ``metadata["retrieval_score"]``
* final ordering: ``sorted(key=-score if score else 0)[:top_n]``
  (``rerankers.py:371-373``; note falsy scores sort as 0, replicated)

``SentenceTransformerRerank`` wraps a CrossEncoder (max_length 512,
``rerankers.py:12,15-99``) via sentence-transformers (``use_reranker=1``).
"""

from __future__ import annotations

from typing import List, Optional

from .corpus.views import get_node_content
from .schema import NodeWithScore, QueryBundle
from .utils.events import emit

#: smallest compiled tail-batch shape. Tail batches pad to the smallest
#: halving of ``embed_bs`` >= this that fits, instead of the full batch:
#: a 198-pair fused set at bs 32 runs 6x32 + 1x8 rather than 7x32 — ~10%
#: of the rerank compute back for two extra compile-cache entries.
TAIL_BUCKET_MIN = 8


def tail_bucket(n_real: int, bsz: int, min_bucket: int = TAIL_BUCKET_MIN) -> int:
    """Smallest halving of ``bsz`` (>= ``min_bucket``) holding ``n_real``."""
    b = bsz
    while b // 2 >= max(n_real, min_bucket):
        b //= 2
    return b


class LLMRerank:
    def __init__(
        self,
        scorer,
        top_n: int = 2,
        embed_bs: int = 64,
        embed_type: int = 0,
        use_efficient: int = 0,
        keep_retrieval_score: bool = True,
        cascade_keep: int = 32,
        cascade_carry: bool = False,
    ) -> None:
        self.scorer = scorer
        self.top_n = top_n
        self.embed_bs = embed_bs
        self.embed_type = embed_type
        self.use_efficient = use_efficient
        self.keep_retrieval_score = keep_retrieval_score
        self.cascade_keep = cascade_keep
        self.cascade_carry = cascade_carry

    def postprocess_nodes(
        self,
        nodes: List[NodeWithScore],
        query_bundle: Optional[QueryBundle] = None,
    ) -> List[NodeWithScore]:
        if query_bundle is None:
            raise ValueError("Missing query bundle in extra info.")
        if len(nodes) == 0:
            return []
        query = query_bundle.query_str
        n = len(nodes)
        bsz = self.embed_bs
        saved_cutoff = getattr(self.scorer, "cutoff_layer", None)
        try:
            return self._postprocess_inner(nodes, query, n, bsz)
        finally:
            # don't leak a stage/exit cutoff across queries, even when a
            # batch raises mid-protocol (for the plain scorer the attribute
            # is process-global; for the coalescer it's this thread's view)
            if saved_cutoff is not None:
                self.scorer.cutoff_layer = saved_cutoff

    def _postprocess_inner(
        self, nodes: List[NodeWithScore], query: str, n: int, bsz: int
    ) -> List[NodeWithScore]:
        if self.use_efficient == 3:
            scores = self._score_cascade(nodes, query)
            for node, score in zip(nodes, scores):
                if self.keep_retrieval_score:
                    node.node.metadata["retrieval_score"] = node.score
                node.score = float(score)
            return sorted(nodes, key=lambda x: -x.score if x.score else 0)[
                : self.top_n
            ]
        if getattr(self.scorer, "coalesce", False) and self.use_efficient != 2:
            # coalescing scorer (serving): hand over un-chunked pair lists so
            # tails can fuse with other requests' pairs into full batches.
            # use_efficient=2 judges every batch -> nothing to coalesce.
            scores = self._score_coalesced(nodes, query)
            for node, score in zip(nodes, scores):
                if self.keep_retrieval_score:
                    node.node.metadata["retrieval_score"] = node.score
                node.score = float(score)
            return sorted(nodes, key=lambda x: -x.score if x.score else 0)[
                : self.top_n
            ]
        for lo in range(0, n, bsz):
            cur = nodes[lo : lo + bsz]
            pairs = [
                (query, get_node_content(node.node, self.embed_type)) for node in cur
            ]
            n_real = len(pairs)
            judge = self.use_efficient != 0 and (
                lo == 0 or self.use_efficient == 2
            )
            # pad tail batches to a bounded compile bucket (duplicate last
            # pair, scores sliced off) so batches hit a small set of
            # compiled shapes. Judge batches stay unpadded: the early-exit
            # criterion softmaxes over the batch's scores and duplicates
            # would perturb it.
            if n_real < bsz and not judge:
                pairs = pairs + [pairs[-1]] * (tail_bucket(n_real, bsz) - n_real)
            emit(
                "reranking",
                {"batch": lo // bsz, "pairs": n_real, "judge": judge},
            )
            scores, layer_used = self.scorer.score_pairs(pairs, judge=judge)
            scores = scores[:n_real]
            if lo == 0 and self.use_efficient == 1:
                # reuse the discovered exit layer for the remaining batches
                self.scorer.cutoff_layer = layer_used
            for node, score in zip(cur, scores):
                if self.keep_retrieval_score:
                    node.node.metadata["retrieval_score"] = node.score
                node.score = float(score)
        new_nodes = sorted(nodes, key=lambda x: -x.score if x.score else 0)[
            : self.top_n
        ]
        return new_nodes

    def _judge_layer(self) -> int:
        """The shallow score layer for cascade stage 1: the scorer's first
        early-exit judge layer (MiniCPM layerwise trains a head there), or
        12 for scorers that don't declare one."""
        s = self.scorer
        layers = getattr(s, "efficient_layers", None)
        if not layers and hasattr(s, "scorer"):  # CoalescingScorer proxy
            layers = getattr(s.scorer, "efficient_layers", None)
        return layers[0] if layers else 12

    def _score_at_cutoff(self, pairs, cutoff: int, stage: str):
        """Score ``pairs`` (judge=False) at ``cutoff`` — chunked with
        tail-bucket padding for plain scorers, one fused call for a
        coalescing scorer (which chunks/pads internally per its warm-shape
        policy)."""
        import numpy as np

        self.scorer.cutoff_layer = cutoff
        if getattr(self.scorer, "coalesce", False):
            emit("reranking", {"stage": stage, "pairs": len(pairs), "judge": False})
            scores, _ = self.scorer.score_pairs(pairs, judge=False)
            return np.asarray(scores, np.float32)[: len(pairs)]
        out: List[float] = []
        bsz = self.embed_bs
        for lo in range(0, len(pairs), bsz):
            chunk = pairs[lo : lo + bsz]
            n_real = len(chunk)
            if n_real < bsz:
                chunk = chunk + [chunk[-1]] * (tail_bucket(n_real, bsz) - n_real)
            emit(
                "reranking",
                {"stage": stage, "batch": lo // bsz, "pairs": n_real,
                 "judge": False},
            )
            scores, _ = self.scorer.score_pairs(chunk, judge=False)
            out.extend(float(s) for s in np.asarray(scores)[:n_real])
        return np.asarray(out, np.float32)

    def _score_cascade(self, nodes: List[NodeWithScore], query: str):
        """Two-stage cascade (``use_efficient=3``, an extension —
        see the module docstring): judge-layer scores for all pairs pick
        ``cascade_keep`` survivors; only those re-run at full depth.

        Final ordering: survivors by their full-depth scores, everything
        else below them in stage-1 order (shifted strictly under the
        lowest survivor so ``top_n`` can never reach past the cascade).
        """
        import numpy as np

        pairs = [
            (query, get_node_content(node.node, self.embed_type)) for node in nodes
        ]
        full_cutoff = self.scorer.cutoff_layer
        j = min(self._judge_layer(), full_cutoff)
        carry_ok = (
            self.cascade_carry
            and j < full_cutoff
            and not getattr(self.scorer, "coalesce", False)
            and hasattr(self.scorer, "score_pairs_carry")
        )
        keep_n = min(max(self.cascade_keep, self.top_n), len(pairs))
        if not carry_ok:
            s1 = self._score_at_cutoff(pairs, j, "cascade-1")
            survivors = np.argsort(-s1, kind="stable")[:keep_n]
            s2 = self._score_at_cutoff([pairs[i] for i in survivors], full_cutoff, "cascade-2")
        else:
            s1, survivors, s2 = self._cascade_carried(pairs, j, full_cutoff, keep_n)
        final = s1 + (float(min(s2.min(), s1.min())) - 1.0 - float(s1.max()))
        final[survivors] = s2
        return final

    def _cascade_carried(self, pairs, j: int, full_cutoff: int, keep_n: int):
        """Carry variant (``tpu.cascade_carry``): stage 1 keeps each chunk's
        post-layer-``j`` hidden states on the device; stage 2 gathers the
        survivors' rows (one indexing op) and resumes at layer ``j`` instead
        of re-running layers ``[0, j)``, saving ``keep x j`` layer-batches
        per query. Scores equal the re-run path's to rounding (the scorer's
        ``score_carried`` RoPE note)."""
        import numpy as np

        self.scorer.cutoff_layer = j
        bsz = self.embed_bs
        s1_parts, hiddens, masks, row_base = [], [], [], []
        base = 0
        for lo in range(0, len(pairs), bsz):
            chunk = pairs[lo : lo + bsz]
            n_real = len(chunk)
            if n_real < bsz:
                chunk = chunk + [chunk[-1]] * (tail_bucket(n_real, bsz) - n_real)
            emit("reranking", {"stage": "cascade-1", "batch": lo // bsz, "pairs": n_real, "judge": False})
            sc, carry = self.scorer.score_pairs_carry(chunk)
            s1_parts.append(np.asarray(sc)[:n_real])
            hiddens.append(carry["hidden"])
            masks.append(carry["mask"])
            row_base.append(base)
            base += carry["hidden"].shape[0]
        s1 = np.concatenate(s1_parts).astype(np.float32)
        survivors = np.argsort(-s1, kind="stable")[:keep_n]

        self.scorer.cutoff_layer = full_cutoff
        s_max = max(h.shape[1] for h in hiddens)
        pad_left = getattr(self.scorer, "padding_side", "left") != "right"
        s2_parts = []
        for lo in range(0, len(survivors), bsz):
            sel = survivors[lo : lo + bsz]
            n_real = len(sel)
            nb = tail_bucket(n_real, bsz) if n_real < bsz else bsz
            sel_padded = np.concatenate([sel, np.full(nb - n_real, sel[-1])])
            flat_idx = np.array([row_base[g // bsz] + g % bsz for g in sel_padded], np.int64)
            mask_rows = np.zeros((nb, s_max), np.int32)
            for out_i, g in enumerate(sel_padded):
                m = masks[g // bsz][g % bsz]
                if pad_left:
                    mask_rows[out_i, s_max - len(m):] = m
                else:
                    mask_rows[out_i, : len(m)] = m
            emit("reranking", {"stage": "cascade-2-carried", "batch": lo // bsz, "pairs": n_real, "judge": False})
            sc = self.scorer.score_carried(hiddens, flat_idx, mask_rows, j)
            s2_parts.append(np.asarray(sc)[:n_real])
        return s1, survivors, np.concatenate(s2_parts).astype(np.float32)

    def _score_coalesced(self, nodes: List[NodeWithScore], query: str):
        """Score through a coalescing scorer: judge protocol (if any) on the
        first ``embed_bs`` pairs exactly as the legacy loop, then ALL
        remaining pairs in one call — the scorer chunks/pads them, fusing
        with concurrent requests."""
        pairs = [
            (query, get_node_content(node.node, self.embed_type)) for node in nodes
        ]
        out: List[float] = []
        start = 0
        if self.use_efficient == 1:
            first = pairs[: self.embed_bs]
            emit("reranking", {"batch": 0, "pairs": len(first), "judge": True})
            scores, layer_used = self.scorer.score_pairs(first, judge=True)
            self.scorer.cutoff_layer = layer_used
            out.extend(float(s) for s in scores[: len(first)])
            start = len(first)
        rest = pairs[start:]
        if rest:
            emit(
                "reranking",
                {"batch": 1 if start else 0, "pairs": len(rest), "judge": False},
            )
            scores, _ = self.scorer.score_pairs(rest, judge=False)
            out.extend(float(s) for s in scores[: len(rest)])
        return out


class SentenceTransformerRerank:
    """CrossEncoder rerank (``use_reranker=1``)."""

    def __init__(
        self,
        top_n: int = 2,
        model: str = "cross-encoder/stsb-distilroberta-base",
        keep_retrieval_score: bool = False,
        max_length: int = 512,
    ) -> None:
        from sentence_transformers import CrossEncoder

        self._model = CrossEncoder(model, max_length=max_length, trust_remote_code=True)
        self.top_n = top_n
        self.keep_retrieval_score = keep_retrieval_score

    def postprocess_nodes(
        self,
        nodes: List[NodeWithScore],
        query_bundle: Optional[QueryBundle] = None,
    ) -> List[NodeWithScore]:
        if query_bundle is None:
            raise ValueError("Missing query bundle in extra info.")
        if len(nodes) == 0:
            return []
        pairs = [(query_bundle.query_str, node.node.get_content()) for node in nodes]
        scores = self._model.predict(pairs)
        assert len(scores) == len(nodes)
        for node, score in zip(nodes, scores):
            if self.keep_retrieval_score:
                node.node.metadata["retrieval_score"] = node.score
            node.score = float(score)
        return sorted(nodes, key=lambda x: -x.score if x.score else 0)[: self.top_n]
