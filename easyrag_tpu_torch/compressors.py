"""Context compression (port of ``easyrag_tpu/compressors.py``, host code;
the reference's ``src/easyrag/custom/compressors.py``).

``bm25_extract``: cut the context into sentences, BM25-score each against
the query with a throwaway index, keep the highest-scoring sentences (in
original order) until ``rate`` x original length (``compressors.py:32-55``).

``embed_extract``: the same extractive policy, scored by query-sentence
cosine similarity from the dense embedder (``get_query_embedding`` and
``get_text_embeddings`` of ``models/qwen2.py::GTEEmbedder`` or
``models/st_embedder.py::STEmbedder``). llmlingua stays behind its import
gate: it is not installed with the port. The pipeline constructs the
compressor but does not call it in ``run``, as the reference does.
"""

from __future__ import annotations

import numpy as np

from .generation import cut_sent


class ContextCompressor:
    def __init__(
        self,
        method: str = "bm25_extract",
        rate: float = 0.5,
        bm25_retriever=None,
        embed_model=None,
    ):
        self.method = method
        self.rate = rate
        if method == "bm25_extract":
            if bm25_retriever is None:
                raise ValueError("bm25_extract requires a BM25Retriever")
            self.bm25_retriever = bm25_retriever
        elif method == "embed_extract":
            if embed_model is None:
                raise ValueError("embed_extract requires an embedding model")
            self.embed_model = embed_model
        elif "llmlingua" in method:
            try:
                from llmlingua import PromptCompressor  # type: ignore
            except ImportError as e:  # pragma: no cover
                raise ImportError(
                    "llmlingua is not available in this environment; use "
                    "compress_method='bm25_extract' or 'embed_extract'"
                ) from e
            self.prompt_compressor = PromptCompressor("Qwen/Qwen2-7B-Instruct")
        else:
            raise ValueError(f"unknown compress_method: {method}")

    def _sentence_scores(self, query: str, sentences: list) -> np.ndarray:
        if self.method == "bm25_extract":
            return np.asarray(self.bm25_retriever.get_scores(query, sentences))
        # embed_extract: cosine similarity of normalized embeddings
        q = np.asarray(self.embed_model.get_query_embedding(query))
        s = np.asarray(self.embed_model.get_text_embeddings(sentences))
        return s @ q

    def compress(self, query: str, context: str) -> str:
        if "llmlingua" in self.method:  # pragma: no cover - llmlingua path
            out = self.prompt_compressor.compress_prompt(
                context, instruction="", question=query, rate=self.rate,
                rank_method=self.method,
            )
            return out["compressed_prompt"]

        pre_len = len(context)
        sentences = [s.strip() for s in cut_sent(context) if s.strip() != ""]
        if not sentences:
            return ""
        scores = self._sentence_scores(query, sentences)
        # take sentences by descending score until rate * original length,
        # then emit them in original order (compressors.py:44-55)
        order = scores.argsort(kind="stable")[::-1]
        now_len, i = 0, 0
        for i, idx in enumerate(order):
            now_len += len(sentences[idx])
            if now_len >= pre_len * self.rate:
                break
        chosen = np.sort(order[: i + 1])
        return "".join(sentences[int(k)] for k in chosen)
