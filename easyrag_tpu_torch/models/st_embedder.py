"""SentenceTransformer-backed embedder (compatibility path; a host copy of
``easyrag_tpu/models/st_embedder.py``).

The reference selects this when the embedding name lacks "gte"/"Zhihui"
(``src/easyrag/pipeline/pipeline.py:109-115``,
``src/easyrag/custom/embeddings/hf_embeddings.py``): a SentenceTransformer
constructed with named "query"/"text" prompts (llama-index derives
instruction defaults per model name, e.g. the BGE zh retrieval instruction)
and normalized embeddings; queries encode with ``prompt_name="query"``,
documents with ``prompt_name="text"``.

The port's device path is ``GTEEmbedder``; this wrapper keeps the secondary
model family available through sentence-transformers, imported only when a
model is loaded.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# llama-index's per-model instruction defaults (the ones the reference
# pipeline can select); unknown models get empty prompts
_QUERY_INSTRUCT_BY_NAME = {
    "bge": "为这个句子生成表示以用于检索相关文章：",
    "instructor": "Represent the question for retrieving supporting documents: ",
}


def _default_query_instruction(model_name: str) -> str:
    lname = model_name.lower()
    for key, instr in _QUERY_INSTRUCT_BY_NAME.items():
        if key in lname:
            return instr
    return ""


class STEmbedder:
    def __init__(self, model, embed_type: int = 0) -> None:
        self.model = model
        self.embed_type = embed_type

    @classmethod
    def from_pretrained(
        cls,
        model_dir: str,
        embed_type: int = 0,
        query_instruction: Optional[str] = None,
        text_instruction: Optional[str] = None,
        max_length: Optional[int] = None,
    ) -> "STEmbedder":
        from sentence_transformers import SentenceTransformer

        model = SentenceTransformer(
            model_dir,
            trust_remote_code=True,
            prompts={
                "query": query_instruction
                or _default_query_instruction(model_dir),
                "text": text_instruction or "",
            },
        )
        if max_length:
            model.max_seq_length = max_length
        return cls(model, embed_type)

    def get_query_embedding(self, query: str) -> np.ndarray:
        return self.model.encode(
            [query], prompt_name="query", normalize_embeddings=True
        )[0]

    def get_query_embeddings(self, queries: List[str]) -> np.ndarray:
        return self.model.encode(
            list(queries), prompt_name="query", normalize_embeddings=True
        )

    def get_text_embedding(self, text: str) -> np.ndarray:
        return self.model.encode(
            [text], prompt_name="text", normalize_embeddings=True
        )[0]

    def get_text_embeddings(self, texts: List[str]) -> np.ndarray:
        return self.model.encode(
            list(texts), prompt_name="text", normalize_embeddings=True
        )

    def embed_nodes(self, nodes, embed_type=None) -> np.ndarray:
        from ..corpus.views import get_node_content

        et = self.embed_type if embed_type is None else embed_type
        return self.get_text_embeddings([get_node_content(n, et) for n in nodes])
