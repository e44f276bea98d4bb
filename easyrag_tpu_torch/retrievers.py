"""Sparse retrieval (port of the BM25 parts of ``easyrag_tpu/retrievers.py``).

:class:`BM25Retriever` scores one content view of the node list on the
device-resident index; a query with more distinct terms than the resident
index takes (``max_query_terms``) overflows to the gather path: the host
gathers its postings and ``ops.bm25.bm25_score_topk`` scatters them (K5 on
CUDA). :class:`HybridRetriever` carries the reference's content
fusion (``retrievers.py:239-253``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .corpus.tokenizer import tokenize_and_remove_stopwords
from .corpus.views import get_node_content
from .devices import resolve_device
from .index.sparse import build_sparse_index
from .ops.bm25 import bm25_score_topk
from .ops.bm25_resident import ResidentSparseIndex
from .schema import NodeWithScore, QueryBundle, TextNode


class BM25Retriever:
    """Sparse retriever over one ``embed_type`` view of the node list."""

    def __init__(
        self,
        nodes: List[TextNode],
        tokenizer,
        stopwords,
        similarity_top_k: int = 192,
        embed_type: int = 0,
        bm25_type: int = 0,
        max_query_postings: int = 32768,
        use_pallas: bool = False,
        max_query_terms: int = 64,
        heavy_dtype: str = "float32",
        heavy_hbm_budget: int = 512 * 1024 * 1024,
        light_rows_hbm_budget: int = 256 * 1024 * 1024,
        device: torch.device | str = "cuda",
    ) -> None:
        self._nodes = nodes
        self._tokenizer = tokenizer
        self.stopwords = stopwords
        self._similarity_top_k = similarity_top_k
        self.embed_type = embed_type
        self.max_query_postings = max_query_postings
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        self.filter_dict: Optional[Dict[str, str]] = None
        corpus_tokens = [
            tokenize_and_remove_stopwords(tokenizer, get_node_content(node, embed_type), stopwords)
            for node in nodes
        ]
        self.index = build_sparse_index(
            corpus_tokens,
            bm25_type=bm25_type,
            dirs=[node.metadata.get("dir", "") for node in nodes],
        )
        self._resident = ResidentSparseIndex(
            self.index,
            max_query_terms=max_query_terms,
            heavy_dtype=heavy_dtype,
            heavy_hbm_budget=heavy_hbm_budget,
            light_rows_hbm_budget=light_rows_hbm_budget,
            device=self.device,
        )

    def _tokenize_query(self, query: str) -> List[str]:
        return tokenize_and_remove_stopwords(self._tokenizer, query, self.stopwords)

    def _dir_filter_value(self) -> int:
        """-1: no filter; -2: a dir the index does not know (matches nothing)."""
        if self.filter_dict is None or self.filter_dict.get("dir") is None:
            return -1
        return self.index.dir_vocab.get(self.filter_dict["dir"], -2)

    def retrieve(self, query_bundle: QueryBundle) -> List[NodeWithScore]:
        tokens = self._tokenize_query(query_bundle.query_str)
        dir_f = self._dir_filter_value()
        if dir_f == -2:
            return []
        top_vals, top_idx = self._device_topk(tokens, dir_f)
        n = int(np.isfinite(top_vals).sum())  # scores descending, -inf tail
        return [
            NodeWithScore(node=self._nodes[i], score=v)
            for v, i in zip(top_vals[:n].tolist(), top_idx[:n].tolist())
        ]

    async def aretrieve(self, query_bundle: QueryBundle) -> List[NodeWithScore]:
        return self.retrieve(query_bundle)

    def _device_topk(self, tokens: List[str], dir_f: int):
        dev = self.device
        dir_t = torch.tensor([dir_f], dtype=torch.int32, device=dev)
        try:
            ids, cnts = self._resident.query_terms(tokens)
        except ValueError:  # more distinct terms than the resident path takes
            ids = None
        if ids is not None:
            tv, ti = self._resident._score_topk(
                torch.from_numpy(ids[None]).to(dev),
                torch.from_numpy(cnts[None]).to(dev),
                self._similarity_top_k,
                dir_t,
                light_t=self._resident.light_t_bound(ids[None]),
            )
            return tv[0].cpu().numpy(), ti[0].cpu().numpy()
        doc_ids, vals = self.index.gather_postings(
            self.index.query_term_ids(tokens), pad_to=self.max_query_postings, bucket=True
        )
        tv, ti = bm25_score_topk(
            torch.from_numpy(doc_ids).to(dev),
            torch.from_numpy(vals).to(dev),
            self.index.num_docs,
            self._similarity_top_k,
            dir_col=self._resident.dir_col,
            dir_filter=dir_t,
            use_pallas=self.use_pallas,
        )
        return tv.cpu().numpy(), ti.cpu().numpy()


class HybridRetriever:
    """Route fusion (``retrievers.py:223-291``); only the content fusion of
    the default route is ported."""

    @classmethod
    def fusion(cls, list_of_list_ranks_system: List[List[NodeWithScore]], topk: int = 256) -> List[NodeWithScore]:
        """Dedup by node content keeping the first occurrence, stable sort by
        score descending, truncate."""
        all_nodes: List[NodeWithScore] = []
        seen = set()
        for nodes in list_of_list_ranks_system:
            for node in nodes:
                content = node.get_content()
                if content not in seen:
                    all_nodes.append(node)
                    seen.add(content)
        all_nodes = sorted(all_nodes, key=lambda n: n.score, reverse=True)
        return all_nodes[:topk]
