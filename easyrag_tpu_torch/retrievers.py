"""Retrievers (port of ``easyrag_tpu/retrievers.py``).

:class:`BM25Retriever` scores one content view of the node list on the
device-resident index; a query with more distinct terms than the resident
index takes (``max_query_terms``) overflows to the gather path: the host
gathers its postings and ``ops.bm25.bm25_score_topk`` scatters them (K5 on
CUDA). With a ``mesh`` whose ``data`` axis is wider than 1 the resident
index is ``parallel/sharded.py``'s ``ShardedResidentSparseIndex`` (doc ranges
over the mesh); the overflow stays the single-device gather path, as in JAX.
:class:`DenseRetriever` embeds the query and queries the cosine index
(``index/dense.py``, or a ``ShardedDenseIndex``). :class:`HybridRetriever`
carries the reference's content fusion (``retrievers.py:239-253``), its
reciprocal rank fusion (:256-274) and the route dispatch per
``retrieval_type`` (:276-291).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .corpus.tokenizer import tokenize_and_remove_stopwords
from .corpus.views import get_node_content
from .devices import resolve_device
from .index.dense import DenseIndex
from .index.sparse import SparseIndex, build_sparse_index
from .ops.bm25 import bm25_score_topk
from .ops.bm25_resident import ResidentSparseIndex
from .schema import NodeWithScore, QueryBundle, TextNode
from .utils import run_sync
from .utils.events import trace


class BM25Retriever:
    """Sparse retriever over one ``embed_type`` view of the node list. Its
    index is ``index`` (a prebuilt ``SparseIndex``, as the corpus artifact
    loads it) or is built from the nodes, through the native builder when it
    builds (``build_sparse_index(use_native=None)``, as JAX's retriever
    builds); ``heavy_dtype`` is the resident index's heavy storage; ``mesh``
    shards the resident index over its ``data`` axis when that is wider
    than 1."""

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
        index: Optional[SparseIndex] = None,
        mesh=None,
    ) -> None:
        self._nodes = nodes
        self._tokenizer = tokenizer
        self.stopwords = stopwords
        self._similarity_top_k = similarity_top_k
        self.embed_type = embed_type
        self.bm25_type = bm25_type
        self.k1, self.b, self.epsilon = 1.5, 0.75, 0.25
        self.max_query_postings = max_query_postings
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        self.filter_dict: Optional[Dict[str, str]] = None
        if index is None:
            corpus_tokens = [
                tokenize_and_remove_stopwords(tokenizer, get_node_content(node, embed_type), stopwords)
                for node in nodes
            ]
            index = build_sparse_index(
                corpus_tokens, bm25_type=bm25_type, k1=self.k1, b=self.b, epsilon=self.epsilon,
                dirs=[node.metadata.get("dir", "") for node in nodes],
            )
        self.index = index
        budgets = dict(max_query_terms=max_query_terms, heavy_dtype=heavy_dtype, heavy_hbm_budget=heavy_hbm_budget,
                       light_rows_hbm_budget=light_rows_hbm_budget)
        if mesh is not None and mesh.shape.get("data", 1) > 1:
            from .parallel.sharded import ShardedResidentSparseIndex

            self._resident = ShardedResidentSparseIndex(mesh, self.index, **budgets)
            # the overflow gather path's dir column, on this retriever's device
            self._dir_col = (None if index.dir_ids is None
                             else torch.from_numpy(index.dir_ids.astype(np.int32)).to(self.device))
        else:
            self._resident = ResidentSparseIndex(self.index, device=self.device, **budgets)
            self._dir_col = self._resident.dir_col

    def _tokenize_query(self, query: str) -> List[str]:
        return tokenize_and_remove_stopwords(self._tokenizer, query, self.stopwords)

    def get_scores(self, query: str, docs: Optional[Sequence[str]] = None) -> np.ndarray:
        """Full float64 score vector on the host. With ``docs``, over a
        throwaway index of those texts (the compressor's path,
        ``easyrag_tpu/retrievers.py:137-156``)."""
        index = self.index
        if docs is not None:
            corpus_tokens = [tokenize_and_remove_stopwords(self._tokenizer, d, self.stopwords) for d in docs]
            index = build_sparse_index(corpus_tokens, bm25_type=self.bm25_type, k1=self.k1, b=self.b,
                                       epsilon=self.epsilon)
        return index.get_scores_host(self._tokenize_query(query))

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

    def retrieve_batch(
        self,
        query_bundles: Sequence[QueryBundle],
        filter_dicts: Optional[Sequence[Optional[Dict[str, str]]]] = None,
    ) -> List[List[NodeWithScore]]:
        """Many queries on the resident index, in 64-row batches with their
        own dir filters; each row equal to :meth:`retrieve`'s (JAX's
        ``retrieve_batch``, ``easyrag_tpu/retrievers.py:235-320``). The whole
        stream is prepped at once; if a query overflows the term budget, the
        rows are prepped one by one and the overflowing ones go to
        :meth:`retrieve` (the gather path, K5). Rows whose filter can never
        match resolve to nothing on the host."""
        tokens = [self._tokenize_query(qb.query_str) for qb in query_bundles]
        rows: List[Optional[tuple]] = []
        overflow: List[int] = []
        try:
            bids, bcnts = self._resident.query_terms_batch(tokens)
            rows = [(bids[i], bcnts[i]) for i in range(len(tokens))]
        except ValueError:
            for i, toks in enumerate(tokens):
                try:
                    rows.append(self._resident.query_terms(toks))
                except ValueError:
                    rows.append(None)
                    overflow.append(i)
        dir_fs = []
        for i in range(len(query_bundles)):
            fd = filter_dicts[i] if filter_dicts else None
            dir_fs.append(-1 if fd is None or fd.get("dir") is None else self.index.dir_vocab.get(fd["dir"], -2))
        valid = [i for i, r in enumerate(rows) if r is not None and dir_fs[i] != -2]
        results: List[List[NodeWithScore]] = [[] for _ in query_bundles]
        if valid:
            tv, ti = self._resident.stream_from_arrays(
                np.stack([rows[i][0] for i in valid]), np.stack([rows[i][1] for i in valid]),
                np.asarray([dir_fs[i] for i in valid], np.int32), self._similarity_top_k,
            )
            finites = np.isfinite(tv).sum(axis=1)  # scores descending, -inf tail
            for row, i in enumerate(valid):
                n = int(finites[row])
                results[i] = [NodeWithScore(node=self._nodes[j], score=v)
                              for v, j in zip(tv[row, :n].tolist(), ti[row, :n].tolist())]
        saved = self.filter_dict
        for i in overflow:
            self.filter_dict = filter_dicts[i] if filter_dicts else None
            results[i] = self.retrieve(query_bundles[i])
        self.filter_dict = saved
        return results

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
            dir_col=self._dir_col,
            dir_filter=dir_t,
            use_pallas=self.use_pallas,
        )
        return tv.cpu().numpy(), ti.cpu().numpy()


class DenseRetriever:
    """Dense retriever: embed the query, query the cosine index. ``filters``
    is a ``dir`` value or None."""

    def __init__(self, index: DenseIndex, nodes: List[TextNode], embed_model, similarity_top_k: int = 288) -> None:
        self.index = index
        self._nodes = nodes
        self._embed_model = embed_model
        self._similarity_top_k = similarity_top_k
        self.filters: Optional[str] = None

    def _to_nodes(self, vals: np.ndarray, idx: np.ndarray) -> List[NodeWithScore]:
        n = int(np.isfinite(vals).sum())  # scores descending, -inf tail
        return [NodeWithScore(node=self._nodes[i], score=v) for v, i in zip(vals[:n].tolist(), idx[:n].tolist())]

    def retrieve(self, query_bundle: QueryBundle) -> List[NodeWithScore]:
        with trace("query_embedding"):
            emb = self._embed_model.get_query_embedding(query_bundle.query_str)
        with trace("dense_topk"):
            vals, idx = self.index.query(np.asarray(emb), self._similarity_top_k, dir_value=self.filters)
        return self._to_nodes(vals[0], idx[0])

    async def aretrieve(self, query_bundle: QueryBundle) -> List[NodeWithScore]:
        return self.retrieve(query_bundle)

    def retrieve_batch(
        self, query_bundles: List[QueryBundle], dir_values: Optional[List[Optional[str]]] = None
    ) -> List[List[NodeWithScore]]:
        """A whole query set: one batched query embedding and one
        ``DenseIndex.query_stream``; row-wise :meth:`retrieve` up to the
        rounding of the embedder's batched products."""
        queries = [qb.query_str for qb in query_bundles]
        if hasattr(self._embed_model, "get_query_embeddings"):
            embs = np.asarray(self._embed_model.get_query_embeddings(queries))
        else:  # an embedder of single queries only: one at a time, still one stream
            embs = np.stack([np.asarray(self._embed_model.get_query_embedding(q)) for q in queries])
        vals, idx = self.index.query_stream(
            embs, self._similarity_top_k, dir_values=list(dir_values or [None] * len(queries))
        )
        return [self._to_nodes(v, i) for v, i in zip(vals, idx)]


class HybridRetriever:
    """Route dispatch and fusion (``retrievers.py:223-291``)."""

    def __init__(
        self,
        dense_retriever: Optional[DenseRetriever],
        sparse_retriever: Optional[BM25Retriever],
        retrieval_type: int = 1,
        topk: int = 256,
    ) -> None:
        self.dense_retriever = dense_retriever
        self.sparse_retriever = sparse_retriever
        self.retrieval_type = retrieval_type  # 1 dense | 2 sparse | 3 hybrid
        self.filters: Optional[str] = None
        self.filter_dict: Optional[Dict[str, str]] = None
        self.topk = topk

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

    @classmethod
    def reciprocal_rank_fusion(
        cls, list_of_list_ranks_system: List[List[NodeWithScore]], K: int = 60, topk: int = 256
    ) -> List[NodeWithScore]:
        """RRF keyed by content: score = sum of 1/(rank + K) over the routes,
        1-based ranks. As in the reference, a later route's node object
        replaces the representative of its content, and its ``score`` is
        overwritten with the fused score."""
        rrf_map: Dict[str, float] = defaultdict(float)
        text_to_node: Dict[str, NodeWithScore] = {}
        for rank_list in list_of_list_ranks_system:
            for rank, item in enumerate(rank_list, 1):
                content = item.get_content()
                text_to_node[content] = item
                rrf_map[content] += 1.0 / (rank + K)
        reranked: List[NodeWithScore] = []
        for text, score in sorted(rrf_map.items(), key=lambda x: x[1], reverse=True):
            node = text_to_node[text]
            node.score = score
            reranked.append(node)
        return reranked[:topk]

    async def aretrieve(self, query_bundle: QueryBundle) -> List[NodeWithScore]:
        sparse_nodes: List[NodeWithScore] = []
        dense_nodes: List[NodeWithScore] = []
        if self.retrieval_type != 1:
            self.sparse_retriever.filter_dict = self.filter_dict
            sparse_nodes = await self.sparse_retriever.aretrieve(query_bundle)
            if self.retrieval_type == 2:
                return sparse_nodes
        if self.retrieval_type != 2:
            self.dense_retriever.filters = self.filters
            dense_nodes = await self.dense_retriever.aretrieve(query_bundle)
            if self.retrieval_type == 1:
                return dense_nodes
        return self.reciprocal_rank_fusion([sparse_nodes, dense_nodes], topk=self.topk)

    def retrieve(self, query_bundle: QueryBundle) -> List[NodeWithScore]:
        return run_sync(self.aretrieve(query_bundle))
