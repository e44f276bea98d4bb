"""EasyRAGPipeline (port of ``easyrag_tpu/pipeline.py``).

``run(query)`` with ``rerank_fusion_type`` 0 mirrors the reference's
``generation_with_knowledge_retrieval`` (``pipeline.py:351-391``): content
BM25 (top ``f_topk_2``) and know-path BM25 (top ``f_topk_3``), both resident
on the device and scored together for the query, content fusion, the
injected reranker (``LLMRerank`` over the port's MiniCPM or Gemma2 scorer),
the top contexts into the QA template, and generation. With
``rerank_fusion_type`` 1-3 it mirrors ``generation_with_rerank_fusion``
(:393-452): the injected gte-Qwen2 embedder embeds the query, the dense
cosine index (top ``f_topk_1``) and content BM25 are queried, each route is
reranked on its own, and reciprocal rank fusion keeps ``r_topk_1`` contexts
for one answer (type 1), or each route answers and the longer answer (2) or
both (3) are returned. ``retrieval_type`` 1 or 3 builds the dense index at
boot (or reloads its artifact from ``cache_path/collection_name``); as in
JAX, ``rerank_fusion_type`` 0 never queries it (ROADMAP Queue 3). The
options of ``easyrag_tpu/pipeline.py`` are all here but tensor parallelism:
``split_type`` 1 (hierarchical chunks, BM25 over the leaves, auto-merging),
HyDE (``hyde``: the LLM's hypothetical document appended to the query;
``hyde_merging``: a second prompt before the rerank), the corpus artifact
(``index_artifact_path``: nodes and both sparse indexes, reloaded while the
corpus fingerprint matches), ``compress_method`` (the compressor is built,
and ``run`` does not call it, as in JAX) and ``tpu.sparse_heavy_dtype`` (the
resident index's heavy storage, both routes). The answer
comes from the injected LLM, or, with ``local_llm_name`` and
``tpu.local_llm_answer``, from the on-device generator
(``models/decode.py::TorchCausalLM``) behind ``generation.BatchingLocalLLM``,
or with ``tpu.local_llm_continuous`` behind ``generation.
ContinuousBatchingLocalLLM`` (the decode pool), as
``easyrag_tpu/pipeline.py:99-127`` wires them. A reranker or an embedder
that is not injected is loaded by name through ``models/registry.py``, as
``easyrag_tpu/pipeline.py:154-165,324-338`` loads them. The batch entry
points: ``run_retrieval_batch`` (a whole query set retrieved in 64-row
batches, the sparse dual route or the fusion route's dense and sparse lists)
and ``run_answers_batch`` (that retrieval, each query reranked, every answer
from ``TorchCausalLM.generate_batch``), each row equal to ``run``'s; under
HyDE, or over the auto-merging retriever, they run ``run`` query by query, as
JAX's gates do. ``tpu.mesh_shape`` builds a device mesh (``parallel/mesh.py``:
by default distinct cards, as many as the shape needs) and ``tpu.shard_index``
shards both BM25 routes' resident indexes and the dense index over its
``data`` axis (``parallel/sharded.py``); a mesh may instead be injected
(``mesh=``), e.g. four shards on one card. Sharded routes are scored route by
route, as in JAX: the fused dual-route scorer is single-chip. A ``model`` axis
wider than 1 (tensor parallelism) raises ``NotImplementedError`` where a model
is loaded.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .automerge import AutoMergingRetriever
from .compressors import ContextCompressor
from .config import EasyRAGConfig, parse_pool_tiers
from .corpus.extractors import run_extractors
from .corpus.hierarchical import HierarchicalSplitter, get_leaf_nodes
from .corpus.reader import read_data
from .corpus.splitter import SentenceSplitter
from .corpus.tokenizer import JiebaTokenizer, default_stopwords, load_stopwords
from .corpus.views import get_node_content
from .devices import resolve_device
from .generation import (
    BatchingLocalLLM,
    CompletionResponse,
    ContinuousBatchingLocalLLM,
    HyDETransform,
    OpenAICompatLLM,
    generation,
)
from .index.artifact import CorpusArtifact
from .index.dense import DenseIndex, load_dense_arrays, prepare_dense_arrays, save_dense_artifact
from .ops.bm25_resident import DualResidentScorer, ResidentSparseIndex
from .retrievers import BM25Retriever, DenseRetriever, HybridRetriever
from .schema import NodeWithScore, QueryBundle, build_nodeid2idx
from .templates import (
    HYDE_PROMPT_MODIFIED_MERGING,
    HYDE_PROMPT_MODIFIED_V2,
    MERGE_TEMPLATE,
    QA_TEMPLATE,
    PromptTemplate,
)
from .utils.events import emit, trace


def _check_supported(cfg: EasyRAGConfig) -> None:
    """Refuse an option combination the pipeline cannot run."""
    if cfg.rerank_fusion_type != 0 and cfg.retrieval_type == 2:
        raise ValueError(f"rerank_fusion_type={cfg.rerank_fusion_type} fuses the dense route: set retrieval_type 1 or 3")


def _corpus_fingerprint(data_path: str) -> str:
    """Fingerprint of the corpus tree (the ``.txt`` files' names, sizes and
    mtimes), so that a stale artifact is rebuilt when a file changes
    (``easyrag_tpu/pipeline.py:45-60``)."""
    import hashlib

    h = hashlib.sha256()
    if os.path.isdir(data_path):
        for dirpath, dirnames, filenames in os.walk(data_path):
            dirnames.sort()
            for name in sorted(filenames):
                if not name.endswith(".txt"):
                    continue
                p = os.path.join(dirpath, name)
                st = os.stat(p)
                h.update(f"{os.path.relpath(p, data_path)}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


class EasyRAGPipeline:
    def __init__(
        self,
        config: EasyRAGConfig | Dict[str, Any],
        llm=None,
        embed_model=None,
        reranker=None,
        documents=None,
        sparse_tokenizer=None,
        splitter=None,
        device: torch.device | str = "cuda",
        mesh=None,
    ) -> None:
        """``sparse_tokenizer`` tokenizes for BM25 (default: jieba, as the
        reference); ``splitter`` chunks the documents (default: the
        reference's ``SentenceSplitter(chunk_size, chunk_overlap)``, or with
        ``split_type`` 1 ``HierarchicalSplitter([chunk_size * 4,
        chunk_size], chunk_overlap)``, whose default token counter wants a
        tiktoken table). The corpus artifact's fingerprint (JAX's) does not
        cover an injected tokenizer or splitter. ``embed_model`` is the
        dense route's embedder (``models/qwen2.py::GTEEmbedder``), used with
        ``retrieval_type`` 1 or 3; without it, ``embedding_name`` is loaded
        through the registry, as ``reranker_name`` is without ``reranker``
        (``use_reranker`` 1 or 2). ``device`` is the card unless the caller
        asks for the CPU; without a card it raises. ``mesh``
        (``parallel.mesh.Mesh``) stands in for the one ``tpu.mesh_shape``
        would build; ``tpu.shard_index`` shards the indexes over its ``data``
        axis."""
        if isinstance(config, dict):
            config = EasyRAGConfig.from_dict(config)
        _check_supported(config)
        self.config = cfg = config
        self.device = resolve_device(device)
        self.re_only = cfg.re_only
        self.llm_embed_type = cfg.llm_embed_type
        self.ans_refine_type = cfg.ans_refine_type
        self.hyde, self.hyde_merging = cfg.hyde, cfg.hyde_merging
        self.local_llm = None
        if llm is not None:
            self.llm = llm
        elif cfg.local_llm_name and cfg.tpu.local_llm_answer:
            # the on-device generator answers; concurrent requests share
            # decodes: in a window (BatchingLocalLLM) or by joining a running
            # decode at chunk boundaries (the decode pool)
            if cfg.tpu.local_llm_continuous and (cfg.tpu.local_llm_backend != "jax" or not cfg.tpu.local_llm_max_new):
                raise ValueError(
                    "tpu.local_llm_continuous needs local_llm_backend=jax and local_llm_max_new set (static pool shapes)"
                )
            self.local_llm = self._make_local_llm(cfg, self.device)
            if cfg.tpu.local_llm_continuous:
                self.llm = ContinuousBatchingLocalLLM(
                    self.local_llm, pool_size=cfg.tpu.local_llm_gen_batch, chunk_steps=cfg.tpu.local_llm_chunk_steps,
                    tiers=parse_pool_tiers(cfg.tpu.local_llm_pool_tiers),
                )
            else:
                self.llm = BatchingLocalLLM(
                    self.local_llm, window_ms=cfg.serve_window_ms, max_batch=cfg.tpu.local_llm_gen_batch
                )
        elif cfg.llm_keys:
            self.llm = OpenAICompatLLM(api_keys=cfg.llm_keys, model=cfg.llm_name, api_base=cfg.llm_api_base)
        else:
            self.llm = None
        self.qa_template = PromptTemplate(QA_TEMPLATE)
        self.merge_template = PromptTemplate(MERGE_TEMPLATE)
        self.hyde_transform = HyDETransform(self.llm, HYDE_PROMPT_MODIFIED_V2) if self.hyde else None
        self.hyde_transform_merging = (
            HyDETransform(self.llm, HYDE_PROMPT_MODIFIED_MERGING) if self.hyde_merging else None
        )

        # corpus -> nodes, or the artifact's nodes and sparse indexes while
        # its fingerprint matches (easyrag_tpu/pipeline.py:167-202)
        data_path = os.path.abspath(cfg.data_path)
        fingerprint = {
            "data_path": data_path,
            "corpus": _corpus_fingerprint(data_path),
            "chunk_size": cfg.chunk_size,
            "chunk_overlap": cfg.chunk_overlap,
            "split_type": cfg.split_type,
            "f_embed_type_2": cfg.f_embed_type_2,
            "bm25_type": cfg.bm25_type,
            "f_topk_3": cfg.f_topk_3,
        }
        artifact = CorpusArtifact(cfg.index_artifact_path) if cfg.index_artifact_path else None
        self.stp_words = load_stopwords(cfg.stopwords_path) if cfg.stopwords_path else default_stopwords()
        self.sparse_tk = sparse_tokenizer if sparse_tokenizer is not None else JiebaTokenizer()
        loaded = artifact is not None and not cfg.reindex and artifact.matches(fingerprint)
        sparse_content = sparse_path = None
        if loaded:
            self.nodes = artifact.load_nodes()
            self.all_nodes = artifact.load_all_nodes() or self.nodes
            sparse_content, sparse_path = artifact.load_sparse("content"), artifact.load_sparse("path")
            emit("artifact", {"loaded_nodes": len(self.nodes)})
        else:
            if documents is None:
                documents = read_data(data_path)
            emit("ingestion", {"documents": len(documents)})
            if splitter is None and cfg.split_type == 1:
                splitter = HierarchicalSplitter(chunk_sizes=[cfg.chunk_size * 4, cfg.chunk_size],
                                                chunk_overlap=cfg.chunk_overlap)
            elif splitter is None:
                splitter = SentenceSplitter(chunk_size=cfg.chunk_size, chunk_overlap=cfg.chunk_overlap)
            self.all_nodes = splitter.parse_documents(documents)
            run_extractors(self.all_nodes, data_path=data_path)
            emit("chunking", {"nodes": len(self.all_nodes)})
            self.nodes = get_leaf_nodes(self.all_nodes) if cfg.split_type == 1 else self.all_nodes
        self.nodeid2idx = build_nodeid2idx(self.nodes)
        self._ctx_cache: Dict[int, str] = {}

        self._ctx_classes = None  # see _content_classes

        # the device mesh (easyrag_tpu/pipeline.py:147-152); the indexes
        # shard over it under tpu.shard_index when its data axis is wider than 1
        self.mesh = mesh
        if mesh is None and cfg.tpu.mesh_shape:
            from .parallel.mesh import make_mesh

            self.mesh = make_mesh(cfg.tpu.mesh_shape, cfg.tpu.mesh_axis_names)
        shard_mesh = self.mesh if cfg.tpu.shard_index else None

        self.embed_model = embed_model
        if cfg.retrieval_type != 2 and embed_model is None:
            from .models.registry import load_embedder

            self.embed_model = load_embedder(
                cfg.embedding_name, cache_folder=cfg.hfmodel_cache_folder, embed_type=cfg.f_embed_type_1,
                mesh=self.mesh, quant=cfg.tpu.embedder_quant, device=self.device,
            )
        self.dense_retriever = self._build_dense(self.nodes, cfg) if cfg.retrieval_type != 2 else None

        route = dict(
            nodes=self.nodes,
            tokenizer=self.sparse_tk,
            stopwords=self.stp_words,
            bm25_type=cfg.bm25_type,
            max_query_postings=cfg.tpu.max_query_postings,
            use_pallas=cfg.tpu.use_pallas,
            max_query_terms=cfg.tpu.max_query_terms,
            heavy_dtype=cfg.tpu.sparse_heavy_dtype,
            heavy_hbm_budget=cfg.tpu.sparse_heavy_hbm_budget,
            light_rows_hbm_budget=cfg.tpu.sparse_light_rows_hbm_budget,
            device=self.device,
            mesh=shard_mesh,
        )
        self.sparse_retriever = BM25Retriever(
            similarity_top_k=cfg.f_topk_2, embed_type=cfg.f_embed_type_2, index=sparse_content, **route
        )
        self.path_retriever = None
        self._dual_scorer = None
        if cfg.f_topk_3 != 0:
            self.path_retriever = BM25Retriever(
                similarity_top_k=cfg.f_topk_3, embed_type=5, index=sparse_path, **route  # know_path
            )
            # sharded residents are scored route by route (JAX's rule): the
            # fused dual scorer is single-chip
            if isinstance(self.sparse_retriever._resident, ResidentSparseIndex):
                self._dual_scorer = DualResidentScorer(self.sparse_retriever._resident, self.path_retriever._resident)
        if artifact is not None and not loaded:
            artifact.save(self.nodes, fingerprint, sparse_content=self.sparse_retriever.index,
                          sparse_path=self.path_retriever.index if self.path_retriever else None,
                          all_nodes=self.all_nodes)
            emit("artifact", {"saved_nodes": len(self.nodes)})
        # the compressor scores sentences with the content route's BM25; JAX
        # hands it the auto-merging wrapper under split_type 1, which has no
        # get_scores, so the port hands it the route itself
        self.compressor = (
            ContextCompressor(cfg.compress_method, cfg.compress_rate, bm25_retriever=self.sparse_retriever,
                              embed_model=self.embed_model)
            if cfg.compress_method
            else None
        )
        if cfg.split_type == 1:
            self.sparse_retriever = AutoMergingRetriever(self.sparse_retriever, self.all_nodes, simple_ratio_thresh=0.4)
            self._dual_scorer = None  # auto-merge takes the per-route path
        if cfg.retrieval_type == 1:
            self.retriever = self.dense_retriever
        elif cfg.retrieval_type == 2:
            self.retriever = self.sparse_retriever
        else:
            self.retriever = HybridRetriever(self.dense_retriever, self.sparse_retriever, cfg.retrieval_type, cfg.f_topk)
        # the serving layer sets rerank_in_thread so concurrent requests
        # overlap in the rerank stage (their pairs then meet in
        # serving.coalesce.CoalescingScorer's queue)
        self.rerank_in_thread = False
        self.reranker = reranker
        if reranker is None and cfg.use_reranker != 0:
            from .models.registry import load_reranker

            self.reranker = load_reranker(
                cfg.reranker_name, top_n=cfg.r_topk, embed_bs=cfg.r_embed_bs, embed_type=cfg.r_embed_type,
                use_efficient=cfg.r_use_efficient, use_st=cfg.use_reranker == 1, quant=cfg.tpu.reranker_quant,
                cascade_keep=cfg.tpu.cascade_keep, cascade_carry=cfg.tpu.cascade_carry, device=self.device,
            )
        if cfg.local_llm_name and self.local_llm is None:  # local_llm_generate only
            self.local_llm = self._make_local_llm(cfg, self.device)

    def _build_dense(self, nodes, cfg: EasyRAGConfig) -> DenseRetriever:
        """The cosine index of the nodes' ``f_embed_type_1`` views: reloaded
        from the artifact at ``cache_path/collection_name`` unless
        ``reindex`` is set or its row count differs from the node list,
        otherwise embedded, built and saved there (``pipeline.py:359-426``).
        Under ``tpu.shard_index`` over a mesh whose ``data`` axis is wider
        than 1 it is a ``ShardedDenseIndex``: the host arrays are read or
        prepared once, then sharded (and saved in the single-chip format), so
        the whole matrix never lands on one device."""
        artifact = os.path.join(cfg.cache_path, cfg.collection_name)
        shard = cfg.tpu.shard_index and self.mesh is not None and self.mesh.shape.get("data", 1) > 1
        if shard:
            from .parallel.sharded import ShardedDenseIndex
        if not cfg.reindex and os.path.exists(os.path.join(artifact, "dense_arrays.npz")):
            if shard:
                arrays = load_dense_arrays(artifact)
                index = ShardedDenseIndex.from_arrays(self.mesh, *arrays) if len(arrays[0]) == len(nodes) else None
            else:
                index = DenseIndex.load(artifact, device=self.device)
            if index is not None and index.num_docs == len(nodes):
                emit("dense_index", {"loaded": index.num_docs})
                return DenseRetriever(index, nodes, self.embed_model, similarity_top_k=cfg.f_topk_1)
        texts = [get_node_content(n, cfg.f_embed_type_1) for n in nodes]
        embeddings = np.asarray(self.embed_model.get_text_embeddings(texts))
        dirs = [n.metadata.get("dir", "") for n in nodes]
        if shard:
            arrays = prepare_dense_arrays(embeddings, dirs, cfg.tpu.index_dtype)
            index = ShardedDenseIndex.from_arrays(self.mesh, *arrays, cfg.tpu.index_dtype)
            save_dense_artifact(artifact, *arrays, cfg.tpu.index_dtype)
        else:
            index = DenseIndex.build(embeddings, dirs=dirs, dtype=cfg.tpu.index_dtype, device=self.device)
            index.save(artifact)
        emit("dense_index", {"built": index.num_docs})
        return DenseRetriever(index, nodes, self.embed_model, similarity_top_k=cfg.f_topk_1)

    # -- query-time helpers ---------------------------------------------------

    def build_filters(self, query: Dict[str, Any]) -> Tuple[Optional[str], Optional[Dict]]:
        """``query["document"]`` -> (dense dir filter, sparse filter dict)
        (``pipeline.py:301-312``)."""
        if query.get("document", "") != "":
            return query["document"], {"dir": query["document"]}
        return None, None

    def get_node_content(self, node) -> str:
        """The ``llm_embed_type`` view of a node, cached by corpus index."""
        inner = node.node if isinstance(node, NodeWithScore) else node
        idx = getattr(inner, "idx", -1)
        cached = self._ctx_cache.get(idx) if idx >= 0 else None
        if cached is None:
            cached = get_node_content(
                inner, embed_type=self.llm_embed_type, nodes=self.nodes, nodeid2idx=self.nodeid2idx
            )
            if idx >= 0:
                self._ctx_cache[idx] = cached
        return cached

    @staticmethod
    def _make_local_llm(cfg: EasyRAGConfig, device: torch.device):
        """The local generator per ``tpu.local_llm_backend``: "jax" is the
        port's KV-cache decoder, "hf" the shared HuggingFace wrapper."""
        if cfg.tpu.local_llm_backend == "jax":
            from .models.decode import TorchCausalLM

            return TorchCausalLM(
                cfg.local_llm_name,
                quant=cfg.tpu.local_llm_quant,
                max_new_tokens=cfg.tpu.local_llm_max_new or None,
                max_batch=cfg.tpu.local_llm_gen_batch,
                spec_tokens=cfg.tpu.local_llm_spec,
                spec_ngram=cfg.tpu.local_llm_spec_ngram,
                device=device,
            )
        from .generation import LocalHFLLM

        return LocalHFLLM(cfg.local_llm_name)

    def local_llm_generate(self, query: str) -> str:
        """Greedy chat completion of ``query`` by the local generator
        (reference ``pipeline.py:320-321``)."""
        if self.local_llm is None:
            raise RuntimeError("local_llm_name not configured")
        return self.local_llm.generate(query)

    async def generation(self, llm, prompt: str) -> CompletionResponse:
        if llm is None:
            raise RuntimeError("no LLM configured (llm_keys empty); use re_only=true for retrieval-only runs")
        return await generation(llm, prompt)

    # -- run ------------------------------------------------------------------

    async def run(self, query: Dict[str, Any]) -> Dict[str, Any]:
        """``{"query": ..., "document": optional dir}`` ->
        ``{"answer", "nodes", "contexts"}``. Under ``hyde`` the LLM's
        hypothetical document is set as ``query["hyde_query"]`` first."""
        if self.hyde:
            with trace("hyde"):
                hyde_bundle = await self.hyde_transform.acall(query["query"])
            query["hyde_query"] = hyde_bundle.custom_embedding_strs[0]
        filters, self.filter_dict = self.build_filters(query)
        self.sparse_retriever.filter_dict = self.filter_dict
        if self.config.rerank_fusion_type == 0:
            return await self.generation_with_knowledge_retrieval(
                query_str=query["query"], hyde_query=query.get("hyde_query", "")
            )
        self.dense_retriever.filters = filters
        return await self.generation_with_rerank_fusion(query_str=query["query"])

    # -- batch entry points -----------------------------------------------------

    async def run_retrieval_batch(self, queries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Retrieval only for a whole query set, each row equal to ``run``
        with ``re_only`` (``easyrag_tpu/pipeline.py:531-560``). Without a
        reranker, the default path scores both sparse routes in 64-row
        batches (:meth:`_sparse_fused_batch`) and the fusion path embeds the
        queries at once and streams the dense and sparse lists
        (:meth:`_run_fusion_retrieval_batch`); anything else (a reranker,
        HyDE, the auto-merging retriever) runs ``run`` query by query."""
        if self.reranker is not None or self.hyde or not isinstance(self.sparse_retriever, BM25Retriever):
            return [await self.run(dict(q)) for q in queries]
        if self.config.rerank_fusion_type != 0:
            return self._run_fusion_retrieval_batch(queries)
        return [
            {"answer": "", "nodes": fused, "contexts": [self.get_node_content(n) for n in fused]}
            for fused in self._sparse_fused_batch(queries)
        ]

    def _sparse_fused_batch(self, queries) -> List[list]:
        """Both sparse routes of every query, in 64-row batches, fused per
        query (dedup through the integer content classes): the shared core of
        :meth:`run_retrieval_batch` and :meth:`run_answers_batch`."""
        bundles = [QueryBundle(query_str=q["query"]) for q in queries]
        filter_dicts = [self.build_filters(q)[1] for q in queries]
        with trace("retrieval_batch"):
            if self._dual_scorer is not None:
                content_lists, path_lists = self._dual_retrieve_stream(bundles, filter_dicts)
            else:
                content_lists = self.sparse_retriever.retrieve_batch(bundles, filter_dicts)
                path_lists = (self.path_retriever.retrieve_batch(bundles) if self.path_retriever is not None
                              else [[] for _ in queries])
        return [self._fuse_corpus_lists([c, p]) for c, p in zip(content_lists, path_lists)]

    async def run_answers_batch(self, queries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Staged batch answers (``easyrag_tpu/pipeline.py:590-627``): one
        retrieval stream for every query, the reranker query by query, then
        every prompt through the local generator's ``generate_batch``
        (``gen_batch``-row decodes). Each row equals ``run``'s. It stages
        only on the default path and where ``run`` itself answers with that
        generator (or with ``re_only``), without HyDE and over the plain
        BM25 route; otherwise it runs ``run`` query by query."""
        gen = self.local_llm
        stageable = (
            self.config.rerank_fusion_type == 0
            and not self.hyde
            and not self.hyde_merging
            and isinstance(self.sparse_retriever, BM25Retriever)
            and (self.re_only or (hasattr(gen, "generate_batch") and self._answers_via_local_llm()))
        )
        if not stageable:
            return [await self.run(dict(q)) for q in queries]
        return await self._run_answers_staged(queries, self._sparse_fused_batch(queries), gen)

    def _answers_via_local_llm(self) -> bool:
        """True when ``run``'s answer LLM is the local generator, directly or
        behind ``BatchingLocalLLM`` (which holds it as ``.model``)."""
        gen = self.local_llm
        return gen is not None and (self.llm is gen or getattr(self.llm, "model", None) is gen)

    async def _run_answers_staged(self, queries, fused_lists, gen) -> List[Dict[str, Any]]:
        results, prompts = [], []
        for q, fused in zip(queries, fused_lists):
            if self.reranker:
                emit("reranking", {"candidates": len(fused)})
                with trace("rerank"):
                    fused = await self._apply_reranker(fused, QueryBundle(query_str=q["query"]))
            contents = [self.get_node_content(n) for n in fused]
            results.append({"answer": "", "nodes": fused, "contexts": contents})
            if not self.re_only:
                context_str = "\n\n".join(f"### 文档{i}: {c}" for i, c in enumerate(contents))
                prompts.append(self.qa_template.format(context_str=context_str, query_str=q["query"]))
        if self.re_only:
            return results
        with trace("generation"):
            answers = gen.generate_batch(prompts)
        if self.ans_refine_type == 1:
            answers = gen.generate_batch([
                self.merge_template.format(context_str=res["contexts"][0] if res["contexts"] else "",
                                           query_str=q["query"], answer_str=ans)
                for q, res, ans in zip(queries, results, answers)
            ])
        for res, ans in zip(results, answers):
            if self.ans_refine_type == 2 and res["contexts"]:
                ans = ans + "\n\n" + res["contexts"][0]
            res["answer"] = ans
        return results

    def _content_classes(self) -> List[int]:
        """``cls[idx]``: the idx of the first corpus node with the same
        content, so batch fusion dedups on ints (built once; the nodes do not
        change after ingest)."""
        if self._ctx_classes is None:
            first: Dict[str, int] = {}
            self._ctx_classes = [first.setdefault(n.get_content(), i) for i, n in enumerate(self.nodes)]
        return self._ctx_classes

    def _fuse_corpus_lists(self, lists) -> list:
        """``HybridRetriever.fusion`` (dedup by content keeping the first,
        stable sort by score descending, top 256) on the integer content
        classes; the classmethod itself where a node lacks a corpus idx."""
        if not all(nw.node.idx >= 0 for nodes in lists for nw in nodes):
            return HybridRetriever.fusion(lists)
        cls = self._content_classes()
        seen, fused = set(), []
        for nodes in lists:
            for nw in nodes:
                c = cls[nw.node.idx]
                if c not in seen:
                    seen.add(c)
                    fused.append(nw)
        fused.sort(key=lambda n: n.score, reverse=True)
        return fused[:256]

    def _run_fusion_retrieval_batch(self, queries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Retrieval only on the fusion path for a whole query set: the
        queries embedded at once, ``DenseIndex.query_stream``, the sparse
        stream, RRF to ``r_topk_1`` per query (``easyrag_tpu/pipeline.py:
        717-744``)."""
        bundles = [QueryBundle(query_str=q["query"]) for q in queries]
        pairs = [self.build_filters(q) for q in queries]
        with trace("retrieval_batch"):
            dense_lists = self.dense_retriever.retrieve_batch(bundles, [p[0] for p in pairs])
            sparse_lists = self.sparse_retriever.retrieve_batch(bundles, [p[1] for p in pairs])
        out = []
        for sparse_nodes, dense_nodes in zip(sparse_lists, dense_lists):
            fused = self._rrf_corpus_lists([sparse_nodes, dense_nodes], topk=self.config.r_topk_1)
            out.append({"answer": "", "nodes": fused, "contexts": [self.get_node_content(n) for n in fused]})
        return out

    def _rrf_corpus_lists(self, lists, K: int = 60, topk: int = 256) -> list:
        """``HybridRetriever.reciprocal_rank_fusion`` on the integer content
        classes (the same sums, the later route's node as representative,
        first insertion breaking score ties); the classmethod itself where a
        node lacks a corpus idx."""
        if not all(nw.node.idx >= 0 for nodes in lists for nw in nodes):
            return HybridRetriever.reciprocal_rank_fusion(lists, K=K, topk=topk)
        cls = self._content_classes()
        rrf: Dict[int, float] = {}
        rep: Dict[int, NodeWithScore] = {}
        for rank_list in lists:
            for rank, item in enumerate(rank_list, 1):
                c = cls[item.node.idx]
                rep[c] = item
                rrf[c] = rrf.get(c, 0.0) + 1.0 / (rank + K)
        fused = []
        for c, score in sorted(rrf.items(), key=lambda x: x[1], reverse=True):
            node = rep[c]
            node.score = score
            fused.append(node)
        return fused[: min(topk, len(fused))]

    def _dual_retrieve_stream(self, bundles, filter_dicts):
        """Both sparse routes of a whole query set in 64-row batches: the
        batch form of :meth:`_dual_retrieve`, row for row (the content route
        takes the dir filter, the path route does not). The stream is prepped
        at once; if a query overflows the term budget, the rows are checked
        one by one and the overflowing ones are retrieved per route (the
        gather path, K5)."""
        sparse, path = self.sparse_retriever, self.path_retriever
        tokens = [sparse._tokenize_query(qb.query_str) for qb in bundles]
        dir_fs = [-1 if fd is None or fd.get("dir") is None else sparse.index.dir_vocab.get(fd["dir"], -2)
                  for fd in filter_dicts]
        try:
            prepped = (*sparse._resident.query_terms_batch(tokens), *path._resident.query_terms_batch(tokens))
            valid, overflow = list(range(len(tokens))), []
        except ValueError:
            valid, overflow = [], []
            for i, toks in enumerate(tokens):
                try:
                    sparse._resident.query_terms(toks)
                    path._resident.query_terms(toks)
                    valid.append(i)
                except ValueError:
                    overflow.append(i)
            kept = [tokens[i] for i in valid]
            prepped = (*sparse._resident.query_terms_batch(kept), *path._resident.query_terms_batch(kept))

        def to_nodes(tv_row, ti_row):
            n = int(np.isfinite(tv_row).sum())  # scores descending, -inf tail
            return [NodeWithScore(node=self.nodes[j], score=v) for v, j in zip(tv_row[:n].tolist(), ti_row[:n].tolist())]

        content_lists = [[] for _ in bundles]
        path_lists = [[] for _ in bundles]
        if valid:
            (tv1, ti1), (tv2, ti2) = self._dual_scorer.stream_from_arrays(
                *prepped, [dir_fs[i] for i in valid], sparse._similarity_top_k, path._similarity_top_k
            )
            for row, i in enumerate(valid):
                content_lists[i] = to_nodes(tv1[row], ti1[row])
                path_lists[i] = to_nodes(tv2[row], ti2[row])
        saved = sparse.filter_dict
        for i in overflow:
            sparse.filter_dict = filter_dicts[i]
            content_lists[i] = sparse.retrieve(bundles[i])
            path_lists[i] = path.retrieve(bundles[i])
        sparse.filter_dict = saved
        return content_lists, path_lists

    def _dual_retrieve(self, query_bundle: QueryBundle):
        """Both routes scored together for one query; None when a route
        overflows the resident term budget (the caller then retrieves per
        route). The content route takes the dir filter, the path route does
        not (``pipeline.py:357-365``)."""
        if self._dual_scorer is None:
            return None
        sparse, path = self.sparse_retriever, self.path_retriever
        sparse.filter_dict = self.filter_dict
        tokens = sparse._tokenize_query(query_bundle.query_str)
        dir_f = sparse._dir_filter_value()
        try:
            sparse._resident.query_terms(tokens)
            path._resident.query_terms(tokens)
        except ValueError:
            return None
        (tv1, ti1), (tv2, ti2) = self._dual_scorer.score_topk(
            [tokens], sparse._similarity_top_k, path._similarity_top_k, [dir_f]
        )

        def to_nodes(tv, ti):
            n = int((tv > float("-inf")).sum())
            return [NodeWithScore(node=self.nodes[i], score=v) for v, i in zip(tv[:n].tolist(), ti[:n].tolist())]

        return to_nodes(tv1[0], ti1[0]), to_nodes(tv2[0], ti2[0])

    async def generation_with_knowledge_retrieval(self, query_str: str, hyde_query: str = "") -> Dict[str, Any]:
        """Sparse dual route -> fusion -> rerank -> QA generation -> optional
        answer refinement (``easyrag_tpu/pipeline.py:901-953``). Retrieval
        scores ``query_str + hyde_query``; with ``hyde_merging`` the LLM
        rewrites the rerank query from the question, the hypothetical
        document and the top context."""
        query_bundle = QueryBundle(query_str=query_str + hyde_query)
        with trace("retrieval"):
            routes = self._dual_retrieve(query_bundle)
            if routes is None:
                routes = (
                    await self.sparse_retriever.aretrieve(query_bundle),
                    await self.path_retriever.aretrieve(query_bundle) if self.path_retriever else [],
                )
            node_with_scores = HybridRetriever.fusion(list(routes))
        if self.reranker:
            if self.hyde_merging and self.hyde:
                seed = (
                    f"问题：{query_str},\n 可能有用的提示文档:{hyde_query},\n "
                    f"检索得到的相关上下文：{self.get_node_content(node_with_scores[0])}"
                )
                with trace("hyde_merging"):
                    merged = await self.hyde_transform_merging.acall(seed)
                query_bundle = QueryBundle(query_str=query_str + "\n" + merged.custom_embedding_strs[0])
            emit("reranking", {"candidates": len(node_with_scores)})
            with trace("rerank"):
                node_with_scores = await self._apply_reranker(node_with_scores, query_bundle)
        contents = [self.get_node_content(node) for node in node_with_scores]
        if self.re_only:
            return {"answer": "", "nodes": node_with_scores, "contexts": contents}
        context_str = "\n\n".join(f"### 文档{i}: {c}" for i, c in enumerate(contents))
        prompt = self.qa_template.format(context_str=context_str, query_str=query_str)
        with trace("generation"):
            ret = await self.generation(self.llm, prompt)
        if self.ans_refine_type == 1:
            ret = await self.generation(
                self.llm,
                self.merge_template.format(context_str=contents[0], query_str=query_str, answer_str=ret.text),
            )
        elif self.ans_refine_type == 2:
            ret.text = ret.text + "\n\n" + contents[0]
        return {"answer": ret.text, "nodes": node_with_scores, "contexts": contents}

    async def _rerank(self, nodes, query_bundle: QueryBundle):
        if not self.reranker:
            return nodes
        emit("reranking", {"candidates": len(nodes)})
        with trace("rerank"):
            return await self._apply_reranker(nodes, query_bundle)

    async def _apply_reranker(self, nodes, query_bundle: QueryBundle):
        """The rerank stage, in a worker thread when the serving layer set
        ``rerank_in_thread`` (threads let concurrent requests' pairs meet in
        the coalescer's queue)."""
        if self.rerank_in_thread:
            import asyncio

            return await asyncio.to_thread(self.reranker.postprocess_nodes, nodes, query_bundle)
        return self.reranker.postprocess_nodes(nodes, query_bundle)

    async def _answer(self, query_str: str, nodes) -> Tuple[str, list]:
        contents = [self.get_node_content(n) for n in nodes]
        context_str = "\n\n".join(f"### 文档{i}: {c}" for i, c in enumerate(contents))
        with trace("generation"):
            ret = await self.generation(self.llm, self.qa_template.format(context_str=context_str, query_str=query_str))
        return ret.text, contents

    async def generation_with_rerank_fusion(self, query_str: str) -> Dict[str, Any]:
        """Dense and content BM25 routes, each reranked on its own, fused by
        RRF into ``r_topk_1`` nodes; then one generation over the fused
        contexts (type 1), or one per route and the longer answer (type 2) or
        both concatenated, sparse first (type 3) (``pipeline.py:955-1007``)."""
        query_bundle = QueryBundle(query_str=query_str)
        dense_nodes = await self._rerank(await self.dense_retriever.aretrieve(query_bundle), query_bundle)
        with trace("sparse"):
            sparse_nodes = await self.sparse_retriever.aretrieve(query_bundle)
        sparse_nodes = await self._rerank(sparse_nodes, query_bundle)
        node_with_scores = HybridRetriever.reciprocal_rank_fusion([sparse_nodes, dense_nodes], topk=self.config.r_topk_1)
        if self.re_only:
            contents = [self.get_node_content(n) for n in node_with_scores]
            return {"answer": "", "nodes": node_with_scores, "contexts": contents}
        if self.config.rerank_fusion_type == 1:
            answer, contents = await self._answer(query_str, node_with_scores)
        else:
            sparse_answer, _ = await self._answer(query_str, sparse_nodes)
            dense_answer, contents = await self._answer(query_str, dense_nodes)
            if self.config.rerank_fusion_type == 2:
                answer = dense_answer if len(dense_answer) >= len(sparse_answer) else sparse_answer
            else:
                answer = sparse_answer + dense_answer
        return {"answer": answer, "nodes": node_with_scores, "contexts": contents}
