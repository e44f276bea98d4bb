"""The port's batch entry points against its per-query ``run`` and against
the JAX package's batch entry points, on the CPU in f32.

``run_retrieval_batch`` over 67 queries (so a 64-row batch and a 3-row tail
run): the sparse dual route, with a dir filter, a filter that never matches,
a query with no hit and one past the resident term budget (the gather path,
K5's plain version); and the fusion route (``retrieval_type`` 3,
``rerank_fusion_type`` 1) with a deterministic embedder. Each batch row must
give ``run``'s contexts and exactly its scores, and the JAX package's batch
row's contexts and scores. The integer-class fusion and RRF equal the
classmethods; ``retrieve_batch`` and ``get_scores(docs=...)`` equal JAX's;
``run_answers_batch`` gives the sequential ``run``'s answers, nodes and
contexts, and JAX's.
"""

import asyncio
import copy

import numpy as np
import pytest
import torch

from easyrag_tpu.pipeline import EasyRAGPipeline as JaxPipeline
from easyrag_tpu.retrievers import BM25Retriever as JaxBM25Retriever
from easyrag_tpu.schema import QueryBundle as JaxQueryBundle
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from easyrag_tpu_torch.retrievers import HybridRetriever
from easyrag_tpu_torch.schema import NodeWithScore, QueryBundle, TextNode
from easyrag_tpu_torch.utils import events
from test_pipeline import FakeEmbedder
from test_torch_decode import tiny_causal_checkpoint  # noqa: F401  (a fixture)
from test_torch_pipeline import QUERIES, configs, make_corpus, offline_counter  # noqa: F401  (a fixture)

torch.set_num_threads(1)

BASE = [
    {"query": "CDU虚机扩容的最大SC个数是多少？"},
    {"query": "鉴权失败如何处理？", "document": "umac"},
    {"query": "备份"},
    {"query": "完全无关的查询词组xyzq"},
    {"query": "备份", "document": "不存在的目录"},  # a filter that never matches
    dict(QUERIES[2]),  # past max_query_terms=8: the gather path
]
STREAM = [dict(BASE[i % len(BASE)]) for i in range(67)]


def pipelines(tmp_path, **kw):
    """(JAX's, the port's) pipelines on one corpus and config."""
    data_path = make_corpus(tmp_path / "corpus")
    tpu = dict(max_query_terms=8, max_query_postings=2048, **kw.pop("tpu", {}))
    cfg, port_cfg = configs(data_path=data_path, re_only=True, use_reranker=0, chunk_size=64, chunk_overlap=10,
                            f_topk_2=8, f_topk_3=2, cache_path=str(tmp_path / "cache"), tpu=tpu, **kw)
    embed = FakeEmbedder() if cfg.retrieval_type != 2 else None
    return JaxPipeline(cfg, embed_model=embed), EasyRAGPipeline(port_cfg, embed_model=embed, device="cpu")


def rows(results):
    return [(r["contexts"], [n.node.idx for n in r["nodes"]], [n.score for n in r["nodes"]]) for r in results]


@pytest.mark.parametrize("route", ["sparse", "fusion"])
def test_retrieval_batch_matches_per_query_and_jax(tmp_path, offline_counter, route):  # noqa: F811
    kw = dict(retrieval_type=3, rerank_fusion_type=1, f_topk=6, f_topk_1=4, r_topk_1=4) if route == "fusion" else {}
    ref, got = pipelines(tmp_path, **kw)
    assert got._dual_scorer is not None
    batch = asyncio.run(got.run_retrieval_batch([dict(q) for q in STREAM]))
    singles = [asyncio.run(got.run(dict(q))) for q in STREAM]
    assert any(r["contexts"] for r in batch) and any(not r["contexts"] for r in batch)
    assert rows(batch) == rows(singles)  # the same nodes and exactly the same scores
    want = asyncio.run(ref.run_retrieval_batch([dict(q) for q in STREAM]))
    for b, w in zip(batch, want, strict=True):
        assert b["contexts"] == w["contexts"]
        assert [n.node.idx for n in b["nodes"]] == [n.node.idx for n in w["nodes"]]
        np.testing.assert_allclose([n.score for n in b["nodes"]], [n.score for n in w["nodes"]], rtol=1e-6)


def test_retrieval_batch_spans(tmp_path, offline_counter):  # noqa: F811
    """One call with the overflowing question: one ``request``; one
    ``retrieval_batch`` whose children are exactly its four stages; then
    ``fusion`` and ``contexts``; every span of the one request."""
    _, got = pipelines(tmp_path)
    spans = []
    off = events.on(lambda kind, p: spans.append(p) if kind == "timing" and p["name"] != "gc" else None)
    try:
        batch = asyncio.run(got.run_retrieval_batch([dict(q) for q in BASE]))
    finally:
        off()
    s = {}
    for p in spans:
        s.setdefault(p["name"], []).append(p)
    assert sorted(s) == sorted(["request", "retrieval_batch", "retrieval_batch.prep", "retrieval_batch.stream",
                                "retrieval_batch.nodes", "retrieval_batch.overflow", "fusion", "contexts"])
    assert all(len(v) == 1 for v in s.values())
    s = {k: v[0] for k, v in s.items()}
    request, rb = s["request"], s["retrieval_batch"]
    assert request["parent"] is None and all(p["request"] == request["id"] for p in s.values())
    kids = [p["name"] for p in spans if p["parent"] == rb["id"]]
    assert kids == ["retrieval_batch.prep", "retrieval_batch.stream", "retrieval_batch.nodes",
                    "retrieval_batch.overflow"]
    for name in kids:
        assert rb["start"] <= s[name]["start"] <= s[name]["end"] <= rb["end"]
    for name in ("retrieval_batch", "fusion", "contexts"):
        assert s[name]["parent"] == request["id"]
    assert rb["end"] <= s["fusion"]["start"] <= s["fusion"]["end"] <= s["contexts"]["start"]
    assert s["contexts"]["end"] <= request["end"]
    assert rows(batch) == rows([asyncio.run(got.run(dict(q))) for q in BASE])


def test_retrieve_batch_matches_jax(tmp_path, offline_counter):  # noqa: F811
    ref, got = pipelines(tmp_path)
    bundles = [QueryBundle(query_str=q["query"]) for q in STREAM]
    filters = [got.build_filters(q)[1] for q in STREAM]
    lists = got.sparse_retriever.retrieve_batch(bundles, filters)
    want = ref.sparse_retriever.retrieve_batch([JaxQueryBundle(query_str=q["query"]) for q in STREAM], filters)
    for a, b in zip(lists, want, strict=True):
        assert [n.node.idx for n in a] == [n.node.idx for n in b]
        np.testing.assert_allclose([n.score for n in a], [n.score for n in b], rtol=1e-6)
    # the gather path served the long query; the resident path the others
    assert [n.node.idx for n in lists[5]] == [n.node.idx for n in got.sparse_retriever.retrieve(bundles[5])]


def test_get_scores_matches_jax(tmp_path, offline_counter):  # noqa: F811
    ref, got = pipelines(tmp_path)
    q = "鉴权 日志 扩容"
    np.testing.assert_allclose(got.sparse_retriever.get_scores(q), ref.sparse_retriever.get_scores(q), rtol=1e-12)
    docs = ["鉴权日志位于日志目录", "扩容需要检查资源池", "无关的文本", "鉴权失败"]
    want = JaxBM25Retriever.get_scores(ref.sparse_retriever, q, docs=docs)
    np.testing.assert_allclose(got.sparse_retriever.get_scores(q, docs=docs), want, rtol=1e-12)


def test_fast_fusion_and_rrf_match_the_classmethods(tmp_path, offline_counter):  # noqa: F811
    _, got = pipelines(tmp_path)
    nodes = got.nodes
    clone = copy.copy(nodes[0])  # node 0's content at another corpus position
    clone.idx = len(nodes)
    got.nodes = nodes + [clone]
    got._ctx_classes = None
    a = [NodeWithScore(node=nodes[0], score=0.9), NodeWithScore(node=nodes[1], score=0.7)]
    b = [NodeWithScore(node=clone, score=0.8), NodeWithScore(node=nodes[2], score=0.7)]
    fast, ref = got._fuse_corpus_lists([a, b]), HybridRetriever.fusion([a, b])
    assert [(n.node.idx, n.score) for n in fast] == [(n.node.idx, n.score) for n in ref]
    assert all(n.node is not clone for n in fast)
    stray = NodeWithScore(node=TextNode(text="独一无二", metadata={}), score=1.0)
    assert [n.node.text for n in got._fuse_corpus_lists([a, [stray]])] == [
        n.node.text for n in HybridRetriever.fusion([a, [stray]])]

    def fresh(lst):
        return [NodeWithScore(node=n.node, score=n.score) for n in lst]

    r1 = [NodeWithScore(node=nodes[i], score=s) for i, s in ((0, 1.0), (1, 0.9), (2, 0.8))]
    r2 = [NodeWithScore(node=nodes[i], score=s) for i, s in ((2, 1.0), (0, 0.9))]
    want = HybridRetriever.reciprocal_rank_fusion([fresh(r1), fresh(r2)], topk=4)
    fast = got._rrf_corpus_lists([fresh(r1), fresh(r2)], topk=4)
    assert [(n.node.idx, n.score) for n in fast] == [(n.node.idx, n.score) for n in want]
    assert [n.node.text for n in got._rrf_corpus_lists([fresh(r1), [stray]], topk=4)] == [
        n.node.text for n in HybridRetriever.reciprocal_rank_fusion([fresh(r1), [stray]], topk=4)]


def test_run_answers_batch_matches_sequential_and_jax(tmp_path, offline_counter, tiny_causal_checkpoint):  # noqa: F811
    kw = dict(f_topk_2=3, f_topk_3=1, local_llm_name=tiny_causal_checkpoint,
              tpu=dict(local_llm_answer=True, local_llm_quant="", local_llm_max_new=4, local_llm_gen_batch=2))
    data_path = make_corpus(tmp_path / "corpus")
    cfg, port_cfg = configs(data_path=data_path, use_reranker=0, chunk_size=64, chunk_overlap=10,
                            cache_path=str(tmp_path / "cache"), **{**kw, "tpu": dict(kw["tpu"], use_pallas=False)})
    ref, got = JaxPipeline(cfg), EasyRAGPipeline(port_cfg, device="cpu")
    queries = [dict(q) for q in BASE[:4]]
    batch = asyncio.run(got.run_answers_batch([dict(q) for q in queries]))
    seq = [asyncio.run(got.run(dict(q))) for q in queries]
    assert any(r["contexts"] for r in batch) and all(r["answer"] for r in batch)
    assert [r["answer"] for r in batch] == [r["answer"] for r in seq]
    assert rows(batch) == rows(seq)
    want = asyncio.run(ref.run_answers_batch([dict(q) for q in queries]))
    assert [r["answer"] for r in batch] == [r["answer"] for r in want]
    assert [r["contexts"] for r in batch] == [r["contexts"] for r in want]
    # an answer LLM other than the local generator: the sequential loop
    got.llm = type("Other", (), {"acomplete": None})()
    assert not got._answers_via_local_llm()
