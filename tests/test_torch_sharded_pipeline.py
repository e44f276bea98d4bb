"""``tpu.shard_index`` in the port's pipeline on the CPU: the analogues of
``tests/test_sharded_pipeline.py``.

The corpus is ``tests/test_torch_pipeline.py``'s six files and 230 short
filler files (about 240 chunks: four shard ranges of 64 docs at D = 4). A
4-shard mesh on a repeated ``cpu`` device is injected into the port's
``EasyRAGPipeline`` (``mesh=``); the JAX package's pipeline takes the same
config with ``tpu.mesh_shape: [4]`` on its virtual CPU devices. The sparse
dual route through ``run`` (with a dir filter, a filter that never matches
and a query past the resident term budget: the gather path), the same route
through ``run_retrieval_batch`` over 67 queries (a 64-row batch and a tail),
and the dense route (``retrieval_type`` 3, ``rerank_fusion_type`` 1, the
artifact reboot) must give the port's single-chip pipeline's contexts and
scores, and JAX's sharded pipeline's contexts. With ``shard_index`` off the
single-chip classes stay.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from easyrag_tpu.pipeline import EasyRAGPipeline as JaxPipeline
from easyrag_tpu_torch.ops.bm25_resident import ResidentSparseIndex
from easyrag_tpu_torch.parallel.mesh import make_mesh
from easyrag_tpu_torch.parallel.sharded import ShardedDenseIndex, ShardedResidentSparseIndex
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from test_pipeline import FakeEmbedder
from test_torch_pipeline import DOCS, QUERIES, configs, make_corpus, offline_counter  # noqa: F401  (a fixture)

torch.set_num_threads(1)

SHARDED_TPU = dict(mesh_shape=[4], mesh_axis_names=["data"], shard_index=True)
BASE = [
    {"query": "CDU虚机扩容的最大SC个数是多少？"},
    {"query": "鉴权失败如何处理？", "document": "umac"},
    {"query": "备份", "document": "不存在的目录"},  # a filter that never matches
    dict(QUERIES[2]),  # past max_query_terms=8: the gather path
]
FUSION = dict(retrieval_type=3, rerank_fusion_type=1, f_topk=6, f_topk_1=4, r_topk_1=4)
WORDS = sorted({text[i : i + 2] for _, text in DOCS.values() for i in range(len(text) - 1)
                if all("\u4e00" <= c <= "\u9fff" for c in text[i : i + 2])})


def sharded_corpus(root, n_fill=230):
    """``make_corpus``'s files and ``n_fill`` filler files of 12 two-character
    words each, drawn from the corpus's own text with a seed."""
    make_corpus(root)
    rng = np.random.default_rng(0)
    with open(os.path.join(root, "pathmap.json"), encoding="utf-8") as f:
        pathmap = json.load(f)
    for i in range(n_fill):
        pkg = ("director", "umac", "rcp")[i % 3]
        rel = f"{pkg}/fill{i}.txt"
        with open(os.path.join(root, rel), "w", encoding="utf-8") as f:
            f.write(f"说明{i}\n" + "".join(rng.choice(WORDS, size=12)) + "。\n")
        pathmap[rel] = [pkg, f"说明{i}"]
    with open(os.path.join(root, "pathmap.json"), "w", encoding="utf-8") as f:
        json.dump(pathmap, f)
    return str(root)


def three_pipelines(tmp_path, tpu_extra=None, **kw):
    """(JAX's sharded, the port's sharded, the port's single-chip) pipelines
    on one corpus; each keeps its own dense artifact."""
    data_path = sharded_corpus(tmp_path / "corpus")
    base = dict(data_path=data_path, re_only=True, use_reranker=0, chunk_size=64, chunk_overlap=10, f_topk_2=8,
                f_topk_3=2, **kw)
    tpu = dict(use_pallas=False, max_query_terms=8, max_query_postings=2048, **(tpu_extra or {}))
    jcfg, cfg = configs(cache_path=str(tmp_path / "cache_j"), tpu={**tpu, **SHARDED_TPU}, **base)
    _, cfg1 = configs(cache_path=str(tmp_path / "cache_1"), tpu=tpu, **base)
    embed = FakeEmbedder() if base.get("retrieval_type", 2) != 2 else None
    mesh = make_mesh([4], devices=["cpu"] * 4)
    return (JaxPipeline(jcfg, embed_model=embed),
            EasyRAGPipeline(cfg, embed_model=embed, device="cpu", mesh=mesh),
            EasyRAGPipeline(cfg1, embed_model=embed, device="cpu"))


def scores(result):
    return [n.score for n in result["nodes"]]


def test_sharded_sparse_pipeline_matches_single_chip(tmp_path, offline_counter):  # noqa: F811
    ref, sharded, single = three_pipelines(tmp_path)
    assert isinstance(sharded.sparse_retriever._resident, ShardedResidentSparseIndex)
    assert isinstance(sharded.path_retriever._resident, ShardedResidentSparseIndex)
    assert len(sharded.sparse_retriever._resident.shards) == 4  # every shard holds docs
    assert sharded._dual_scorer is None  # the fused dual scorer is single-chip
    for q in BASE:
        got = asyncio.run(sharded.run(dict(q)))
        one = asyncio.run(single.run(dict(q)))
        assert got["contexts"] == one["contexts"]
        assert scores(got) == scores(one)  # bit for bit
        want = asyncio.run(ref.run(dict(q)))
        assert got["contexts"] == want["contexts"]
        np.testing.assert_allclose(scores(got), scores(want), rtol=1e-6)
    assert asyncio.run(sharded.run(dict(BASE[0])))["contexts"]  # not vacuous


def test_sharded_sparse_batch_matches_single_chip(tmp_path, offline_counter):  # noqa: F811
    ref, sharded, single = three_pipelines(tmp_path)
    stream = [dict(BASE[i % len(BASE)]) for i in range(67)]  # a 64-row batch and a 3-row tail
    got = asyncio.run(sharded.run_retrieval_batch([dict(q) for q in stream]))
    one = asyncio.run(single.run_retrieval_batch([dict(q) for q in stream]))
    want = asyncio.run(ref.run_retrieval_batch([dict(q) for q in stream]))
    assert all(r["contexts"] for r in got)
    for g, o, w in zip(got, one, want, strict=True):
        assert g["contexts"] == o["contexts"] == w["contexts"]
        assert scores(g) == scores(o)
    # each batch row equals the sharded pipeline's own run
    for q, g in zip(stream[:4], got[:4]):
        assert asyncio.run(sharded.run(dict(q)))["contexts"] == g["contexts"]


@pytest.mark.parametrize("index_dtype", ["float32", "int8"])
def test_sharded_dense_pipeline_matches_single_chip(tmp_path, offline_counter, index_dtype):  # noqa: F811
    ref, sharded, single = three_pipelines(tmp_path, tpu_extra=dict(index_dtype=index_dtype), **FUSION)
    assert isinstance(sharded.dense_retriever.index, ShardedDenseIndex)
    assert len(sharded.dense_retriever.index.shards) == 4
    queries = [dict(q) for q in BASE[:3]] + [{"query": "备份"}]
    for q in queries:
        got = asyncio.run(sharded.run(dict(q)))
        assert got["contexts"] == asyncio.run(single.run(dict(q)))["contexts"]
        assert got["contexts"] == asyncio.run(ref.run(dict(q)))["contexts"]
    batch = asyncio.run(sharded.run_retrieval_batch([dict(q) for q in queries]))
    assert [r["contexts"] for r in batch] == [r["contexts"] for r in
                                              asyncio.run(single.run_retrieval_batch([dict(q) for q in queries]))]
    assert [r["contexts"] for r in batch] == [r["contexts"] for r in
                                              asyncio.run(ref.run_retrieval_batch([dict(q) for q in queries]))]
    # a reboot reads the saved artifact on the host, shards it, embeds nothing
    class NoEmbed(FakeEmbedder):
        def get_text_embeddings(self, texts):
            raise AssertionError("the reboot embedded the corpus")

    again = EasyRAGPipeline(sharded.config, embed_model=NoEmbed(), device="cpu", mesh=sharded.mesh)
    assert isinstance(again.dense_retriever.index, ShardedDenseIndex)
    assert [asyncio.run(again.run(dict(q)))["contexts"] for q in queries] == [r["contexts"] for r in batch]


def test_shard_index_off_keeps_single_chip_classes(tmp_path, offline_counter):  # noqa: F811
    _, cfg = configs(data_path=make_corpus(tmp_path / "corpus"), re_only=True, use_reranker=0, f_topk_3=2,
                     tpu=dict(use_pallas=False, max_query_postings=2048, mesh_shape=[4], mesh_axis_names=["data"]))
    pipeline = EasyRAGPipeline(cfg, device="cpu", mesh=make_mesh([4], devices=["cpu"] * 4))
    assert pipeline.mesh.shape == {"data": 4}
    assert isinstance(pipeline.sparse_retriever._resident, ResidentSparseIndex)
    assert pipeline._dual_scorer is not None
