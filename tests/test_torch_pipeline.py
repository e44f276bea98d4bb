"""The port's default RAG path end to end against the JAX package's.

One small corpus, one tiny MiniCPM reranker (one JAX parameter tree, given
to the port through ``minicpm_from_jax``) and a recording stub LLM: both
``EasyRAGPipeline.run`` implementations must return the same nodes (corpus
positions and texts), the same contexts, reranker scores within atol 1e-4,
and send the same QA prompt. The queries cover the dual route, the dir filter
and a query past the resident term budget (the overflow gather path, K5's
plain version here). With ``tpu.local_llm_answer`` both pipelines answer with
their own on-device generator over one tiny saved Qwen2 checkpoint, and the
answers must be equal, also through each package's decode pool
(``tpu.local_llm_continuous``). The dense route (``retrieval_type`` 1 and 3,
``rerank_fusion_type`` 0-3, with ``re_only`` and with the stub LLM) takes one
tiny gte-Qwen2 tree, given to the port through ``gte_from_jax``: the same
nodes, contexts and prompts, the same route dispatch and RRF, and a reboot
from either package's saved index that embeds nothing. Each pipeline takes
its own package's config, `LLMRerank` and schema. A subprocess with ``jax``, ``jaxlib`` and ``easyrag_tpu``
blocked runs the port alone, including a generator loaded from a bf16
checkpoint, and an AST scan holds every port file to importing nothing of
either.
"""

import ast
import asyncio
import dataclasses
import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from easyrag_tpu import config as jconfig
from easyrag_tpu.corpus import tokenizer as jtokmod
from easyrag_tpu.models.minicpm import MiniCPMLayerWiseReranker as JaxReranker
from easyrag_tpu.models.qwen2 import GTEEmbedder as JaxEmbedder
from easyrag_tpu.pipeline import EasyRAGPipeline as JaxPipeline
from easyrag_tpu.rerankers import LLMRerank as JaxLLMRerank
from easyrag_tpu.schema import QueryBundle as JaxQueryBundle
from easyrag_tpu_torch import config as tconfig
from easyrag_tpu_torch.corpus import tokenizer as tokmod
from easyrag_tpu_torch.generation import CompletionResponse
from easyrag_tpu_torch.models.convert import gte_from_jax, minicpm_from_jax
from easyrag_tpu_torch.models.layers import DecoderConfig, quantize_layers_
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from easyrag_tpu_torch.rerankers import LLMRerank
from easyrag_tpu_torch.retrievers import HybridRetriever
from easyrag_tpu_torch.schema import QueryBundle
from test_torch_decode import tiny_causal_checkpoint  # noqa: F401  (a fixture)
from test_torch_embedder import ARCH as GTE_ARCH
from test_torch_embedder import BatchCharTok, jax_tree
from test_torch_minicpm import ARCH, CharTok, tiny_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOCS = {
    "director/scale.txt": (["运维", "扩容"], "CDU虚机扩容指南\nCDU虚机每次扩容的最大SC个数为15，步长为3。扩容前需检查资源池容量。\n\n\n"
                           "GSU虚机每次扩容的最大SC个数为5，步长为1。扩容需在维护窗口执行。\n"),
    "director/backup.txt": (["运维", "备份"], "数据备份说明\n系统支持全量备份和增量备份，备份文件存储在共享存储上。\n"),
    "director/alarm.txt": (["运维", "告警"], "告警处理\n资源池容量不足时系统产生告警，需扩容或清理资源。\n"),
    "umac/auth.txt": (["安全", "鉴权"], "鉴权配置\n用户鉴权失败时需要检查LDAP服务器连接，鉴权日志位于日志目录。\n"),
    "umac/log.txt": (["安全", "日志"], "日志说明\n日志目录保存鉴权日志和操作日志，日志按天滚动。\n"),
    "rcp/net.txt": (["网络", "配置"], "网络配置\n虚机网络配置需要检查交换机端口和VLAN，扩容后需重新配置网络。\n"),
}
QUERIES = [
    {"query": "CDU虚机扩容的最大SC个数是多少？"},
    {"query": "鉴权失败如何处理？", "document": "umac"},
    {"query": "扩容 备份 鉴权 日志 网络 告警 资源池 容量 交换机 端口 维护 窗口 存储"},  # > 8 terms
]


def make_corpus(root):
    for rel, (path, text) in DOCS.items():
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        with open(os.path.join(root, rel), "w", encoding="utf-8") as f:
            f.write(text)
    with open(os.path.join(root, "pathmap.json"), "w", encoding="utf-8") as f:
        json.dump({rel: path for rel, (path, _) in DOCS.items()}, f)
    return str(root)


class RecordingLLM:
    def __init__(self):
        self.prompts = []

    async def acomplete(self, prompt):
        self.prompts.append(prompt)
        return CompletionResponse(text=f"answer-{len(self.prompts)}")


def configs(**kw):
    """The same knobs as each package's ``EasyRAGConfig``: (JAX's, the port's)."""
    tpu = kw.pop("tpu", {})
    return tuple(m.EasyRAGConfig(**kw, tpu=m.TPUConfig(**tpu)) for m in (jconfig, tconfig))


@pytest.fixture
def offline_counter(monkeypatch):
    # the splitter's default counter would try to fetch a tiktoken table;
    # both pipelines chunk with the offline approximation instead
    for mod in (jtokmod, tokmod):
        monkeypatch.setattr(mod, "_counter", mod.approx_token_count)
        monkeypatch.setattr(mod, "_counter_name", "approx")


@pytest.mark.parametrize("side", ["left", "right"])
def test_run_matches_jax_pipeline(tmp_path, offline_counter, side):
    data_path = make_corpus(tmp_path / "corpus")
    cfg, _ = configs(
        data_path=data_path, chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2,
        r_topk=3, r_embed_bs=4, tpu=dict(use_pallas=False, max_query_terms=8, max_query_postings=2048),
    )
    _, port_cfg = configs(
        data_path=data_path, chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2,
        r_topk=3, r_embed_bs=4, tpu=dict(max_query_terms=8, max_query_postings=2048),
    )
    jcfg, params, params_np = tiny_params()
    opts = dict(start_layer=1, cutoff_layer=3, max_length=64)
    jax_llm, port_llm = RecordingLLM(), RecordingLLM()
    ref = JaxPipeline(
        cfg, llm=jax_llm,
        reranker=JaxLLMRerank(JaxReranker(jcfg, params, CharTok(side), **opts), top_n=3, embed_bs=4, embed_type=1),
    )
    scorer = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok(side), **opts)
    got = EasyRAGPipeline(
        port_cfg, llm=port_llm, reranker=LLMRerank(scorer, top_n=3, embed_bs=4, embed_type=1), device="cpu"
    )
    assert got.config.tpu.use_pallas  # the overflow query goes through K5's wrapper
    assert [n.text for n in got.nodes] == [n.text for n in ref.nodes]
    for q in QUERIES:
        a = asyncio.run(ref.run(dict(q)))
        b = asyncio.run(got.run(dict(q)))
        assert [n.node.idx for n in b["nodes"]] == [n.node.idx for n in a["nodes"]]
        assert [n.node.text for n in b["nodes"]] == [n.node.text for n in a["nodes"]]
        assert b["contexts"] == a["contexts"]
        np.testing.assert_allclose([n.score for n in b["nodes"]], [n.score for n in a["nodes"]], atol=1e-4, rtol=0)
        assert b["answer"] == a["answer"]
    assert port_llm.prompts == jax_llm.prompts
    # the long query overflowed the resident term budget into the gather path
    assert got._dual_retrieve(QueryBundle(query_str=QUERIES[2]["query"])) is None


def test_local_llm_answer_matches_jax_pipeline(tmp_path, offline_counter, tiny_causal_checkpoint):
    from easyrag_tpu_torch.generation import BatchingLocalLLM

    data_path = make_corpus(tmp_path / "corpus")
    cfg, port_cfg = configs(
        data_path=data_path, chunk_size=64, chunk_overlap=10, f_topk_2=3, f_topk_3=0, use_reranker=0,
        local_llm_name=tiny_causal_checkpoint, cache_path=str(tmp_path / "cache"),
        tpu=dict(use_pallas=False, local_llm_answer=True, local_llm_quant="", local_llm_max_new=4,
                 local_llm_gen_batch=2, local_llm_spec=3),
    )
    ref = JaxPipeline(cfg)
    got = EasyRAGPipeline(port_cfg, device="cpu")
    assert isinstance(got.llm, BatchingLocalLLM) and got.local_llm.spec_tokens == 3
    for n, q in enumerate(QUERIES[:2], start=1):
        a = asyncio.run(ref.run(dict(q)))
        b = asyncio.run(got.run(dict(q)))
        assert b["contexts"] == a["contexts"]
        assert b["answer"] == a["answer"] and b["answer"]
        assert got.llm.dispatches == n  # one batched generation per query
    assert got.local_llm_generate("w3 w1 w4") == ref.local_llm_generate("w3 w1 w4")


@pytest.mark.parametrize("spec", [0, 3])
def test_local_llm_continuous_matches_jax_pipeline(tmp_path, offline_counter, tiny_causal_checkpoint, spec):
    """With ``tpu.local_llm_continuous`` both pipelines answer through their
    own decode pool (two tiers) over one tiny saved Qwen2 checkpoint: the
    same contexts and answers, plain and speculative."""
    from easyrag_tpu_torch.generation import ContinuousBatchingLocalLLM

    data_path = make_corpus(tmp_path / "corpus")
    cfg, port_cfg = configs(
        data_path=data_path, chunk_size=64, chunk_overlap=10, f_topk_2=3, f_topk_3=0, use_reranker=0,
        local_llm_name=tiny_causal_checkpoint, cache_path=str(tmp_path / "cache"),
        tpu=dict(use_pallas=False, local_llm_answer=True, local_llm_quant="", local_llm_max_new=4,
                 local_llm_gen_batch=2, local_llm_spec=spec, local_llm_continuous=True, local_llm_chunk_steps=2,
                 local_llm_pool_tiers="256:1,512:1"),
    )
    ref = JaxPipeline(cfg)
    got = EasyRAGPipeline(port_cfg, device="cpu")
    assert isinstance(got.llm, ContinuousBatchingLocalLLM) and got.llm.model is got.local_llm
    assert [(t.bucket, t.slots) for t in got.llm.pool.tiers] == [(256, 1), (512, 1)]
    for q in QUERIES:
        a = asyncio.run(ref.run(dict(q)))
        b = asyncio.run(got.run(dict(q)))
        assert b["contexts"] == a["contexts"]
        assert b["answer"] == a["answer"] and b["answer"]
    assert got.llm.dispatches == got.llm.pool.chunks > 0


def test_flagship_preset_matches_jax_pipeline(tmp_path, offline_counter, tiny_causal_checkpoint):
    """``configs/four_tenant.yaml`` through both pipelines: the w8a8 MiniCPM
    reranker (one tiny tree, int8 leaves and ``act_quant``) behind
    ``LLMRerank`` with the preset's carried two-stage cascade (keep 32), and
    each package's own int4 generator over one tiny saved Qwen2 checkpoint
    answering. The same nodes, contexts and answers; reranker scores within
    atol 1e-4. Overridden for the tiny run: the corpus, the generator's
    directory and ``local_llm_max_new`` 4; JAX's warmup and compile cache,
    which the port does not have, are off."""
    from easyrag_tpu.models import hf_loader as jh
    from easyrag_tpu_torch.generation import BatchingLocalLLM

    preset = os.path.join(REPO, "configs", "four_tenant.yaml")
    overrides = {"data_path": make_corpus(tmp_path / "corpus"), "local_llm_name": tiny_causal_checkpoint,
                 "cache_path": str(tmp_path / "cache"), "tpu.local_llm_max_new": 4,
                 "tpu.local_llm_warmup": False, "tpu.compile_cache_dir": ""}
    cfg, port_cfg = jconfig.load_config(preset, overrides=overrides), tconfig.load_config(preset, overrides=overrides)
    assert (port_cfg.r_use_efficient, port_cfg.tpu.cascade_carry, port_cfg.tpu.reranker_quant,
            port_cfg.tpu.local_llm_quant) == (3, True, "w8a8", "int4")
    jcfg, params, params_np = tiny_params()
    qparams = jh.quantize_decoder_tree(params, "int8")
    qparams["heads"] = params["heads"]
    opts = dict(start_layer=1, cutoff_layer=3, max_length=64, efficient_layers=(2,), use_efficient=3)
    rerank = dict(top_n=cfg.r_topk, embed_bs=cfg.r_embed_bs, use_efficient=cfg.r_use_efficient,
                  cascade_keep=cfg.tpu.cascade_keep, cascade_carry=cfg.tpu.cascade_carry)
    ref = JaxPipeline(cfg, reranker=JaxLLMRerank(
        JaxReranker(dataclasses.replace(jcfg, act_quant=True), qparams, CharTok(), **opts), **rerank))
    scorer = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok(), **opts)
    quantize_layers_(scorer, port_cfg.tpu.reranker_quant)
    got = EasyRAGPipeline(port_cfg, reranker=LLMRerank(scorer, **rerank), device="cpu")
    assert isinstance(got.llm, BatchingLocalLLM) and "w_p" in got.local_llm.params["layers"][0]["mlp"]["down"]
    carried = []
    scorer.score_carried = (lambda f: lambda *a: carried.append(1) or f(*a))(scorer.score_carried)
    for q in QUERIES:
        a = asyncio.run(ref.run(dict(q)))
        b = asyncio.run(got.run(dict(q)))
        assert [n.node.idx for n in b["nodes"]] == [n.node.idx for n in a["nodes"]]
        assert b["contexts"] == a["contexts"]
        np.testing.assert_allclose([n.score for n in b["nodes"]], [n.score for n in a["nodes"]], atol=1e-4, rtol=0)
        assert b["answer"] == a["answer"] and b["answer"]
    assert len(carried) == len(QUERIES)  # stage 2 resumed from the carried hidden states


def dense_pair(tmp_path, side="right", **kw):
    """(JAX's pipeline, the port's, the port's embedder) on the dense route
    with one tiny gte-Qwen2 tree and one tiny MiniCPM reranker; each writes
    its dense index under its own cache path. JAX's embedder takes the
    einsum path, the port's K3's plain version: one function."""
    data_path = make_corpus(tmp_path / "corpus")
    knobs = dict(data_path=data_path, chunk_size=64, chunk_overlap=10, f_topk_1=5, f_topk_2=5, f_topk_3=2, f_topk=6,
                 r_topk=3, r_topk_1=4, r_embed_bs=4, **kw)
    cfg, _ = configs(cache_path=str(tmp_path / "jax"), tpu=dict(use_pallas=False), **knobs)
    _, port_cfg = configs(cache_path=str(tmp_path / "port"), **knobs)
    jcfg, params, params_np = tiny_params()
    opts = dict(start_layer=1, cutoff_layer=3, max_length=64)
    gcfg, gparams, gparams_np = jax_tree()
    ref = JaxPipeline(
        cfg, llm=RecordingLLM(), embed_model=JaxEmbedder(gcfg, gparams, BatchCharTok(), embed_type=1),
        reranker=JaxLLMRerank(JaxReranker(jcfg, params, CharTok(side), **opts), top_n=3, embed_bs=4, embed_type=1),
    )
    emb = gte_from_jax(DecoderConfig(**GTE_ARCH), gparams_np, "cpu", torch.float32, BatchCharTok(),
                       embed_type=1)
    scorer = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok(side), **opts)
    got = EasyRAGPipeline(port_cfg, llm=RecordingLLM(), embed_model=emb,
                          reranker=LLMRerank(scorer, top_n=3, embed_bs=4, embed_type=1), device="cpu")
    return ref, got, emb


def assert_runs_match(ref, got, queries=QUERIES):
    for q in queries:
        a = asyncio.run(ref.run(dict(q)))
        b = asyncio.run(got.run(dict(q)))
        assert [n.node.idx for n in b["nodes"]] == [n.node.idx for n in a["nodes"]]
        assert b["contexts"] == a["contexts"]
        np.testing.assert_allclose([n.score for n in b["nodes"]], [n.score for n in a["nodes"]], atol=1e-4, rtol=0)
        assert b["answer"] == a["answer"]
    assert got.llm.prompts == ref.llm.prompts


@pytest.mark.parametrize(
    "retrieval_type,fusion,re_only", [(3, 1, False), (3, 1, True), (1, 2, False), (3, 3, False), (3, 0, False)]
)
def test_dense_route_matches_jax_pipeline(tmp_path, offline_counter, retrieval_type, fusion, re_only):
    ref, got, emb = dense_pair(tmp_path, retrieval_type=retrieval_type, rerank_fusion_type=fusion, re_only=re_only)
    n = len(got.nodes)
    assert got.dense_retriever.index.num_docs == ref.dense_retriever.index.num_docs == n
    if retrieval_type == 1:
        assert got.retriever is got.dense_retriever
    else:
        assert isinstance(got.retriever, HybridRetriever) and got.retriever.topk == 6
    boot = dict(emb.stats)
    assert boot["batches"] == 1  # the whole corpus in one 128-row bucket
    assert_runs_match(ref, got)
    # every fused query embeds once; the knowledge path (fusion 0) never
    # queries the dense index it built, as in JAX (ROADMAP Queue 3)
    assert emb.stats["batches"] - boot["batches"] == (len(QUERIES) if fusion else 0)


def test_dense_index_reboots_from_either_artifact(tmp_path, offline_counter):
    ref, got, emb = dense_pair(tmp_path, retrieval_type=3, rerank_fusion_type=1)
    for cache in ("port", "jax"):
        before = emb.stats["batches"]
        again = EasyRAGPipeline(
            dataclasses.replace(got.config, cache_path=str(tmp_path / cache)), llm=RecordingLLM(),
            embed_model=emb, reranker=got.reranker, device="cpu",
        )
        assert emb.stats["batches"] == before  # loaded, not embedded
        if cache == "port":
            assert torch.equal(again.dense_retriever.index.matrix, got.dense_retriever.index.matrix)
        assert_runs_match(ref, again, QUERIES[:2])
        ref.llm.prompts.clear()
    before = emb.stats["batches"]
    stale = EasyRAGPipeline(dataclasses.replace(got.config, reindex=True), llm=RecordingLLM(), embed_model=emb,
                            reranker=got.reranker, device="cpu")
    assert emb.stats["batches"] == before + 1 and stale.dense_retriever.index.num_docs == len(got.nodes)


@pytest.mark.parametrize("retrieval_type", [1, 2, 3])
def test_hybrid_retriever_matches_jax(tmp_path, offline_counter, retrieval_type):
    from easyrag_tpu.retrievers import HybridRetriever as JaxHybrid

    ref, got, _ = dense_pair(tmp_path, retrieval_type=3, rerank_fusion_type=1)
    jr = JaxHybrid(ref.dense_retriever, ref.sparse_retriever, retrieval_type, topk=6)
    tr = HybridRetriever(got.dense_retriever, got.sparse_retriever, retrieval_type, topk=6)
    for q in QUERIES:
        filters, filter_dict = got.build_filters(q)
        jr.filters, jr.filter_dict, tr.filters, tr.filter_dict = filters, filter_dict, filters, filter_dict
        a, b = jr.retrieve(JaxQueryBundle(query_str=q["query"])), tr.retrieve(QueryBundle(query_str=q["query"]))
        assert [n.node.idx for n in b] == [n.node.idx for n in a] and len(b) > 0
        np.testing.assert_allclose([n.score for n in b], [n.score for n in a], atol=1e-5, rtol=0)
    bundles = [QueryBundle(query_str=q["query"]) for q in QUERIES]
    dirs = [got.build_filters(q)[0] for q in QUERIES]
    batch = got.dense_retriever.retrieve_batch(bundles, dirs)
    for nodes, bundle, d in zip(batch, bundles, dirs):
        got.dense_retriever.filters = d
        rows = got.dense_retriever.retrieve(bundle)
        assert [n.node.idx for n in nodes] == [n.node.idx for n in rows]
        np.testing.assert_allclose([n.score for n in nodes], [n.score for n in rows], atol=1e-5, rtol=0)


def test_rrf_replaces_the_representative_node():
    from easyrag_tpu_torch.schema import NodeWithScore, TextNode

    a, b, c = (TextNode(text=t) for t in "abc")
    first = [NodeWithScore(node=a, score=9.0), NodeWithScore(node=b, score=8.0)]
    later_b = NodeWithScore(node=TextNode(text="b"), score=1.0)
    second = [later_b, NodeWithScore(node=c, score=0.5)]
    fused = HybridRetriever.reciprocal_rank_fusion([first, second], topk=2)
    assert [n.node.text for n in fused] == ["b", "a"] and fused[0] is later_b
    assert fused[0].score == pytest.approx(1 / 62 + 1 / 61) and fused[1].score == pytest.approx(1 / 61)


def test_fusion_without_the_dense_route_is_refused(tmp_path, offline_counter):
    with pytest.raises(ValueError, match="retrieval_type 1 or 3"):
        EasyRAGPipeline(tconfig.EasyRAGConfig(data_path=make_corpus(tmp_path / "c"), use_reranker=0,
                                              rerank_fusion_type=1), device="cpu")


def test_unported_options_raise(tmp_path, offline_counter):
    data_path = make_corpus(tmp_path / "corpus")
    # split_type 1, HyDE, the corpus artifact and the compressor are ported:
    # each builds and answers (tests/test_torch_options.py holds them to JAX)
    for kw in ({"split_type": 1}, {"hyde": True, "hyde_merging": True}, {"index_artifact_path": str(tmp_path / "a")},
               {"compress_method": "bm25_extract"}):
        llm = RecordingLLM()
        pipe = EasyRAGPipeline(tconfig.EasyRAGConfig(data_path=data_path, **{"use_reranker": 0, **kw}), llm=llm,
                               device="cpu")
        out = asyncio.run(pipe.run(dict(QUERIES[0])))
        assert out["contexts"] and out["answer"] == f"answer-{len(llm.prompts)}"
    # sharded indexes are ported (tests/test_torch_sharded_pipeline.py): a
    # config's mesh takes distinct cards, so without one it raises, and a
    # mesh's model axis (tensor parallelism) is still refused where a model loads
    for tpu in (dict(shard_index=True, mesh_shape=[2]), dict(mesh_shape=[1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EasyRAGPipeline(tconfig.EasyRAGConfig(data_path=data_path, use_reranker=0, tpu=tconfig.TPUConfig(**tpu)),
                            device="cpu")
    from easyrag_tpu_torch.models.registry import load_embedder
    from easyrag_tpu_torch.parallel.mesh import data_model_mesh

    with pytest.raises(NotImplementedError, match="item 13"):
        load_embedder(str(tmp_path), mesh=data_model_mesh(2, model_parallel=2, devices=["cpu"] * 2), device="cpu")
    # the decode pool is ported; like JAX's it needs static shapes and the
    # on-device decoder, and says so before loading a model
    for tpu in (dict(local_llm_max_new=0), dict(local_llm_max_new=4, local_llm_backend="hf")):
        with pytest.raises(ValueError, match="local_llm_continuous needs"):
            EasyRAGPipeline(tconfig.EasyRAGConfig(
                data_path=data_path, use_reranker=0, local_llm_name="m",
                tpu=tconfig.TPUConfig(local_llm_answer=True, local_llm_continuous=True, **tpu)), device="cpu")
    # the registry loads an embedder or a reranker named in the config: a
    # name that is no local directory raises before any download
    for kw in ({"retrieval_type": 1}, {"rerank_fusion_type": 1, "retrieval_type": 3}, {"use_reranker": 2}):
        with pytest.raises(FileNotFoundError, match="no network egress"):
            EasyRAGPipeline(tconfig.EasyRAGConfig(data_path=data_path, **{"use_reranker": 0, **kw}), device="cpu")


BLOCKED_JAX_SCRIPT = textwrap.dedent(
    """
    import asyncio, json, os, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    sys.modules["easyrag_tpu"] = None
    sys.path.insert(0, {repo!r})
    import torch
    import chip_smoke  # noqa: F401  (importing the smoke script loads nothing of JAX)
    from easyrag_tpu_torch.config import EasyRAGConfig, TPUConfig
    from easyrag_tpu_torch.corpus.hierarchical import HierarchicalSplitter
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.rerankers import LLMRerank
    from easyrag_tpu_torch.models.layers import DecoderConfig
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker
    from easyrag_tpu_torch.generation import CompletionResponse
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline
    from easyrag_tpu_torch.models.yes_logit import YesLogitScorer  # noqa: F401
    from easyrag_tpu_torch.models.hf_loader import load_minicpm_reranker, params_from_state_dict  # noqa: F401
    from easyrag_tpu_torch import cli, eval, submit  # noqa: F401
    from easyrag_tpu_torch.models import registry, st_embedder  # noqa: F401
    from easyrag_tpu_torch.ops import chunkmax  # noqa: F401
    from easyrag_tpu_torch.models import decode_pool  # noqa: F401
    from easyrag_tpu_torch.serving import api, coalesce, webui  # noqa: F401
    from easyrag_tpu_torch import automerge, compressors, native  # noqa: F401
    from easyrag_tpu_torch.index import artifact  # noqa: F401
    from easyrag_tpu_torch.parallel import mesh as pmesh, multihost, sharded  # noqa: F401
    from easyrag_tpu_torch.corpus import html_text, ocr, zedx  # noqa: F401

    DOCS, QUERIES = json.loads({docs!r}), json.loads({queries!r})
    root = {tmp!r}
    for rel, (path, text) in DOCS.items():
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        with open(os.path.join(root, rel), "w", encoding="utf-8") as f:
            f.write(text)
    with open(os.path.join(root, "pathmap.json"), "w", encoding="utf-8") as f:
        json.dump({{rel: path for rel, (path, _) in DOCS.items()}}, f)

    class StubLLM:
        async def acomplete(self, prompt):
            return CompletionResponse(text="answer")

    class CharCut:  # one token per character: no jieba needed
        def cut(self, text):
            return list(text)

    ARCH = dict(vocab_size=96, hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                num_attention_heads=2, num_key_value_heads=2, scale_emb=12.0, scale_depth=1.4,
                dim_model_base=64.0)

    class Tok:
        bos_token_id, pad_token_id, padding_side = 1, 0, "right"
        def __call__(self, text, add_special_tokens=False, max_length=None, truncation=False):
            ids = [ord(c) % 94 + 2 for c in text]
            return {{"input_ids": ids[:max_length] if truncation and max_length else ids}}

    scorer = MiniCPMLayerWiseReranker(DecoderConfig(**ARCH), Tok(), start_layer=1, cutoff_layer=3,
                                      max_length=64, device="cpu", dtype=torch.float32)
    scorer.init_random_(torch.Generator().manual_seed(0))
    pipe = EasyRAGPipeline(
        EasyRAGConfig(data_path=root, chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2),
        llm=StubLLM(), reranker=LLMRerank(scorer, top_n=3, embed_bs=4, embed_type=1),
        sparse_tokenizer=CharCut(),
        splitter=SentenceSplitter(64, 10, token_counter=approx_token_count, sentence_splitter=lambda t: [t]),
        device="cpu",
    )
    out = [asyncio.run(pipe.run(dict(q))) for q in QUERIES]
    # the same pipeline with its indexes sharded over two shards on the CPU
    sharded_pipe = EasyRAGPipeline(
        EasyRAGConfig(data_path=root, chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2,
                      tpu=TPUConfig(shard_index=True)),
        llm=StubLLM(), reranker=LLMRerank(scorer, top_n=3, embed_bs=4, embed_type=1), sparse_tokenizer=CharCut(),
        splitter=SentenceSplitter(64, 10, token_counter=approx_token_count, sentence_splitter=lambda t: [t]),
        device="cpu", mesh=pmesh.make_mesh([2], devices=["cpu"] * 2),
    )
    sharded_out = [asyncio.run(sharded_pipe.run(dict(q))) for q in QUERIES]
    prepped = html_text.html_to_text("<p>扩容</p><table><tr><td>a</td></tr></table>")

    # the non-default options: hierarchical chunks with auto-merging, HyDE,
    # the compressor, int8 heavy storage, the corpus artifact (saved, then
    # booted from) and the native index builder
    def options_pipeline():
        split = [SentenceSplitter(n, 10, token_counter=approx_token_count, sentence_splitter=lambda t: [t])
                 for n in (256, 64)]
        return EasyRAGPipeline(
            EasyRAGConfig(data_path=root, chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2, split_type=1,
                          hyde=True, hyde_merging=True, compress_method="bm25_extract",
                          index_artifact_path=root + "_artifact", tpu=TPUConfig(sparse_heavy_dtype="int8")),
            llm=StubLLM(), reranker=LLMRerank(scorer, top_n=3, embed_bs=4, embed_type=1), sparse_tokenizer=CharCut(),
            splitter=HierarchicalSplitter(splitters=split), device="cpu",
        )
    opt = [asyncio.run(options_pipeline().run(dict(q))) for q in QUERIES]
    rebooted = [asyncio.run(options_pipeline().run(dict(q))) for q in QUERIES]

    # the generator: a tiny bf16 checkpoint (as real shards are) read back
    # as int4 with an int8 embedding table, fused, and one greedy generate
    from safetensors.torch import save_file
    from easyrag_tpu_torch.models import decode
    from easyrag_tpu_torch.models.hf_loader import load_decoder_params
    from easyrag_tpu_torch.models.quant import fuse_decode_tree
    ckpt = root + "_ckpt"
    os.makedirs(ckpt)
    gen = torch.Generator().manual_seed(0)
    shapes = {{"embed_tokens.weight": (64, 256), "norm.weight": (256,), "lm_head.weight": (64, 256)}}
    for i in range(2):
        for n, shape in (("self_attn.q_proj.weight", (256, 256)), ("self_attn.q_proj.bias", (256,)),
                         ("self_attn.k_proj.weight", (128, 256)), ("self_attn.k_proj.bias", (128,)),
                         ("self_attn.v_proj.weight", (128, 256)), ("self_attn.v_proj.bias", (128,)),
                         ("self_attn.o_proj.weight", (256, 256)), ("mlp.gate_proj.weight", (512, 256)),
                         ("mlp.up_proj.weight", (512, 256)), ("mlp.down_proj.weight", (256, 512)),
                         ("input_layernorm.weight", (256,)), ("post_attention_layernorm.weight", (256,))):
            shapes[f"model.layers.{{i}}.{{n}}"] = shape
    save_file({{n: (torch.randn(s, generator=gen) * 0.05).to(torch.bfloat16) for n, s in shapes.items()}},
              os.path.join(ckpt, "model.safetensors"))
    cfg = DecoderConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=1, attention_bias=True)
    params = fuse_decode_tree(load_decoder_params(ckpt, 2, dtype=torch.float32, quant="int4", device="cpu"))
    ids = torch.tensor([[0, 0, 5, 7, 9, 11, 3, 2]], dtype=torch.int32)
    toks = decode.generate_greedy(cfg, params, ids, (ids > 0).to(torch.int32), torch.tensor([63], dtype=torch.int32), 4)

    # the dense route: the same checkpoint as a gte embedder (K3's plain
    # version at the 128 bucket), RRF of both reranked routes
    import numpy as np
    from easyrag_tpu_torch.models.hf_loader import load_qwen2_embedder
    from easyrag_tpu_torch.models.qwen2 import GTEEmbedder
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(dict(vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                       num_attention_heads=2, num_key_value_heads=1), f)

    class BTok:
        padding_side = "right"
        def __call__(self, texts, max_length=None, padding=True, truncation=True, return_tensors="np"):
            rows = [[ord(c) % 62 + 2 for c in t][:max_length] for t in texts]
            ids = np.zeros((len(rows), max(map(len, rows))), np.int64)
            for i, r in enumerate(rows):
                ids[i, :len(r)] = r
            return {{"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}}

    gcfg, gparams = load_qwen2_embedder(ckpt, dtype=torch.float32, device="cpu")
    emb = GTEEmbedder(gcfg, gparams, BTok(), embed_type=1, device="cpu")
    dense = EasyRAGPipeline(
        EasyRAGConfig(data_path=root, chunk_size=64, chunk_overlap=10, f_topk_1=4, f_topk_2=8, f_topk_3=2,
                      retrieval_type=3, rerank_fusion_type=1, cache_path=root + "_cache"),
        llm=StubLLM(), embed_model=emb, reranker=LLMRerank(scorer, top_n=3, embed_bs=4, embed_type=1),
        sparse_tokenizer=CharCut(),
        splitter=SentenceSplitter(64, 10, token_counter=approx_token_count, sentence_splitter=lambda t: [t]),
        device="cpu",
    )
    fused = [asyncio.run(dense.run(dict(q))) for q in QUERIES]

    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "easyrag_tpu"))
    print(json.dumps({{"contexts": [len(o["contexts"]) for o in out], "answers": [o["answer"] for o in out],
                      "sharded": [o["contexts"] for o in sharded_out] == [o["contexts"] for o in out],
                      "sharded_class": type(sharded_pipe.sparse_retriever._resident).__name__,
                      "prepped": prepped,
                      "fused": sorted(params["layers"][0]["attn"]) + sorted(params["layers"][0]["mlp"]),
                      "embed": sorted(params["embed"]), "tokens": toks.tolist(), "jax_modules": loaded,
                      "rrf_nodes": [len(o["nodes"]) for o in fused], "embedded": emb.stats["batches"],
                      "options": [o["contexts"] for o in opt], "rebooted": [o["contexts"] for o in rebooted],
                      "native_builds": native.builds}}))
    """
)


def test_port_runs_with_jax_blocked(tmp_path):
    script = BLOCKED_JAX_SCRIPT.format(
        repo=REPO, tmp=str(tmp_path / "corpus"),
        docs=json.dumps(DOCS, ensure_ascii=False), queries=json.dumps(QUERIES, ensure_ascii=False),
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["jax_modules"] == []
    assert result["fused"] == ["o", "qkv", "down", "gateup"] and result["embed"] == ["scale", "w_q"]
    assert len(result["tokens"][0]) == 4 and all(0 <= t < 64 for t in result["tokens"][0])
    assert result["answers"] == ["answer"] * len(QUERIES)
    assert all(0 < n <= 3 for n in result["contexts"])
    assert all(0 < n <= 6 for n in result["rrf_nodes"]) and result["embedded"] == 1 + len(QUERIES)
    assert all(result["options"]) and result["rebooted"] == result["options"]
    assert result["native_builds"] >= 2  # both routes of the options pipeline's first boot
    assert result["sharded"] and result["sharded_class"] == "ShardedResidentSparseIndex"
    assert result["prepped"] == "扩容\n\n| a |\n| --- |\n"


def _imported_modules(path):
    """Every module a file imports, by its absolute dotted name (relative
    imports inside the port resolve to ``easyrag_tpu_torch``)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("easyrag_tpu_torch" if node.level else node.module or "")
    return names


def test_no_port_file_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(REPO, "easyrag_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 30
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("easyrag_tpu", "jax", "jaxlib")]
    assert bad == []


@pytest.mark.parametrize("name", ["easyrag.yaml", "four_tenant.yaml"])
def test_both_packages_parse_configs_alike(name):
    path = os.path.join(REPO, "configs", name)
    ref, got = jconfig.load_config(path), tconfig.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.extra == ref.extra


def test_entry_points_default_to_the_card(tmp_path, offline_counter, tiny_causal_checkpoint):
    from easyrag_tpu_torch.index.sparse import build_sparse_index
    from easyrag_tpu_torch.models.decode import TorchCausalLM
    from easyrag_tpu_torch.models.gemma import GemmaCostWiseReranker
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker
    from easyrag_tpu_torch.ops.bm25_resident import ResidentSparseIndex
    from easyrag_tpu_torch.retrievers import BM25Retriever

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    _, cfg = configs(data_path=make_corpus(tmp_path / "corpus"), use_reranker=0)
    no_card = pytest.raises(RuntimeError, match="no CUDA device")
    with no_card:
        EasyRAGPipeline(cfg, llm=RecordingLLM())
    with no_card:
        BM25Retriever([], tokenizer=None, stopwords=set())
    with no_card:
        ResidentSparseIndex(build_sparse_index([["a", "b"], ["b"]]))
    with no_card:
        TorchCausalLM(tiny_causal_checkpoint)
    tiny = DecoderConfig(vocab_size=8, hidden_size=8, intermediate_size=8, num_hidden_layers=1,
                         num_attention_heads=1, num_key_value_heads=1)
    with no_card:
        MiniCPMLayerWiseReranker(tiny, tokenizer=None)
    with no_card:
        GemmaCostWiseReranker(dataclasses.replace(tiny, gemma=True), tokenizer=None)
    assert EasyRAGPipeline(cfg, llm=RecordingLLM(), device="cpu").device.type == "cpu"
