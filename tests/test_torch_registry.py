"""The port's model registry against the JAX package's, on tiny checkpoints
built offline (``tests/test_checkpoint_boot.py``'s and the port tests'
fixtures): each name branch gives the same kind of model with the same
settings and, where both load bf16 weights, scores or embeddings within
bf16 roundings of JAX's. A pipeline booted from checkpoint directories only
gives JAX's nodes and contexts.
"""

import asyncio
import dataclasses
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyrag_tpu.models import registry as jreg
from easyrag_tpu.pipeline import EasyRAGPipeline as JaxPipeline
from easyrag_tpu_torch.models import registry as reg
from easyrag_tpu_torch.models.gemma import GemmaCostWiseReranker
from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker
from easyrag_tpu_torch.models.qwen2 import GTEEmbedder
from easyrag_tpu_torch.models.st_embedder import STEmbedder
from easyrag_tpu_torch.models.yes_logit import YesLogitScorer
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from easyrag_tpu_torch.rerankers import LLMRerank, SentenceTransformerRerank
from test_checkpoint_boot import minicpm_checkpoint, sharded_gte_checkpoint  # noqa: F401  (fixtures)
from test_torch_decode import tiny_causal_checkpoint  # noqa: F401  (a fixture)
from test_torch_embedder import tiny_gte_checkpoint  # noqa: F401  (a fixture)
from test_torch_gemma import gemma_checkpoint  # noqa: F401  (a fixture)
from test_torch_pipeline import configs, offline_counter  # noqa: F401  (a fixture)

torch.set_num_threads(1)

PAIRS = [("w1 w2", "w1 w2 w3 w4"), ("w5", "w6 w7 w8"), ("w9 w9", "w3 w9 w12 w1 w5")]
TEXTS = ["w1 w2 w3", "w4 w5 w6 w7", "w30 w2"]


def close_scores(got, want, rel=0.05):
    """Both sides load bf16 weights and compute in bf16, rounding at other
    places: within ``rel`` of the scores' scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("quant", ["", "int8", "w8a8", "w4a8"])
def test_gte_branch_matches_jax(tiny_gte_checkpoint, quant):  # noqa: F811
    ref = jreg.load_embedder(tiny_gte_checkpoint, embed_type=1, quant=quant)
    got = reg.load_embedder(tiny_gte_checkpoint, embed_type=1, quant=quant, device="cpu")
    assert isinstance(got, GTEEmbedder) and got.embed_batch_size == ref.embed_batch_size == 128
    assert got.embed_type == 1 and got.cfg.act_quant == ref.cfg.act_quant == (quant in ("w8a8", "w4a8"))
    a, b = got.get_text_embeddings(TEXTS), np.asarray(ref.get_text_embeddings(TEXTS))
    assert ((a * b).sum(axis=1) > 0.999).all()  # unit vectors, bf16 apart


def test_minicpm_branch_matches_jax(minicpm_checkpoint):  # noqa: F811
    ref = jreg.load_reranker(minicpm_checkpoint, top_n=2, embed_bs=4, embed_type=0)
    got = reg.load_reranker(minicpm_checkpoint, top_n=2, embed_bs=4, embed_type=0, device="cpu")
    assert isinstance(got, LLMRerank) and isinstance(got.scorer, MiniCPMLayerWiseReranker)
    scorer = got.scorer
    # the checkpoint's tokenizer declares right padding; the cutoff is clamped to its 3 layers
    assert scorer.padding_side == ref.scorer.padding_side == "right"
    assert scorer.start_layer == ref.scorer.start_layer == 1
    assert scorer.cutoff_layer == ref.scorer.cutoff_layer == 3
    assert (got.top_n, got.embed_bs, got.use_efficient) == (2, 4, 0)
    # the layerwise heads of layers 1-3 were read
    assert (scorer.heads[1:4].abs().sum(-1) > 0).all() and not scorer.heads[0].any()
    close_scores(scorer.score_pairs(PAIRS)[0], ref.scorer.score_pairs(PAIRS)[0])
    eff = reg.load_reranker(minicpm_checkpoint, top_n=2, embed_bs=4, use_efficient=1, device="cpu")
    jeff = jreg.load_reranker(minicpm_checkpoint, top_n=2, embed_bs=4, use_efficient=1)
    assert eff.scorer.efficient_layers == jeff.scorer.efficient_layers == (3,)
    assert eff.use_efficient == eff.scorer.use_efficient == 1
    carry = reg.load_reranker(minicpm_checkpoint, use_efficient=3, cascade_keep=8, cascade_carry=True,
                              quant="w8a8", device="cpu")
    assert carry.cascade_keep == 8 and carry.cascade_carry and carry.scorer.cfg.act_quant


@pytest.mark.parametrize("use_efficient", [1, 3])
def test_gemma_branch_matches_jax(tmp_path, gemma_checkpoint, use_efficient):  # noqa: F811
    model_dir = str(tmp_path / "bge-reranker-v2.5-gemma2-lightweight-tiny")
    shutil.copytree(gemma_checkpoint, model_dir)
    ref = jreg.load_reranker(model_dir, top_n=2, embed_bs=4, use_efficient=use_efficient)
    got = reg.load_reranker(model_dir, top_n=2, embed_bs=4, use_efficient=use_efficient, device="cpu")
    assert isinstance(got.scorer, GemmaCostWiseReranker) and got.scorer.padding_side == "right"
    # the cascade (3) is kept, the judge-layer exit (1) is not
    assert got.use_efficient == ref.use_efficient == (3 if use_efficient == 3 else 0)
    # JAX's scorer keeps the reference's cutoff 28; the tiny checkpoint has 4 layers
    got.scorer.cutoff_layer = ref.scorer.cutoff_layer = 4
    close_scores(got.scorer.score_pairs(PAIRS)[0], ref.scorer.score_pairs(PAIRS)[0])


def test_yes_logit_fallback_matches_jax(tiny_causal_checkpoint):  # noqa: F811
    ref = jreg.load_reranker(tiny_causal_checkpoint, top_n=2, embed_bs=4, use_efficient=3)
    got = reg.load_reranker(tiny_causal_checkpoint, top_n=2, embed_bs=4, use_efficient=3, device="cpu")
    assert isinstance(got.scorer, YesLogitScorer)
    assert got.use_efficient == ref.use_efficient == 0  # no cascade on a full-depth scorer
    close_scores(got.scorer.score_pairs(PAIRS)[0], ref.scorer.score_pairs(PAIRS)[0])


def test_missing_path_and_mesh_raise(tiny_gte_checkpoint):  # noqa: F811
    for port, jax_fn, name in ((reg.load_embedder, jreg.load_embedder, "Alibaba-NLP/gte-Qwen2-7B-instruct"),
                               (reg.load_reranker, jreg.load_reranker, "BAAI/bge-reranker-v2-minicpm-layerwise")):
        with pytest.raises(FileNotFoundError) as got:
            port(name, device="cpu")
        with pytest.raises(FileNotFoundError) as want:
            jax_fn(name)
        assert str(got.value) == str(want.value) and "no network egress" in str(got.value)
    # a model axis of 2 loads the gte embedder tensor-parallel (it used to be refused)
    from easyrag_tpu_torch.models.layers import tp_devices
    from easyrag_tpu_torch.parallel.mesh import data_model_mesh

    mesh = data_model_mesh(2, model_parallel=2, devices=["cpu"] * 2)
    got = reg.load_embedder(tiny_gte_checkpoint, mesh=mesh, device="cpu")
    assert isinstance(got, GTEEmbedder) and tp_devices(got.params) == mesh.model_devices()
    assert got.get_text_embeddings(TEXTS).shape == (len(TEXTS), 32)


class FakeSentenceTransformer:
    """Records the prompts and encode calls; each text maps to a seeded
    unit vector."""

    def __init__(self, model_dir, trust_remote_code=False, prompts=None):
        self.model_dir, self.prompts, self.calls = model_dir, prompts, []

    def encode(self, texts, prompt_name=None, normalize_embeddings=False):
        self.calls.append((list(texts), prompt_name))
        rows = [np.random.default_rng(sum(map(ord, self.prompts[prompt_name] + t))).normal(size=8) for t in texts]
        rows = np.stack(rows)
        return rows / np.linalg.norm(rows, axis=1, keepdims=True) if normalize_embeddings else rows


class FakeCrossEncoder:
    def __init__(self, model, max_length=512, trust_remote_code=False):
        self.model = model

    def predict(self, pairs):
        return np.asarray([len(q) - len(d) for q, d in pairs], dtype=np.float32)


def test_sentence_transformer_branches(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sentence_transformers", types.SimpleNamespace(
        SentenceTransformer=FakeSentenceTransformer, CrossEncoder=FakeCrossEncoder))
    model_dir = str(tmp_path / "bge-small-zh")
    (tmp_path / "bge-small-zh").mkdir()
    got = reg.load_embedder(model_dir, embed_type=2, device="cpu")
    ref = jreg.load_embedder(model_dir, embed_type=2)
    assert isinstance(got, STEmbedder) and got.embed_type == 2
    assert got.model.prompts == ref.model.prompts and got.model.prompts["query"].startswith("为这个句子")
    np.testing.assert_array_equal(got.get_query_embedding("问题"), ref.get_query_embedding("问题"))
    np.testing.assert_array_equal(got.get_text_embeddings(TEXTS), ref.get_text_embeddings(TEXTS))
    assert got.model.calls == [(["问题"], "query"), (TEXTS, "text")]
    rr = reg.load_reranker(model_dir, top_n=3, use_st=True, device="cpu")
    assert isinstance(rr, SentenceTransformerRerank) and rr.top_n == 3 and rr._model.model == model_dir


def test_pipeline_boots_from_checkpoint_dirs_like_jax(tmp_path, offline_counter, sharded_gte_checkpoint,  # noqa: F811
                                                      minicpm_checkpoint):  # noqa: F811
    """The dense route and the LLM rerank booted from checkpoint directories
    through the registry (``tests/test_checkpoint_boot.py:212``'s scenario,
    with three files): the same nodes and contexts as JAX's pipeline."""
    root = tmp_path / "corpus"
    (root / "director").mkdir(parents=True)
    docs = {"a": "w1 w2 w3\nw1 w2 w3 w4 w5。\n", "b": "w6 w7\nw6 w7 w8 w9。\n", "c": "w10 w11\nw3 w12 w13。\n"}
    for name, text in docs.items():
        (root / "director" / f"{name}.txt").write_text(text, encoding="utf-8")
    (root / "pathmap.json").write_text(
        '{"director/a.txt": ["k", "a"], "director/b.txt": ["k", "b"], "director/c.txt": ["k", "c"]}', encoding="utf-8")
    kw = dict(re_only=True, retrieval_type=1, rerank_fusion_type=1, use_reranker=2,
              embedding_name=sharded_gte_checkpoint, reranker_name=minicpm_checkpoint, vector_size=32,
              chunk_size=64, chunk_overlap=10, data_path=str(root), f_topk_1=4, r_topk=2)
    cfg, _ = configs(cache_path=str(tmp_path / "jax_cache"), tpu=dict(use_pallas=False, embedder_quant="int8"), **kw)
    _, port_cfg = configs(cache_path=str(tmp_path / "port_cache"), tpu=dict(embedder_quant="int8"), **kw)
    ref, got = JaxPipeline(cfg), EasyRAGPipeline(port_cfg, device="cpu")
    assert isinstance(got.embed_model, GTEEmbedder) and got.reranker.scorer.padding_side == "right"
    # the tiny random reranker's scores lie closer together than bf16's
    # roundings: both rerankers compute in f32 from the same bf16 weights
    jsc = ref.reranker.scorer
    jsc.cfg = dataclasses.replace(jsc.cfg, dtype=jnp.float32)
    jsc.params = jax.tree.map(lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x,
                              jsc.params)
    got.reranker.scorer.float()
    for q in ("w1 w2 w3", "w6 w9", "w3 w12"):
        a = asyncio.run(ref.run({"query": q}))
        b = asyncio.run(got.run({"query": q}))
        assert b["answer"] == a["answer"] == "" and b["contexts"]
        assert [n.node.idx for n in b["nodes"]] == [n.node.idx for n in a["nodes"]]
        assert b["contexts"] == a["contexts"]
        np.testing.assert_allclose([n.score for n in b["nodes"]], [n.score for n in a["nodes"]], rtol=1e-6)


def test_smoke_checkpoint_round_trips_through_the_registry(tmp_path):
    """``chip_smoke.py`` phase 9 saves its seeded MiniCPM under Hugging Face
    names with a word tokenizer and loads it back by name: on the CPU, at a
    tiny size, the loaded scorer has the same tensors and scores to the bit."""
    import chip_smoke
    from easyrag_tpu_torch.models.layers import DecoderConfig

    arch = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=2,
                num_key_value_heads=2, scale_emb=12.0, scale_depth=1.4, dim_model_base=32.0)
    model_dir = str(tmp_path / "models" / "bge-reranker-v2-minicpm-layerwise")
    chip_smoke.save_word_tokenizer(model_dir, [f"w{i}" for i in range(60)])
    tok = __import__("transformers").AutoTokenizer.from_pretrained(model_dir)
    scorer = MiniCPMLayerWiseReranker(DecoderConfig(**arch), tok, start_layer=1, cutoff_layer=3, device="cpu")
    scorer.init_random_(torch.Generator().manual_seed(5))
    chip_smoke.save_minicpm_checkpoint(torch, scorer, arch, model_dir, 1)
    got = reg.load_reranker(model_dir, top_n=2, embed_bs=4, device="cpu").scorer
    assert (got.start_layer, got.cutoff_layer, got.padding_side) == (1, 3, "right")
    want = scorer.state_dict()
    assert sorted(got.state_dict()) == sorted(want)
    assert all(torch.equal(t, want[k]) for k, t in got.state_dict().items())
    np.testing.assert_array_equal(got.score_pairs(PAIRS)[0], scorer.score_pairs(PAIRS)[0])
