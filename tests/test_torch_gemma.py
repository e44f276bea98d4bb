"""The port's Gemma2 cost-wise reranker against the JAX package's.

One JAX parameter tree per case, given to the port through
``convert.gemma_from_jax``; everything in f32 on the CPU, where the port's
softcapped attention is K4's plain version:

* the decoder stack against ``easyrag_tpu.models.layers.forward_hidden`` at
  head_dim 8 (the JAX einsum path) and at head_dim 128 (JAX's K4 in interpret
  mode), and against HF ``Gemma2Model``, at real positions: rtol 3e-4, atol
  3e-5;
* ``token_compress`` on the cases of ``tests/test_gemma.py``: 1e-6;
* ``score_pairs`` with compression points (1, 3), (1,), (1, 4) and ():
  rtol 1e-4, atol 1e-5; (1, 4) equals (1,);
* the loader's leaves against ``easyrag_tpu``'s on a tiny saved checkpoint
  with layerwise heads, and ``load_gemma_reranker`` on it;
* ``EasyRAGPipeline.run`` with the Gemma scorer behind ``LLMRerank`` against
  the JAX pipeline: the same nodes and contexts, scores within 1e-4 (also
  through the ``use_efficient=3`` cascade).
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from easyrag_tpu.models import gemma as jg
from easyrag_tpu.models import hf_loader as jh
from easyrag_tpu.models import layers as jl
from easyrag_tpu.pipeline import EasyRAGPipeline as JaxPipeline
from easyrag_tpu.rerankers import LLMRerank as JaxLLMRerank
from easyrag_tpu_torch.models import gemma as tg
from easyrag_tpu_torch.models import hf_loader as th
from easyrag_tpu_torch.models.convert import gemma_from_jax
from easyrag_tpu_torch.models.layers import DecoderConfig, embed, rms_norm
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from easyrag_tpu_torch.rerankers import LLMRerank
from test_torch_pipeline import QUERIES, RecordingLLM, configs, make_corpus, offline_counter  # noqa: F401

torch.set_num_threads(1)

TINY = dict(  # tests/test_gemma.py's tiny Gemma2: 4 heads of 8 on 2, softcap 50
    vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, head_dim=8, gemma=True, attn_logit_softcapping=50.0, query_pre_attn_scalar=8,
)
WIDE = dict(  # tests/test_flash_softcap.py's: 4 heads of 128 on 2, softcap 30
    vocab_size=64, hidden_size=512, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=128, gemma=True, attn_logit_softcapping=30.0, query_pre_attn_scalar=144.0,
)
PAIRS = [("查询一", "很长的文档内容 " * 20), ("查询二", "短文"), ("what is x", "x is a thing " * 6)]


class CharTok:
    bos_token_id = 1
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=False, max_length=None, truncation=False):
        ids = [ord(ch) % 120 + 2 for ch in text]
        return {"input_ids": ids[:max_length] if truncation and max_length else ids}


def jax_tree(arch, seed=0, heads=()):
    """A JAX Gemma tree (f32) with score heads at ``heads``: (cfg, params, numpy leaves)."""
    cfg = jl.DecoderConfig(dtype=jnp.float32, **arch)
    params = jl.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    # norms away from JAX's init ones, so the (1 + w) gain is tested
    for layer in params["layers"]:
        for name in ("input_norm", "post_attn_norm", "pre_mlp_norm", "post_mlp_norm"):
            layer[name] = jnp.asarray(rng.normal(size=arch["hidden_size"]) * 0.1, jnp.float32)
    params["final_norm"] = jnp.asarray(rng.normal(size=arch["hidden_size"]) * 0.1, jnp.float32)
    params["heads"] = {L: jnp.asarray(rng.normal(size=(1, arch["hidden_size"])), jnp.float32) for L in heads}
    return cfg, params, jax.tree.map(np.asarray, params)


def port_stack(model, ids, n_layers):
    """The port's decoder stack: embedding, ``n_layers`` layers, final Gemma norm."""
    with torch.inference_mode():
        h = embed(model.cfg, model.embed, torch.from_numpy(ids))
        h = model._segment(h, 0, n_layers)
        return rms_norm(h, model.final_norm, model.cfg.rms_norm_eps, gemma=True).numpy()


def right_padded(lengths, S, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(len(lengths), S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array(lengths)[:, None]).astype(np.int32)
    return ids, mask


def test_stack_matches_jax_einsum_head_dim_8():
    jcfg, params, params_np = jax_tree(TINY)
    model = gemma_from_jax(DecoderConfig(**TINY), params_np, "cpu", torch.float32, CharTok())
    ids, mask = right_padded([40, 23], 40, 128, seed=1)
    ref = np.asarray(jl.forward_hidden(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)))
    got = port_stack(model, ids, 4)
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref[real], rtol=3e-4, atol=3e-5)
    assert np.isfinite(got).all()


def test_stack_matches_jax_k4_head_dim_128():
    from dataclasses import replace

    from jax.experimental.pallas import tpu as pltpu

    jcfg, params, params_np = jax_tree(WIDE, seed=2)
    model = gemma_from_jax(DecoderConfig(**WIDE), params_np, "cpu", torch.float32, CharTok())
    ids, mask = right_padded([136, 93], 136, 64, seed=3)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jl.forward_hidden(replace(jcfg, use_flash=True), params, jnp.asarray(ids), jnp.asarray(mask)))
    got = port_stack(model, ids, 2)
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref[real], rtol=3e-4, atol=3e-5)


def test_stack_matches_hf_gemma2():
    from transformers import Gemma2Config, Gemma2Model

    torch.manual_seed(0)
    hf_cfg = Gemma2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=8, max_position_embeddings=128, attn_logit_softcapping=50.0,
        final_logit_softcapping=None, query_pre_attn_scalar=8, sliding_window=4096, attn_implementation="eager",
    )
    hf = Gemma2Model(hf_cfg).eval().float()
    with torch.no_grad():  # norms away from HF's init zeros
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.normal_(0.0, 0.1)
    cfg = tg.gemma_config_from_hf({**hf_cfg.to_dict(), "num_hidden_layers": 2})
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    params_np = jax.tree.map(np.asarray, jh.params_from_state_dict(sd, 2, gemma=True, dtype=jnp.float32))
    params_np["heads"] = {}
    model = gemma_from_jax(cfg, params_np, "cpu", torch.float32, CharTok())
    ids, mask = right_padded([12, 9], 12, 128, seed=0)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long()).last_hidden_state
    got = port_stack(model, ids, 2)
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], ref.numpy()[real], rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize(
    "hidden_shape,seqs,qlens,plens,ratio,extra",
    [((3, 23, 8), [23, 17, 12], [4, 6, 3], [3, 3, 3], 2, 5), ((1, 10, 1), [10], [2], [3], 2, 0)],
)
def test_token_compress_matches_jax(hidden_shape, seqs, qlens, plens, ratio, extra):
    b, s, _ = hidden_shape
    if hidden_shape[-1] == 1:
        hidden = np.arange(10, dtype=np.float32).reshape(hidden_shape)  # the ragged-tail case
    else:
        hidden = np.random.default_rng(1).normal(size=hidden_shape).astype(np.float32)
    mask = (np.arange(s)[None, :] < np.array(seqs)[:, None]).astype(np.int32)
    qlens, plens = np.array(qlens, np.int32), np.array(plens, np.int32)
    retain = -(-(np.array(seqs) - qlens - plens) // ratio)
    out_len = int((qlens + plens + retain).max()) + extra
    rh, rm = jg.token_compress(jnp.asarray(hidden), jnp.asarray(mask), jnp.asarray(qlens), jnp.asarray(plens),
                               ratio, out_len)
    gh, gm = tg.token_compress(*(torch.from_numpy(a) for a in (hidden, mask, qlens, plens)), ratio, out_len)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    np.testing.assert_allclose(gh.numpy(), np.asarray(rh), rtol=1e-6, atol=1e-6)


def _scorers(compress_layer, cutoff=4):
    jcfg, params, params_np = jax_tree(TINY, seed=1, heads=(2, 3, 4))
    opts = dict(cutoff_layer=cutoff, compress_layer=compress_layer, compress_ratio=2, max_length=128)
    ref = jg.GemmaCostWiseReranker(jcfg, params, CharTok(), **opts)
    got = gemma_from_jax(DecoderConfig(**TINY), params_np, "cpu", torch.float32, CharTok(), **opts)
    return ref, got


@pytest.mark.parametrize("compress_layer", [(1, 3), (1,), (1, 4), ()])
def test_score_pairs_matches_jax(compress_layer):
    ref, got = _scorers(compress_layer)
    assert got.padding_side == "right"
    for a, b in zip(got.build_inputs(PAIRS), ref.build_inputs(PAIRS)):
        np.testing.assert_array_equal(a, b)
    rs, rl = ref.score_pairs(PAIRS)
    gs, gl = got.score_pairs(PAIRS)
    assert gl == rl == 4
    np.testing.assert_allclose(gs, np.asarray(rs), rtol=1e-4, atol=1e-5)


def test_compression_point_at_cutoff_is_skipped():
    _, single = _scorers((1,))
    _, at_cutoff = _scorers((1, 4))
    _, double = _scorers((1, 3))
    s1, s3, s2 = (m.score_pairs(PAIRS)[0] for m in (single, at_cutoff, double))
    np.testing.assert_array_equal(s3, s1)
    assert not np.allclose(s2, s1)  # the second compression changes the computation


@pytest.fixture
def gemma_checkpoint(tmp_path):
    """A tiny Gemma2 body saved with HF names plus two layerwise heads
    (``lm_head.{j}.linear_head.weight``), a config with ``start_layer`` and
    ``layer_sep``, and a word tokenizer."""
    from safetensors.torch import save_file
    from transformers import Gemma2Config, Gemma2Model

    from test_checkpoint_boot import _word_tokenizer

    torch.manual_seed(4)
    hf_cfg = Gemma2Config(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=2, head_dim=8, attn_logit_softcapping=50.0, final_logit_softcapping=None,
        query_pre_attn_scalar=8, sliding_window=4096,
    )
    sd = {f"model.{k}": v.detach().clone().contiguous() for k, v in Gemma2Model(hf_cfg).state_dict().items()}
    for j in range(2):
        sd[f"lm_head.{j}.linear_head.weight"] = torch.randn(1, 32)
    save_file(sd, str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump({**hf_cfg.to_dict(), "start_layer": 2, "layer_sep": 2}, f)
    _word_tokenizer().save_pretrained(str(tmp_path))
    return str(tmp_path)


@pytest.mark.parametrize("quant", ["", "w8a8"])
def test_loader_matches_jax(gemma_checkpoint, quant):
    ref = jax.tree.map(np.asarray, jh.load_decoder_params(
        gemma_checkpoint, 4, start_layer=2, gemma=True, head_layer_sep=2, dtype=jnp.float32, quant=quant))
    got = th.load_decoder_params(gemma_checkpoint, 4, dtype=torch.float32, start_layer=2, gemma=True, head_layer_sep=2,
                                  device="cpu", quant=quant)
    assert sorted(got["heads"]) == sorted(ref["heads"]) == [2, 4]

    def same(a, b):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, list):
            for x, y in zip(a, b, strict=True):
                same(x, y)
        else:
            np.testing.assert_array_equal(a.numpy(), b)

    same(got, ref)
    assert sorted(got["layers"][0]) == ["attn", "input_norm", "mlp", "post_attn_norm", "post_mlp_norm", "pre_mlp_norm"]


@pytest.mark.parametrize("quant", ["", "w8a8"])
def test_load_gemma_reranker(gemma_checkpoint, quant):
    got = tg.load_gemma_reranker(gemma_checkpoint, quant=quant, device="cpu", dtype=torch.float32, cutoff_layer=4,
                                 compress_layer=(2,))
    assert got.padding_side == got.tokenizer.padding_side == "right"
    assert got.cfg.act_quant == (quant == "w8a8") and ("w_q" in got.layers[0].q) == (quant == "w8a8")
    hf = jh.load_hf_config(gemma_checkpoint)
    params = jh.load_decoder_params(gemma_checkpoint, 4, start_layer=2, gemma=True, head_layer_sep=2,
                                    dtype=jnp.float32, quant=quant)
    jcfg = dataclasses.replace(jg.gemma_config_from_hf(hf, dtype=jnp.float32), act_quant=quant == "w8a8")
    ref = jg.GemmaCostWiseReranker(jcfg, params, got.tokenizer, cutoff_layer=4, compress_layer=(2,))
    pairs = [("w1 w2", "w3 w4 w5 w6 w7"), ("w9", "w8 w7")]
    np.testing.assert_allclose(got.score_pairs(pairs)[0], np.asarray(ref.score_pairs(pairs)[0]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_efficient", [0, 3])
def test_pipeline_matches_jax(tmp_path, offline_counter, use_efficient):  # noqa: F811
    kw = dict(data_path=make_corpus(tmp_path / "corpus"), chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2,
              r_topk=3, r_embed_bs=4, r_use_efficient=use_efficient,
              tpu=dict(use_pallas=False, max_query_terms=8, max_query_postings=2048))
    cfg, port_cfg = configs(**kw)
    ref_scorer, scorer = _scorers((1,), cutoff=4)
    rr = dict(top_n=3, embed_bs=4, embed_type=1, use_efficient=use_efficient, cascade_keep=4)
    ref = JaxPipeline(cfg, llm=RecordingLLM(), reranker=JaxLLMRerank(ref_scorer, **rr))
    got = EasyRAGPipeline(port_cfg, llm=RecordingLLM(), reranker=LLMRerank(scorer, **rr), device="cpu")
    for q in QUERIES:
        a = asyncio.run(ref.run(dict(q)))
        b = asyncio.run(got.run(dict(q)))
        assert [n.node.idx for n in b["nodes"]] == [n.node.idx for n in a["nodes"]]
        assert b["contexts"] == a["contexts"]
        np.testing.assert_allclose([n.score for n in b["nodes"]], [n.score for n in a["nodes"]], rtol=1e-4, atol=1e-5)
    assert got.llm.prompts == ref.llm.prompts
