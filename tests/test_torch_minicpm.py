"""The port's MiniCPM layerwise reranker against the JAX package's.

A tiny MiniCPM (4 layers, hidden 128, 2 heads of 64, the reranker's
scalings) with one JAX parameter tree, run by ``easyrag_tpu`` (einsum path,
as on its CPU backend) and by the port through ``minicpm_from_jax``. f32
scores agree within atol 1e-4 and rank the pairs in the same order, on both
padding sides and through the early-exit judge path.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from easyrag_tpu.models import layers as jl
from easyrag_tpu.models.minicpm import MiniCPMLayerWiseReranker as JaxReranker
from easyrag_tpu_torch.models.convert import minicpm_from_jax
from easyrag_tpu_torch.models.layers import DecoderConfig
from easyrag_tpu_torch.models.minicpm import key_ranges

torch.set_num_threads(1)

ARCH = dict(
    vocab_size=96, hidden_size=128, intermediate_size=256, num_hidden_layers=4,
    num_attention_heads=2, num_key_value_heads=2,
    scale_emb=12.0, scale_depth=1.4, dim_model_base=64.0,
)
PAIRS = [
    ("what is x", "x is a thing"),
    ("q" * 30, "p" * 100),
    ("中文问题", "答案在这里"),
    ("what is y", "unrelated text"),
]


class CharTok:
    bos_token_id = 1
    pad_token_id = 0

    def __init__(self, padding_side=None):
        if padding_side:
            self.padding_side = padding_side

    def __call__(self, text, add_special_tokens=False, max_length=None, truncation=False):
        ids = [ord(ch) % 94 + 2 for ch in text]
        return {"input_ids": ids[:max_length] if truncation and max_length else ids}


def tiny_params(seed=0):
    """One JAX parameter tree (f32) plus score heads, as numpy leaves."""
    cfg = jl.DecoderConfig(dtype=jnp.float32, **ARCH)
    params = jl.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params["heads"] = {
        layer: jnp.asarray(rng.normal(size=(1, cfg.hidden_size)), jnp.float32)
        for layer in range(1, cfg.num_hidden_layers + 1)
    }
    return cfg, params, jax.tree.map(np.asarray, params)


def _pair(padding_side, **kw):
    jcfg, params, params_np = tiny_params()
    opts = dict(start_layer=1, cutoff_layer=3, max_length=64, efficient_layers=(2,), **kw)
    ref = JaxReranker(jcfg, params, CharTok(padding_side), **opts)
    got = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok(padding_side), **opts)
    return ref, got


@pytest.mark.parametrize("side", ["left", "right"])
def test_scores_match_jax_both_padding_sides(side):
    ref, got = _pair(side)
    assert got.padding_side == ref.padding_side == side
    for a, b in zip(got.build_inputs(PAIRS), ref.build_inputs(PAIRS)):
        np.testing.assert_array_equal(a, b)
    rs, rl = ref.score_pairs(PAIRS)
    gs, gl = got.score_pairs(PAIRS)
    assert gl == rl == 3
    np.testing.assert_allclose(gs, rs, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.argsort(-gs), np.argsort(-np.asarray(rs)))


@pytest.mark.parametrize("use_efficient", [1, 2])
@pytest.mark.parametrize("efficient_t", [0.0, 1.01])  # always exit / never exit
def test_judge_path_matches_jax(use_efficient, efficient_t):
    ref, got = _pair("right", use_efficient=use_efficient, efficient_t=efficient_t)
    rs, rl = ref.score_pairs(PAIRS, judge=True)
    gs, gl = got.score_pairs(PAIRS, judge=True)
    assert gl == rl == (2 if efficient_t == 0.0 else 3)
    np.testing.assert_allclose(gs, rs, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.argsort(-gs), np.argsort(-np.asarray(rs)))


def test_key_ranges_and_rejected_masks():
    start, end = key_ranges(np.array([[0, 0, 1, 1], [1, 1, 1, 0], [0, 0, 0, 0]]))
    np.testing.assert_array_equal(start, [2, 0, 0])
    np.testing.assert_array_equal(end, [4, 3, 0])
    with pytest.raises(ValueError):
        key_ranges(np.array([[1, 0, 1, 1]]))


def test_random_init_is_seeded():
    cfg = DecoderConfig(**ARCH)
    a = minicpm_from_jax(cfg, tiny_params()[2], "cpu", torch.float32, CharTok(), start_layer=1, cutoff_layer=3)
    b = minicpm_from_jax(cfg, tiny_params()[2], "cpu", torch.float32, CharTok(), start_layer=1, cutoff_layer=3)
    a.init_random_(torch.Generator().manual_seed(3))
    b.init_random_(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert (a.heads[0] == 0).all() and (a.heads[1:] != 0).any()
    np.testing.assert_array_equal(a.score_pairs(PAIRS)[0], b.score_pairs(PAIRS)[0])


@pytest.fixture(scope="module")
def minicpm_checkpoint(tmp_path_factory):
    """A tiny MiniCPM layerwise checkpoint in HF names: the decoder, three
    layerwise heads (``lm_head.{j}.linear_head.weight``), ``start_layer`` 2
    in ``config.json``, and a word tokenizer."""
    import json

    from safetensors.torch import save_file

    from test_checkpoint_boot import _word_tokenizer

    out = tmp_path_factory.mktemp("models") / "minicpm-tiny"
    out.mkdir()
    g = torch.Generator().manual_seed(8)
    d, inter = ARCH["hidden_size"], ARCH["intermediate_size"]
    shapes = {"model.embed_tokens.weight": (64, d), "model.norm.weight": (d,)}
    for i in range(ARCH["num_hidden_layers"]):
        for n, shape in (("self_attn.q_proj.weight", (d, d)), ("self_attn.k_proj.weight", (d, d)),
                         ("self_attn.v_proj.weight", (d, d)), ("self_attn.o_proj.weight", (d, d)),
                         ("mlp.gate_proj.weight", (inter, d)), ("mlp.up_proj.weight", (inter, d)),
                         ("mlp.down_proj.weight", (d, inter)), ("input_layernorm.weight", (d,)),
                         ("post_attention_layernorm.weight", (d,))):
            shapes[f"model.layers.{i}.{n}"] = shape
    for j in range(3):
        shapes[f"lm_head.{j}.linear_head.weight"] = (1, d)
    save_file({n: torch.randn(s, generator=g) * 0.05 + (1.0 if "norm" in n else 0.0) for n, s in shapes.items()},
              str(out / "model.safetensors"))
    with open(out / "config.json", "w") as f:
        json.dump({**ARCH, "vocab_size": 64, "start_layer": 2, "rms_norm_eps": 1e-5}, f)
    _word_tokenizer().save_pretrained(str(out))
    return str(out)


@pytest.mark.parametrize("quant", ["", "w8a8", "w4a8"])
def test_minicpm_loader_matches_jax(minicpm_checkpoint, quant):
    from easyrag_tpu.models import hf_loader as jh
    from easyrag_tpu_torch.models import hf_loader as th
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker

    jcfg, ref, jstart = jh.load_minicpm_reranker(minicpm_checkpoint, dtype=jnp.float32, quant=quant)
    cfg, got, start = th.load_minicpm_reranker(minicpm_checkpoint, dtype=torch.float32, quant=quant, device="cpu")
    assert start == jstart == 2 and sorted(got["heads"]) == sorted(ref["heads"]) == [2, 3, 4]
    assert cfg == DecoderConfig(**{**ARCH, "vocab_size": 64}, rms_norm_eps=1e-5, act_quant=bool(quant))
    assert cfg.act_quant == jcfg.act_quant

    def same(a, b):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, list):
            for x, y in zip(a, b, strict=True):
                same(x, y)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    same(got, jax.tree.map(np.asarray, ref))
    if not quant:  # the in-memory form over the same tensors
        from safetensors.numpy import load_file

        sd = load_file(os.path.join(minicpm_checkpoint, "model.safetensors"))
        same(th.params_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, 4, start_layer=2, device="cpu"),
             jax.tree.map(np.asarray, jh.params_from_state_dict(sd, 4, start_layer=2)))
    # the checkpoint-backed scorer: the same leaves in its DecoderLayers, JAX's scores
    scorer = MiniCPMLayerWiseReranker.from_pretrained(minicpm_checkpoint, quant=quant, device="cpu",
                                                      dtype=torch.float32, cutoff_layer=4, max_length=64)
    assert scorer.start_layer == 2 and scorer.cfg.act_quant == bool(quant)
    jscorer = JaxReranker(jcfg, ref, scorer.tokenizer, start_layer=2, cutoff_layer=4, max_length=64)
    pairs = [("w1 w2", "w3 w4 w5 w6 w7"), ("w9", "w8 w7"), ("w5", "w5 w5 w5 w1")]
    np.testing.assert_allclose(scorer.score_pairs(pairs)[0], np.asarray(jscorer.score_pairs(pairs)[0]),
                               rtol=1e-4, atol=1e-5)
