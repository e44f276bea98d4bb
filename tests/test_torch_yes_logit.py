"""The port's yes-logit reranker against the JAX package's.

The analogue of ``tests/test_models.py::test_yes_logit_scorer`` (:257): one
tiny Qwen2 tree (2 layers, hidden 128, 2 query heads of 64 on 1 KV head,
QKV bias) scored by ``easyrag_tpu.models.yes_logit.YesLogitScorer`` and by
the port's, in f32: the same prompts, scores within rtol 1e-4 and the same
ranking, with an untied dense head, a tied head (no ``lm_head``), an int8
head, and a w8a8 tree. An int4 head raises ``ValueError`` in the port
(``KeyError`` in JAX). At the port's default 128 bucket (K3's gate) the
scores equal those at JAX's 64 bucket to rounding. ``from_pretrained``
loads a tiny saved checkpoint as JAX's does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from easyrag_tpu.models import hf_loader as jh
from easyrag_tpu.models import layers as jl
from easyrag_tpu.models.yes_logit import YesLogitScorer as JaxScorer
from easyrag_tpu_torch.models import layers as tl
from easyrag_tpu_torch.models.convert import causal_lm_params_from_jax
from easyrag_tpu_torch.models.yes_logit import YesLogitScorer
from test_torch_decode import tiny_causal_checkpoint  # noqa: F401  (a fixture)

torch.set_num_threads(1)

ARCH = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=1, attention_bias=True)
PAIRS = [("q1", "passage one"), ("q2", "other"), ("which one", "a much longer passage " * 4), ("中文", "答案")]


class Tok:
    bos_token_id = 1
    pad_token_id = 0

    def __init__(self, padding_side=None):
        if padding_side:
            self.padding_side = padding_side

    def __call__(self, text, add_special_tokens=False, max_length=None, truncation=False):
        ids = [ord(ch) % 120 + 2 for ch in text]
        return {"input_ids": ids[:max_length] if truncation and max_length else ids}


def _tree(head="untied", quant=""):
    cfg = jl.DecoderConfig(dtype=jnp.float32, **ARCH)
    params = jl.init_params(cfg, jax.random.key(2))
    rng = np.random.default_rng(2)
    for layer in params["layers"]:
        for n in "qkv":
            layer["attn"][n]["b"] = jnp.asarray(rng.normal(size=layer["attn"][n]["b"].shape).astype(np.float32) * 0.1)
    w = rng.normal(size=(128, 128)).astype(np.float32) * 0.05
    if quant:
        params = jh.quantize_decoder_tree(params, "int8")
        cfg = dataclasses.replace(cfg, act_quant=True)
    if head == "untied":
        params["lm_head"] = jnp.asarray(w)
    elif head == "int8":
        params["lm_head"] = jh.quantize_linear_int8(w)
    elif head == "int4":
        params["lm_head"] = jh.quantize_linear_int4(w)
    return cfg, params


def _port(params, quant="", side=None, **kw):
    cfg = tl.DecoderConfig(**ARCH, act_quant=bool(quant))
    tp = causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", torch.float32)
    return YesLogitScorer(cfg, tp, Tok(side), max_length=64, device="cpu", **kw)


@pytest.mark.parametrize("head,quant", [("untied", ""), ("tied", ""), ("int8", ""), ("int8", "w8a8")])
@pytest.mark.parametrize("side", ["left", "right"])
def test_scores_match_jax(head, quant, side):
    cfg, params = _tree(head, quant)
    ref = JaxScorer(cfg, params, Tok(side), max_length=64)
    got = _port(params, quant, side, seq_bucket=64)
    ids, mask = got.build_inputs(PAIRS)
    from easyrag_tpu.models.minicpm import MiniCPMLayerWiseReranker

    rids, rmask = MiniCPMLayerWiseReranker.build_inputs(ref._builder, PAIRS)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(mask, rmask)
    np.testing.assert_allclose(got.yes_row.numpy(), np.asarray(ref.yes_row, np.float32).reshape(-1), rtol=1e-6, atol=0)
    rs, rl = ref.score_pairs(PAIRS)
    gs, gl = got.score_pairs(PAIRS)
    assert gl == rl == 2 and got.cutoff_layer == 2
    np.testing.assert_allclose(gs, rs, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.argsort(-gs), np.argsort(-np.asarray(rs)))
    # the manual recomputation of test_models.py: the hidden state at the last real token times the row
    h = tl.forward_hidden(got.cfg, got.params, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    last = mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)
    np.testing.assert_allclose(gs, h[np.arange(len(PAIRS)), last] @ got.yes_row.numpy(), rtol=1e-5, atol=1e-6)


def test_default_bucket_takes_k3s_gate_and_keeps_the_scores():
    """The port pads to a multiple of 128 by default (layers.attention's K3
    gate): pad keys are masked and RoPE keeps only position differences, so
    the scores equal those at JAX's 64 bucket to f32 rounding."""
    cfg, params = _tree()
    ref = JaxScorer(cfg, params, Tok(), max_length=64)
    got = _port(params)
    ids, _ = got.build_inputs(PAIRS)
    assert ids.shape[1] % 128 == 0 and got.padding_side == "left"
    np.testing.assert_allclose(got.score_pairs(PAIRS)[0], ref.score_pairs(PAIRS)[0], rtol=1e-4, atol=1e-5)


def test_int4_head_raises():
    cfg, params = _tree("int4")
    with pytest.raises(KeyError):  # the reference's defect (ROADMAP Queue 3)
        JaxScorer(cfg, params, Tok(), max_length=64)
    with pytest.raises(ValueError, match="int4"):
        _port(params)


def test_from_pretrained_matches_jax(tiny_causal_checkpoint):  # noqa: F811
    ref = JaxScorer.from_pretrained(tiny_causal_checkpoint)
    got = YesLogitScorer.from_pretrained(tiny_causal_checkpoint, device="cpu", seq_bucket=64)
    assert got.padding_side == ref._builder.padding_side and got.params["final_norm"].dtype == torch.bfloat16
    pairs = [("w1 w2", "w3 w4 w5 w6 w7"), ("w9", "w8 w7"), ("w5", "w5 w5 w5 w1")]
    want = np.asarray(ref.score_pairs(pairs)[0])
    # both run bf16 weights and activations, rounded at other places
    np.testing.assert_allclose(got.score_pairs(pairs)[0], want, rtol=0, atol=0.05 * np.abs(want).max())
    a8 = YesLogitScorer.from_pretrained(tiny_causal_checkpoint, quant="w8a8", device="cpu")
    assert a8.cfg.act_quant and "w_q" in a8.params["layers"][0]["attn"]["q"] and "w_q" in a8.params["lm_head"]
