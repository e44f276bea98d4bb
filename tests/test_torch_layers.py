"""The one decoder block and the one attention gate of
``easyrag_tpu_torch/models/layers.py``.

* The gate (``layers.attention``) picks each caller's kernel from its inputs
  alone: calls are counted through the monkeypatched K1, K3, K4 and einsum
  entry points for the MiniCPM reranker (head_dim 64, as many KV heads as
  query heads: K1), the Gemma2 reranker and Gemma2 through
  ``forward_hidden`` (softcap: K4), gte-Qwen2's shapes (head_dim 128 on
  grouped KV heads: K3 at ``S % 128 == 0``, the einsum path otherwise) and
  head_dim 64 on grouped KV heads (the same).
* Gemma2 through ``forward_hidden`` against JAX's ``forward_hidden`` on real
  rows (rtol 3e-4, atol 3e-5, as ``tests/test_torch_gemma.py``); left
  padding is refused.
* The MiniCPM reranker's layers (the fused chain's plain versions on the
  CPU) and ``forward_hidden`` (the eager chain) over the same weights give
  the same hidden states bit for bit, both padding sides, f32 and bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from easyrag_tpu.models import layers as jl
from easyrag_tpu_torch.dryrun import random_tree
from easyrag_tpu_torch.models import layers as tl
from easyrag_tpu_torch.models.convert import causal_lm_params_from_jax
from easyrag_tpu_torch.models.gemma import GemmaCostWiseReranker
from easyrag_tpu_torch.models.layers import DecoderConfig, embed, rms_norm
from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker, key_ranges
from test_torch_gemma import TINY as GEMMA_TINY
from test_torch_gemma import WIDE as GEMMA_WIDE
from test_torch_gemma import jax_tree as gemma_jax_tree
from test_torch_gemma import right_padded
from test_torch_minicpm import ARCH as MINICPM_ARCH
from test_torch_minicpm import PAIRS, CharTok

torch.set_num_threads(1)

#: the gate's entry points in ``layers``, by kernel
KERNELS = {"K1": "flash64_attention", "K3": "flash_attention", "K4": "flash_softcap_attention",
           "einsum": "flash_attention_plain"}
GTE = dict(  # tests/test_torch_embedder.py's gte-Qwen2: 2 heads of 128 on 1
    vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=1, head_dim=128, attention_bias=True,
)
GQA64 = dict(GTE, num_attention_heads=4, num_key_value_heads=2, head_dim=64)


@pytest.fixture
def kernel_calls(monkeypatch):
    """The kernels the gate calls, in order."""
    calls = []
    for kernel, name in KERNELS.items():
        real = getattr(tl, name)
        monkeypatch.setattr(tl, name, lambda *a, _real=real, _kernel=kernel: calls.append(_kernel) or _real(*a))
    return calls


def _minicpm(seq_bucket):
    model = MiniCPMLayerWiseReranker(DecoderConfig(**MINICPM_ARCH), CharTok(), start_layer=1, cutoff_layer=4,
                                     seq_bucket=seq_bucket, device="cpu", dtype=torch.float32)
    model.init_random_(torch.Generator().manual_seed(0))
    return lambda: model.score_pairs(PAIRS)


def _gemma_reranker():
    model = GemmaCostWiseReranker(DecoderConfig(**GEMMA_TINY), CharTok(), cutoff_layer=4, compress_layer=(),
                                  device="cpu", dtype=torch.float32)
    model.init_random_(torch.Generator().manual_seed(1), start_layer=1)
    return lambda: model.score_pairs(PAIRS)


def _tree_stack(arch, s, n_real):
    """``forward_hidden`` over a seeded tree (``dryrun.random_tree``) at
    ``[len(n_real), s]``, right padded."""
    cfg = DecoderConfig(**arch)
    tree = random_tree(cfg, seed=2, device="cpu")
    ids, mask = right_padded(n_real, s, cfg.vocab_size, seed=3)
    return lambda: tl.forward_hidden(cfg, tree, torch.from_numpy(ids), torch.from_numpy(mask))


def _gemma_tree(s):
    cfg = DecoderConfig(**GEMMA_TINY)
    _, _, params_np = gemma_jax_tree(GEMMA_TINY)
    tree = causal_lm_params_from_jax(params_np, "cpu", torch.float32)
    ids, mask = right_padded([s, 23], s, cfg.vocab_size, seed=4)
    return lambda: tl.forward_hidden(cfg, tree, torch.from_numpy(ids), torch.from_numpy(mask))


@pytest.mark.parametrize("caller,kernel,layers", [
    (lambda: _minicpm(64), "K1", 4),  # S = 320: K1 whatever S % 128
    (lambda: _minicpm(128), "K1", 4),  # S = 384
    (_gemma_reranker, "K4", 4),
    (lambda: _gemma_tree(40), "K4", 4),
    (lambda: _gemma_tree(128), "K4", 4),
    (lambda: _tree_stack(GTE, 128, [128, 30]), "K3", 2),
    (lambda: _tree_stack(GTE, 72, [72, 30]), "einsum", 2),
    (lambda: _tree_stack(GQA64, 128, [128, 30]), "K3", 2),
    (lambda: _tree_stack(GQA64, 72, [72, 30]), "einsum", 2),
], ids=["minicpm-S320", "minicpm-S384", "gemma2-reranker", "gemma2-tree-S40", "gemma2-tree-S128",
        "gte-qwen2-S128", "gte-qwen2-S72", "hd64-gqa-S128", "hd64-gqa-S72"])
def test_the_gate_keeps_each_callers_kernel(kernel_calls, caller, kernel, layers):
    run = caller()
    kernel_calls.clear()
    with torch.inference_mode():
        run()
    assert kernel_calls == [kernel] * layers


@pytest.mark.parametrize("arch", [GEMMA_TINY, GEMMA_WIDE], ids=["head_dim-8", "head_dim-128"])
def test_gemma2_forward_hidden_matches_jax(arch):
    jcfg, params, params_np = gemma_jax_tree(arch, seed=5)
    tree = causal_lm_params_from_jax(params_np, "cpu", torch.float32)
    ids, mask = right_padded([72, 41, 9], 72, arch["vocab_size"], seed=6)
    want = np.asarray(jl.forward_hidden(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)))
    got = tl.forward_hidden(DecoderConfig(**arch), tree, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], rtol=3e-4, atol=3e-5)
    with pytest.raises(ValueError, match="right padding"):
        tl.forward_hidden(DecoderConfig(**arch), tree, torch.from_numpy(ids), torch.from_numpy(mask[:, ::-1].copy()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", ["left", "right"])
def test_minicpm_layers_equal_forward_hidden(dtype, side):
    cfg = DecoderConfig(**MINICPM_ARCH)
    model = MiniCPMLayerWiseReranker(cfg, CharTok(side), start_layer=1, cutoff_layer=4, device="cpu", dtype=dtype)
    model.init_random_(torch.Generator().manual_seed(7))
    with torch.no_grad():  # norms away from 1
        for layer in model.layers:
            for name in tl.norm_names(cfg):
                getattr(layer, name).normal_(1.0, 0.1)
        model.final_norm.normal_(1.0, 0.1)
    ids_np, mask_np = model.build_inputs(PAIRS)
    ids, mask = torch.from_numpy(ids_np), torch.from_numpy(mask_np)
    tree = {"embed": model.embed, "final_norm": model.final_norm, "layers": [layer.tree() for layer in model.layers]}
    with torch.inference_mode():
        ranges = tuple(torch.from_numpy(a) for a in key_ranges(mask_np))
        cos, sin = tl.rope_tables(ids.shape[1], cfg.hd, cfg.rope_theta)
        h = embed(cfg, model.embed, ids, dtype)
        for layer in model.layers:
            h = layer(h, *ranges, cos, sin)
        got = rms_norm(h, model.final_norm, cfg.rms_norm_eps)
        want = tl.forward_hidden(cfg, tree, ids, mask)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
