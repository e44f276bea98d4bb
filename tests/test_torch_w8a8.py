"""Activation quantization (w8a8, w4a8) in the port against the JAX package.

``layers.linear(x, p, a8=True)`` against JAX's compiled
``layers._linear(x, p, a8=True)`` on int8 and int4 leaves, f32 and bf16:
bit for bit wherever both quantize the activations, which for int4 is where
JAX's TPU kernel gate says no (a port K2 shape that JAX's gate refuses
included). Then the tree forms and the rerankers' ``DecoderLayer`` in f32
against JAX's ``forward_hidden`` and MiniCPM scorer, the model-level
closeness of ``tests/test_w8a8.py`` (cosine > 0.99 and the same ranking as
the weight-only path), and the w8a8 and w4a8 generators' tokens against
JAX's. The card cases (``cuda``): ``torch._int_mm``'s padding at 1-17 rows,
a w8a8 verify block's bits against single steps, and the int8 quantizer on
the card byte-equal to the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from easyrag_tpu.models import decode as jd
from easyrag_tpu.models import hf_loader as jh
from easyrag_tpu.models import layers as jl
from easyrag_tpu.models.minicpm import MiniCPMLayerWiseReranker as JaxReranker
from easyrag_tpu.ops import int4_matvec as jax_i4
from easyrag_tpu_torch.models import decode as td
from easyrag_tpu_torch.models import layers as tl
from easyrag_tpu_torch.models import quant as tq
from easyrag_tpu_torch.models.convert import causal_lm_params_from_jax, minicpm_from_jax
from easyrag_tpu_torch.ops import int4_matvec as port_i4
from test_torch_minicpm import ARCH as MINICPM_ARCH
from test_torch_minicpm import PAIRS, CharTok, tiny_params

torch.set_num_threads(1)

_jit_linear = jax.jit(jl._linear, static_argnames=("a8",))


def _leaf(kind, n_out, n_in, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_out, n_in)).astype(np.float32)
    p = jh.quantize_linear_int8(w) if kind == "int8" else jh.quantize_linear_int4(w)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(rows, n_in, seed, dtype):
    rng = np.random.default_rng(seed + 100)
    x = rng.normal(size=(rows, n_in)).astype(np.float32)
    x *= rng.uniform(0.01, 50.0, size=(rows, 1)).astype(np.float32)  # per-token scales apart
    xj = jnp.asarray(x, dtype)
    return xj, torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.float32 if dtype == jnp.float32 else torch.bfloat16)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,n_out,n_in", [(1, 48, 40), (5, 64, 128), (20, 256, 96), (33, 40, 24)])
def test_int8_a8_linear_is_jax_bit_for_bit(dtype, rows, n_out, n_in):
    p, tp = _leaf("int8", n_out, n_in, rows)
    xj, xt = _x(rows, n_in, rows, dtype)
    want = np.asarray(_jit_linear(xj, p, a8=True).astype(jnp.float32))
    got = tl.linear(xt, tp, a8=True)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), want)
    # the flag changes the function
    assert not np.array_equal(_np(tl.linear(xt, tp)), want)


# (rows, n_out, n_in): JAX's TPU gate says no at each (int4 w4a8 quantizes
# the activations): widths not multiples of 128 where the port's own K2 gate
# takes them (rows <= 64, I/2 % 64, O % 16), and more than 64 rows
JAX_GATE_NO = [(4, 64, 128), (2, 160, 128), (70, 128, 256), (3, 48, 40)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,n_out,n_in", JAX_GATE_NO)
def test_int4_a8_linear_is_jax_bit_for_bit_where_jax_quantizes(dtype, rows, n_out, n_in):
    assert not jax_i4.supported(rows, n_out, n_in // 2)
    assert not tl.tpu_int4_kernel_shape(rows, n_out, n_in // 2)
    p, tp = _leaf("int4", n_out, n_in, rows)
    xj, xt = _x(rows, n_in, rows, dtype)
    want = np.asarray(_jit_linear(xj, p, a8=True).astype(jnp.float32))
    np.testing.assert_array_equal(_np(tl.linear(xt, tp, a8=True)), want)
    if rows <= 64 and port_i4.supported(rows, n_out, n_in // 2):
        # K2's gate takes the shape, JAX's does not: the port follows JAX's
        np.testing.assert_array_equal(_np(tl.linear(xt, tp, a8=True)), want)


@pytest.mark.parametrize("rows,n_out,half", [(1, 128, 128), (64, 256, 128), (8, 512, 256)])
def test_int4_a8_skips_activation_quant_where_jax_takes_its_kernel(rows, n_out, half):
    """At decode shapes JAX's TPU kernel runs without activation quant (and
    its CPU path mirrors that): the port's w4a8 is its weight-only int4
    there, K2's math, equal to JAX's XLA formula to rounding in f32."""
    assert jax_i4.supported(rows, n_out, half) and tl.tpu_int4_kernel_shape(rows, n_out, half)
    p, tp = _leaf("int4", n_out, 2 * half, rows)
    xj, xt = _x(rows, 2 * half, rows, jnp.float32)
    got = tl.linear(xt, tp, a8=True)
    torch.testing.assert_close(got, tl.linear(xt, tp), rtol=0, atol=0)
    want = np.asarray(_jit_linear(xj, p, a8=True))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4 * np.abs(want).max())


def test_jax_int4_gate_copy_agrees_everywhere():
    for rows in (0, 1, 64, 65):
        for n_out in (64, 128, 384, 1024, 3584, 4096, 18944, 37888, 152064):
            for half in (64, 128, 1792, 9472, 12288):
                assert tl.tpu_int4_kernel_shape(rows, n_out, half) == jax_i4.supported(rows, n_out, half), (rows, n_out, half)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_a8_zero_rows_give_zeros(kind):
    _, tp = _leaf(kind, 32, 64, 0)
    x = torch.zeros(70, 64)
    x[3] = 1.0  # one live row among zeros
    y = tl.linear(x, tp, a8=True)
    assert torch.isfinite(y).all() and (y[torch.arange(70) != 3] == 0).all() and (y[3] != 0).any()


def test_a8_error_bound_and_int8_matmul_padding():
    """tests/test_w8a8.py's error bound, and ``int8_matmul``'s zero padding
    (rows to 17, widths to multiples of 8) against an exact int64 product."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(32, 64)).astype(np.float32)
    got = tl.linear(torch.from_numpy(x), tq.quantize_linear_int8(torch.from_numpy(w)), a8=True).numpy()
    exact = x @ w.T
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.05
    for m, k, n in [(1, 13, 5), (16, 8, 8), (17, 24, 9), (40, 7, 3)]:
        a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, size=(n, k)).astype(np.int8))
        y = tl.int8_matmul(a, b)
        assert y.dtype == torch.int32 and y.shape == (m, n)
        torch.testing.assert_close(y.long(), a.long() @ b.long().t(), rtol=0, atol=0)


def _tree_pair(quant, num_layers=3, seed=0):
    cfg = jl.DecoderConfig(dtype=jnp.float32, vocab_size=128, hidden_size=256, intermediate_size=320,
                           num_hidden_layers=num_layers, num_attention_heads=2, num_key_value_heads=1,
                           attention_bias=True)
    params = jl.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for n in "qkv":
            layer["attn"][n]["b"] = jnp.asarray(rng.normal(size=layer["attn"][n]["b"].shape).astype(np.float32) * 0.1)
    params = jh.quantize_decoder_tree(params, {"w8a8": "int8", "w4a8": "int4"}[quant])
    port_cfg = tl.DecoderConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tl.DecoderConfig)
                                   if hasattr(cfg, f.name) and f.name != "act_quant"}, act_quant=True)
    return dataclasses.replace(cfg, act_quant=True), params, port_cfg


@pytest.mark.parametrize("quant", ["w8a8", "w4a8"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_forward_hidden_matches_jax(quant, side):
    jcfg, params, cfg = _tree_pair(quant)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 128, size=(3, 128)).astype(np.int32)
    mask = np.zeros_like(ids)
    for b, n in enumerate((128, 77, 5)):
        if side == "left":
            mask[b, 128 - n:] = 1
        else:
            mask[b, :n] = 1
    want = np.asarray(jax.jit(jl.forward_hidden, static_argnums=0)(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)))
    tp = causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", torch.float32)
    got = tl.forward_hidden(cfg, tp, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    real = mask > 0
    got, want = got[real], want[real]
    # the per-token quantization rounds at thresholds: an f32 difference of
    # rounding size upstream (the two packages sum in other orders) moves an
    # int8 code by one now and then (~1e-5 of the codes here), which moves
    # that token's projection by 1/127 of one input's share, and attention
    # carries it to the row's later tokens. So most tokens agree to f32
    # rounding (median relative L2 ~1e-7) and none by more than 2e-2
    # (measured: 1.2e-2 at most, in the right-padded w4a8 case)
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert np.median(rel) < 1e-6 and rel.max() < 2e-2, (np.median(rel), rel.max())


def _minicpm_pair(quant, side="right", **kw):
    jcfg, params, params_np = tiny_params()
    qparams = jh.quantize_decoder_tree(params, {"w8a8": "int8", "w4a8": "int4"}[quant])
    qparams["heads"] = params["heads"]
    opts = dict(start_layer=1, cutoff_layer=3, max_length=64, efficient_layers=(2,), **kw)
    ref = JaxReranker(dataclasses.replace(jcfg, act_quant=True), qparams, CharTok(side), **opts)
    cfg = tl.DecoderConfig(**MINICPM_ARCH, act_quant=True)
    got = minicpm_from_jax(cfg, jax.tree.map(np.asarray, qparams), "cpu", torch.float32, CharTok(side), **opts)
    return ref, got, params_np


@pytest.mark.parametrize("quant", ["w8a8", "w4a8"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_decoder_layer_reranker_matches_jax(quant, side):
    """The rerankers' DecoderLayer holds the quantized leaves (minicpm_from_jax
    carries them) and computes them through ``linear(..., cfg.act_quant)``."""
    ref, got, _ = _minicpm_pair(quant, side)
    key = "w_q" if quant == "w8a8" else "w_p"
    assert key in got.layers[0].q and got.layers[0].q[key].dtype == torch.int8 and got.cfg.act_quant
    rs, _ = ref.score_pairs(PAIRS)
    gs, _ = got.score_pairs(PAIRS)
    np.testing.assert_allclose(gs, rs, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.argsort(-gs), np.argsort(-np.asarray(rs)))


def test_quantize_in_place_equals_the_jax_quantized_tree():
    ref, got, params_np = _minicpm_pair("w8a8")
    own = minicpm_from_jax(tl.DecoderConfig(**MINICPM_ARCH), params_np, "cpu", torch.float32, CharTok("right"),
                           start_layer=1, cutoff_layer=3, max_length=64)
    tl.quantize_layers_(own, "w8a8")
    for a, b in zip(own.state_dict().items(), got.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    assert own.cfg.act_quant and all(layer.cfg.act_quant for layer in own.layers)
    np.testing.assert_array_equal(own.score_pairs(PAIRS)[0], got.score_pairs(PAIRS)[0])


def test_w8a8_close_and_rank_stable_against_weight_only():
    """The analogue of tests/test_w8a8.py::test_w8a8_forward_close_and_rank_stable
    in the port: per-position cosine > 0.99 and the same last-token ranking
    as the int8 weight-only path, through 4 layers."""
    cfg = jl.DecoderConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                           num_attention_heads=4, num_key_value_heads=4, dtype=jnp.float32)
    params = causal_lm_params_from_jax(
        jax.tree.map(np.asarray, jh.quantize_decoder_tree(jl.init_params(cfg, jax.random.key(0)))), "cpu", torch.float32)
    port_cfg = tl.DecoderConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                                num_attention_heads=4, num_key_value_heads=4)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 128, size=(8, 16)).astype(np.int32))
    mask = torch.ones(8, 16, dtype=torch.int32)
    h_w8 = tl.forward_hidden(port_cfg, params, ids, mask).numpy()
    h_a8 = tl.forward_hidden(dataclasses.replace(port_cfg, act_quant=True), params, ids, mask).numpy()
    cos = np.sum(h_w8 * h_a8, -1) / (np.linalg.norm(h_w8, axis=-1) * np.linalg.norm(h_a8, axis=-1))
    assert cos.min() > 0.99 and not np.array_equal(h_w8, h_a8)
    head = rng.normal(size=(64,)).astype(np.float32)
    assert list(np.argsort(h_w8[:, -1] @ head)) == list(np.argsort(h_a8[:, -1] @ head))


GEN_ARCH = dict(vocab_size=256, hidden_size=256, intermediate_size=320, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=1, head_dim=128, attention_bias=True)


@pytest.mark.parametrize("quant", ["w8a8", "w4a8"])
def test_generator_tokens_match_jax(quant):
    """The analogue of tests/test_decode.py::test_w8a8_decode_matches_growing_forward
    across packages: the same quantized tree, act_quant on, the port's
    greedy and speculative tokens equal JAX's (the intermediate width 320
    keeps JAX's int4 gate shut, so w4a8 quantizes the MLP's activations)."""
    cfg = jl.DecoderConfig(dtype=jnp.float32, **GEN_ARCH)
    params = jl.init_params(cfg, jax.random.key(5))
    rng = np.random.default_rng(5)
    params["lm_head"] = jnp.asarray(rng.standard_normal((256, 256)).astype(np.float32) * 0.05)
    if quant == "w8a8":
        params = jh.quantize_decoder_tree(params, "int8")
        params["lm_head"] = jh.quantize_linear_int8(np.asarray(params["lm_head"]))
    else:
        params = jh.fuse_decode_tree(jh.quantize_decoder_tree(params, "int4"))
        params["embed"] = jh.quantize_linear_int8(np.asarray(params["embed"]))
    jcfg = dataclasses.replace(cfg, act_quant=True)
    tp = causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", torch.float32)
    pcfg = tl.DecoderConfig(**GEN_ARCH, act_quant=True)
    prompts = [[5, 7, 9, 11, 3, 3, 5, 7, 9, 11, 2], [1, 2, 3, 1, 2], [4]]
    rows = np.array([[0] * (16 - len(p)) + p for p in prompts], np.int32)
    masks = np.array([[0] * (16 - len(p)) + [1] * len(p) for p in prompts], np.int32)
    eos = [257]
    want = np.asarray(jd.generate_greedy(jcfg, params, jnp.asarray(rows), jnp.asarray(masks),
                                         jnp.asarray(eos, jnp.int32), 8))
    args = (pcfg, tp, torch.from_numpy(rows), torch.from_numpy(masks), torch.tensor(eos, dtype=torch.int32), 8)
    np.testing.assert_array_equal(td.generate_greedy(*args).numpy(), want)
    np.testing.assert_array_equal(td.generate_greedy_spec(*args, draft_len=3).numpy(), want)


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("rows", list(range(1, 18)))
def test_int_mm_padding_on_card(rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 2304), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (5760, 2304), generator=g, dtype=torch.int8)
    got = tl.int8_matmul(a.cuda(), w.cuda()).cpu()
    assert torch.equal(got, tl.int8_matmul(a, w))
    assert torch.equal(got.long(), a.long() @ w.long().t())
    x = torch.randn(rows, 2304, generator=g).to(torch.bfloat16)
    p = tq.quantize_linear_int8(torch.randn(5760, 2304, generator=g))
    got = tl.linear(x.cuda(), {k: v.cuda() for k, v in p.items()}, a8=True).cpu()
    assert torch.equal(got.view(torch.int16), tl.linear(x, p, a8=True).view(torch.int16))


@pytest.mark.cuda
def test_int8_quantizer_on_card_matches_cpu():
    """The analogue of tests/test_w8a8.py::test_device_quantizer_matches_host:
    the port's quantizer is one function on both devices, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = torch.randn(512, 2304, generator=torch.Generator().manual_seed(3))
    w[5] = 0.0
    host, card = tq.quantize_linear_int8(w), tq.quantize_linear_int8(w.cuda())
    assert torch.equal(card["w_q"].cpu(), host["w_q"]) and torch.equal(card["scale"].cpu(), host["scale"])
    assert host["scale"][5] == 1.0


@pytest.mark.cuda
def test_w8a8_verify_block_equals_single_steps_on_card():
    """Per-token quantization is row-local and ``_int_mm`` is exact, so a
    w8a8 verify block's final hidden states equal, bit for bit, those of
    single steps fed the same tokens (teacher forcing), at Qwen2-7B's
    widths cut to 2 layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = tl.DecoderConfig(vocab_size=1024, hidden_size=3584, intermediate_size=18944, num_hidden_layers=2,
                           num_attention_heads=28, num_key_value_heads=4, rope_theta=1e6, attention_bias=True,
                           act_quant=True)
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16) * 0.02

    d, hd, inter = cfg.hidden_size, cfg.hd, cfg.intermediate_size
    layers = []
    for _ in range(2):
        attn = {n: {**tq.quantize_linear_int8(rnd(o, d)), "b": rnd(o)} for n, o in (("q", 28 * hd), ("k", 4 * hd), ("v", 4 * hd))}
        attn["o"] = tq.quantize_linear_int8(rnd(d, 28 * hd))
        mlp = {n: tq.quantize_linear_int8(rnd(inter, d)) for n in ("gate", "up")}
        mlp["down"] = tq.quantize_linear_int8(rnd(d, inter))
        layers.append({"input_norm": torch.ones(d, device=dev, dtype=torch.bfloat16), "attn": attn, "mlp": mlp,
                       "post_norm": torch.ones(d, device=dev, dtype=torch.bfloat16)})
    params = {"embed": rnd(1024, d), "layers": layers, "final_norm": torch.ones(d, device=dev, dtype=torch.bfloat16)}
    b, s, q = 4, 128, 8
    ids = torch.randint(0, 1024, (b, s), generator=g, device=dev, dtype=torch.int32)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    block = torch.randint(0, 1024, (b, q), generator=g, device=dev, dtype=torch.int32)
    with torch.inference_mode():
        total = s + q
        caches = [td.init_cache(cfg, b, total, torch.bfloat16, dev) for _ in range(2)]
        for cache in caches:
            td._prefill(cfg, params, ids, mask, cache)
        kv_valid = torch.cat([mask > 0, torch.zeros(b, q, dtype=torch.bool, device=dev)], dim=1)
        steps = []
        for j in range(q):  # single steps, teacher-forced
            kv_valid[:, s + j] = True
            cos, sin = tl.rope_tables(torch.full((b, 1), s + j, device=dev), hd, cfg.rope_theta)
            h = tl.embed(cfg, params["embed"], block[:, j : j + 1], torch.bfloat16)
            for idx in range(2):
                h = td._decode_layer(cfg, layers[idx], h, s + j, kv_valid, cos, sin, caches[0][idx])
            steps.append(tl.rms_norm(h, params["final_norm"], cfg.rms_norm_eps))
        slots = s + torch.arange(q, device=dev)[None, :].expand(b, q)
        t_idx = torch.arange(total, device=dev)[None, None, :]
        allowed = (t_idx < s) | ((t_idx >= s) & (t_idx <= slots[:, :, None]))
        cos, sin = tl.rope_tables(slots, hd, cfg.rope_theta)
        h = tl.embed(cfg, params["embed"], block, torch.bfloat16)
        for idx in range(2):
            h = td._verify_layer(cfg, layers[idx], h, slots, allowed, cos, sin, caches[1][idx])
        h = td._row_norm(h, params["final_norm"], cfg.rms_norm_eps)
    assert torch.equal(torch.cat(steps, dim=1).view(torch.int16), h.view(torch.int16))
