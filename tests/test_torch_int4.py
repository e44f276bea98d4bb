"""The port's weight quantizers and int4 matvec (K2) against the JAX package's.

CPU: the quantizers give the same bytes and scales as
``easyrag_tpu.models.hf_loader``'s numpy versions on the same f32 weights;
K2's plain version (what ``int4_matvec`` runs for CPU tensors) agrees with the
Pallas kernel in interpret mode within rtol 1e-5 in f32 (f32 sums in another
order) and within one bf16 ulp in bf16 (one rounding of nearly equal f32
sums); ``linear`` agrees with ``layers._linear`` in every form within rtol
1e-5 in f32; ``fuse_decode_tree`` builds JAX's fused leaves where the JAX
package fuses, and skips gate/up of unequal widths.

The kernel's host plan (K slices, blocks) is the same at every row count,
and the repack for ``_weight_int4pack_mm`` (the yardstick) dequantizes to
K2's weights.

CUDA (marked ``cuda``, skipped without a card): the kernel against its plain
version in bf16 at the generator's five shapes and at odd ones (one slice, a
last 16-output tile alone), and a row's result with the same bits at every R
from 1 to 64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from easyrag_tpu.models import hf_loader as jh
from easyrag_tpu.models import layers as jl
from easyrag_tpu.ops.int4_matvec import int4_matvec as jax_int4_matvec
from easyrag_tpu_torch.models import layers as tl
from easyrag_tpu_torch.models import quant
from easyrag_tpu_torch.ops import int4_matvec as k2

torch.set_num_threads(1)

QWEN2_7B_SHAPES = {  # [O, I/2] of every int4 matvec a Qwen2-7B decode step makes
    "q": (3584, 1792), "k": (512, 1792), "o": (3584, 1792), "gate": (18944, 1792), "down": (3584, 9472),
    "qkv": (4608, 1792), "gateup": (37888, 1792), "lm_head": (152064, 1792),
}


def _weights(seed, n_out=96, n_in=256):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n_out, n_in)).astype(np.float32) * 0.05
    w[3] = 0.0  # zero row: scale 1
    w[5, :8] = [7.0, 3.5, -3.5, 2.5, -0.5, 0.5, 1.5, -7.0]  # exact halves: round half to even
    w[5, 8:] = 0.0
    return w


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizers_match_jax_bytes(bits):
    w = _weights(bits)
    if bits == 8:
        ref, got = jh.quantize_linear_int8(w), quant.quantize_linear_int8(torch.from_numpy(w))
        np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(ref["w_q"]))
    else:
        ref, got = jh.quantize_linear_int4(w), quant.quantize_linear_int4(torch.from_numpy(w))
        np.testing.assert_array_equal(got["w_p"].numpy(), np.asarray(ref["w_p"]))
        np.testing.assert_array_equal(quant.unpack_int4(got["w_p"]).numpy(), np.asarray(jh.unpack_int4(ref["w_p"])))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))


@pytest.mark.parametrize("rows", [1, 5, 32])
def test_plain_matvec_matches_pallas_interpret_f32(rows):
    rng = np.random.default_rng(rows)
    w = _weights(rows, n_out=256, n_in=512)
    p = jh.quantize_linear_int4(w)
    x = rng.standard_normal((rows, 512)).astype(np.float32)
    ref = np.asarray(jax_int4_matvec(jnp.asarray(x), p["w_p"], p["scale"], interpret=True))
    got = k2.int4_matvec(torch.from_numpy(x), torch.from_numpy(np.array(p["w_p"])), torch.from_numpy(np.array(p["scale"])))
    assert got.dtype == torch.float32 and got.shape == (rows, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_plain_matvec_matches_pallas_interpret_bf16():
    rng = np.random.default_rng(11)
    w = _weights(11, n_out=256, n_in=512)
    p = jh.quantize_linear_int4(w)
    x = jnp.asarray(rng.standard_normal((8, 512)).astype(np.float32), jnp.bfloat16)
    ref = np.asarray(jax_int4_matvec(x, p["w_p"], p["scale"], interpret=True), np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = k2.int4_matvec(xt, torch.from_numpy(np.array(p["w_p"])), torch.from_numpy(np.array(p["scale"])))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()


def _jax_linear_cases(rng):
    w = rng.standard_normal((128, 256)).astype(np.float32) * 0.05
    b = rng.standard_normal((128,)).astype(np.float32)
    return {
        "dense": {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        "int8": {**jh.quantize_linear_int8(w), "b": jnp.asarray(b)},
        "int4": {**jh.quantize_linear_int4(w), "b": jnp.asarray(b)},
    }


@pytest.mark.parametrize("form", ["dense", "int8", "int4"])
@pytest.mark.parametrize("shape", [(2, 3), (4, 40)])  # 6 rows take K2, 160 rows the unpacked product
def test_linear_matches_jax(form, shape):
    rng = np.random.default_rng(len(form) + shape[1])
    p = _jax_linear_cases(rng)[form]
    x = rng.standard_normal((*shape, 256)).astype(np.float32)
    ref = np.asarray(jl._linear(jnp.asarray(x), p))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    before = k2.launches
    got = tl.linear(torch.from_numpy(x), tp)
    assert k2.launches == before  # CPU tensors never launch the kernel
    assert got.shape == (*shape, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _tiny_tree(gate_out=512, up_out=512):
    cfg = jl.DecoderConfig(
        vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=1, head_dim=128, attention_bias=True, dtype=jnp.float32,
    )
    params = jl.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    for layer in params["layers"]:
        layer["mlp"]["gate"]["w"] = jnp.asarray(rng.standard_normal((gate_out, 256)).astype(np.float32) * 0.02)
        layer["mlp"]["up"]["w"] = jnp.asarray(rng.standard_normal((up_out, 256)).astype(np.float32) * 0.02)
    return params


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _assert_same_tree(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _assert_same_tree(got[k], ref[k])
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_same_tree(a, b)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("form", ["int8", "int4"])
def test_quantize_and_fuse_tree_match_jax(form):
    params = _tiny_tree()
    ref = jh.quantize_decoder_tree(params, form)
    got = quant.quantize_decoder_tree(_to_torch(params), form)
    _assert_same_tree(got, ref)
    fused_ref, fused = jh.fuse_decode_tree(ref), quant.fuse_decode_tree(got)
    _assert_same_tree(fused, fused_ref)
    if form == "int4":  # the JAX package fuses both groups at this shape
        assert "qkv" in fused["layers"][0]["attn"] and "gateup" in fused["layers"][0]["mlp"]
    else:
        assert "qkv" not in fused["layers"][0]["attn"] and "gateup" not in fused["layers"][0]["mlp"]


def test_fuse_skips_unequal_gate_up_and_ungated_shapes():
    tree = quant.quantize_decoder_tree(_to_torch(_tiny_tree(gate_out=512, up_out=384)), "int4")
    fused = quant.fuse_decode_tree(tree)
    assert "qkv" in fused["layers"][0]["attn"]
    assert set(fused["layers"][0]["mlp"]) == {"gate", "up", "down"}  # the midpoint split would be wrong
    # the JAX package fuses these and mlp then splits them at 448
    assert "gateup" in jh.fuse_decode_tree(jax.tree.map(np.asarray, tree))["layers"][0]["mlp"]
    # a fused width K2 does not take stays unfused
    narrow = {"layers": [{"attn": {n: quant.quantize_linear_int4(torch.randn(8, 64)) for n in "qkv"}, "mlp": {}}]}
    assert set(quant.fuse_decode_tree(narrow)["layers"][0]["attn"]) == {"q", "k", "v"}


def test_kernel_gate_covers_qwen2_7b():
    for n_out, half in QWEN2_7B_SHAPES.values():
        for rows in (1, 4, 32, 64):
            assert k2.supported(rows, n_out, half)
    assert not k2.supported(0, 3584, 1792) and not k2.supported(65, 3584, 1792)
    assert not k2.supported(1, 3584, 96) and not k2.supported(1, 3580, 1792)


K2_SHAPES = {  # [O, I/2] as the generator runs them, fused (chip_smoke.K2_SHAPES)
    "qkv": (4608, 1792), "o": (3584, 1792), "gateup": (37888, 1792), "down": (3584, 9472), "lm_head": (152064, 1792),
}


@pytest.mark.parametrize("name", sorted(K2_SHAPES))
def test_host_plan_is_the_same_at_every_row_count(name):
    """The kernel's K slices and blocks depend on (O, I/2) only: every output
    is summed in one order at every R, so a row has the same bits at R=1 and
    R=32. Slices stay within the kernel's 512-column limit, and the blocks
    fill one wave of the H100 SXM's 132 multiprocessors at most."""
    n_out, half = K2_SHAPES[name]
    sms = 132
    plans = {rows: k2.plan(n_out, half, sms) for rows in range(1, k2.MAX_ROWS + 1) if k2.supported(rows, n_out, half)}
    assert len(plans) == k2.MAX_ROWS and len(set(plans.values())) == 1
    ks, nblk = plans[1]
    steps = half // k2.STEP
    assert 1 <= ks <= steps and -(-steps // ks) <= k2.MAX_SLICE_STEPS
    assert 1 <= nblk <= -(-n_out // k2.TILE_O) and nblk * ks <= sms


@pytest.mark.parametrize("n_out,half,group", [(96, 128, 128), (64, 256, 64)])
def test_int4pack_operands_dequantize_to_k2_weights(n_out, half, group):
    """The yardstick's repack for ``_weight_int4pack_mm``: PyTorch's rule
    ``(u - 8) * scale + zero`` on the repacked bytes gives K2's signed
    nibbles times the bf16-rounded scale, every value -8..7 included."""
    g = torch.Generator().manual_seed(n_out)
    w = torch.randint(-128, 128, (n_out, half), generator=g, dtype=torch.int32).to(torch.int8)
    w[0] = torch.arange(half) % 256 - 128  # every byte, so every pair of nibbles
    scale = torch.rand(n_out, generator=g) * 2e-3 + 1e-4
    w_u8, sz = k2.int4pack_operands(w, scale, group)
    assert w_u8.dtype == torch.uint8 and w_u8.shape == (n_out, half)
    assert sz.dtype == torch.bfloat16 and sz.shape == (2 * half // group, n_out, 2)
    want = quant.unpack_int4(w).float() * scale.to(torch.bfloat16).float()[:, None]
    assert torch.equal(k2.int4pack_dequantize(w_u8, sz), want)
    with pytest.raises(ValueError):
        k2.int4pack_operands(w, scale, 3 * half)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(2, 256)
    w = torch.zeros(64, 128, dtype=torch.int8)
    with pytest.raises(ValueError):
        k2.int4_matvec(x, w[:, :64], torch.ones(64))
    with pytest.raises(ValueError):
        k2.int4_matvec(x, w, torch.ones(63))
    with pytest.raises(TypeError):
        k2.int4_matvec(x, w.to(torch.int32), torch.ones(64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,half", [*K2_SHAPES.values(), (3584, 3584), (512, 1792), (64, 128), (80, 64)])
def test_kernel_matches_plain_and_is_row_count_independent_on_card(cuda, n_out, half):
    g = torch.Generator(device=cuda).manual_seed(n_out)
    w = torch.randint(-128, 128, (n_out, half), generator=g, device=cuda, dtype=torch.int32).to(torch.int8)
    scale = torch.rand(n_out, generator=g, device=cuda) * 0.01 + 1e-3
    x = torch.randn(64, 2 * half, generator=g, device=cuda).to(torch.bfloat16)
    before = k2.launches
    full = {r: k2.int4_matvec(x[:r].contiguous(), w, scale) for r in (1, 5, 8, 32, 33, 64)}
    torch.cuda.synchronize()
    assert k2.launches == before + 6
    for r, y in full.items():
        # one bf16 rounding of each output, plus f32-order slack
        p = k2.int4_matvec_plain(x[:r], w, scale).float()
        bound = 2.0 ** -7 * p.abs() + 1e-4 * p.abs().amax(dim=1, keepdim=True)
        assert ((y.float() - p).abs() <= bound).all()
        assert torch.equal(y, full[64][:r])  # the same bits whatever R is
