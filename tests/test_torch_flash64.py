"""The port's head_dim-64 attention against the JAX package's.

CPU: the port's plain version (what ``flash64_attention`` runs for CPU
tensors) against ``easyrag_tpu``'s Pallas kernel in interpret mode (left
padding, with and without in-kernel RoPE) and against the einsum formulation
(right padding, which the TPU kernel does not support). f32, real rows, max
abs error 1e-5; pad rows must be finite.

CUDA (marked ``cuda``, skipped without a card): the hand-written kernel
against the plain version in bf16. Each real row of one head (64 values)
must agree within ``KERNEL_ROW_RTOL`` times the row's largest ``|plain|``:
the kernel rounds the unnormalised probabilities to bf16 and divides at the
end, the plain version rounds the normalised ones, which moves an output by
about one bf16 rounding of its own size, at most one of the row's largest.
A bound relative to the row, not to each element, stays tight for long rows
(outputs near 0.05) without failing where an element cancels to near zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from easyrag_tpu.models.layers import attention_bias_from_mask, rope_tables
from easyrag_tpu.ops.flash64 import flash64_attention as jax_flash64
from easyrag_tpu_torch.ops import flash64 as f64

torch.set_num_threads(1)

KERNEL_ROW_RTOL = 1.6e-2  # two bf16 roundings of the row's largest value


def _qkv(B, S, H, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, B, S, H * 64)).astype(np.float32)


def _ranges(mask):
    """[B, S] contiguous 0/1 mask -> (kv_start, kv_end) int32."""
    idx = np.arange(mask.shape[1])
    start = np.where(mask.any(1), np.argmax(mask, 1), 0)
    end = np.where(mask.any(1), mask.shape[1] - np.argmax(mask[:, ::-1], 1), 0)
    assert (mask == ((idx >= start[:, None]) & (idx < end[:, None]))).all()
    return torch.from_numpy(start.astype(np.int32)), torch.from_numpy(end.astype(np.int32))


def _port(q, k, v, mask, scale, cos=None, sin=None):
    s, e = _ranges(mask)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return f64.flash64_attention(t(q), t(k), t(v), s, e, scale, t(cos), t(sin)).numpy()


def _left_mask(B, S, pads):
    mask = np.ones((B, S), np.int32)
    for b, p in enumerate(pads):
        mask[b, :p] = 0
    return mask


@pytest.mark.parametrize("rope", [False, True])
def test_plain_matches_jax_kernel_left_padding(rope):
    from jax.experimental.pallas import tpu as pltpu

    B, S, H = 2, 256, 2
    q, k, v = _qkv(B, S, H, seed=1 + rope)
    mask = _left_mask(B, S, [0, 100])
    scale = 64 ** -0.5
    cos = sin = None
    if rope:
        c, s_ = rope_tables(jnp.arange(S, dtype=jnp.int32)[None, :], 64, 10000.0)
        cos, sin = np.asarray(c[0]), np.asarray(s_[0])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(
            jax_flash64(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale,
                block_q=128,
                cos=None if cos is None else jnp.asarray(cos),
                sin=None if sin is None else jnp.asarray(sin),
            )
        )
    got = _port(q, k, v, mask, scale, cos, sin)
    real = mask.astype(bool)
    assert np.abs(got[real] - ref[real]).max() <= 1e-5
    assert np.isfinite(got).all()


def _assert_rows_close(got, ref):
    """``got``/``ref``: [n, H*64] real rows; per head row of 64 values."""
    g, r = got.float().reshape(-1, 64), ref.float().reshape(-1, 64)
    bound = KERNEL_ROW_RTOL * r.abs().amax(dim=1, keepdim=True)
    assert ((g - r).abs() <= bound).all(), float(((g - r).abs() / bound.clamp_min(1e-30)).max())


def _einsum_reference(q, k, v, mask, scale):
    """The JAX package's einsum attention path (layers.attention without
    the projections)."""
    B, S, F = q.shape
    H = F // 64
    qh, kh, vh = (jnp.asarray(a).reshape(B, S, H, 64) for a in (q, k, v))
    logits = jnp.einsum("bqhd,bkhd->bhqk", qh, kh, preferred_element_type=jnp.float32) * scale
    logits = logits + attention_bias_from_mask(jnp.asarray(mask))
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(jnp.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(B, S, F))


def test_plain_matches_einsum_right_padding():
    B, S, H = 3, 96, 2
    q, k, v = _qkv(B, S, H, seed=5)
    mask = np.zeros((B, S), np.int32)
    for b, n in enumerate([96, 41, 7]):
        mask[b, :n] = 1
    got = _port(q, k, v, mask, 0.125)
    ref = _einsum_reference(q, k, v, mask, 0.125)
    real = mask.astype(bool)
    assert np.abs(got[real] - ref[real]).max() <= 1e-5
    assert np.isfinite(got).all()


def test_plain_rows_without_keys_stay_finite():
    B, S, H = 2, 64, 2
    q, k, v = _qkv(B, S, H, seed=7)
    got = f64.flash64_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.tensor([10, 0], dtype=torch.int32),
        torch.tensor([10, 0], dtype=torch.int32),  # empty ranges
        0.125,
    )
    assert torch.isfinite(got).all()


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 128)
    r = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        f64.flash64_attention(q, q[:, :4], q, r, r, 1.0)
    with pytest.raises(ValueError):
        f64.flash64_attention(q, q, q, r, r, 1.0, cos=torch.zeros(8, 64))
    with pytest.raises(ValueError):
        f64.flash64_attention(torch.zeros(1, 8, 96), torch.zeros(1, 8, 96), torch.zeros(1, 8, 96), r, r, 1.0)


def _ranges_for(side, S, n_real, dev):
    """``(kv_start, kv_end)`` of rows holding ``n_real`` real tokens, padded
    on ``side``; a row of 0 has an empty range."""
    start = [S - n for n in n_real] if side == "left" else [0] * len(n_real)
    end = [S] * len(n_real) if side == "left" else list(n_real)
    return (torch.tensor(start, dtype=torch.int32, device=dev), torch.tensor(end, dtype=torch.int32, device=dev))


def _rope_for(S, dev):
    inv = 1.0 / (10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64))
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().to(dev), ang.sin().to(dev)


def _check_on_card(q, k, v, kv_s, kv_e, cos, sin):
    before = f64.launches
    got = f64.flash64_attention(q, k, v, kv_s, kv_e, 0.125, cos, sin)
    torch.cuda.synchronize()
    assert f64.launches == before + 1
    ref = f64.flash64_attention_plain(q, k, v, kv_s, kv_e, 0.125, cos, sin)
    assert torch.isfinite(got.float()).all()  # pad rows included
    pos = torch.arange(q.shape[1], device=q.device)
    real = (pos[None, :] >= kv_s[:, None]) & (pos[None, :] < kv_e[:, None])
    _assert_rows_close(got[real], ref[real])
    return got


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("side", ["left", "right"])
def test_kernel_matches_plain_on_card(cuda, rope, side):
    # ragged last tile; pads longer than one 64-key tile; rows up to 16 k
    # tiles long, where a fault in one tile or key moves the output least
    B, S, H = 3, 1000, 4
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _qkv(B, S, H, seed=11))
    kv_s, kv_e = _ranges_for(side, S, [1000, 731, 9], cuda)
    _check_on_card(q, k, v, kv_s, kv_e, *(_rope_for(S, cuda) if rope else (None, None)))


@pytest.mark.cuda
def test_kernel_single_ragged_tile_and_empty_row_on_card(cuda):
    B, S, H = 2, 40, 2  # one ragged tile; row 1 has no valid key at all
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _qkv(B, S, H, seed=13))
    kv_s = torch.tensor([3, 0], dtype=torch.int32, device=cuda)
    kv_e = torch.tensor([40, 0], dtype=torch.int32, device=cuda)
    got = f64.flash64_attention(q, k, v, kv_s, kv_e, 0.125)
    ref = f64.flash64_attention_plain(q, k, v, kv_s, kv_e, 0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got[1] == 0).all()  # rows that visit no key tile write zeros
    _assert_rows_close(got[0, 3:], ref[0, 3:])


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("S", [1064, 8])
def test_kernel_ragged_lengths_and_empty_row_on_card(cuda, S, side, rope):
    # the last 128-row q tile and 64-key tile are ragged at both S; rows of
    # full length, 40, 1 and none
    B, H = 4, 4
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _qkv(B, S, H, seed=S + len(side) + rope))
    kv_s, kv_e = _ranges_for(side, S, [S, min(40, S), 1, 0], cuda)
    cos, sin = _rope_for(S, cuda) if rope else (None, None)
    got = _check_on_card(q, k, v, kv_s, kv_e, cos, sin)
    assert (got[3] == 0).all()  # the empty row visits no key tile and writes zeros


@pytest.mark.cuda
def test_kernel_at_the_reranker_shape_on_card(cuda):
    # the pipeline's MiniCPM batch: B=32, S=1216, 36 heads, RoPE, right
    # padding, lengths between 60% and all of S, one full and one 40 long
    B, S, H = 32, 1216, 36
    rng = np.random.default_rng(1216)
    lengths = rng.integers(S * 6 // 10, S + 1, size=B).tolist()
    lengths[0], lengths[-1] = S, 40
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H * 64), dtype=np.float32)).to(cuda, torch.bfloat16)
               for _ in range(3))
    kv_s, kv_e = _ranges_for("right", S, lengths, cuda)
    _check_on_card(q, k, v, kv_s, kv_e, *_rope_for(S, cuda))


def test_kernel_names_carry_the_benchmark_marks():
    # benchmark/metrics/k1_roofline_pct.query.py sums the device time of every
    # kernel whose name holds flash64_kernel or rope_k_kernel: a kernel K1
    # launches under another name would fall out of K1's time
    import pathlib
    import re

    src = (pathlib.Path(f64.__file__).parent.parent / "csrc" / "flash64.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert len(names) == src.count("__global__") >= 2
    assert all("flash64_kernel" in n or "rope_k_kernel" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize(
    "B, S, H",
    [
        (1, 64, 2),  # fewer work items than SMs
        (5, 1000, 36),  # a work count that is no multiple of the persistent CTAs
        (4, 1216, 8),  # S a multiple of neither the 128-key tile nor the 128-row q tile
        (4, 1000, 8),
        (4, 8, 8),
        (8, 1216, 36),  # the tail buckets
        (16, 1216, 36),
    ],
)
def test_kernel_persistent_schedule_edges_on_card(cuda, B, S, H, side):
    # rows of full length, one token and none where B allows, the rest
    # random; two calls on the same inputs give the same bits
    rng = np.random.default_rng(B * 7919 + S + H + len(side))
    lengths = rng.integers(1, S + 1, size=B).tolist()
    for i, n in enumerate([S, 1, 0][:B]):
        lengths[i] = n
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H * 64), dtype=np.float32)).to(cuda, torch.bfloat16)
               for _ in range(3))
    kv_s, kv_e = _ranges_for(side, S, lengths, cuda)
    cos, sin = _rope_for(S, cuda)
    got = _check_on_card(q, k, v, kv_s, kv_e, cos, sin)
    again = f64.flash64_attention(q, k, v, kv_s, kv_e, 0.125, cos, sin)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if B >= 3:
        assert (got[2] == 0).all()  # the empty row writes zeros
