"""The port's softcapped attention (K4) against the JAX package's.

CPU: the port's plain version (what ``flash_softcap_attention`` runs for CPU
tensors) against ``easyrag_tpu.ops.flash_softcap.flash_softcap_attention``
under ``pltpu.force_tpu_interpret_mode()``, as ``tests/test_flash_softcap.py``
runs it: GQA 1:1, 2:1 and 4:1 at head_dim 128; S=64 with ``block_q=24`` on
the JAX side (several blocks and a ragged tail) and S=136; softcap 20 and 0.
f32, rtol and atol 2e-4 (the JAX tests' own). Under right padding (pad
positions filled with large values) only real rows are compared, and pad
rows must be finite.

CUDA (marked ``cuda``, skipped without a card): the hand-written kernel
against the plain version in bf16, at head_dim 256 and 128, S=1152 and 640
(the Gemma2 reranker's before and after its compression) and ragged S. Each real row of
one head must agree within 1.6e-2 of the row's largest ``|plain|``: the
kernel rounds the unnormalised probabilities to bf16 and divides at the end,
the plain version rounds the normalised ones (the bound of the K1 and K3
tests). The wrapper refuses what the kernel does not take, without launching.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from easyrag_tpu_torch.ops import flash_softcap as k4

torch.set_num_threads(1)

ROW_RTOL = 1.6e-2  # two bf16 roundings of the row's largest value


def _inputs(B, S, nh, nkv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, nh * hd)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv * hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv * hd)).astype(np.float32)
    return q, k, v


def _jax_k4(q, k, v, nh, nkv, scale, cap, block_q=None):
    from jax.experimental.pallas import tpu as pltpu

    from easyrag_tpu.ops.flash_softcap import flash_softcap_attention

    with pltpu.force_tpu_interpret_mode():
        out = flash_softcap_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=nh, num_kv_heads=nkv,
            sm_scale=scale, softcap=cap, block_q=block_q,
        )
    return np.asarray(out)


def _port(q, k, v, nh, nkv, scale, cap):
    before = k4.launches
    out = k4.flash_softcap_attention(*(torch.from_numpy(a) for a in (q, k, v)), nh, nkv, scale, cap).numpy()
    assert k4.launches == before  # CPU tensors take the plain version
    return out


@pytest.mark.parametrize("cap", [20.0, 0.0])
@pytest.mark.parametrize("S,block_q", [(64, 24), (136, None)])
@pytest.mark.parametrize("nkv", [4, 2, 1])
def test_plain_matches_jax_kernel(nkv, S, block_q, cap):
    nh, hd, scale = 4, 128, 0.11
    q, k, v = _inputs(2, S, nh, nkv, hd, seed=S + nkv + int(cap))
    ref = _jax_k4(q, k, v, nh, nkv, scale, cap, block_q)
    got = _port(q, k, v, nh, nkv, scale, cap)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_plain_matches_jax_kernel_under_right_padding():
    """Rows past each row's length hold large values, as pad tokens can; the
    real rows must not see them, and the pad rows must stay finite."""
    nh, nkv, hd, S, scale, cap = 4, 2, 128, 136, 0.11, 50.0
    q, k, v = _inputs(2, S, nh, nkv, hd, seed=7)
    lengths = [136, 93]
    for b, n in enumerate(lengths):
        for a in (q, k, v):
            a[b, n:] = 1e3
    ref = _jax_k4(q, k, v, nh, nkv, scale, cap)
    got = _port(q, k, v, nh, nkv, scale, cap)
    real = np.arange(S)[None, :] < np.array(lengths)[:, None]
    np.testing.assert_allclose(got[real], ref[real], rtol=2e-4, atol=2e-4)
    assert np.isfinite(got).all()


def test_plain_matches_numpy_oracle_at_head_dim_256():
    """The Gemma2 shape (16 heads of 256 on 8, softcap 50, scale 1/16) at a
    small S, against softcap -> causal mask -> softmax in numpy f64."""
    B, S, nh, nkv, hd, scale, cap = 1, 24, 16, 8, 256, 1 / 16, 50.0
    q, k, v = _inputs(B, S, nh, nkv, hd, seed=11)
    q *= 4.0  # logits past the cap's knee
    krep = np.repeat(k.reshape(B, S, nkv, hd), 2, axis=2).astype(np.float64)
    vrep = np.repeat(v.reshape(B, S, nkv, hd), 2, axis=2).astype(np.float64)
    logits = np.einsum("bqhd,bkhd->bhqk", q.reshape(B, S, nh, hd).astype(np.float64), krep) * scale
    logits = np.tanh(logits / cap) * cap
    logits = np.where(np.tril(np.ones((S, S), bool)), logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", p, vrep).reshape(B, S, nh * hd)
    got = _port(q, k, v, nh, nkv, scale, cap)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 512)
    kv = torch.zeros(1, 8, 256)
    with pytest.raises(ValueError):
        k4.flash_softcap_attention(q, kv[:, :4], kv[:, :4], 4, 2, 1.0)  # sequence lengths differ
    with pytest.raises(ValueError):
        k4.flash_softcap_attention(q, kv, kv, 4, 3, 1.0)  # 4 query heads on 3 KV heads
    with pytest.raises(ValueError):
        k4.flash_softcap_attention(q, kv, kv, 2, 2, 1.0)  # k is not 2 heads of 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    before = k4.launches
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _inputs(1, 64, 4, 2, 64, seed=5))
    with pytest.raises(ValueError, match="head_dim"):
        k4.flash_softcap_attention(q, k, v, 4, 2, 0.125, 50.0)
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _inputs(1, 64, 2, 1, 256, seed=5))
    with pytest.raises(TypeError):
        k4.flash_softcap_attention(q, k, v, 2, 1, 1 / 16, 50.0)  # f32
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _inputs(1, 60, 2, 1, 256, seed=5))
    with pytest.raises(ValueError, match="multiple of 8"):
        k4.flash_softcap_attention(q, k, v, 2, 1, 1 / 16, 50.0)
    assert k4.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,nh,nkv,hd,lengths,cap",
    [
        (2, 1152, 16, 8, 256, [1152, 300], 50.0),
        (3, 136, 16, 8, 256, [136, 93, 8], 50.0),
        (2, 640, 16, 8, 256, [640, 17], 0.0),
        (2, 264, 8, 2, 128, [264, 100], 20.0),
        (4, 640, 16, 8, 256, [640, 600, 311, 40], 50.0),  # the compressed layers' S
        (2, 1152, 8, 2, 128, [1152, 700], 50.0),
        (2, 640, 8, 4, 128, [640, 77], 0.0),
    ],
)
def test_kernel_matches_plain_on_card(cuda, B, S, nh, nkv, hd, lengths, cap):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _inputs(B, S, nh, nkv, hd, seed=S + hd))
    q = q * 4.0  # logits past the cap's knee
    for b, n in enumerate(lengths):  # right padding: zero vectors, as after a compression
        for t in (q, k, v):
            t[b, n:] = 0.0
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    scale = hd ** -0.5
    before = k4.launches
    got = k4.flash_softcap_attention(q, k, v, nh, nkv, scale, cap)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    ref = k4.flash_softcap_attention_plain(q, k, v, nh, nkv, scale, cap)
    assert torch.isfinite(got.float()).all()  # pad rows included
    real = torch.arange(S, device=cuda)[None, :] < torch.tensor(lengths, device=cuda)[:, None]
    g, r = got[real].float().reshape(-1, hd), ref[real].float().reshape(-1, hd)
    assert ((g - r).abs() <= ROW_RTOL * r.abs().amax(dim=1, keepdim=True)).all()
