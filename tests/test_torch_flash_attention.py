"""The port's K3 attention against the JAX package's.

CPU: the port's plain version (what ``flash_attention`` runs for CPU tensors)
against the stock Pallas TPU ``flash_attention`` under
``pltpu.force_tpu_interpret_mode()``, called as both of its JAX call sites
call it: K/V repeated over the query groups, heads transposed, padding as
segment ids, left padding as ``easyrag_tpu/models/decode.py::_prefill_layer``
gives it and right padding as ``easyrag_tpu/models/layers.py:351`` gives it
for the gte-Qwen2 embedder (where the port passes ``kv_start = 0, kv_end =
length``). f32, real rows within atol 2e-5 (f32 sums in another order); every
output, pad rows included, must be finite. Head_dim 128, and head_dim 64 and
192 with grouped KV heads at the block sizes of JAX's fallback for head dims
that are not multiples of 128 (``easyrag_tpu/models/layers.py:333-340``),
and head_dim 576, past the 512 where the card's kernel starts streaming Q and
K through shared memory.

CUDA (marked ``cuda``, skipped without a card): the hand-written kernel
against the plain version in bf16 at S=1024, left and right padded, at
head_dim 128, at head_dim 64 (GQA) and 256 with ragged rows, at 192, 320,
384, 448 and 512 (past 256 the kernel splits V's columns into groups), and
at 576, 768 and 1024 (past 512 Q and K stream through shared memory in
64-dim panels). Each real row of one head must agree within 1.6e-2 of the
row's largest ``|plain|``: the kernel rounds the unnormalised probabilities
to bf16 and divides at the end, the plain version rounds the normalised ones
(the bound of the K1 tests). A head dim that is not a multiple of 64 raises
without a launch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from easyrag_tpu_torch.ops import flash_attention as k3

torch.set_num_threads(1)

ROW_RTOL = 1.6e-2  # two bf16 roundings of the row's largest value


def _inputs(B, S, nh, nkv, seed, hd=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, nh * hd)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv * hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv * hd)).astype(np.float32)
    return q, k, v


def _stock(q, k, v, mask, nh, nkv, scale, hd=128):
    """The JAX package's call (decode.py:109-141, layers.py:321-361), in
    interpret mode; at head_dim 64 with the block sizes of JAX's fallback
    (q block 384 or the largest of 512/256/128 dividing S, k block S)."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, SegmentIds, flash_attention

    B, S, _ = q.shape
    qh = jnp.asarray(q).reshape(B, S, nh, hd)
    kh = jnp.repeat(jnp.asarray(k).reshape(B, S, nkv, hd), nh // nkv, axis=2)
    vh = jnp.repeat(jnp.asarray(v).reshape(B, S, nkv, hd), nh // nkv, axis=2)
    seg = jnp.asarray(mask, jnp.int32)
    blocks = None
    if hd % 128:
        bq = 384 if S % 384 == 0 else max(b for b in (512, 256, 128) if S % b == 0)
        blocks = BlockSizes(
            block_q=bq, block_k_major=S, block_k=S, block_b=1, block_q_major_dkv=bq, block_k_major_dkv=S,
            block_k_dkv=S, block_q_dkv=bq, block_k_major_dq=S, block_k_dq=S, block_q_dq=bq,
        )
    with pltpu.force_tpu_interpret_mode():
        out = flash_attention(
            qh.transpose(0, 2, 1, 3), kh.transpose(0, 2, 1, 3), vh.transpose(0, 2, 1, 3),
            segment_ids=SegmentIds(seg, seg), causal=True, sm_scale=scale, block_sizes=blocks,
        )
    return np.asarray(out.transpose(0, 2, 1, 3).reshape(B, S, nh * hd))


@pytest.mark.parametrize("nh,nkv", [(2, 1), (2, 2)])
def test_plain_matches_stock_kernel_left_padding(nh, nkv):
    B, S = 2, 256
    q, k, v = _inputs(B, S, nh, nkv, seed=nh + nkv)
    lengths = np.array([S, S - 100])
    mask = (np.arange(S)[None, :] >= (S - lengths)[:, None]).astype(np.int32)
    scale = 128 ** -0.5
    ref = _stock(q, k, v, mask, nh, nkv, scale)
    got = k3.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy((S - lengths).astype(np.int32)), torch.full((B,), S, dtype=torch.int32), scale, nkv,
    ).numpy()
    real = mask.astype(bool)
    assert np.abs(got[real] - ref[real]).max() <= 2e-5
    assert np.isfinite(got).all()


@pytest.mark.parametrize("nh,nkv", [(2, 1), (4, 2)])
def test_plain_matches_stock_kernel_right_padding(nh, nkv):
    """The embedder's call (``layers.py:351``): right padding, a
    batch-padding row with one real token."""
    B, S = 3, 256
    q, k, v = _inputs(B, S, nh, nkv, seed=10 + nh)
    lengths = np.array([S, 130, 1])
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    scale = 128 ** -0.5
    ref = _stock(q, k, v, mask, nh, nkv, scale)
    got = k3.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.zeros(B, dtype=torch.int32), torch.from_numpy(lengths.astype(np.int32)), scale, nkv,
    ).numpy()
    real = mask.astype(bool)
    assert np.abs(got[real] - ref[real]).max() <= 2e-5
    assert np.isfinite(got).all()


@pytest.mark.parametrize("side", ["left", "right"])
def test_plain_matches_stock_kernel_head_dim_64_gqa(side):
    """Head_dim 64 with 4 query heads on 1 KV head: JAX's fallback branch of
    the stock kernel, which the port's K3 kernel now takes on the card."""
    B, S, nh, nkv, hd = 2, 256, 4, 1, 64
    q, k, v = _inputs(B, S, nh, nkv, seed=20 + len(side), hd=hd)
    lengths = np.array([S, 90])
    pos = np.arange(S)[None, :]
    if side == "left":
        kv_s, kv_e = S - lengths, np.full(B, S)
    else:
        kv_s, kv_e = np.zeros(B, np.int64), lengths
    mask = ((pos >= kv_s[:, None]) & (pos < kv_e[:, None])).astype(np.int32)
    scale = hd ** -0.5
    ref = _stock(q, k, v, mask, nh, nkv, scale, hd=hd)
    got = k3.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(kv_s.astype(np.int32)), torch.from_numpy(kv_e.astype(np.int32)), scale, nkv,
    ).numpy()
    real = mask.astype(bool)
    assert np.abs(got[real] - ref[real]).max() <= 2e-5
    assert np.isfinite(got).all()


@pytest.mark.parametrize("side", ["left", "right"])
def test_plain_matches_stock_kernel_head_dim_192(side):
    """Head_dim 192 (a multiple of 64, not of 128) with 2 query heads on 1 KV
    head: JAX sends it to the stock kernel with its fallback block sizes, and
    the port's K3 kernel takes it on the card."""
    B, S, nh, nkv, hd = 2, 256, 2, 1, 192
    q, k, v = _inputs(B, S, nh, nkv, seed=30 + len(side), hd=hd)
    lengths = np.array([S, 77])
    pos = np.arange(S)[None, :]
    if side == "left":
        kv_s, kv_e = S - lengths, np.full(B, S)
    else:
        kv_s, kv_e = np.zeros(B, np.int64), lengths
    mask = ((pos >= kv_s[:, None]) & (pos < kv_e[:, None])).astype(np.int32)
    scale = hd ** -0.5
    ref = _stock(q, k, v, mask, nh, nkv, scale, hd=hd)
    got = k3.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(kv_s.astype(np.int32)), torch.from_numpy(kv_e.astype(np.int32)), scale, nkv,
    ).numpy()
    real = mask.astype(bool)
    assert np.abs(got[real] - ref[real]).max() <= 2e-5
    assert np.isfinite(got).all()


@pytest.mark.parametrize("side", ["left", "right"])
def test_plain_matches_stock_kernel_head_dim_576(side):
    """Head_dim 576 (past 512: the card's kernel streams Q and K through
    shared memory) with 2 query heads on 1 KV head, as JAX sends it to the
    stock kernel with its fallback block sizes."""
    B, S, nh, nkv, hd = 2, 128, 2, 1, 576
    q, k, v = _inputs(B, S, nh, nkv, seed=40 + len(side), hd=hd)
    lengths = np.array([S, 45])
    pos = np.arange(S)[None, :]
    if side == "left":
        kv_s, kv_e = S - lengths, np.full(B, S)
    else:
        kv_s, kv_e = np.zeros(B, np.int64), lengths
    mask = ((pos >= kv_s[:, None]) & (pos < kv_e[:, None])).astype(np.int32)
    scale = hd ** -0.5
    ref = _stock(q, k, v, mask, nh, nkv, scale, hd=hd)
    got = k3.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(kv_s.astype(np.int32)), torch.from_numpy(kv_e.astype(np.int32)), scale, nkv,
    ).numpy()
    real = mask.astype(bool)
    assert np.abs(got[real] - ref[real]).max() <= 2e-5
    assert np.isfinite(got).all()


def test_kernel_head_dim_rule():
    """The head dims the kernel takes: every multiple of 64, as JAX sends
    any to the stock kernel. The wrapper keeps no list and no cap, and the
    CUDA entry point sends head dims past 512 to the streaming kernel."""
    import os

    assert not hasattr(k3, "HEAD_DIMS") and not hasattr(k3, "MAX_HEAD_DIM")
    src = os.path.join(os.path.dirname(k3.__file__), "..", "csrc", "flash_attention.cu")
    with open(src, encoding="utf-8") as f:
        assert "if (HD > 512 && HD % 64 == 0)" in f.read()


def test_plain_rows_without_keys_stay_finite():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 64, 4, 2, seed=3))
    got = k3.flash_attention(q, k, v, torch.tensor([10, 0], dtype=torch.int32),
                             torch.tensor([10, 0], dtype=torch.int32), 0.1, 2)
    assert torch.isfinite(got).all()


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 256)
    kv = torch.zeros(1, 8, 128)
    r = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        k3.flash_attention(q, kv[:, :4], kv[:, :4], r, r, 1.0, 1)  # sequence lengths differ
    with pytest.raises(ValueError):
        k3.flash_attention(q, kv, kv, r, r, 1.0, 3)  # 128 is not 3 heads
    with pytest.raises(ValueError):
        k3.flash_attention(torch.zeros(1, 8, 192), kv, kv, r, r, 1.0, 2)  # 3 query heads on 2 KV heads
    with pytest.raises(ValueError):
        k3.flash_attention(q, kv, kv, torch.zeros(2, dtype=torch.int32), r, 1.0, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [96, 160])
def test_kernel_raises_at_other_head_dims(cuda, hd):
    """The kernel takes head dims that are multiples of 64; on the card any
    other head dim raises, and never runs the plain version."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _inputs(1, 128, 2, 1, seed=5, hd=hd))
    r = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = k3.launches
    with pytest.raises(ValueError, match="head_dim"):
        k3.flash_attention(q, k, v, r, r + 128, hd ** -0.5, 1)
    assert k3.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("lengths", [[1024, 1024], [1024, 41], [700, 0], [130, 1]])
def test_kernel_matches_plain_on_card(cuda, lengths, side):
    B, S, nh, nkv = 2, 1024, 8, 2
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _inputs(B, S, nh, nkv, seed=sum(lengths)))
    n = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if side == "left":
        kv_s, kv_e = S - n, torch.full((B,), S, dtype=torch.int32, device=cuda)
    else:  # the embedder's padding
        kv_s, kv_e = torch.zeros(B, dtype=torch.int32, device=cuda), n
    before = k3.launches
    got = k3.flash_attention(q, k, v, kv_s, kv_e, 128 ** -0.5, nkv)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ref = k3.flash_attention_plain(q, k, v, kv_s, kv_e, 128 ** -0.5, nkv)
    assert torch.isfinite(got.float()).all()  # pad rows included
    pos = torch.arange(S, device=cuda)[None, :]
    real = (pos >= kv_s[:, None]) & (pos < kv_e[:, None])
    g, r = got[real].float().reshape(-1, 128), ref[real].float().reshape(-1, 128)
    assert ((g - r).abs() <= ROW_RTOL * r.abs().amax(dim=1, keepdim=True)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("hd,nh,nkv,S,lengths", [
    (64, 28, 4, 1024, [1024, 700, 41, 0]),  # head_dim-64 GQA, 7 query heads a KV head
    (64, 4, 4, 200, [200, 130, 1, 65]),  # ragged last q and k tiles
    (256, 8, 4, 1024, [1024, 500, 41, 0]),
    (256, 4, 1, 136, [136, 93, 64, 8]),
])
def test_kernel_matches_plain_at_head_dims_64_and_256(cuda, hd, nh, nkv, S, lengths, side):
    B = len(lengths)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _inputs(B, S, nh, nkv, seed=S + hd, hd=hd))
    n = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if side == "left":
        kv_s, kv_e = S - n, torch.full((B,), S, dtype=torch.int32, device=cuda)
    else:
        kv_s, kv_e = torch.zeros(B, dtype=torch.int32, device=cuda), n
    before = k3.launches
    got = k3.flash_attention(q, k, v, kv_s, kv_e, hd ** -0.5, nkv)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ref = k3.flash_attention_plain(q, k, v, kv_s, kv_e, hd ** -0.5, nkv)
    assert torch.isfinite(got.float()).all()  # pad rows included
    pos = torch.arange(S, device=cuda)[None, :]
    real = (pos >= kv_s[:, None]) & (pos < kv_e[:, None])
    g, r = got[real].float().reshape(-1, hd), ref[real].float().reshape(-1, hd)
    assert ((g - r).abs() <= ROW_RTOL * r.abs().amax(dim=1, keepdim=True)).all()
    # a row with no key at all writes zeros
    for b, length in enumerate(lengths):
        if length == 0:
            assert (got[b] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("hd,nh,nkv,S,lengths", [
    (192, 8, 2, 1024, [1024, 500, 41, 0]),
    (192, 4, 4, 200, [200, 130, 1, 65]),  # ragged last q and k tiles
    (320, 4, 2, 1024, [1024, 700, 41, 0]),  # V in two column groups (256 + 64), two warpgroups
    (320, 4, 1, 136, [136, 93, 64, 8]),
    (384, 4, 2, 520, [520, 300, 1, 0]),  # one warpgroup, two stages
    (448, 2, 1, 520, [520, 130, 64, 0]),  # two warpgroups, one stage
    (512, 4, 2, 520, [520, 257, 1, 0]),
])
def test_kernel_matches_plain_at_head_dims_192_to_512(cuda, hd, nh, nkv, S, lengths, side):
    B = len(lengths)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _inputs(B, S, nh, nkv, seed=S + hd, hd=hd))
    n = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if side == "left":
        kv_s, kv_e = S - n, torch.full((B,), S, dtype=torch.int32, device=cuda)
    else:
        kv_s, kv_e = torch.zeros(B, dtype=torch.int32, device=cuda), n
    before = k3.launches
    got = k3.flash_attention(q, k, v, kv_s, kv_e, hd ** -0.5, nkv)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ref = k3.flash_attention_plain(q, k, v, kv_s, kv_e, hd ** -0.5, nkv)
    assert torch.isfinite(got.float()).all()  # pad rows included
    pos = torch.arange(S, device=cuda)[None, :]
    real = (pos >= kv_s[:, None]) & (pos < kv_e[:, None])
    g, r = got[real].float().reshape(-1, hd), ref[real].float().reshape(-1, hd)
    assert ((g - r).abs() <= ROW_RTOL * r.abs().amax(dim=1, keepdim=True)).all()
    for b, length in enumerate(lengths):
        if length == 0:
            assert (got[b] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("hd,nh,nkv,S,lengths", [
    (576, 4, 2, 520, [520, 300, 1, 0]),  # Q and K in chunks of 4 + 5 panels, V in 4 + 5
    (768, 2, 1, 264, [264, 130, 64, 8]),
    (1024, 4, 1, 520, [520, 257, 1, 0]),
])
def test_kernel_matches_plain_past_head_dim_512(cuda, hd, nh, nkv, S, lengths, side):
    B = len(lengths)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _inputs(B, S, nh, nkv, seed=S + hd, hd=hd))
    n = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if side == "left":
        kv_s, kv_e = S - n, torch.full((B,), S, dtype=torch.int32, device=cuda)
    else:
        kv_s, kv_e = torch.zeros(B, dtype=torch.int32, device=cuda), n
    before = k3.launches
    got = k3.flash_attention(q, k, v, kv_s, kv_e, hd ** -0.5, nkv)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ref = k3.flash_attention_plain(q, k, v, kv_s, kv_e, hd ** -0.5, nkv)
    assert torch.isfinite(got.float()).all()  # pad rows included
    pos = torch.arange(S, device=cuda)[None, :]
    real = (pos >= kv_s[:, None]) & (pos < kv_e[:, None])
    g, r = got[real].float().reshape(-1, hd), ref[real].float().reshape(-1, hd)
    assert ((g - r).abs() <= ROW_RTOL * r.abs().amax(dim=1, keepdim=True)).all()
    for b, length in enumerate(lengths):
        if length == 0:
            assert (got[b] == 0).all()
