"""The MiniCPM decoder layer's fused elementwise chain
(``easyrag_tpu_torch/ops/fused_norm.py``, ``csrc/fused_norm.cu``).

CPU: the plain versions equal the eager op sequence the decoder layer ran
before the kernels (``layers.rms_norm``, ``x + h * r``, ``F.silu(g) * u``) bit
for bit, in bf16 and f32; the kernels' rounding points, written out in f32,
give the same bits (the residual and the activation) or lie within one bf16
ulp (the norm, whose f32 sum of squares is taken in another order); a
MiniCPM ``DecoderLayer`` (``layers.decoder_layer`` with the fused chain)
on the CPU takes the plain path and returns what the eager forward
returns; the reranker's ``fused_chain`` event counts plain calls. No JAX
here: the file also holds the card's tests.

CUDA (marked ``cuda``, skipped without a card): each kernel against its
plain version at the reranker's shapes (``[32 x 1216, 2304]`` and
``[32 x 1216, 5760]``) and at odd row counts. The new residual and the
activation are equal bit for bit, the normalised rows within one bf16 ulp
(adjacent bf16 bit patterns). One full-width MiniCPM layer at B=32, S=1216
against the same layer run by the eager ops; the wrappers' refusals.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from easyrag_tpu_torch.models import layers
from easyrag_tpu_torch.models.layers import DecoderConfig, DecoderLayer, linear, rms_norm
from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker
from easyrag_tpu_torch.ops import fused_norm as fn
from easyrag_tpu_torch.utils import events

torch.set_num_threads(1)

EPS = 1e-5
R = 1.4 / 40 ** 0.5  # MiniCPM's residual scale: scale_depth / sqrt(num_layers)
TINY = DecoderConfig(vocab_size=96, hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                     num_attention_heads=2, num_key_value_heads=2, rms_norm_eps=EPS,
                     scale_emb=12.0, scale_depth=1.4, dim_model_base=64.0)
# bge-reranker-v2-minicpm-layerwise's widths
FULL = DecoderConfig(vocab_size=122753, hidden_size=2304, intermediate_size=5760, num_hidden_layers=40,
                     num_attention_heads=36, num_key_value_heads=36, rms_norm_eps=EPS,
                     scale_emb=12.0, scale_depth=1.4, dim_model_base=256.0)


def _randn(shape, dtype, seed, device="cpu", scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def _ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 steps lie between ``a`` and ``b`` (same-sign values:
    the distance of their bit patterns)."""
    ia, ib = a.view(torch.int16).int(), b.view(torch.int16).int()
    same = (ia < 0) == (ib < 0)
    return torch.where(same, (ia - ib).abs(), torch.where(a == b, 0, 1 << 16))


def _eager_forward(layer: DecoderLayer, x, kv_start, kv_end, cos, sin):
    """A MiniCPM ``DecoderLayer`` as the eager ops ran it before the fused
    chain: the one attention gate between the projections, every other
    step written out."""
    cfg, eps, r = layer.cfg, layer.cfg.rms_norm_eps, layer.cfg.residual_scale
    a8 = cfg.act_quant
    q, k, v = layers.qkv_proj(cfg, layer.tree()["attn"], rms_norm(x, layer.input_norm, eps))
    h = linear(layers.attention(cfg, q, k, v, kv_start, kv_end, cos, sin), layer.o, a8)
    x = x + h * r
    m = rms_norm(x, layer.post_norm, eps)
    h = linear(F.silu(linear(m, layer.gate, a8)) * linear(m, layer.up, a8), layer.down, a8)
    return x + h * r


def _layer(cfg, device, dtype, seed):
    layer = DecoderLayer(cfg, device=device, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name in layers.PROJECTIONS:
            p = getattr(layer, name)["w"]
            p.copy_(torch.randn(p.shape, generator=g, device=device).to(dtype) * 0.02)
        for norm in (layer.input_norm, layer.post_norm):
            norm.copy_((1 + 0.1 * torch.randn(norm.shape, generator=g, device=device)).to(dtype))
    return layer


def _layer_inputs(cfg, B, S, device, dtype, seed, n_real):
    x = _randn((B, S, cfg.hidden_size), dtype, seed, device)
    kv_end = torch.tensor(n_real, dtype=torch.int32, device=device)
    kv_start = torch.zeros_like(kv_end)
    cos, sin = layers.rope_tables(S, cfg.hd, cfg.rope_theta, device=device)
    return x, kv_start, kv_end, cos, sin


# -- CPU ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(1, 8), (7, 16), (33, 2304), (5, 5760)])
def test_plain_versions_equal_the_eager_ops(dtype, rows, d):
    x, h, w = _randn((rows, d), dtype, 1), _randn((rows, d), dtype, 2), _randn((d,), dtype, 3)
    got_x, got_n = fn.residual_rms_norm_plain(x, w, EPS, h, R)
    assert torch.equal(got_x, x + h * R)
    assert torch.equal(got_n, rms_norm(x + h * R, w, EPS))
    same_x, normed = fn.residual_rms_norm_plain(x, w, EPS)
    assert same_x is x and torch.equal(normed, rms_norm(x, w, EPS))
    assert torch.equal(fn.residual_add_plain(x, h, R), x + h * R)
    assert torch.equal(fn.silu_mul_plain(x, h), F.silu(x) * h)


@pytest.mark.parametrize("rows,d", [(1, 8), (7, 16), (33, 2304), (5, 5760)])
def test_the_kernels_rounding_points_give_the_eager_bits(rows, d):
    """The kernels' arithmetic written out in f32 with bf16 roundings
    (``csrc/fused_norm.cu``'s header) against the eager bf16 ops."""
    x, h, w = (_randn(s, torch.bfloat16, seed) for s, seed in (((rows, d), 4), ((rows, d), 5), ((d,), 6)))
    r32 = torch.tensor(R, dtype=torch.float32)
    hr = (h.float() * r32).to(torch.bfloat16)
    x2 = (x.float() + hr.float()).to(torch.bfloat16)
    assert torch.equal(x2, x + h * R)
    xf = x2.float()
    inv = torch.rsqrt((xf * xf).sum(-1, keepdim=True) * torch.tensor(1.0 / d, dtype=torch.float32) + EPS)
    normed = ((xf * inv) * w.float()).to(torch.bfloat16)
    assert _ulps_apart(normed, rms_norm(x2, w, EPS)).max() <= 1
    act = (F.silu(x.float()).to(torch.bfloat16).float() * h.float()).to(torch.bfloat16)
    assert torch.equal(act, F.silu(x) * h)


def test_the_functions_take_the_plain_versions_on_the_cpu():
    x, h, w = _randn((3, 2304), torch.bfloat16, 7), _randn((3, 2304), torch.bfloat16, 8), _randn((2304,), torch.bfloat16, 9)
    before = (fn.plain_calls, fn.launches)
    x2, normed = fn.residual_rms_norm(x, w, EPS, h, R)
    assert torch.equal(x2, x + h * R) and torch.equal(normed, rms_norm(x + h * R, w, EPS))
    assert torch.equal(fn.residual_add(x, h, R), x + h * R)
    assert torch.equal(fn.silu_mul(x, h), F.silu(x) * h)
    assert (fn.plain_calls, fn.launches) == (before[0] + 3, before[1])


def test_the_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 16, dtype=torch.bfloat16)
    w = torch.ones(16, dtype=torch.bfloat16)
    for call in (lambda: fn.residual_rms_norm_kernel(x, w, EPS), lambda: fn.residual_add_kernel(x, x, R),
                 lambda: fn.silu_mul_kernel(x, x)):
        with pytest.raises(RuntimeError, match="no kernel"):
            call()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("side", ["left", "right"])
def test_decoder_layer_on_the_cpu_takes_the_plain_path_unchanged(dtype, side):
    layer = _layer(TINY, "cpu", dtype, seed=11)
    n_real = [40, 64, 17]
    x, kv_start, kv_end, cos, sin = _layer_inputs(TINY, 3, 64, "cpu", dtype, 12, n_real)
    if side == "left":
        kv_start, kv_end = 64 - kv_end, torch.full_like(kv_end, 64)
    before = (fn.launches, fn.plain_calls)
    got = layer(x, kv_start, kv_end, cos, sin)
    assert (fn.launches, fn.plain_calls) == (before[0], before[1] + 4)
    assert torch.equal(got, _eager_forward(layer, x, kv_start, kv_end, cos, sin))


class _CharTok:
    bos_token_id = 1
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=False, max_length=None, truncation=False):
        ids = [ord(ch) % 94 + 2 for ch in text]
        return {"input_ids": ids[:max_length] if truncation and max_length else ids}


PAIRS = [("what is x", "x is a thing"), ("q" * 30, "p" * 100), ("what is y", "unrelated text")]


def test_the_reranker_reports_plain_calls_once_a_batch_on_the_cpu():
    model = MiniCPMLayerWiseReranker(TINY, _CharTok(), start_layer=1, cutoff_layer=3, max_length=64,
                                     efficient_layers=(2,), device="cpu", dtype=torch.bfloat16)
    model.init_random_(torch.Generator().manual_seed(0))
    got = []
    off = events.on(lambda kind, p: got.append(p) if kind == "fused_chain" else None)
    try:
        model.score_pairs(PAIRS)
        model.score_pairs(PAIRS, judge=True)  # two segments, one batch: one event
        _, carry = model.score_pairs_carry(PAIRS)
        mask = carry["mask"]
        model.score_carried([carry["hidden"]], np.array([0, 2]), mask[[0, 2]], from_layer=2)
    finally:
        off()
    # four calls a layer: the input norm, the mid-layer add + norm, the
    # layer-end add, SiLU * up; the judge may stop after layer 2
    assert got[0] == {"kernel": 0, "plain": 4 * 3}
    assert got[1]["kernel"] == 0 and got[1]["plain"] in (4 * 2, 4 * 3)
    assert got[2:] == [{"kernel": 0, "plain": 4 * 3}, {"kernel": 0, "plain": 4 * 1}]


# -- CUDA -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused chain's kernels are CUDA kernels with no CPU mode")
    return torch.device("cuda")


CELL_ROWS = 32 * 1216


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(CELL_ROWS, 2304), (CELL_ROWS + 1, 2304), (7, 2304), (1, 2304), (33, 128),
                                    (5, 8), (3, 2296)])
@pytest.mark.parametrize("residual", [True, False])
def test_residual_rms_norm_kernel_matches_plain_on_card(cuda, rows, d, residual):
    x = _randn((rows, d), torch.bfloat16, rows + d, cuda)
    h = _randn((rows, d), torch.bfloat16, rows + d + 1, cuda, scale=4.0) if residual else None
    w = (1 + 0.1 * _randn((d,), torch.float32, d, cuda)).to(torch.bfloat16)
    launches = fn.launches
    got_x, got_n = fn.residual_rms_norm_kernel(x, w, EPS, h, R)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    ref_x, ref_n = fn.residual_rms_norm_plain(x, w, EPS, h, R)
    assert torch.equal(got_x, ref_x)
    assert int(_ulps_apart(got_n, ref_n).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(CELL_ROWS, 2304), (CELL_ROWS, 5760), (7, 5760), (1, 8), (33, 2304)])
def test_elementwise_kernels_match_plain_bit_for_bit_on_card(cuda, rows, d):
    a = _randn((rows, d), torch.bfloat16, rows, cuda, scale=3.0)
    b = _randn((rows, d), torch.bfloat16, d, cuda)
    assert torch.equal(fn.silu_mul_kernel(a, b), fn.silu_mul_plain(a, b))
    assert torch.equal(fn.residual_add_kernel(b, a, R), fn.residual_add_plain(b, a, R))


@pytest.mark.cuda
def test_silu_mul_kernel_matches_plain_over_every_bf16_gate_on_card(cuda):
    gate = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32, device=cuda).to(torch.int16).view(torch.bfloat16)
    gate = gate[torch.isfinite(gate)].contiguous()  # silu(-inf) is NaN, whose bits differ
    gate = gate[: gate.numel() // 8 * 8]
    up = _randn(gate.shape, torch.bfloat16, 5, cuda)
    got, ref = fn.silu_mul_kernel(gate, up), fn.silu_mul_plain(gate, up)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.cuda
def test_minicpm_decoder_layer_matches_the_eager_ops_on_card(cuda):
    layer = _layer(FULL, cuda, torch.bfloat16, seed=21)
    n_real = [1216 - 37 * (i % 9) for i in range(32)]
    x, kv_start, kv_end, cos, sin = _layer_inputs(FULL, 32, 1216, cuda, torch.bfloat16, 22, n_real)
    before = (fn.launches, fn.plain_calls)
    with torch.inference_mode():
        got = layer(x, kv_start, kv_end, cos, sin)
        ref = _eager_forward(layer, x, kv_start, kv_end, cos, sin)
    assert (fn.launches, fn.plain_calls) == (before[0] + 4, before[1])
    # the norms' one-ulp differences reach the output through the products
    # and flip roundings there: the mid-layer sum, the MLP's scaled output
    # and the layer-end sum, three bf16 roundings (each at most 2**-7 of its
    # value) of values no larger than about the row's largest. Reading on
    # the H100: 0.0143 of the row's largest value (two bf16 steps at a row
    # largest of 4.375), past one rounding's 2**-7 = 0.0078
    diff = (got.float() - ref.float()).abs().amax(-1)
    assert bool((diff <= 3 * 2 ** -7 * ref.float().abs().amax(-1)).all())


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take_on_card(cuda):
    x = torch.zeros(4, 64, dtype=torch.bfloat16, device=cuda)
    w = torch.ones(64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        fn.residual_rms_norm_kernel(x.float(), w, EPS)
    with pytest.raises(TypeError):
        fn.silu_mul_kernel(x, x.half())
    with pytest.raises(ValueError, match="contiguous"):
        fn.residual_add_kernel(x.t().contiguous().t(), x, R)
    with pytest.raises(ValueError, match="contiguous"):
        fn.residual_rms_norm_kernel(torch.zeros(64, 4, dtype=torch.bfloat16, device=cuda).t(), w, EPS)
    odd = torch.zeros(4, 12, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        fn.silu_mul_kernel(odd, odd)
    with pytest.raises(ValueError, match="multiple of 8"):
        fn.residual_rms_norm_kernel(odd, torch.ones(12, dtype=torch.bfloat16, device=cuda), EPS)
    wide = torch.zeros(2, fn.MAX_D + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="D <="):
        fn.residual_rms_norm_kernel(wide, torch.ones(fn.MAX_D + 8, dtype=torch.bfloat16, device=cuda), EPS)
    with pytest.raises(ValueError, match="weight"):
        fn.residual_rms_norm_kernel(x, torch.ones(32, dtype=torch.bfloat16, device=cuda), EPS)
    with pytest.raises(ValueError, match="shapes differ"):
        fn.residual_add_kernel(x, x[:2], R)
    flat = torch.zeros(72, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fn.silu_mul_kernel(flat[1:65], flat[:64])
    # the dispatching functions send every card tensor to the kernels, which
    # refuse the same inputs: no eager fallback on the card
    before = (fn.launches, fn.plain_calls)
    with pytest.raises(TypeError):
        fn.silu_mul(x.float(), x.float())
    with pytest.raises(ValueError, match="contiguous"):
        fn.residual_add(x.t().contiguous().t(), x, R)
    with pytest.raises(ValueError, match="multiple of 8"):
        fn.residual_rms_norm(odd, torch.ones(12, dtype=torch.bfloat16, device=cuda), EPS)
    with pytest.raises(ValueError, match="D <="):
        fn.residual_rms_norm(wide, torch.ones(fn.MAX_D + 8, dtype=torch.bfloat16, device=cuda), EPS)
    assert (fn.launches, fn.plain_calls) == before
