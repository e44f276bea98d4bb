"""Decoder core (port of ``easyrag_tpu/models/layers.py``).

Weights are stored ``[out, in]`` as in the JAX tree; RMSNorm in f32;
rotate-half RoPE; SiLU MLP; MiniCPM's residual scale
``scale_depth / sqrt(num_layers)`` and embedding scale ``scale_emb``; Gemma2's
``(1 + w)`` norm gain, four-norm block, GeGLU (tanh GELU), embedding scale
``sqrt(hidden)`` and attention scale ``query_pre_attn_scalar ** -0.5``.
Padding is a per-row key range ``[kv_start, kv_end)`` instead of a mask; the
softcapped (Gemma2) attention takes right padding only, given as no range.

Every decoder layer runs through one block, :func:`decoder_layer`, over a
JAX-layout tree layer. Its callers hand it ``attend(shard, cfg, q, k, v)``:
the one gate :func:`attention` at batch-shared positions (the rerankers, and
the gte-Qwen2 embedder and yes-logit through :func:`forward_hidden`), or the
generator's cache-writing attention (``models/decode.py``); and a
:class:`Chain`, its norms, residual adds and SiLU * up: the eager ops, the
kernels of ``ops/fused_norm.py`` (the rerankers) or the decoder's
per-position norms. The rerankers hold their weights in
:class:`DecoderLayer` modules, each a view of one tree layer.

A linear is a leaf: dense (``w``), int8 (``w_q``/``scale``) or int4
(``w_p``/``scale``), each with an optional bias ``b``, computed by the one
:func:`linear`. With ``DecoderConfig.act_quant`` (w8a8, w4a8) every
projection quantizes its activations per token to int8 and contracts s8 x s8
exactly in s32 (``torch._int_mm``), as JAX's ``layers._linear(..., a8)``.
A tensor-parallel layer of ``parallel/tp.py`` holds per-shard ``attn`` and
``mlp`` lists; one process drives every shard, and the all-reduce that JAX's
compiler inserts is :func:`row_parallel_linear`'s sum of the partial
products on the first device, in shard order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import int4_matvec
from ..ops.flash64 import apply_rope, flash64_attention
from ..ops.flash_attention import flash_attention, flash_attention_plain
from ..ops.flash_softcap import flash_softcap_attention
from ..ops.fused_norm import residual_add, residual_add_plain, residual_rms_norm, silu_mul
from .quant import quantize_linear_int4, quantize_linear_int8, unpack_int4


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attention_bias: bool = False  # True for Qwen2 QKV
    # MiniCPM mup-style scalings (1.0 / 0.0 = disabled)
    scale_emb: float = 1.0
    scale_depth: float = 0.0
    dim_model_base: float = 0.0
    # Gemma2 deltas: (1 + w) norms, four-norm block, GeGLU, sqrt(hidden)
    # embedding scale; logit softcap (0 = off) and attention scale
    # query_pre_attn_scalar ** -0.5 (0 = head_dim ** -0.5)
    gemma: bool = False
    attn_logit_softcapping: float = 0.0
    query_pre_attn_scalar: float = 0.0
    # w8a8 / w4a8: quantize activations per token to int8 at every
    # projection (int8 or int4 weights; linear's a8)
    act_quant: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def residual_scale(self) -> float:
        if self.scale_depth:
            return self.scale_depth / (self.num_hidden_layers ** 0.5)
        return 1.0


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, gemma: bool = False) -> torch.Tensor:
    """RMSNorm in f32; Gemma parameterizes the gain as ``1 + w``."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    return (normed * (1.0 + w if gemma else w)).to(x.dtype)


def key_ranges(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``[B, S]`` 0/1 mask whose ones are contiguous per row ->
    ``(kv_start, kv_end)`` int32; raises on any other mask."""
    mask = np.asarray(mask) > 0
    has = mask.any(axis=1)
    start = np.where(has, np.argmax(mask, axis=1), 0)
    end = np.where(has, mask.shape[1] - np.argmax(mask[:, ::-1], axis=1), 0)
    if (mask.sum(axis=1) != end - start).any():
        raise ValueError("padding mask is not one contiguous run of real tokens per row")
    return start.astype(np.int32), end.astype(np.int32)


def rope_tables(
    positions: Union[int, torch.Tensor], head_dim: int, theta: float, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 rotate-half cos/sin tables. An int ``S`` gives ``[S, head_dim]``
    for positions ``0..S-1``; a ``[B, S]`` tensor of positions gives
    ``[B, S, head_dim]`` (the JAX signature)."""
    if isinstance(positions, int):
        positions = torch.arange(positions, device=device)
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim))
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


PROJECTIONS = ("q", "k", "v", "o", "gate", "up", "down")
_EXACT = ("w_q", "w_p", "scale")  # int8/int4 bytes and f32 scales keep their dtype


def to_tensor(value) -> torch.Tensor:
    """A tree leaf (a tensor, or a numpy array such as JAX's) as a tensor:
    integer arrays keep their dtype, float ones (bf16 included) become f32."""
    if torch.is_tensor(value):
        return value
    a = np.asarray(value)
    return torch.from_numpy(np.array(a if a.dtype.kind in "iu" else a.astype(np.float32)))


def leaf(p: Dict[str, Any], device=None, dtype=None) -> nn.ParameterDict:
    """A linear leaf (``w``, ``w_q``/``scale`` or ``w_p``/``scale``, maybe
    ``b``; tensors or numpy arrays) as a module's parameters on ``device``:
    quantized bytes and scales keep their dtypes, ``w`` and ``b`` take
    ``dtype``."""
    return nn.ParameterDict({
        k: nn.Parameter(to_tensor(v).to(device=device, dtype=None if k in _EXACT else dtype), requires_grad=False)
        for k, v in p.items()
    })


def _weight(n_out: int, n_in: int, **kw) -> nn.ParameterDict:
    return leaf({"w": torch.empty(n_out, n_in, **kw)})


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator, start_layer: int, std: float = 0.02) -> nn.Module:
    """Seeded random weights for a reranker module (``embed``, ``layers``,
    ``heads``), drawn on its device: the embedding and every projection
    ``N(0, std)``, score heads from ``start_layer`` on, norms left as built
    (the layout ``easyrag_tpu.models.layers.init_params`` draws)."""

    def fill(p: torch.Tensor) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device, dtype=p.dtype) * std)

    fill(model.embed)
    for layer in model.layers:
        for name in PROJECTIONS:
            fill(getattr(layer, name)["w"])
    model.heads.zero_()
    fill(model.heads[start_layer:])
    return model


QUANTS = ("", "int8", "w8a8", "int4", "w4a8")


@torch.no_grad()
def quantize_layers_(model: nn.Module, quant: str) -> nn.Module:
    """Quantize every projection of a reranker module's ``layers`` in place
    (``quant``: int8 or w8a8 -> int8 leaves, int4 or w4a8 -> int4 leaves,
    biases kept) and set ``cfg.act_quant`` for w8a8 and w4a8, as the JAX
    package's loader does with ``quant``. Embeddings, norms and score heads
    stay as they are. Works on any device (``models/quant.py``)."""
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    if not quant:
        return model
    quantize = quantize_linear_int4 if quant in ("int4", "w4a8") else quantize_linear_int8
    cfg = dataclasses.replace(model.cfg, act_quant=quant in ("w8a8", "w4a8"))
    for layer in model.layers:
        for name in PROJECTIONS:
            p = getattr(layer, name)
            if "w" not in p:
                raise ValueError(f"projection {name} is already quantized")
            q = quantize(p["w"])
            if "b" in p:
                q["b"] = p["b"]
            setattr(layer, name, leaf(q))
        layer.cfg = cfg
    model.cfg = cfg
    return model


@torch.no_grad()
def load_tree_(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy a JAX-layout tree (``easyrag_tpu.models.layers.init_params`` plus
    ``heads``, layer -> ``[1, hidden]``; numpy or torch leaves) into a
    reranker module (``embed``, ``final_norm``, ``layers``, ``heads``;
    each layer's norms are :func:`norm_names`'). A linear may be dense, int8
    or int4 (any bias kept) and the embedding table dense or int8: quantized
    bytes and scales keep their dtypes, everything else takes the module's
    dtype; heads stay f32. A w8a8 or w4a8 tree needs ``cfg.act_quant``."""
    dev, dt = model.final_norm.device, model.final_norm.dtype

    def put(param: torch.Tensor, value) -> None:
        param.copy_(to_tensor(value).reshape(param.shape))

    if isinstance(params["embed"], dict):  # int8 table (int4/w4a8 trees)
        del model.embed
        model.embed = leaf(params["embed"], dev, dt)
    else:
        put(model.embed, params["embed"])
    put(model.final_norm, params["final_norm"])
    for layer, p in zip(model.layers, params["layers"], strict=True):
        for name in norm_names(model.cfg):
            put(getattr(layer, name), p[name])
        for name in PROJECTIONS:
            setattr(layer, name, leaf(p["attn" if name in ("q", "k", "v", "o") else "mlp"][name], dev, dt))
    model.heads.zero_()
    for layer_idx, w in params["heads"].items():
        put(model.heads[int(layer_idx)], w)
    return model


class DecoderLayer(nn.Module):
    """The rerankers' decoder layer: its parameters held as a module (the
    norms, and each projection a leaf, :func:`leaf`), run by
    :func:`decoder_layer` at batch-shared positions with the fused chain."""

    def __init__(self, cfg: DecoderConfig, device=None, dtype=None) -> None:
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, hd, nh, nkv = cfg.hidden_size, cfg.hd, cfg.num_attention_heads, cfg.num_key_value_heads
        self.cfg = cfg
        self.input_norm = nn.Parameter(torch.ones(d, **kw), requires_grad=False)
        self.q = _weight(nh * hd, d, **kw)
        self.k = _weight(nkv * hd, d, **kw)
        self.v = _weight(nkv * hd, d, **kw)
        self.o = _weight(d, nh * hd, **kw)
        for name in norm_names(cfg)[1:]:
            setattr(self, name, nn.Parameter(torch.ones(d, **kw), requires_grad=False))
        self.gate = _weight(cfg.intermediate_size, d, **kw)
        self.up = _weight(cfg.intermediate_size, d, **kw)
        self.down = _weight(d, cfg.intermediate_size, **kw)

    def tree(self) -> Dict[str, Any]:
        """The layer as a JAX-layout tree layer over its own parameters."""
        return {
            **{name: getattr(self, name) for name in norm_names(self.cfg)},
            "attn": {name: getattr(self, name) for name in ("q", "k", "v", "o")},
            "mlp": {name: getattr(self, name) for name in ("gate", "up", "down")},
        }

    def forward(self, x, kv_start, kv_end, cos, sin) -> torch.Tensor:
        """``kv_start``/``kv_end`` ``None``: right padding (pad keys follow
        every real query), the only padding the softcapped attention takes."""
        return decoder_layer(self.cfg, self.tree(), x, shared_attend(kv_start, kv_end, cos, sin), FUSED)


# easyrag_tpu/ops/int4_matvec.py's shape gate (its VMEM budget and block
# sizes): JAX's w4a8 quantizes the activations exactly where this says its
# TPU kernel does not apply, so the port decides a8 by it, not by K2's gate
_TPU_I4_VMEM_BUDGET = 12 * 2**20
_TPU_I4_MAX_ROWS = 64


def tpu_int4_kernel_shape(rows: int, n_out: int, half_in: int) -> bool:
    """JAX's ``ops/int4_matvec.py::supported``: at most 64 rows, ``I/2`` and
    ``O`` multiples of 128, and an output block of 1024, 512, 256 or 128
    channels that divides ``O`` and fits the VMEM budget."""
    if not (0 < rows <= _TPU_I4_MAX_ROWS and half_in % 128 == 0 and n_out % 128 == 0):
        return False
    return any(n_out % bo == 0 and bo * half_in * 6 <= _TPU_I4_VMEM_BUDGET for bo in (1024, 512, 256, 128))


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ w.T`` of int8 ``a`` ``[M, K]`` and ``w`` ``[N, K]``
    through ``torch._int_mm``. Its CUDA form wants more than 16 rows and
    widths that are multiples of 8: ``a`` and ``w`` are zero-padded to them
    (as ``index/dense.py`` pads), which adds nothing to any sum."""
    m, k = a.shape
    n = w.shape[0]
    pad_k, pad_n, pad_m = -k % 8, -n % 8, max(17 - m, 0)
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    y = torch._int_mm(a, w.t())
    return y[:m, :n] if pad_m or pad_n else y


def quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization of the last axis: ``(x_q,
    xs)`` with ``xs = where(amax > 0, amax, 1) / 127`` in f32 (``[..., 1]``)
    and ``x_q = round(x / xs)``. JAX's compiled ``_linear`` takes the
    ``/ 127`` as a product with the f32 reciprocal, so this does too."""
    xf = x.float()
    xs = token_scales(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / xs).to(torch.int8), xs


def token_scales(amax: torch.Tensor) -> torch.Tensor:
    """Per-token f32 scales from the per-token ``amax``:
    ``where(amax > 0, amax, 1) * (1 / 127)``."""
    return torch.where(amax > 0, amax, torch.ones_like(amax)) * (1.0 / 127.0)


def a8_product(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """w8a8's product: ``x`` quantized per token (:func:`quantize_tokens`),
    the exact s32 contraction with int8 ``w8`` ``[O, I]``
    (:func:`int8_matmul`), then ``(y * xs * scale)`` in f32 in that order,
    cast to ``x``'s dtype. A zero row gives zeros."""
    x_q, xs = quantize_tokens(x)
    y = int8_matmul(x_q.reshape(-1, x.shape[-1]), w8).reshape(*x.shape[:-1], w8.shape[0])
    return rescale_s32(y, xs, scale, x.dtype)


def rescale_s32(y: torch.Tensor, xs: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(y * xs * scale)`` in f32, in that order, cast to ``dtype``: the
    s32 product back to the activations' scale."""
    return y.float().mul_(xs).mul_(scale.float()).to(dtype)


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], a8: bool = False) -> torch.Tensor:
    """``x @ W.T (+ b)`` for a dense, int8 or int4 leaf (JAX's
    ``layers._linear``).

    ``a8`` (w8a8, w4a8): int8 weights, and int4 ones wherever JAX's TPU
    kernel gate (:func:`tpu_int4_kernel_shape`) says no, take
    :func:`a8_product` (the unpacked nibbles are the s8 operand). Otherwise
    int4 with at most ``int4_matvec.MAX_ROWS`` rows goes to K2, whose math
    is the TPU kernel's (f32 sums, f32 rescale, one cast); more rows unpack
    the nibbles and take one large ``torch.matmul`` with the XLA formula
    ``(x @ w.T) * scale`` in x's dtype, as the JAX package leaves prefill to
    XLA; in f32 the two agree to rounding. Int8 without ``a8`` is the XLA
    formula too."""
    if "w_p" in p:
        rows = x.numel() // x.shape[-1]
        n_out, half_in = p["w_p"].shape
        if a8 and not tpu_int4_kernel_shape(rows, n_out, half_in):
            y = a8_product(x, unpack_int4(p["w_p"]), p["scale"])
        elif rows <= int4_matvec.MAX_ROWS:
            y2 = int4_matvec.int4_matvec(x.reshape(rows, x.shape[-1]).contiguous(), p["w_p"], p["scale"])
            y = y2.reshape(*x.shape[:-1], n_out)
        else:
            y = (x @ unpack_int4(p["w_p"]).t().to(x.dtype)) * p["scale"].to(x.dtype)
    elif "w_q" in p:
        if a8:
            y = a8_product(x, p["w_q"], p["scale"])
        else:
            y = (x @ p["w_q"].t().to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        y = x @ p["w"].t()
    if "b" in p:
        y = y + p["b"]
    return y


class Chain(NamedTuple):
    """A layer's elementwise steps: ``norm(x, w, eps, h=None, r=1.0)`` ->
    ``(x', rms_norm(x') * w)`` with ``x' = x + h * r`` (``x`` without
    ``h``), ``add(x, h, r)`` -> ``x + h * r``, ``act(gate, up)`` ->
    ``silu(gate) * up``."""

    norm: Callable
    add: Callable
    act: Callable


def norm_chain(norm: Callable) -> Chain:
    """The eager ops around an RMSNorm ``norm(x, w, eps)``. SiLU * up is
    taken in place in the gate's fresh buffer: at the embedder's largest
    batch each ``[B, S, intermediate]`` buffer is ~10 GB."""

    def residual_norm(x, w, eps, h=None, r=1.0):
        if h is not None:
            x = x + h * r
        return x, norm(x, w, eps)

    return Chain(residual_norm, residual_add_plain, lambda gate, up: F.silu(gate, inplace=True).mul_(up))


#: the eager ops (the embedder, yes-logit, the generator's prefill and steps)
EAGER = norm_chain(rms_norm)
#: ``ops/fused_norm.py``: its kernels on the card, the plain versions on the
#: CPU (the rerankers)
FUSED = Chain(residual_rms_norm, residual_add, silu_mul)


def norm_names(cfg: DecoderConfig) -> Tuple[str, ...]:
    """A layer's norms: Gemma2 has four, the others two."""
    if cfg.gemma:
        return ("input_norm", "post_attn_norm", "pre_mlp_norm", "post_mlp_norm")
    return ("input_norm", "post_norm")


def qkv_proj(cfg: DecoderConfig, p: Dict[str, Any], h: torch.Tensor):
    """q ``[B, S, NH, D]`` and k, v ``[B, S, NKV, D]`` of a layer's ``attn``;
    ``qkv`` is the fused int4 projection (one K2 launch)."""
    b, s, _ = h.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    if "qkv" in p:
        q, k, v = linear(h, p["qkv"], cfg.act_quant).split([nh * hd, nkv * hd, nkv * hd], dim=-1)
    else:
        q, k, v = (linear(h, p[name], cfg.act_quant) for name in ("q", "k", "v"))
    return q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd), v.reshape(b, s, nkv, hd)


def mlp_act(cfg: DecoderConfig, p: Dict[str, Any], x: torch.Tensor, act: Callable) -> torch.Tensor:
    """The down projection's input of a layer's ``mlp``: ``act(gate, up)``
    (Gemma2: ``gelu_tanh(gate) * up``); ``gateup`` is the fused gate+up,
    split at its midpoint (``quant.fuse_decode_tree`` fuses equal widths
    only)."""
    if "gateup" in p:
        gate, up = linear(x, p["gateup"], cfg.act_quant).chunk(2, dim=-1)
    else:
        gate, up = linear(x, p["gate"], cfg.act_quant), linear(x, p["up"], cfg.act_quant)
    if cfg.gemma:
        return F.gelu(gate, approximate="tanh") * up
    return act(gate, up)


def decoder_layer(
    cfg: DecoderConfig, p: Dict[str, Any], x: torch.Tensor, attend: Callable, chain: Chain = EAGER
) -> torch.Tensor:
    """One pre-norm decoder layer (``easyrag_tpu/models/layers.py::
    decoder_layer``): the input norm, q/k/v, ``attend(shard, shard_cfg, q,
    k, v)`` (``[B, S, nh * hd]``, before the output projection), o and the
    residual (MiniCPM's ``residual_scale``), the post norm, the SiLU MLP and
    the last residual, the norms, adds and SiLU * up taken from ``chain``.
    Gemma2 (``cfg.gemma``): JAX's four ``(1 + w)`` norms, GeGLU and plain
    residuals, by the eager ops.

    A tensor-parallel layer (:func:`is_tp`) runs ``attend`` and the MLP on
    every shard at :func:`shard_config`'s head counts, its input sent to
    the shard's device; o and down are :func:`row_parallel_linear`, and the
    norms and residuals run on the first device."""
    tp = is_tp(p)
    attn, mlp = (p["attn"], p["mlp"]) if tp else ([p["attn"]], [p["mlp"]])
    scfg = shard_config(cfg, len(attn)) if tp else cfg
    a8, r, eps = cfg.act_quant, cfg.residual_scale, cfg.rms_norm_eps

    def project(xs, ps):
        return row_parallel_linear(xs, ps, a8) if tp else linear(xs[0], ps[0], a8)

    if cfg.gemma:
        h = rms_norm(x, p["input_norm"], eps, True)
    else:
        x, h = chain.norm(x, p["input_norm"], eps)
    outs = [attend(s, scfg, *qkv_proj(scfg, pa, h.to(leaf_device(pa["o"])))) for s, pa in enumerate(attn)]
    h = project(outs, [pa["o"] for pa in attn])
    if cfg.gemma:
        x = x + rms_norm(h, p["post_attn_norm"], eps, True)
        h = rms_norm(x, p["pre_mlp_norm"], eps, True)
    else:
        x, h = chain.norm(x, p["post_norm"], eps, h, r)
    acts = [mlp_act(scfg, pm, h.to(leaf_device(pm["down"])), chain.act) for pm in mlp]
    h = project(acts, [pm["down"] for pm in mlp])
    if cfg.gemma:
        return x + rms_norm(h, p["post_mlp_norm"], eps, True)
    return chain.add(x, h, r)


def attention(
    cfg: DecoderConfig,
    q: torch.Tensor,  # [B, S, NH, D], before RoPE
    k: torch.Tensor,  # [B, S, NKV, D]
    v: torch.Tensor,
    kv_start: Optional[torch.Tensor],  # [B] int32; None: right padding
    kv_end: Optional[torch.Tensor],
    cos: torch.Tensor,  # [S, D] f32, batch-shared positions
    sin: torch.Tensor,
) -> torch.Tensor:
    """The attention between the projections at batch-shared positions,
    ``[B, S, NH*D]``, its kernel picked from its inputs alone in JAX's order
    (``easyrag_tpu/models/layers.py:240-310``):

    * a softcap: K4 (``ops/flash_softcap.py``), which has no mask input, so
      the padding must be on the right, given as no range (causality then
      keeps pad keys out of every real row);
    * head dim 64 with as many KV heads as query heads: K1
      (``ops/flash64.py``), RoPE in the kernel;
    * a head dim that is a multiple of 64 at ``S % 128 == 0``: K3
      (``ops/flash_attention.py``);
    * otherwise K3's plain version, the einsum formulation (the 64-token
      bucket of a short query).

    Elsewhere padding is a per-row key range. Query rows outside it attend
    to the range's keys where JAX's segment ids pair them with pad keys; no
    real row reads a pad row, so real rows agree. On the CPU every kernel
    runs its plain version."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    scale = cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar else hd ** -0.5
    if hd == 64 and nkv == nh and not cfg.attn_logit_softcapping:
        q, k, v = (t.reshape(b, s, nh * hd).contiguous() for t in (q, k, v))
        return flash64_attention(q, k, v, kv_start, kv_end, scale, cos, sin)
    q = apply_rope(q, cos[None], sin[None]).reshape(b, s, nh * hd)
    k = apply_rope(k, cos[None], sin[None]).reshape(b, s, nkv * hd)
    v = v.reshape(b, s, nkv * hd).contiguous()
    if cfg.attn_logit_softcapping:
        if kv_start is not None or kv_end is not None:
            raise ValueError("softcapped attention takes right padding only (kv_start/kv_end None)")
        return flash_softcap_attention(q, k, v, nh, nkv, scale, cfg.attn_logit_softcapping)
    kernel = flash_attention if hd % 64 == 0 and s % 128 == 0 else flash_attention_plain
    return kernel(q, k, v, kv_start, kv_end, scale, nkv)


def shared_attend(kv_start, kv_end, cos, sin) -> Callable:
    """:func:`decoder_layer`'s ``attend`` at batch-shared positions:
    :func:`attention`, its ranges and tables sent to each shard's device."""

    def attend(shard, cfg, q, k, v):
        return attention(cfg, q, k, v, *(t if t is None else t.to(q.device) for t in (kv_start, kv_end, cos, sin)))

    return attend


def forward_hidden(
    cfg: DecoderConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S], one contiguous run of ones per row
) -> torch.Tensor:
    """The decoder stack over a tree (``layers.py::forward_hidden``): the
    final-normed hidden state ``[B, S, D]``, positions ``0..S-1`` shared by
    the batch. A softcapped config (Gemma2) takes right padding only."""
    dev = input_ids.device
    ranges = key_ranges(attention_mask.cpu().numpy())
    if cfg.attn_logit_softcapping:
        if ranges[0].any():
            raise ValueError("softcapped attention takes right padding only")
        ranges = (None, None)
    else:
        ranges = tuple(torch.from_numpy(a).to(dev) for a in ranges)
    attend = shared_attend(*ranges, *rope_tables(input_ids.shape[1], cfg.hd, cfg.rope_theta, device=dev))
    h = embed(cfg, params["embed"], input_ids, params["final_norm"].dtype)
    for idx in range(cfg.num_hidden_layers):
        h = decoder_layer(cfg, params["layers"][idx], h, attend)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps, cfg.gemma)


def embed(
    cfg: DecoderConfig,
    table: Union[torch.Tensor, Dict[str, torch.Tensor]],
    input_ids: torch.Tensor,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Rows of the embedding table, times ``scale_emb`` (Gemma: times
    ``sqrt(hidden)`` rounded to the rows' dtype first, 59.75 in bf16 at
    hidden 3584, as JAX rounds it). An int8 table (``{"w_q", "scale"}``,
    per-row scales; a dict or a module's ``ParameterDict``) is dequantized on
    the gathered rows into ``dtype``."""
    ids = input_ids.long()
    if not torch.is_tensor(table):
        rows = F.embedding(ids, table["w_q"]).to(dtype)
        h = rows * table["scale"][ids].to(dtype)[..., None]
    else:
        h = F.embedding(ids, table)
    if cfg.gemma:
        return h * torch.tensor(cfg.hidden_size ** 0.5, dtype=h.dtype, device=h.device)
    return h * cfg.scale_emb if cfg.scale_emb != 1.0 else h


# -- tensor parallelism: the layer trees of parallel/tp.py ---------------------
#
# A tensor-parallel layer holds ``attn`` and ``mlp`` as lists of per-shard
# dicts (shard ``s`` on the ``s``-th ``model`` device): q, k, v, gate and up
# split by output rows (column parallel), o and down by input columns (row
# parallel) with their scale and bias whole on every shard. The norms, the
# embedding and the head stay on the first device, which also holds the
# residual stream. One process drives every shard; JAX's GSPMD inserts the
# all-reduce that :func:`row_parallel_linear` performs by hand.


def is_tp(p: Dict[str, Any]) -> bool:
    """Whether a tree layer is tensor-parallel (per-shard ``attn`` list)."""
    return isinstance(p.get("attn"), list)


def leaf_device(p: Dict[str, torch.Tensor]) -> torch.device:
    """The device of a linear leaf's tensors."""
    return next(iter(p.values())).device


def tp_devices(params: Dict[str, Any]) -> Optional[list]:
    """The shard devices of a tensor-parallel tree, in shard order; None for
    an unsharded tree."""
    layers = params["layers"]
    if not layers or not is_tp(layers[0]):
        return None
    return [leaf_device(a["q"]) for a in layers[0]["attn"]]


def shard_config(cfg: DecoderConfig, mp: int) -> DecoderConfig:
    """The config one of ``mp`` shards computes with: its query and KV
    heads and its slice of the MLP, ``head_dim`` kept explicit (``hd``
    would otherwise follow the shard's head count)."""
    return dataclasses.replace(
        cfg, num_attention_heads=cfg.num_attention_heads // mp, num_key_value_heads=cfg.num_key_value_heads // mp,
        intermediate_size=cfg.intermediate_size // mp, head_dim=cfg.hd,
    )


def row_parallel_linear(xs: list, ps: list, a8: bool = False) -> torch.Tensor:
    """A row-parallel linear: shard ``s`` contracts its slice of the input,
    ``xs[s]`` (on its device), with its input columns ``ps[s]``; the partial
    products are copied to shard 0's device and summed there in shard order,
    after every shard's product has been issued. Then the scale and the bias
    apply once, as JAX's dot, all-reduce, scale computes it.

    Float and int8 weight-only leaves form each partial in f32
    (:func:`f32_product`), sum them in f32 and round the sum once to the
    activations' dtype, as the unsharded product rounds its f32 sums once
    (in bf16, JAX's all-reduce adds bf16 partials). ``a8`` (w8a8; the int8
    nibble values of w4a8 under TP): the per-token amax is the max over the
    shards' amaxes, which is exact; every shard quantizes its slice with the
    global scales (:func:`token_scales`, as :func:`quantize_tokens` does)
    and the s32 partials sum exactly in int32 before :func:`rescale_s32`, so
    the product equals the unsharded :func:`a8_product` bit for bit."""
    if any("w_p" in p for p in ps):
        raise ValueError("a row-parallel leaf holds int8 values (parallel/tp.py unpacks int4)")
    first = xs[0].device
    int8 = "w_q" in ps[0]
    if a8 and int8:
        xfs = [x.float() for x in xs]
        amaxes = [xf.abs().amax(dim=-1, keepdim=True) for xf in xfs]
        amax = amaxes[0]
        for m in amaxes[1:]:
            amax = torch.maximum(amax, m.to(first))
        xsc = token_scales(amax)
        parts = []
        for xf, p in zip(xfs, ps):
            x_q = torch.round(xf / xsc.to(xf.device)).to(torch.int8)
            parts.append(int8_matmul(x_q.reshape(-1, x_q.shape[-1]), p["w_q"]))
        y = parts[0]
        for part in parts[1:]:
            y = y + part.to(first)
        y = rescale_s32(y.reshape(*xs[0].shape[:-1], y.shape[-1]), xsc, ps[0]["scale"], xs[0].dtype)
    else:
        parts = [f32_product(x, p["w_q"].to(x.dtype) if int8 else p["w"]) for x, p in zip(xs, ps)]
        y = parts[0]
        for part in parts[1:]:
            y = y + part.to(first)
        y = y.to(xs[0].dtype)
        if int8:
            y = y * ps[0]["scale"].to(y.dtype)
    if "b" in ps[0]:
        y = y + ps[0]["b"]
    return y


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in f32 for ``x`` and ``w`` of one dtype: a bf16 product
    on the card keeps cuBLAS's f32 sums unrounded (``torch.mm``'s
    ``out_dtype``), on the CPU it multiplies the f32 upcasts."""
    if x.dtype == torch.float32:
        return x @ w.t()
    if x.device.type == "cuda":
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return x.float() @ w.float().t()
