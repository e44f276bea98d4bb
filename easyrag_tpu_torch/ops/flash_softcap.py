"""Causal softcapped grouped-query attention (the port of ``easyrag_tpu`` K4,
``ops/flash_softcap.py::flash_softcap_attention``), the attention of every
layer of the Gemma2 reranker.

``flash_softcap_attention(q, k, v, num_heads, num_kv_heads, sm_scale,
softcap)`` takes q ``[B, S, NH*D]`` and k/v ``[B, S, NKV*D]`` (RoPE already
applied); query head ``h`` reads KV head ``h // (NH // NKV)``. The logits are
f32: scaled, then ``tanh(l / softcap) * softcap`` (``softcap`` 0: no cap), then
the causal mask with ``finfo(f32).min``; the softmax is f32. There is no mask
input: the caller pads on the right, so causality alone keeps pad keys out of
every real row, and pad rows get a finite average of earlier keys.

CUDA tensors go through ``csrc/flash_softcap.cu`` (bf16, head_dim 128 or 256,
S a multiple of 8: the ``wgmma``/TMA body of ``csrc/attention_sm90.cuh``
shared with K3) or raise; CPU tensors go through
:func:`flash_softcap_attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .flash64 import MASK_VALUE

HEAD_DIMS = (128, 256)  # the kernel's head dims

#: kernel launches made by :func:`flash_softcap_attention`
launches = 0


def flash_softcap_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    sm_scale: float,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version, the einsum path of
    ``easyrag_tpu/models/layers.py::attention``: K/V repeated over the query
    groups, f32 logits times the scale, softcap, causal mask, f32 softmax
    cast to the input dtype, then P·V summed in f32 and cast."""
    B, S, F = q.shape
    d = F // num_heads
    g = num_heads // num_kv_heads
    qh = q.reshape(B, S, num_heads, d)
    kh = k.reshape(B, S, num_kv_heads, d).repeat_interleave(g, dim=2)
    vh = v.reshape(B, S, num_kv_heads, d).repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * sm_scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal, logits, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), vh.float())
    return out.reshape(B, S, F).to(q.dtype)


def _lib():
    lib = _build.load("flash_softcap")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_softcap_launch.argtypes = [p, p, p, p, i, i, i, i, i, f, f, p]
        lib.flash_softcap_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check_args(q, k, v, num_heads, num_kv_heads):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: need [B, S, NH*D] and [B, S, NKV*D]")
    if num_heads <= 0 or num_kv_heads <= 0 or num_heads % num_kv_heads or q.shape[-1] % num_heads:
        raise ValueError(f"q width {q.shape[-1]}: need {num_heads} query heads on {num_kv_heads} KV heads")
    d = q.shape[-1] // num_heads
    if k.shape[-1] != num_kv_heads * d:
        raise ValueError(f"k width {k.shape[-1]} is not {num_kv_heads} heads of {d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    return d


def flash_softcap_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    sm_scale: float,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Causal softcapped GQA attention over right-padded ``[B, S, NH*D]``."""
    d = _check_args(q, k, v, num_heads, num_kv_heads)
    if q.device.type == "cpu":
        return flash_softcap_attention_plain(q, k, v, num_heads, num_kv_heads, sm_scale, softcap)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_softcap_attention: no kernel for device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_softcap kernel takes head_dim {HEAD_DIMS}, got {d}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_softcap kernel takes bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[1] % 8:
        raise ValueError(f"flash_softcap kernel needs S a multiple of 8, got {q.shape[1]}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_softcap kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_softcap kernel needs 16-byte aligned q/k/v")
    B, S, _ = q.shape
    out = torch.empty_like(q)
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(
            _lib().flash_softcap_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, num_heads, num_kv_heads, d,
                float(sm_scale), float(softcap), stream,
            ),
            "flash_softcap_launch",
        )
    launches += 1
    return out
