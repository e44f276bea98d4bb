"""Causal grouped-query attention (the port of ``easyrag_tpu`` K3, the stock
Pallas TPU ``flash_attention``) at both of its call sites:
``models/decode.py::_prefill_layer`` (the generator's prefill, left padding,
per-row RoPE positions) and ``models/layers.py::attention`` (every layer of
the gte-Qwen2 embedder, right padding, batch-shared positions).

``flash_attention(q, k, v, kv_start, kv_end, sm_scale, num_kv_heads)`` takes
q ``[B, S, NH*D]`` and k/v ``[B, S, NKV*D]`` (the projections' layout, RoPE
already applied) and a per-row range of valid keys ``[kv_start[b],
kv_end[b])``; left padding is ``kv_start = S - length``, right padding
``kv_start = 0, kv_end = length``. Query head ``h``
reads KV head ``h // (NH // NKV)``. Logits and softmax are f32; masked logits
are ``finfo(f32).min``, so every output is finite, pad rows included.

CUDA tensors go through ``csrc/flash_attention.cu`` (bf16, every head_dim
that is a multiple of 64, as JAX sends any multiple of 64 to the stock
kernel: the ``wgmma``/TMA body of ``csrc/attention_sm90.cuh`` up to 512, and
past it a kernel that streams Q and K through shared memory in 64-dim
panels) or raise; CPU tensors go through :func:`flash_attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .flash64 import masked_attention

#: kernel launches made by :func:`flash_attention`
launches = 0


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_start: torch.Tensor,
    kv_end: torch.Tensor,
    sm_scale: float,
    num_kv_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version: K/V repeated over the query groups, then the
    materialised f32 einsum attention of ``ops/flash64.py``."""
    B, S, F = q.shape
    hd = k.shape[-1] // num_kv_heads
    nh = F // hd
    qh = q.reshape(B, S, nh, hd)
    kh = k.reshape(B, S, num_kv_heads, hd).repeat_interleave(nh // num_kv_heads, dim=2)
    vh = v.reshape(B, S, num_kv_heads, hd).repeat_interleave(nh // num_kv_heads, dim=2)
    return masked_attention(qh, kh, vh, kv_start, kv_end, sm_scale).reshape(B, S, F)


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check_args(q, k, v, kv_start, kv_end, num_kv_heads):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: need [B, S, NH*D] and [B, S, NKV*D]")
    if num_kv_heads <= 0 or k.shape[-1] % num_kv_heads:
        raise ValueError(f"k width {k.shape[-1]} is not a multiple of num_kv_heads={num_kv_heads}")
    hd = k.shape[-1] // num_kv_heads
    if q.shape[-1] % hd or (q.shape[-1] // hd) % num_kv_heads:
        raise ValueError(f"q width {q.shape[-1]}: the query heads must be a multiple of {num_kv_heads} heads of {hd}")
    B = q.shape[0]
    if kv_start.shape != (B,) or kv_end.shape != (B,):
        raise ValueError(f"kv_start/kv_end must be [{B}]")
    if any(t.device != q.device for t in (k, v, kv_start, kv_end)):
        raise ValueError("all flash_attention inputs must be on one device")
    return hd


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_start: torch.Tensor,
    kv_end: torch.Tensor,
    sm_scale: float,
    num_kv_heads: int,
) -> torch.Tensor:
    """Causal GQA attention over ``[B, S, NH*D]`` with per-row key ranges."""
    hd = _check_args(q, k, v, kv_start, kv_end, num_kv_heads)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_start, kv_end, sm_scale, num_kv_heads)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if hd % 64:
        raise ValueError(f"flash_attention kernel takes head_dim a multiple of 64, got {hd}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if kv_start.dtype != torch.int32 or kv_end.dtype != torch.int32:
        raise TypeError("kv_start/kv_end must be int32")
    if not all(t.is_contiguous() for t in (q, k, v, kv_start, kv_end)):
        raise ValueError("flash_attention kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned q/k/v")
    B, S, F = q.shape
    out = torch.empty_like(q)
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(
            _lib().flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_start.data_ptr(), kv_end.data_ptr(),
                out.data_ptr(), B, S, F // hd, num_kv_heads, hd, float(sm_scale), stream,
            ),
            "flash_attention_launch",
        )
    launches += 1
    return out
