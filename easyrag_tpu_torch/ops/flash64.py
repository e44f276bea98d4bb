"""Causal head_dim-64 attention (the port of ``easyrag_tpu`` K1,
``ops/flash64.py::flash64_attention``).

``flash64_attention(q, k, v, kv_start, kv_end, sm_scale, cos, sin)`` takes
the ``[B, S, H*64]`` hidden layout and a per-row range of valid keys
``[kv_start[b], kv_end[b])``, which covers left and right padding alike (the
TPU kernel's ``first_real`` prefix assumption is wrong under right padding).
Logits and softmax are f32; masked logits are ``finfo(f32).min``, so rows with
no valid key stay finite. With ``cos``/``sin`` (``[S, 64]`` f32,
batch-shared positions) rotate-half RoPE is applied to q and k first.

CUDA tensors go through ``csrc/flash64.cu``, CPU tensors through
:func:`flash64_attention_plain`. The CUDA kernel (its design note has the
details) is persistent: one CTA per SM walks (batch row, head, 128-row q
tile) items, a producer warpgroup keeps Q and K/V tiles of 128 keys coming by
TMA, and two consumer warpgroups overlap each tile's softmax with their
``wgmma`` products. With RoPE a prologue kernel first rotates Q and K into a
``[2, B, S, H*64]`` scratch tensor that the attention kernel loads. Rows
whose keys are all masked (pad rows before ``kv_start``) and rows with an
empty range write zeros. One call counts one launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

MASK_VALUE = float(torch.finfo(torch.float32).min)

#: kernel launches made by :func:`flash64_attention`, one per call
launches = 0


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in f32, rounded back to ``x``'s dtype.
    ``x``: ``[B, S, H, D]``; ``cos``/``sin``: ``[B or 1, S, D]``."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[:, :, None, :] + rotated.float() * sin[:, :, None, :]).to(x.dtype)


def key_keep_mask(kv_start: torch.Tensor, kv_end: torch.Tensor, S: int) -> torch.Tensor:
    """``[B, 1, S, S]`` bool: causal and key inside the row's range."""
    pos = torch.arange(S, device=kv_start.device)
    causal = pos[None, :] <= pos[:, None]
    in_range = (pos[None, :] >= kv_start[:, None]) & (pos[None, :] < kv_end[:, None])
    return causal[None, None] & in_range[:, None, None, :]


def masked_attention(
    qh: torch.Tensor,  # [B, S, H, D]
    kh: torch.Tensor,
    vh: torch.Tensor,
    kv_start: torch.Tensor,
    kv_end: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """The reference's einsum attention: materialised f32 logits, softmax
    over all S keys, probabilities rounded to the input dtype before ``@ v``.
    Rows with no valid key average all S keys."""
    S = qh.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * sm_scale
    logits = torch.where(key_keep_mask(kv_start, kv_end, S), logits, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(qh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh)


def flash64_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_start: torch.Tensor,
    kv_end: torch.Tensor,
    sm_scale: float,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash64_attention`."""
    B, S, F = q.shape
    qh, kh, vh = (t.reshape(B, S, F // 64, 64) for t in (q, k, v))
    if cos is not None:
        qh = apply_rope(qh, cos[None], sin[None])
        kh = apply_rope(kh, cos[None], sin[None])
    return masked_attention(qh, kh, vh, kv_start, kv_end, sm_scale).reshape(B, S, F)


def _lib():
    lib = _build.load("flash64")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash64_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, ctypes.c_float, p]
        lib.flash64_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check_args(q, k, v, kv_start, kv_end, cos, sin):
    if q.dim() != 3 or q.shape[-1] % 64:
        raise ValueError(f"q must be [B, S, H*64], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, S, _ = q.shape
    if kv_start.shape != (B,) or kv_end.shape != (B,):
        raise ValueError(f"kv_start/kv_end must be [{B}]")
    if (cos is None) != (sin is None):
        raise ValueError("give both cos and sin, or neither")
    if cos is not None and (cos.shape != (S, 64) or sin.shape != (S, 64)):
        raise ValueError(f"cos/sin must be [{S}, 64]")
    tensors = [k, v, kv_start, kv_end] + ([cos, sin] if cos is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("all flash64 inputs must be on one device")


def flash64_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_start: torch.Tensor,
    kv_end: torch.Tensor,
    sm_scale: float,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention over ``[B, S, H*64]`` with per-row key ranges."""
    _check_args(q, k, v, kv_start, kv_end, cos, sin)
    if q.device.type == "cpu":
        return flash64_attention_plain(q, k, v, kv_start, kv_end, sm_scale, cos, sin)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash64_attention: no kernel for device {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash64 kernel takes bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if kv_start.dtype != torch.int32 or kv_end.dtype != torch.int32:
        raise TypeError("kv_start/kv_end must be int32")
    if cos is not None and (cos.dtype != torch.float32 or sin.dtype != torch.float32):
        raise TypeError("cos/sin must be float32")
    tensors = [q, k, v, kv_start, kv_end] + ([cos, sin] if cos is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash64 kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors if t.dtype != torch.int32):
        raise ValueError("flash64 kernel needs 16-byte aligned q/k/v/cos/sin")
    B, S, F = q.shape
    out = torch.empty_like(q)
    qk_rot = torch.empty((2, B, S, F), dtype=q.dtype, device=q.device) if cos is not None else None
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(
            _lib().flash64_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_start.data_ptr(), kv_end.data_ptr(),
                cos.data_ptr() if cos is not None else None,
                sin.data_ptr() if sin is not None else None,
                qk_rot.data_ptr() if qk_rot is not None else None,
                out.data_ptr(), B, S, F // 64, float(sm_scale), stream,
            ),
            "flash64_launch",
        )
    launches += 1
    return out
