"""The MiniCPM decoder layer's elementwise chain (``csrc/fused_norm.cu``):
residual add + RMSNorm, the residual add alone, and SiLU times up, the
rerankers' chain (``models/layers.py::FUSED``) in ``layers.decoder_layer``.

:func:`residual_rms_norm`, :func:`residual_add` and :func:`silu_mul` choose
by device alone: CUDA tensors go to the ``*_kernel`` wrappers, CPU tensors
to the plain versions, which are the eager ops of ``models/layers.py``'s
eager chain. The wrappers take bf16, contiguous, 16-byte aligned tensors of
one shape on one device, with a last axis that is a multiple of 8 (at most
``MAX_D`` for the norm), and raise on anything else and on a failed build or
launch: there is no fallback on the card. The kernels round where the eager
ops round: the new residual and the activation equal the plain versions'
bit for bit, the normalised rows within one bf16 ulp (the f32 sum of squares
is taken in another order).

``launches`` counts kernel launches and ``plain_calls`` the calls that took
the plain versions (read by the reranker, which reports both once a batch).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

#: widest row the norm kernel holds in registers (9 16-byte vectors a lane:
#: MiniCPM's hidden size)
MAX_D = 2304

#: kernel launches made by the ``*_kernel`` wrappers
launches = 0
#: calls of the three functions that took the plain versions
plain_calls = 0


def residual_rms_norm_plain(
    x: torch.Tensor, w: torch.Tensor, eps: float, h: Optional[torch.Tensor] = None, r: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + h * r, rms_norm(x + h * r) * w)`` by the eager ops (``x`` and
    ``rms_norm(x) * w`` without ``h``)."""
    if h is not None:
        x = x + h * r
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return x, (normed * w.float()).to(x.dtype)


def residual_add_plain(x: torch.Tensor, h: torch.Tensor, r: float) -> torch.Tensor:
    return x + h * r


def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def _check(name: str, x: torch.Tensor, *others: Optional[torch.Tensor], w: Optional[torch.Tensor] = None) -> None:
    """Raise unless the kernels take ``x``, ``others`` (``x``'s shape; None
    skipped) and the weight ``w`` (``[D]``, ``D <= MAX_D``)."""
    tensors = [x, *(t for t in others if t is not None), *([w] if w is not None else [])]
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: no kernel for device {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on {t.device} and {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned inputs (16-byte vectors)")
        if t.dim() == 0 or t.shape[-1] % 8:
            raise ValueError(f"{name} takes a last axis that is a multiple of 8, got {tuple(t.shape)}")
    for t in others:
        if t is not None and t.shape != x.shape:
            raise ValueError(f"{name}: shapes differ: {tuple(x.shape)} and {tuple(t.shape)}")
    if w is not None and (w.shape != x.shape[-1:] or x.shape[-1] > MAX_D):
        raise ValueError(f"{name} takes [..., D] with D <= {MAX_D} and a [D] weight, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")


def _lib():
    lib = _build.load("fused_norm")
    if not getattr(lib, "_argtypes_set", False):
        p, f, n = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
        lib.residual_rms_norm_launch.argtypes = [p, p, p, f, f, p, p, n, ctypes.c_int, p]
        lib.scale_add_launch.argtypes = [p, p, f, p, n, p]
        lib.silu_mul_launch.argtypes = [p, p, p, n, p]
        for fn in (lib.residual_rms_norm_launch, lib.scale_add_launch, lib.silu_mul_launch):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _launch(what: str, device: torch.device, call) -> None:
    global launches
    with torch.cuda.device(device):
        _build.check(call(_lib(), torch.cuda.current_stream().cuda_stream), what)
    launches += 1


def residual_rms_norm_kernel(
    x: torch.Tensor, w: torch.Tensor, eps: float, h: Optional[torch.Tensor] = None, r: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`residual_rms_norm_plain` on the card: ``x`` (and ``h``)
    ``[..., D]``, ``w`` ``[D]``, D a multiple of 8 up to ``MAX_D``."""
    _check("residual_rms_norm", x, h, w=w)
    d = x.shape[-1]
    x_out = torch.empty_like(x) if h is not None else x
    normed = torch.empty_like(x)
    if normed.numel():
        _launch("residual_rms_norm_launch", x.device, lambda lib, s: lib.residual_rms_norm_launch(
            x.data_ptr(), h.data_ptr() if h is not None else None, w.data_ptr(), r, eps,
            x_out.data_ptr() if h is not None else None, normed.data_ptr(), x.numel() // d, d, s))
    return x_out, normed


def residual_add_kernel(x: torch.Tensor, h: torch.Tensor, r: float) -> torch.Tensor:
    """:func:`residual_add_plain` on the card."""
    _check("residual_add", x, h)
    out = torch.empty_like(x)
    if out.numel():
        _launch("scale_add_launch", x.device,
                lambda lib, s: lib.scale_add_launch(x.data_ptr(), h.data_ptr(), r, out.data_ptr(), x.numel(), s))
    return out


def silu_mul_kernel(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """:func:`silu_mul_plain` on the card."""
    _check("silu_mul", gate, up)
    out = torch.empty_like(gate)
    if out.numel():
        _launch("silu_mul_launch", gate.device,
                lambda lib, s: lib.silu_mul_launch(gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(), s))
    return out


def _on_card(x: torch.Tensor) -> bool:
    global plain_calls
    if x.device.type == "cuda":
        return True
    plain_calls += 1
    return False


def residual_rms_norm(
    x: torch.Tensor, w: torch.Tensor, eps: float, h: Optional[torch.Tensor] = None, r: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x', rms_norm(x') * w)`` with ``x' = x + h * r`` (``x' = x``
    without ``h``): the kernel on the card, the plain version else."""
    if _on_card(x):
        return residual_rms_norm_kernel(x, w, eps, h, r)
    return residual_rms_norm_plain(x, w, eps, h, r)


def residual_add(x: torch.Tensor, h: torch.Tensor, r: float) -> torch.Tensor:
    """``x + h * r``: the kernel on the card, the plain version else."""
    if _on_card(x):
        return residual_add_kernel(x, h, r)
    return residual_add_plain(x, h, r)


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up``: the kernel on the card, the plain version else."""
    if _on_card(gate):
        return silu_mul_kernel(gate, up)
    return silu_mul_plain(gate, up)
