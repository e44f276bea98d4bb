"""Matvec over nibble-packed int4 weights (the port of ``easyrag_tpu`` K2,
``ops/int4_matvec.py::int4_matvec``).

``int4_matvec(x, w_p, scale)`` computes, for ``x`` ``[R, I]`` with
``R <= 64``, ``w_p`` ``[O, I/2]`` int8 in the halves layout
(``models/quant.py``) and ``scale`` ``[O]`` f32::

    y = (x[:, :I/2] @ lo.T + x[:, I/2:] @ hi.T) * scale   # -> [R, O], x's dtype

where ``lo``/``hi`` are the sign-extended low/high nibbles: the TPU kernel's
math (f32 sums, f32 rescale, one cast at the end). CUDA tensors go through
``csrc/int4_matvec.cu``, which reads the packed bytes once per launch and
sums every output in an order that does not depend on ``R``; CPU tensors go
through :func:`int4_matvec_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

MAX_ROWS = 64  # past this the product is compute-bound: layers.linear unpacks
STEP = 64  # packed bytes of one row a warp reads per step
TILE_O = 16  # output channels per block

#: kernel launches made by :func:`int4_matvec`
launches = 0


def supported(rows: int, n_out: int, half_in: int) -> bool:
    """The kernel's shape gate: whole 64-byte steps along ``I/2`` and whole
    16-channel tiles along ``O``. It covers every Qwen2-7B projection, fused
    or not, and the LM head."""
    return 0 < rows <= MAX_ROWS and half_in > 0 and half_in % STEP == 0 and n_out > 0 and n_out % TILE_O == 0


def int4_matvec_plain(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack, f32 product, f32 rescale, cast."""
    half = w_p.shape[1]
    b = w_p.to(torch.int32)
    lo = ((b << 28) >> 28).float()
    hi = (b >> 4).float()
    xf = x.float()
    acc = xf[:, :half] @ lo.t() + xf[:, half:] @ hi.t()
    return (acc * scale.float()).to(x.dtype)


def _lib():
    lib = _build.load("int4_matvec")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int4_matvec_launch.argtypes = [p, p, p, p, i, i, i, p]
        lib.int4_matvec_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def int4_matvec(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``[R, I]`` x ``[O, I/2]`` packed -> ``[R, O]`` in x's dtype."""
    if x.dim() != 2 or w_p.dim() != 2 or x.shape[1] != 2 * w_p.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} / w_p {tuple(w_p.shape)}: need [R, I] and [O, I/2]")
    if scale.shape != (w_p.shape[0],):
        raise ValueError(f"scale must be [{w_p.shape[0]}], got {tuple(scale.shape)}")
    if x.device != w_p.device or x.device != scale.device:
        raise ValueError("x, w_p and scale must be on one device")
    if w_p.dtype != torch.int8:
        raise TypeError(f"w_p must be int8, got {w_p.dtype}")
    if x.device.type == "cpu":
        return int4_matvec_plain(x, w_p, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"int4_matvec: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or scale.dtype != torch.float32:
        raise TypeError(f"int4_matvec kernel takes bfloat16 x and float32 scale, got {x.dtype}/{scale.dtype}")
    R, O, half = x.shape[0], w_p.shape[0], w_p.shape[1]
    if not supported(R, O, half):
        raise ValueError(f"int4_matvec kernel does not take R={R}, O={O}, I/2={half}")
    if not (x.is_contiguous() and w_p.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int4_matvec kernel needs contiguous inputs")
    if x.data_ptr() % 16 or w_p.data_ptr() % 16:
        raise ValueError("int4_matvec kernel needs 16-byte aligned x and w_p")
    out = torch.empty((R, O), dtype=x.dtype, device=x.device)
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(
            _lib().int4_matvec_launch(
                x.data_ptr(), w_p.data_ptr(), scale.data_ptr(), out.data_ptr(), R, O, half, stream
            ),
            "int4_matvec_launch",
        )
    launches += 1
    return out
