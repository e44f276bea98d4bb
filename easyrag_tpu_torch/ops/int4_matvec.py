"""Matvec over nibble-packed int4 weights (the port of ``easyrag_tpu`` K2,
``ops/int4_matvec.py::int4_matvec``).

``int4_matvec(x, w_p, scale)`` computes, for ``x`` ``[R, I]`` with
``R <= 64``, ``w_p`` ``[O, I/2]`` int8 in the halves layout
(``models/quant.py``) and ``scale`` ``[O]`` f32::

    y = (x[:, :I/2] @ lo.T + x[:, I/2:] @ hi.T) * scale   # -> [R, O], x's dtype

where ``lo``/``hi`` are the sign-extended low/high nibbles: the TPU kernel's
math (f32 sums, f32 rescale, one cast at the end). CUDA tensors go through
``csrc/int4_matvec.cu`` (body in ``csrc/int4_matvec.cuh``), which reads the
packed bytes once per launch and sums every output in an order that does not
depend on ``R``: the K slices and blocks of :func:`plan` depend on ``(O,
I/2)`` and the card only, and with more than one slice a second pass adds
the slices' f32 partials in slice order. CPU tensors go through
:func:`int4_matvec_plain`.

:func:`int4pack_operands` repacks K2's operands for PyTorch's own int4
kernel, ``torch.ops.aten._weight_int4pack_mm``: the yardstick ``chip_smoke.py``
times beside K2. The port never calls that kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build

MAX_ROWS = 64  # past this the product is compute-bound: layers.linear unpacks
STEP = 64  # packed bytes of one row a lane group reads per step
TILE_O = 16  # output channels of one mma tile
WARPS = 8  # warps per block (the kernel runs 4 at R > 32; the plan does not change)
MAX_SLICE_STEPS = 8  # a K slice is at most 512 packed columns: x's slice fits shared memory at R = 64
MIN_SLICE_STEPS = 2  # slices are cut finer for parallelism only down to 128 packed columns
# plan()'s cost model, in steps of one warp tile: a block's start (x staged,
# the first copies' latency), and a warp tile's own cost beyond its steps
# (the wait for its copies, its partials' stores). Against the closed form
# (the fewest slices, one wave of blocks) its plans took 13-21% less time at
# qkv, 6-50% at kv and 4-7% at down, R = 1-64 (PERF.md §6).
START_STEPS = 8
TILE_STEPS = 2

#: wrapper calls that launched the kernel; a call whose plan has more than one
#: K slice is two device launches (the matvec and the slices' reduction)
launches = 0


def supported(rows: int, n_out: int, half_in: int) -> bool:
    """The kernel's shape gate: whole 64-byte steps along ``I/2`` and whole
    16-channel tiles along ``O``. It covers every Qwen2-7B projection, fused
    or not, and the LM head."""
    return 0 < rows <= MAX_ROWS and half_in > 0 and half_in % STEP == 0 and n_out > 0 and n_out % TILE_O == 0


@functools.lru_cache(maxsize=None)
def plan(n_out: int, half_in: int, sms: int) -> Tuple[int, int]:
    """``(ks, nblk)``: the kernel's K slices of ``I/2`` and its blocks per
    slice on a card of ``sms`` multiprocessors (the kernel runs one block on
    each). A function of ``(O, I/2)`` and the card only, never of the row
    count, so every output is summed in the same order at every ``R``.

    Slices hold at most ``MAX_SLICE_STEPS`` 64-byte steps (x's slice for 64
    rows then fits shared memory) and at least ``MIN_SLICE_STEPS``. Of those,
    the plan takes the fewest (waves of one block an SM) x (``START_STEPS`` +
    the busiest warp's tiles x (their steps + ``TILE_STEPS``)); on a tie the
    fewest slices (the smallest workspace), then the most SMs busy in the
    first wave, then the fewest blocks."""
    steps = half_in // STEP
    tiles = -(-n_out // TILE_O)
    best = None
    for ks in range(-(-steps // MAX_SLICE_STEPS), max(steps // MIN_SLICE_STEPS, 1) + 1):
        per_slice = -(-steps // ks)
        for nblk in range(1, -(-tiles // WARPS) + 1):
            waves = -(-(nblk * ks) // sms)
            busiest = -(-tiles // (nblk * WARPS))
            cost = (waves * (busiest * (per_slice + TILE_STEPS) + START_STEPS), ks, -min(nblk * ks, sms), nblk)
            if best is None or cost < best:
                best = cost
    return best[1], best[3]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nibbles(w_p: torch.Tensor):
    """``(lo, hi)``: the sign-extended low and high nibbles of ``w_p``, int32."""
    b = w_p.to(torch.int32)
    return (b << 28) >> 28, b >> 4


def int4_matvec_plain(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack, f32 product, f32 rescale, cast."""
    half = w_p.shape[1]
    lo, hi = (n.float() for n in _nibbles(w_p))
    xf = x.float()
    acc = xf[:, :half] @ lo.t() + xf[:, half:] @ hi.t()
    return (acc * scale.float()).to(x.dtype)


def _lib():
    lib = _build.load("int4_matvec")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int4_matvec_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
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
    if x.data_ptr() % 16 or w_p.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("int4_matvec kernel needs 16-byte aligned x, w_p and scale")
    ks, nblk = plan(O, half, _sms(x.device.index))
    out = torch.empty((R, O), dtype=x.dtype, device=x.device)
    # the slices' f32 partials, added in slice order by the kernel's second pass
    ws = torch.empty((ks, R, O), dtype=torch.float32, device=x.device) if ks > 1 else None
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(
            _lib().int4_matvec_launch(
                x.data_ptr(), w_p.data_ptr(), scale.data_ptr(), out.data_ptr(),
                ws.data_ptr() if ws is not None else None, R, O, half, ks, nblk, stream,
            ),
            "int4_matvec_launch",
        )
    launches += 1
    return out


def int4pack_operands(w_p: torch.Tensor, scale: torch.Tensor, group_size: int = 128):
    """K2's operands as ``torch.ops.aten._convert_weight_to_int4pack`` and
    ``_weight_int4pack_mm`` take them: ``(w_u8, scales_and_zeros)``.

    ``w_u8`` is ``[O, I/2]`` uint8 with column ``2j`` in the high nibble and
    ``2j + 1`` in the low one, each the unsigned ``s + 8`` of K2's signed
    nibble ``s``; ``scales_and_zeros`` is ``[I / group_size, O, 2]`` bf16 with
    the channel's scale (rounded to bf16) in every group and zero 0, so that
    PyTorch's dequantization ``(u - 8) * scale + zero`` gives ``s * scale``."""
    half = w_p.shape[1]
    if (2 * half) % group_size:
        raise ValueError(f"I={2 * half} is not a multiple of group_size={group_size}")
    q = torch.cat(_nibbles(w_p), dim=1) + 8  # [O, I], 0..15
    w_u8 = ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8)
    groups = 2 * half // group_size
    sz = torch.zeros((groups, w_p.shape[0], 2), dtype=torch.bfloat16, device=w_p.device)
    sz[:, :, 0] = scale.to(torch.bfloat16)[None, :]
    return w_u8, sz


def int4pack_dequantize(w_u8: torch.Tensor, scales_and_zeros: torch.Tensor) -> torch.Tensor:
    """``[O, I]`` f32 weights of :func:`int4pack_operands`'s layout, by
    PyTorch's rule ``(u - 8) * scale + zero`` per ``I / groups`` columns."""
    u = w_u8.to(torch.int32)
    q = torch.stack([u >> 4, u & 15], dim=2).reshape(u.shape[0], -1).float()
    group = q.shape[1] // scales_and_zeros.shape[0]
    sc = scales_and_zeros[:, :, 0].float().t().repeat_interleave(group, dim=1)
    zero = scales_and_zeros[:, :, 1].float().t().repeat_interleave(group, dim=1)
    return (q - 8.0) * sc + zero
