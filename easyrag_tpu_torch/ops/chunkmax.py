"""Chunk maxima of a score row (K6, the port of ``easyrag_tpu``'s chunk-max
stage: ``tools/exp_chunkmax.py:131`` ``pallas_roll``, step 1 of
``ops/topk.py::_chunkmax_pruned_topk``).

``chunk_max(x)`` takes a contiguous f32 ``[B, N]`` with ``N % 8 == 0`` and
returns ``[B, N / 8]``, ``out[b, c] = max(x[b, 8c : 8c + 8])``. A CUDA tensor
goes through ``csrc/chunkmax.cu`` (one thread per chunk, two ``float4``
loads, one store), a CPU tensor through :func:`chunk_max_plain`. Anything
else raises; a failed build or launch raises too: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: chunk length (``easyrag_tpu/ops/topk.py::_PRUNE_CH``)
CH = 8

#: kernel launches made by :func:`chunk_max` (read and reset by callers)
launches = 0


def chunk_max_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x.view(B, N // 8, 8).amax(-1)``."""
    B, N = x.shape
    return x.view(B, N // CH, CH).amax(-1)


def _lib():
    lib = _build.load("chunkmax")
    if not getattr(lib, "_argtypes_set", False):
        lib.chunk_max_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.chunk_max_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _launch(x: torch.Tensor, out: torch.Tensor) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(_lib().chunk_max_launch(x.data_ptr(), out.data_ptr(), out.numel(), stream), "chunk_max_launch")


def chunk_max(x: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` f32 -> ``[B, N / 8]`` chunk maxima (K6 on a CUDA tensor)."""
    if x.dim() != 2 or x.shape[1] % CH:
        raise ValueError(f"chunk_max takes [B, N] with N % {CH} == 0, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"chunk_max takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("chunk_max needs a contiguous input")
    if x.device.type == "cpu":
        return chunk_max_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"chunk_max: no kernel for device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("chunk_max kernel needs a 16-byte aligned input (float4 loads)")
    B, N = x.shape
    out = torch.empty((B, N // CH), dtype=torch.float32, device=x.device)
    if out.numel() == 0:  # nothing to launch
        return out
    global launches
    # the launch goes to the current device: switch only when the tensor
    # lies on another one
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            _launch(x, out)
    else:
        _launch(x, out)
    launches += 1
    return out
