"""BM25 postings scatter (the port of ``easyrag_tpu`` K5,
``ops/bm25_pallas.py::bm25_scores_pallas``).

``bm25_scores(doc_ids, vals, num_docs)`` turns gathered postings into a dense
score vector: ``s[d] = sum_p vals[p] * [doc_ids[p] == d]`` in exact f32, ids
outside ``[0, num_docs)`` dropped (the sentinel ``num_docs`` carries value 0).
CUDA tensors go through ``csrc/bm25_scatter.cu``: a stable counting sort of
the postings by doc tile, then one sum per doc over its tile's bucket, so each
doc adds its postings in posting order without float atomics and the result
is the same on every run; CPU tensors go through :func:`bm25_scores_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: kernel launches made by :func:`bm25_scores` (read and reset by callers);
#: one per call, though a call runs the kernel's four passes
launches = 0

# csrc/bm25_scatter.cu's SUB, TILE_DOCS and MAX_TILES
SUB = 512
TILE_DOCS = 128
MAX_TILES = 1024


def scatter_layout(B: int, P: int, num_docs: int):
    """``(tile, n_tiles, n_sub, n_scratch)`` of the kernel's counting sort:
    docs per tile (``TILE_DOCS``, or a multiple of it so that at most
    ``MAX_TILES`` tiles cover ``num_docs``), the tile count, the count of
    ``SUB``-posting sub-chunks per row, and the 4-byte scratch words (counts
    and in-tile offsets, tile totals, bucketed ids, bucketed values)."""
    tile = TILE_DOCS * max(1, -(-num_docs // (TILE_DOCS * MAX_TILES)))
    n_tiles = -(-num_docs // tile)
    n_sub = -(-P // SUB)
    if n_tiles * n_sub + n_tiles + P >= 2**31:
        raise ValueError(f"bm25_scores: P={P}, num_docs={num_docs} overflow the kernel's int32 offsets")
    return tile, n_tiles, n_sub, B * (n_tiles * n_sub + n_tiles + 2 * P)


def bm25_scores_plain(doc_ids: torch.Tensor, vals: torch.Tensor, num_docs: int) -> torch.Tensor:
    """Plain PyTorch version: scatter-add into a sentinel slot that is cut
    off. ``[P]`` or ``[B, P]`` in, ``[N]`` or ``[B, N]`` f32 out."""
    squeeze = doc_ids.dim() == 1
    ids = (doc_ids[None] if squeeze else doc_ids).long()
    v = (vals[None] if squeeze else vals).float()
    B = ids.shape[0]
    valid = (ids >= 0) & (ids < num_docs)
    row = torch.arange(B, device=ids.device)[:, None] * (num_docs + 1)
    flat = torch.where(valid, row + ids, row + num_docs).reshape(-1)
    out = torch.zeros(B * (num_docs + 1), dtype=torch.float32, device=ids.device)
    out.index_add_(0, flat, torch.where(valid, v, 0.0).reshape(-1))
    out = out.reshape(B, num_docs + 1)[:, :num_docs]
    return out[0] if squeeze else out


def _lib():
    lib = _build.load("bm25_scatter")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.bm25_scores_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.bm25_scores_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _launch(ids, vals, out, scratch, B, P, N, tile, n_tiles, n_sub) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = _lib().bm25_scores_launch(
        ids.data_ptr(), vals.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, P, N, tile, n_tiles, n_sub, stream
    )
    _build.check(rc, "bm25_scores_launch")


def bm25_scores(doc_ids: torch.Tensor, vals: torch.Tensor, num_docs: int) -> torch.Tensor:
    """Dense BM25 scores from gathered postings; ``[P]`` or ``[B, P]``."""
    if doc_ids.shape != vals.shape or doc_ids.dim() not in (1, 2):
        raise ValueError(f"doc_ids {tuple(doc_ids.shape)} / vals {tuple(vals.shape)}: need equal [P] or [B, P]")
    if doc_ids.device != vals.device:
        raise ValueError("doc_ids and vals must be on one device")
    if doc_ids.device.type == "cpu":
        return bm25_scores_plain(doc_ids, vals, num_docs)
    if doc_ids.device.type != "cuda":
        raise RuntimeError(f"bm25_scores: no kernel for device {doc_ids.device}")
    if doc_ids.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"bm25_scores kernel takes int32 ids and float32 vals, got {doc_ids.dtype}/{vals.dtype}")
    if not (doc_ids.is_contiguous() and vals.is_contiguous()):
        raise ValueError("bm25_scores kernel needs contiguous inputs")
    if num_docs >= 2**31:
        raise ValueError(f"num_docs {num_docs} does not fit int32 ids")
    squeeze = doc_ids.dim() == 1
    ids2 = doc_ids[None] if squeeze else doc_ids
    B, P = ids2.shape
    dev = doc_ids.device
    out = torch.empty((B, num_docs), dtype=torch.float32, device=dev)
    if num_docs <= 0 or B == 0:  # nothing to launch
        return out[0] if squeeze else out
    tile, n_tiles, n_sub, n_scratch = scatter_layout(B, P, num_docs)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    global launches
    # the launch goes to the current device: switch only when the tensors
    # lie on another one (the switch costs more host time than the kernel)
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            _launch(ids2, vals, out, scratch, B, P, num_docs, tile, n_tiles, n_sub)
    else:
        _launch(ids2, vals, out, scratch, B, P, num_docs, tile, n_tiles, n_sub)
    launches += 1
    return out[0] if squeeze else out
