"""Device mesh (port of ``easyrag_tpu/parallel/mesh.py``).

A mesh is an array of ``torch.device`` with named axes. One process drives
it, as JAX's single controller drives its ``Mesh``: the corpus shards over
the ``data`` axis (``parallel/sharded.py``) and a decoder's weights over
the ``model`` axis (tensor parallelism, ``parallel/tp.py``). By default a mesh takes
distinct cards ``cuda:0``, ``cuda:1``, ...; a caller may pass its own
devices, repeated ones included (``["cuda:0"] * 4`` runs four shards on one
card, ``["cpu"] * 4`` on the CPU, as the tests do).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices import resolve_device


class Mesh:
    """``devices``: an object ndarray of ``torch.device`` whose axes are
    ``axis_names``; ``shape`` maps each name to its size, as JAX's
    ``mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {devices.ndim} with axis names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def data_devices(self) -> list:
        """One device per ``data`` shard: ``devices[s, 0, ...]`` (shard ``s``
        is not repeated over the other axes); the whole mesh in order when
        it has no ``data`` axis."""
        if "data" not in self.axis_names:
            return list(self.devices.flat)
        moved = np.moveaxis(self.devices, self.axis_names.index("data"), 0)
        return list(moved.reshape(moved.shape[0], -1)[:, 0])

    def model_devices(self, axis: str = "model") -> list:
        """One device per shard of ``axis``: ``devices[0, ..., s, ..., 0]``,
        the ``axis`` devices of data row 0 (tensor-parallel weights are not
        repeated over the other axes)."""
        moved = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(moved.reshape(moved.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: every card, distinct);
    ``shape`` None puts them all on one axis. Raises where there are fewer
    devices than the shape needs, and without a card when no devices are
    given: there is no CPU default."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass devices=[...] (e.g. ['cpu'] * 4)")
        devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if shape is None:
        shape = [len(devices)]
        axis_names = (axis_names[0],) if axis_names else ("data",)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {list(shape)} needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape), axis_names)


def data_model_mesh(n_devices: int, model_parallel: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """``(data, model)`` mesh: ``data`` shards the corpus, ``model`` the
    weights."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by mp={model_parallel}")
    return make_mesh([n_devices // model_parallel, model_parallel], ("data", "model"), devices)
