"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
one file compiles in seconds. The shared library lands in ``build/kernels/``
at the repository root (git-ignored), under a name that hashes the source,
every shared header ``csrc/*.cuh`` and the flags, so an edited source or
header is rebuilt and a stale library is never loaded. A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: every kernel library of ``csrc/`` on a path of the port (the probes aside)
KERNELS = ("flash64", "bm25_scatter", "int4_matvec", "flash_attention", "flash_softcap", "chunkmax", "fused_norm")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ``nvcc``'s stderr per kernel library (ptxas register / spill report)
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _paths(name: str):
    """``(source, library)``: the library's name hashes the source, every
    header of ``csrc/`` (a source may include any of them) and the flags."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    digest = hashlib.sha1()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _compile(names) -> None:
    """Run ``nvcc`` for every library of ``names`` not built yet, one process
    per source, all started together."""
    jobs = []
    for name in names:
        src, out = _paths(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, src, out, tmp, proc))
    failed = []
    for name, src, out, tmp, proc in jobs:
        _, build_logs[name] = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{build_logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(names) -> None:
    """Build (if needed) every library of ``names`` at once, then load them."""
    with _lock:
        todo = [name for name in names if name not in _libs]
        _compile(todo)
        for name in todo:
            _libs[name] = ctypes.CDLL(_paths(name)[1])


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a shared library."""
    build([name])
    return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
