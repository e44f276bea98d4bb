"""ctypes bindings for the native BM25 index builder (port of
``easyrag_tpu/native.py``).

The source is the port's own copy, ``csrc/bm25_index.cpp``. ``g++`` builds
it at first use into ``build/native/`` at the repository root (git-ignored),
under a name that hashes the source and the flags; the repository's
``native/`` is never read or written. Without a toolchain
:func:`build_index_native` returns None and ``build_sparse_index`` takes the
Python builder, whose arrays are the same (host code, not a device kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "bm25_index.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

#: indexes built by the native builder (read and reset by callers)
builds = 0


def _lib_path() -> str:
    digest = hashlib.sha1()
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libeasyrag_bm25-{digest.hexdigest()[:12]}.so")


def _build_lib() -> Optional[str]:
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    os.replace(tmp, path)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it cannot build."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build_lib()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        lib.easyrag_build_bm25_index.restype = ctypes.c_int64
        lib.easyrag_build_bm25_index.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,  # text_buf, buf_len
            ctypes.c_int64,  # n_tokens
            i64p, ctypes.c_int64,  # doc_offsets, n_docs
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
            i32p,  # token_term_ids
            i32p,  # doc_lens
            i64p,  # term_offsets
            i32p,  # post_docs
            i32p,  # post_tfs
            ctypes.POINTER(ctypes.c_double),  # post_vals
            i64p, i64p,  # out_vocab, out_postings
            i64p,  # first_token_pos
        ]
        _lib = lib
        return _lib


def build_index_native(
    corpus_tokens: Sequence[Sequence[str]],
    k1: float = 1.5,
    b: float = 0.75,
    epsilon: float = 0.25,
    bm25_type: int = 0,
):
    """Tokenized corpus -> ``(vocab, doc_lens, term_offsets, post_docs,
    post_tfs, post_vals)`` through the C++ builder, the Python builder's
    arrays; None when the library is unavailable."""
    global builds
    lib = get_lib()
    if lib is None:
        return None

    flat: List[str] = []
    doc_offsets = np.zeros(len(corpus_tokens) + 1, dtype=np.int64)
    for d, toks in enumerate(corpus_tokens):
        flat.extend(toks)
        doc_offsets[d + 1] = len(flat)
    n_tokens = len(flat)
    # one join + encode: the C++ side splits on the NUL separators (no token
    # holds a NUL)
    text_buf = "\x00".join(flat).encode("utf-8")

    n = max(n_tokens, 1)
    token_term_ids = np.zeros(n, dtype=np.int32)
    doc_lens = np.zeros(max(len(corpus_tokens), 1), dtype=np.int32)
    term_offsets = np.zeros(n_tokens + 1, dtype=np.int64)
    post_docs = np.zeros(n, dtype=np.int32)
    post_tfs = np.zeros(n, dtype=np.int32)
    post_vals = np.zeros(n, dtype=np.float64)
    first_token_pos = np.zeros(n, dtype=np.int64)
    out_v, out_p = ctypes.c_int64(0), ctypes.c_int64(0)

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    ret = lib.easyrag_build_bm25_index(
        text_buf, len(text_buf), n_tokens, ptr(doc_offsets, ctypes.c_int64), len(corpus_tokens),
        k1, b, epsilon, bm25_type,
        ptr(token_term_ids, ctypes.c_int32), ptr(doc_lens, ctypes.c_int32), ptr(term_offsets, ctypes.c_int64),
        ptr(post_docs, ctypes.c_int32), ptr(post_tfs, ctypes.c_int32), ptr(post_vals, ctypes.c_double),
        ctypes.byref(out_v), ctypes.byref(out_p), ptr(first_token_pos, ctypes.c_int64),
    )
    if ret != 0:
        return None
    V, P = out_v.value, out_p.value
    # term ids are assigned in first-appearance order; the C++ side records
    # the first token position of each id
    vocab = {flat[int(first_token_pos[v])]: v for v in range(V)}
    builds += 1
    return (
        vocab,
        doc_lens[: len(corpus_tokens)],
        term_offsets[: V + 1].copy(),
        post_docs[:P].copy(),
        post_tfs[:P].copy(),
        post_vals[:P].copy(),
    )
