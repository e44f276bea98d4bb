"""The kernel build's cache key (``easyrag_tpu_torch/_build.py``), without
``nvcc``: a library's name hashes its source, every shared header of
``csrc/`` and the flags, so editing any of them names a new library and a
stale one is never loaded."""

import os
import shutil

import pytest

from easyrag_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    for name in ("flash_attention.cu", "flash_softcap.cu", "int4_matvec.cu", "attention_sm90.cuh"):
        shutil.copy(os.path.join(_build.CSRC_DIR, name), tmp_path / name)
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    return tmp_path


def _lib(name):
    return _build._paths(name)[1]


@pytest.mark.parametrize("name", ["flash_attention", "flash_softcap"])
def test_editing_a_header_renames_the_library(csrc, name):
    before = _lib(name)
    assert _lib(name) == before  # stable while nothing changes
    with open(csrc / "attention_sm90.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _lib(name) != before


def test_adding_a_header_renames_the_library(csrc):
    before = _lib("int4_matvec")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _lib("int4_matvec") != before


def test_editing_a_source_or_the_flags_renames_the_library(csrc, monkeypatch):
    before = _lib("flash_softcap")
    with open(csrc / "flash_softcap.cu", "a") as f:
        f.write("\n")
    edited = _lib("flash_softcap")
    assert edited != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _lib("flash_softcap") != edited


def test_library_lands_in_the_build_dir(csrc):
    src, lib = _build._paths("flash_attention")
    assert src == os.path.join(str(csrc), "flash_attention.cu")
    assert os.path.dirname(lib) == _build.BUILD_DIR and os.path.basename(lib).startswith("libflash_attention-")
