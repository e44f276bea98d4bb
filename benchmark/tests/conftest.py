"""Tiny cells for the benchmark's CPU tests: the real files of a cell, with
the model and the corpus cut to a size a test run holds, in float32."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2**31 + 4321  # past 32 signed bits, as the driver's seeds are


QUERY, BATCH = "easyrag_minicpm.query_c1", "easyrag_minicpm.retrieval_b32"


def shrink(cell):
    """Depth, vocabulary, pair length and candidates cut to a CPU test's
    size, in float32, over a small corpus. The width stays at 1024: narrower,
    bf16's rounding of the scores grows to a large share of their spread
    (4% of it at 512, a third at 128; 3-4% at the published 2304), and the
    check's unit, a plain bf16 computation's error, would hide the planted
    faults."""
    c = cell.config
    c.update(vocab_size=500, hidden_size=1024, intermediate_size=2048, num_hidden_layers=4,
             num_attention_heads=16, num_key_value_heads=16, start_layer=1)
    c["reranker"].update(cutoff_layer=3, max_length=128, dtype="float32")
    c["corpus"].update(files=400, vocab=3000, mean_words=60, min_words=10)
    c["preset"]["f_topk_2"] = 56  # two rerank batches
    return cell


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    """A tiny cell by name; its corpus goes under this test's own temporary
    directory (the harness writes it at a fixed name under ``TMPDIR``, and
    test workers run side by side)."""
    import tempfile

    from benchmark.harness.cell import load_cell

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return lambda name: shrink(load_cell(name))
