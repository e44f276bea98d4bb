"""Tiny cells for the benchmark's CPU tests: the real files of a cell, with
the model and the corpus cut to a size a test run holds, in float32."""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2**31 + 4321  # past 32 signed bits, as the driver's seeds are


QUERY, BATCH = "easyrag_minicpm.query_c1", "easyrag_minicpm.retrieval_b32"

# The retrieval batch cell, kept for the tests of the ``retrieval_batch``
# entry (the CLI's evaluation path) after it left the benchmark: 32-question
# ``run_retrieval_batch`` calls of query_c1's mix with the reranker off.
BATCH_TRAFFIC = {"entry": "retrieval_batch", "clients": 1, "batch": 32, "cycle": 4096, "words": 12,
                 "doc_name": True, "filter_every": 8, "long_every": 16, "long_terms": 80, "check_share": 0.016,
                 "overrides": {"use_reranker": 0}}


def lay_out(root, files, link=()):
    """A manifest's tree under ``root``: ``files`` (path -> text) written,
    and the real benchmark's directories ``link`` linked in by name."""
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    for d in link:
        os.makedirs(os.path.join(root, "benchmark"), exist_ok=True)
        target = os.path.join(root, "benchmark", d)
        if not os.path.lexists(target):
            os.symlink(os.path.join(ROOT, "benchmark", d), target)
    return os.path.join(root, "BENCHMARK.json")


def batch_manifest(root) -> str:
    """A manifest holding the batch cell: the real configuration, system and
    readers, the batch traffic, and ``setup_s`` as its one metric."""
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        real = json.load(f)
    manifest = dict(real, configs=[c for c in real["configs"] if c["name"] == "easyrag_minicpm"],
                    workloads=[{"name": BATCH, "config": "easyrag_minicpm", "traffic": "retrieval_b32", "chips": 1,
                                "why": "32-question retrieval calls, reranker off"}],
                    end_to_end=[m for m in real["end_to_end"] if m["name"] == "setup_s"], per_layer=[])
    return lay_out(str(root), {"BENCHMARK.json": json.dumps(manifest),
                               "benchmark/traffic/retrieval_b32.json": json.dumps(BATCH_TRAFFIC)},
                   link=("configs", "systems", "metrics"))


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
    """A tiny cell by name, the batch cell from :func:`batch_manifest`; its
    corpus goes under this test's own temporary directory (the harness writes
    it at a fixed name under ``TMPDIR``, and test workers run side by side)."""
    import tempfile

    from benchmark.harness.cell import MANIFEST, load_cell

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return lambda name: shrink(load_cell(name, batch_manifest(tmp_path / "layout") if name == BATCH else MANIFEST))
