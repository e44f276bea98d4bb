"""The readers of the program's stage spans at hand-built readings: each
gives its span's median (or the collector's share of the window), and
nothing where the program emits no such span."""

from __future__ import annotations

import math

import pytest

from benchmark.harness.cell import Readings, load_reader
from benchmark.harness.drivers import Window

MEDIANS = {
    "retrieval_prep_ms.batch": "retrieval_batch.prep",
    "retrieval_stream_ms.batch": "retrieval_batch.stream",
    "retrieval_nodes_ms.batch": "retrieval_batch.nodes",
    "retrieval_overflow_ms.batch": "retrieval_batch.overflow",
    "fusion_ms.batch": "fusion",
    "contexts_ms.batch": "contexts",
    "rerank_prep_ms.query": "rerank.prep",
    "rerank_forward_ms.query": "rerank.forward",
}


def readings(spans):
    return Readings(config={}, traffic={}, window=Window(start=10.0, end=60.0), spans=spans)


@pytest.mark.parametrize("metric", sorted(MEDIANS))
def test_median_of_its_span(metric):
    read = load_reader(metric)
    rec = readings({MEDIANS[metric]: [0.004, 0.001, 0.009], "request": [1.0], "gc": [0.5]})
    assert math.isclose(read(rec), 4.0)
    assert read(readings({"request": [1.0], "gc": [0.5]})) is None


def test_gc_share_of_the_window():
    read = load_reader("gc_pct.batch")
    assert math.isclose(read(readings({"gc": [0.5, 2.0, 2.5], "fusion": [9.0]})), 10.0)
    assert read(readings({"fusion": [9.0]})) is None
