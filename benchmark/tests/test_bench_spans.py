"""The readers of the program's stage spans at hand-built readings: each
gives its span's median, and nothing where the program emits no such
span."""

from __future__ import annotations

import math

import pytest

from benchmark.harness.cell import Readings, load_reader
from benchmark.harness.drivers import Window

MEDIANS = {
    "retrieval_ms.query": "retrieval",
    "rerank_ms.query": "rerank",
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

