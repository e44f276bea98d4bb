"""Median milliseconds of the window's questions, each one
``EasyRAGPipeline.run`` from call to return (host clock)."""

import statistics


def read(rec):
    lat = rec.latencies()
    return statistics.median(lat) * 1e3 if lat else None
