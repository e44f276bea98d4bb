"""Median milliseconds of the window's calls, each one
``run_retrieval_batch`` over a batch of questions, from call to return
(host clock)."""

import statistics


def read(rec):
    lat = rec.latencies()
    return statistics.median(lat) * 1e3 if lat else None
