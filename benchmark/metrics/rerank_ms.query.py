"""Median milliseconds of the pipeline's ``rerank`` span over the window's
requests."""


def read(rec):
    return rec.span_ms("rerank")
