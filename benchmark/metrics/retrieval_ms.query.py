"""Median milliseconds of the pipeline's ``retrieval`` span (the sparse
dual route and the fusion) over the window's requests."""


def read(rec):
    return rec.span_ms("retrieval")
