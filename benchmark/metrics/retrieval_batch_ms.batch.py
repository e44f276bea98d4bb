"""Median milliseconds of the pipeline's ``retrieval_batch`` span (both
sparse routes of a whole call, before the fusion) over the window's calls."""


def read(rec):
    return rec.span_ms("retrieval_batch")
