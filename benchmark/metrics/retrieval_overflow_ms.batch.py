"""Median milliseconds of the pipeline's ``retrieval_batch.overflow`` span over
the window's calls that had one: the per-route retrieval of the questions
past the term budget (the gather path)."""


def read(rec):
    return rec.span_ms("retrieval_batch.overflow")
