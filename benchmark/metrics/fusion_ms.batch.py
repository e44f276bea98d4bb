"""Median milliseconds of the pipeline's ``fusion`` span over the window's
calls: both routes' lists fused, row by row, after ``retrieval_batch``."""


def read(rec):
    return rec.span_ms("fusion")
