"""Median milliseconds of the pipeline's ``contexts`` span over the window's
calls: every row's node contents, after the fusion."""


def read(rec):
    return rec.span_ms("contexts")
