"""Median milliseconds of the pipeline's ``retrieval_batch.stream`` span over
the window's calls: both routes' resident scoring and top-k over the rows in
the term budget, to the host read of the results."""


def read(rec):
    return rec.span_ms("retrieval_batch.stream")
