"""Median milliseconds of the pipeline's ``retrieval_batch.nodes`` span over
the window's calls: the node lists of the streamed rows, both routes."""


def read(rec):
    return rec.span_ms("retrieval_batch.nodes")
