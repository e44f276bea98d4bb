"""Median milliseconds of the reranker's ``rerank.forward`` span over the
window's batches: the layers to the cutoff and the score head with its host
read."""


def read(rec):
    return rec.span_ms("rerank.forward")
