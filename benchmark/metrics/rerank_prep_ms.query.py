"""Median milliseconds of the reranker's ``rerank.prep`` span over the window's
batches: a batch's inputs, key ranges, RoPE tables, the ids' upload and the
embedding, up to the first layer."""


def read(rec):
    return rec.span_ms("rerank.prep")
