"""Median milliseconds of the pipeline's ``retrieval_batch.prep`` span over the
window's calls: the query tokens, dir filters and query terms of both routes
(with the failed batch try and the row-by-row re-check when a question
overflows the term budget)."""


def read(rec):
    return rec.span_ms("retrieval_batch.prep")
