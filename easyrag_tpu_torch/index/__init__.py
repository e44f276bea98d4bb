"""Index structures: the sparse BM25 index (numpy), the dense cosine index
(torch) and the on-disk corpus artifact."""
