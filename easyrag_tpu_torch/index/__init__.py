"""Index structures: the sparse BM25 index (numpy) and the dense cosine
index (torch)."""
