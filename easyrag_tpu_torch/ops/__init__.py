"""Device ops: deterministic top-k, BM25 scoring, head_dim-64 attention."""
