"""Serving layer: HTTP API, reranker coalescing and web UI (port of
``easyrag_tpu/serving``)."""
