"""Torch models: the decoder core and the MiniCPM layerwise reranker."""
