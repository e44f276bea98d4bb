"""easyrag_tpu_torch — the PyTorch + CUDA port of ``easyrag_tpu`` for one
NVIDIA H100.

The default RAG path (``EasyRAGPipeline.run(query)`` on
``configs/easyrag.yaml``): the dual BM25 route resident on the card, content
fusion, the MiniCPM layerwise reranker and the QA prompt. Host code that has
no JAX dependency is shared with ``easyrag_tpu`` (config, schema, corpus,
templates, ``LLMRerank``, generation); everything that touched JAX there has a
torch counterpart here. The two TPU kernels on this path are hand-written CUDA
kernels under ``csrc/`` (built with ``nvcc`` at first use, see ``_build.py``):

* ``ops/flash64.py`` — causal head_dim-64 attention (``easyrag_tpu`` K1);
* ``ops/bm25_scatter.py`` — the BM25 postings scatter (``easyrag_tpu`` K5).

Every wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel (or raises) for CUDA tensors. Nothing here imports ``jax``.
"""

__version__ = "0.1.0"
