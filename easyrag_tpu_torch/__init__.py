"""easyrag_tpu_torch — the PyTorch + CUDA port of ``easyrag_tpu`` for one
NVIDIA H100.

The default RAG path (``EasyRAGPipeline.run(query)`` on
``configs/easyrag.yaml``): the dual BM25 route resident on the card, content
fusion, a layerwise reranker (MiniCPM, or the Gemma2 cost-wise reranker with
token compression) and the QA prompt, answered by an injected LLM or the
on-device Qwen2 generator. The dense route (``retrieval_type`` 1 or 3 with
an injected gte-Qwen2 embedder, ``models/qwen2.py``): the flat cosine index
(``index/dense.py``), and with ``rerank_fusion_type`` 1-3 both routes
reranked and fused by reciprocal rank fusion. Batch evaluation (``cli.py``)
and serving (``serving/api.py``: the rerank coalescer and, with
``tpu.local_llm_continuous``, the decode pool of ``models/decode_pool.py``).
Every non-default option of the config but tensor parallelism: hierarchical
chunks with auto-merging, HyDE, the corpus artifact, context compression,
bf16 or int8 heavy storage of the resident BM25 index (whose light tail may
go through K5), the native C++ index builder (``native.py``, built with
``g++``), and indexes sharded over a device mesh (``parallel/``, with the
multi-host corpus build). The offline data prep is ``corpus/zedx.py``,
``corpus/html_text.py`` and ``corpus/ocr.py``.
The package keeps its own copy of the host code it
needs (config, schema, corpus, templates, ``LLMRerank``, generation, event
hooks) and imports nothing of ``easyrag_tpu`` and nothing of ``jax``. Every
TPU kernel on these paths is a hand-written CUDA kernel under ``csrc/``
(built with ``nvcc`` at first use, see ``_build.py``):

* ``ops/flash64.py`` — causal head_dim-64 attention (``easyrag_tpu`` K1);
* ``ops/int4_matvec.py`` — the int4 decode matvec (K2);
* ``ops/flash_attention.py`` — causal GQA attention (K3): the generator's
  prefill and the embedder's layers;
* ``ops/flash_softcap.py`` — softcapped GQA attention, head_dim 256 (K4);
* ``ops/bm25_scatter.py`` — the BM25 postings scatter (K5);
* ``ops/chunkmax.py`` — the pruned top-k's chunk-max (K6).

Every wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel (or raises) for CUDA tensors. The entry points run on the card unless
the caller passes ``device="cpu"``, and raise without one.
"""

__version__ = "0.1.0"
