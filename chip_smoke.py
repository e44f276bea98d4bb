#!/usr/bin/env python3
"""Smoke test of easyrag_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one raises on failure; nothing falls back to the CPU):

0. environment: Python/torch/CUDA versions, the card's ``nvidia-smi`` name
   and power limit, ``nvcc``, and which of yaml/jieba/transformers/bs4
   import;
1. build the six CUDA kernels from ``easyrag_tpu_torch/csrc`` (the sources
   and their shared header ``attention_sm90.cuh``), one ``nvcc`` per source,
   all started together; print each one's registers and spills;
2. each kernel against its plain PyTorch version on the card: K1
   (``flash64_attention``) at B=4, S=1064, H=36 with and without RoPE on
   both padding sides, and at S=1064 and S=8 (ragged last tiles) with rows
   of full length, 40, 1 and 0 (the empty row must be zero); K5
   (``bm25_scores``) at P=32768, N=20000 for B=1 and B=4, and at P 0, 1000,
   32768 and 262144, B 1 and 3, N 20000 and 1 with ids out of range,
   all-sentinel and skewed rows, each the same bits twice and equal bit for
   bit to the plain version's posting-order sums on the CPU; K2
   (``int4_matvec``) on the five Qwen2-7B int4 shapes at R=1, 4, 8, 32 and 64
   (rows of the R=32 launch must equal the smaller launches bit for bit, and
   the R=64 launch's the R=32 launch's; times, GB/s and share of the bound
   from CUDA graphs of at least 50 launches that cycle through copies of the
   weights four times the size of the L2, as a decode step reads every
   layer's weights from HBM; ``_weight_int4pack_mm`` timed the same way on
   the same weights, repacked once, and held to the plain version, or the
   error the card's torch gave),
   K3 (``flash_attention``) at B=1, S=7680 and at B=4, S=2048 left-padded,
   28 query heads of 128 on 4 KV heads, then at head_dim 64 (28 on 4), 192
   (16 on 4), 256 (16 on 8) and 320 (8 on 2), both padding sides, at S=2048
   and (64, 256, 320) S=200, and at 576 (4 on 2) and 1024 (4 on 1), past
   512 where Q and K stream through shared memory, at S=520, with ragged and
   empty rows (an empty row must be zero); max error, median times from
   CUDA events, and SDPA's time on the same inputs; K6 (``chunk_max``) at
   [1, 20000], [64, 20000], [67, 20000] and [256, 20480] with an all
   ``-inf`` row and tied chunks, equal to its plain version bit for bit, the
   pruned top-6/192/288 through it equal to the whole row sorted; device
   times from CUDA graphs cycling through copies of the input 4x the L2's
   size, beside ``amax`` over contiguous 8;
3. the port's ``EasyRAGPipeline.run`` on ``configs/easyrag.yaml`` over a
   seeded synthetic corpus of 20,000 chunks, with the full-width
   bge-reranker-v2-minicpm-layerwise (hidden 2304, 36x64 heads, 40 layers,
   vocab 122,753; random bf16 weights from a seeded ``torch.Generator``), a
   character tokenizer with right padding, and a stub in place of the GLM-4
   client. Three queries: a short one, one with a ``document`` dir filter,
   one with more than 64 distinct terms. Kernel launch counts are reset just
   before the three runs and read just after; K1 and K6 (the content top-192
   and the path top-6) must run on every query and K5 on the long one. The content route's top-192 must equal the
   float64 host ranking (ties aside) and the reranker must agree with an f32
   CPU run of its first 8 layers on a small input. The long query's overflow
   scatter, run twice with ``use_pallas`` off, must go through K5 and give
   the same bits;
4. K1 and K5 against their plain versions at the pipeline's own shapes,
   with K1's TFLOP/s and K5's GB/s, each one's share of its bound and its
   factor against SDPA or ``index_add_`` timed in the same run;
5. the on-device answer generator: Qwen2-7B-Instruct at full width and
   depth (random bf16 weights from a seeded ``torch.Generator``, quantized by
   the port into the ``local_llm_quant: int4`` layout, fused), with
   ``max_new_tokens`` 128, ``spec_tokens`` 7 and ``max_batch`` 4, answers
   phase 3's three queries through the same pipeline, its LLM the shared
   ``BatchingLocalLLM``. Kernel launch counts are reset just before the three
   runs and read just after; K2 and K3 must run on every answer. Then the
   three prompts in one batched dispatch, whose tokens must equal plain
   greedy decoding's on every active row (and so must those of the verify
   path with blocks of one token), a 2-layer cut of the same tree on the card
   against the CPU in f32, and the peak device memory;
6. the Gemma2 cost-wise reranker (bge-reranker-v2.5-gemma2-lightweight at
   its Gemma2-9B body's full width and depth: 42 layers, hidden 3584, 16x256
   heads on 8, softcap 50, vocab 256,000; random bf16 weights from a seeded
   ``torch.Generator``, heads 8..42): K4 (``flash_softcap_attention``)
   against its plain version at the reranker's shapes (B=32, S=1152 and
   S=640, B=4, S=136 ragged, right padded; compiled ``flex_attention`` timed
   at both B=32 shapes); then phase 3's three queries
   through ``EasyRAGPipeline.run`` with this reranker behind ``LLMRerank``
   (cutoff 28, compression at layer 24 by 2, 32-pair batches). Kernel launch
   counts are reset just before the three runs and read just after; K4 must
   run 28 times per 32-pair batch. Then a 2-layer cut (compression at 1,
   cutoff 2) on the card against the CPU in f32 on eight pairs drawn from the
   seed, each score within a tenth of the score's scale, and the peak
   device memory;
7. the dense route: ``DenseIndex`` at 20,000 x 3584 in bf16 and int8, 32
   queries' top-288 against the float64 (bf16) or exact integer (int8) host
   ranking, the dir filter and ``query_stream``; then gte-Qwen2-7B-instruct
   at full width and depth (28 layers, hidden 3584, 28 heads on 4, vocab
   151,646; random bf16 weights from a seeded ``torch.Generator``) injected
   into ``EasyRAGPipeline`` with ``retrieval_type: 3``,
   ``rerank_fusion_type: 1`` and phase 3's MiniCPM reranker over the first
   512 files of phase 3's corpus. Launch counts are reset just before the
   boot and read just after the three queries: the boot embeds and indexes
   the files (K3 must run), phase 3's three queries run (K3 and K1 on every
   query). A reboot from the saved index embeds nothing and gives the same
   nodes; a second reboot with ``use_reranker: 0`` runs
   ``run_retrieval_batch`` over 128 queries (embedded at B=128) against
   ``run`` query by query: sparse lists equal bit for bit, dense lists within
   the bf16 embedding's drift between B=128 and B=1, fused rows equal where
   the dense lists are; a 2-layer cut on the card against the CPU in f32
   (relative L2 of each embedding within 5e-2). Then K3 against its plain version at the
   shapes and right padding the boot and the queries gave it (every
   index-build batch, B=128, S=2048, with the plain version over 8-row
   slices; each query at B=1), and at B=32, S=1024, B=8, S=2048 and B=1,
   S=128, ragged; and the peak device memory;
8. the flagship preset: ``EasyRAGPipeline.run`` on
   ``configs/four_tenant.yaml`` over phase 3's corpus, reranking with phase
   3's MiniCPM quantized to w8a8 on the card (``tpu.reranker_quant``: int8
   weights, activations quantized per token, ``torch._int_mm``) behind
   ``LLMRerank`` with the preset's carried two-stage cascade
   (``use_efficient`` 3, keep 32, judge layer 12, ``cascade_carry``), and
   answering with phase 5's int4 generator, which the pipeline wraps in its
   own ``BatchingLocalLLM``. Launch counts are reset just before the three
   queries and read just after: K1, K2 and K3 must run on every query, K5 on
   the long one; each query's retrieval, stage-1 and stage-2 rerank and
   generation times. Then the checks: the carried stage 2 against the
   re-score path on the same survivors (within ``CARRY_TOL`` of the scores'
   scale, the same top 6); w8a8 against the bf16 scorer on one 32-pair batch
   (the last hidden states' cosine above 0.99; the top-6 orders reported);
   a 2-layer w8a8 cut on the card against the CPU in f32 (cosine above
   0.99); ``linear(a8=True)`` on the card equal to the CPU's bit for bit at
   the gate projection. Times: each projection shape as ``F.linear`` in
   bf16 against w8a8's quantization, ``_int_mm`` and rescale; one batch in
   bf16 and in w8a8; the first query's rerank stage at ``use_efficient`` 0, the
   cascade re-scoring and the cascade with the carry, with the device memory
   each adds. Last the yes-logit scorer (``models/yes_logit.py``) on phase
   7's gte-Qwen2-7B-width tree rebuilt from its seed (the head tied to the
   embedding): one 32-pair batch in bf16 and w8a8 (K3 in every layer), and a
   2-layer w8a8 cut against the CPU;
9. batch evaluation: phase 3's MiniCPM saved under Hugging Face names with
   a word tokenizer as ``bge-reranker-v2-minicpm-layerwise``; the CLI
   (``cli.run_batch``, ``--re-only``, ``configs/easyrag.yaml`` over phase 3's
   corpus) over 8 val questions (one filtered, one of 80 terms), the reranker
   loaded by that name through the registry; ``run_retrieval_batch`` with no
   reranker over 512 queries (8 of 80 terms: K5), every row equal to
   ``run``'s (nodes, scores, contexts); ``run_answers_batch`` on the 8
   questions with phase 5's int4 generator (32 new tokens, gen batch 4),
   whose contexts must equal the sequential ``run``'s and the CLI's bit for
   bit; launch counts reset just before each of the three runs and read
   just after, and the qps and wall times;
10. serving: (a) the decode pool (``models/decode_pool.py``) with phase 5's
   generator at the flagship's tiers and chunks (2048:2 and 7680:2, 32
   steps) and 64 new tokens (the served runs take the preset's 128): six
   prompts over both tiers join at chunk
   boundaries, one finding the 2048 tier full and overflowing into the 7680
   tier; every row's tokens must equal its solo ``generate_greedy`` at B=1,
   plain and with spec 7 (on a difference, the first op that differs when
   the step is replayed is printed); (b) ``configs/four_tenant.yaml`` with
   ``tpu.local_llm_continuous`` booted into ``EasyRAGPipeline`` (phase 3's
   MiniCPM quantized to w8a8, phase 5's generator behind the decode pool)
   and served by ``serving.api.create_app`` (the rerank coalescer, the
   kernel build, the pool's boot warmup) on 127.0.0.1 at an ephemeral port:
   ``GET /test``, ``GET /ui``, a CORS preflight, then 8 ``POST /v1/rag``
   at concurrency 4 after one warm request (``tools/bench_serving.py``'s
   pattern); each response's contexts must equal ``run``'s for its query
   without the server and each answer the solo greedy answer at B=1, a
   coalesced rerank batch must hold pairs of more than one request, a
   request must join a live pool, and K1, K2 and K3 must launch (counts
   reset after the warm request, read after the 12); (c) the same requests
   with ``BatchingLocalLLM``, for comparison. Latency p50/p99, wall,
   requests/s, generated tokens/s, the pool's chunks, live rows and ms a
   step with its host sync, the coalesced batch sizes, each beside the
   card's ``nvidia-smi`` line;
11. the pipeline's non-default options: the native index builder against
   the Python builder on phase 3's content view (the same arrays, both
   timed); (a) ``ResidentSparseIndex`` over phase 3's content index in f32,
   bf16 and int8 at the default budget (the reference's caps) and in f32
   with ``tail="pallas"`` (K5 at its second call site), phase 9's stream
   (its queries within the 64-term budget) through each: the heavy matrix's
   device bytes, ms and qps, K5's launches (one a batch with the tail, none
   without), every 41st stream row equal to its query alone bit for bit,
   the K5 tail's scores within rtol 1e-6 of the scatter tail's; the int8
   heavy part on the card equal to the CPU's bit for bit (the gather at 64
   rows, the s8 product at 4 rows padded to 17) and the int8 top-192 ids
   equal to a CPU run's on all the stream's queries; K5 against its plain
   version at the tail's shape (the first batch's light postings), with
   ``index_add_`` and the bound; (b) ``EasyRAGPipeline`` on
   ``configs/easyrag.yaml`` over phase 3's corpus with ``split_type`` 1,
   ``hyde`` and ``hyde_merging``, ``compress_method: bm25_extract``, an
   ``index_artifact_path`` under a temporary directory and
   ``tpu.sparse_heavy_dtype: int8``, both indexes from the native builder,
   phase 3's MiniCPM reranking and phase 5's int4 generator writing the
   HyDE documents and the answers (32 new tokens); two queries (phase 3's
   short one, and its long one with the dir filter, past the term budget:
   K5's overflow path), each split by its timing events (HyDE, retrieval,
   the HyDE merge, rerank, generation), K1, K2, K3 and K6 launched on each;
   then a reboot from the artifact (no ingestion, no index build) whose
   contexts and answers must equal the cold boot's;
12. sharded retrieval on one card (``easyrag_tpu_torch/parallel``): (a) phase
   3's content index as ``ShardedResidentSparseIndex`` at D = 4 and D = 3 on
   ``["cuda:0"] * D`` in f32, bf16 and int8, rows and CSR, each at the cap
   and layout of the single-chip index it is held to: phase 9's stream
   (the queries within the term budget) and phase 3's queries alone, top-192
   equal to the single-chip index's bit for bit, K6 launched once a batch on
   every shard (counted from 0 just before the stream), each shard's device
   bytes and the stream's ms beside the single-chip index's (shards on one
   card: not a scaling figure); (b) phase 7's seeded 20,000 x 3584 index as
   ``ShardedDenseIndex`` at D = 4 in bf16 and int8, a 64-query top-288
   stream against ``DenseIndex``'s (int8 bit for bit; bf16 ids equal where
   the scores are distinct, scores within rtol 1e-5); (c)
   ``EasyRAGPipeline`` on ``configs/easyrag.yaml`` with ``tpu.shard_index``
   and an injected 4-shard mesh on the card, phase 3's reranker: phase 3's
   three queries, contexts equal to phase 3's pipeline's, K6 on the shards,
   K5 on the 80-term query (launches counted from 0 just before each query);
   (d) two gloo processes on the card's host (``parallel/multihost.py``)
   each parse their share of 512 of phase 3's files, save it, all-gather
   a per-chunk vector and the result is assembled: nodes, vectors and BM25
   index equal to a one-process build.

Every kernel's entry in the JSON line carries its bound at the timed shape
(the larger of its operations over the card's peak for their type and its
bytes, each input read once and each output written once, over 3.35 TB/s)
and, where one PyTorch call computes the same function, that call's time
(``scaled_dot_product_attention`` for K1 and K3, ``index_add_`` for K5,
``flex_attention`` compiled with the softcap as its ``score_mod`` for K4,
``torch.ops.aten._weight_int4pack_mm`` for K2, on weights repacked into its
layout with the per-channel scale as every group's bf16 scale, ``amax`` for
K6).

Prints its total seconds, one JSON line of kernel results (K1's and K5's
times at the pipeline's shapes, K2's gateup's at R=1, K3's at both call
sites: the prefill's at B=1, S=7680 and the embedder's at the boot's first
index-build batch, K4's at B=32, S=1152, K6's at B=64, N=20000, and K5's
second entry at the resident tail's shape; launches from phases 3, 5, 6, 7
and 9, each kernel's own main path, and the K5 tail's from phase 11's
stream; phase 10's served requests print their own), the ``nvidia-smi``
line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_DOCS = 20_000
VOCAB = 40_000
SEED = 0
MAX_LENGTH = 1024
# K1 vs plain, per 64-wide head row: |kernel - plain| <= K1_ROW_RTOL * max|plain row|,
# two bf16 roundings of the row's largest value (see tests/test_torch_flash64.py)
K1_ROW_RTOL = 1.6e-2
K5_RTOL = 1e-6
RERANK_REL_TOL = 5e-2  # bf16 card vs f32 CPU, 8 layers, relative L2 of the score vector
# Gemma2 reranker, bf16 card vs f32 CPU, 2 layers, per pair:
# |card - cpu| <= GEMMA_PAIR_TOL * the score's scale, ||head|| * rms(1 + final
# norm): the spread of head . norm(x) over hidden states x, which the bf16
# rounding of the pooled hidden projects onto whatever the pair's score.
# Readings on the H100: errors of 0.002-0.091 at a scale of ~2.39 (0.038 of
# it at most)
GEMMA_PAIR_TOL = 0.1
GEMMA_CPU_PAIRS = 8
GEN_REL_TOL = 5e-2  # bf16 card vs f32 CPU, 2 generator layers, relative L2 of the last-position logits
# K3 vs plain, per 128-wide head row: K1's rule (the same rounding of the
# unnormalised probabilities)
K3_ROW_RTOL = 1.6e-2
# K2 vs plain, per output: |k - p| <= K2_RTOL * |p| + K2_ROW_ATOL * max|p row|.
# The kernel and the plain version take f32 sums of the same exact products
# in other orders, then round once to bf16: one bf16 rounding of the output
# (2^-8 of it, doubled for the two roundings of nearly equal sums) plus
# f32-order slack relative to the row's scale.
K2_RTOL = 2.0 ** -7
K2_ROW_ATOL = 1e-4
QWEN2_7B = dict(  # Qwen2-7B-Instruct's config.json
    vocab_size=152_064, hidden_size=3584, intermediate_size=18_944, num_hidden_layers=28,
    num_attention_heads=28, num_key_value_heads=4, rope_theta=1e6, rms_norm_eps=1e-6, attention_bias=True,
)
QWEN2_EOS = [151_643, 151_645]  # <|endoftext|>, <|im_end|> (generation_config.json)
# K2 times cycle through copies of the weights totalling 4x the H100's 50 MB L2
L2_FLUSH_BYTES = 200 << 20
K2_ROWS = (1, 4, 8, 32, 64)
# _weight_int4pack_mm, K2's yardstick: scale groups of 128 columns, 8 inner k tiles
INT4PACK_GROUP, INT4PACK_INNER_K_TILES = 128, 8
K2_SHAPES = {  # [O, I/2] of the int4 matvecs of a Qwen2-7B decode step, fused as the generator runs them
    "qkv": (4608, 1792), "o": (3584, 1792), "gateup": (37_888, 1792), "down": (3584, 9472), "lm_head": (152_064, 1792),
}
GEN_MAX_NEW, GEN_SPEC, GEN_BATCH = 128, 7, 4  # configs/four_tenant.yaml's local_llm_max_new/_spec/_gen_batch
RERANKER = dict(
    vocab_size=122_753, hidden_size=2304, intermediate_size=5760, num_hidden_layers=40,
    num_attention_heads=36, num_key_value_heads=36, scale_emb=12.0, scale_depth=1.4,
    dim_model_base=256.0,
)
# bge-reranker-v2.5-gemma2-lightweight's body: Google's gemma-2-9b config.json
# (tools/bench_gemma9b.py:122-132)
GEMMA2_9B = dict(
    vocab_size=256_000, hidden_size=3584, intermediate_size=14_336, num_hidden_layers=42,
    num_attention_heads=16, num_key_value_heads=8, head_dim=256, rms_norm_eps=1e-6, rope_theta=10000.0,
    gemma=True, attn_logit_softcapping=50.0, query_pre_attn_scalar=256.0,
)
# the reference's operating point: cutoff 28, compression (24, 40) by 2,
# heads from layer 8, 32-pair batches
GEMMA_CUTOFF, GEMMA_COMPRESS, GEMMA_START = 28, (24, 40), 8
# K4 vs plain, per 256-wide head row: K1's rule (the same rounding of the
# unnormalised probabilities)
K4_ROW_RTOL = 1.6e-2
# Alibaba-NLP/gte-Qwen2-7B-instruct's config.json
GTE_QWEN2_7B = dict(
    vocab_size=151_646, hidden_size=3584, intermediate_size=18_944, num_hidden_layers=28,
    num_attention_heads=28, num_key_value_heads=4, rope_theta=1e6, rms_norm_eps=1e-6, attention_bias=True,
)
DENSE_DOCS = 512  # files of phase 3's corpus the dense pipeline embeds (all 20,000 take ~8-9 min)
INDEX_ROWS = 20_000  # configs/four_tenant.yaml:16, "dense cosine 20k x 3584 bf16"
INDEX_QUERIES = 32
# the index's device top-k against the float64 host ranking: scores at each
# rank within this of the host's (f32 sums of 3584 exact products), so ids
# may differ only among docs this close
DENSE_TIE_ATOL = 1e-5
EMB_REL_TOL = GEN_REL_TOL  # bf16 card vs f32 CPU, 2 embedder layers, relative L2 of each embedding
# the carried cascade's stage 2 against the re-score path, per survivor:
# |carry - rescore| <= CARRY_TOL * the survivors' largest |score|. Both run
# the same bf16 layers 12-28 on the same rows; the carried rows sit in a
# batch of another width and (left padding) at other absolute positions,
# which moves a few bf16 roundings of the hidden state
CARRY_TOL = 2e-2
# phase 9: queries of the 512-query retrieval stream, questions of the CLI's
# val split and of the staged answers, and the generator's new tokens there
# (phase 5 runs the flagship's 128; 32 keep the sequential reference short)
STREAM_QUERIES, BATCH_QUESTIONS, BATCH_GEN_NEW = 512, 8, 32
# phase 10: the decode pool's tiers and chunk, six prompt lengths over both
# tiers (2048, 2048 and 512 first: the 512 one finds the 2048 tier full and
# overflows; then 7680, 7680 and 2048 as slots free), and the served
# requests at tools/bench_serving.py's defaults
POOL_TIERS, POOL_CHUNK = "2048:2,7680:2", 32
# (a)'s new tokens, two chunks a row (the served runs keep the preset's 128;
# 64 keeps the smoke inside its time limit)
POOL_MAX_NEW = 64
POOL_PROMPTS = (1800, 1200, 500, 7000, 6000, 1900)
# 8 served requests (tools/bench_serving.py's default is 12): two waves at
# concurrency 4 keep the smoke inside its time limit with phase 12
SERVE_REQUESTS, SERVE_CONCURRENCY = 8, 4
SERVE_TIMEOUT_S = 420  # one served run, (b) or (c), fails past this instead of hanging
# phase 11: HyDE's and the answer's new tokens (phase 5 runs the flagship's 128)
OPT_GEN_NEW = 32
# the H100 SXM's peaks (NVIDIA's data sheet): dense bf16 tensor cores, f32
# outside them, HBM bandwidth
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def run_text(cmd, timeout=120) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise SmokeFailure(f"{cmd[0]} failed: {proc.stderr.strip()[-500:]}")
    return proc.stdout.strip()


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16):
    """``(ms, "bytes" or "operations")``: the least time the card could take
    for ``ops`` operations at ``peak`` and ``nbytes`` at HBM bandwidth."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(np, S: int, start, end) -> int:
    """(query, key) pairs an attention needs: for every real query row ``i``
    of every batch row (``start <= i < end``), the keys ``j <= i`` inside
    ``[start, end)``. Pad rows are read by nothing and count nothing."""
    i = np.arange(S)[None, :]
    lo, hi = np.asarray(start)[:, None], np.asarray(end)[:, None]
    return int(np.where((i >= lo) & (i < hi), i - lo + 1, 0).sum())


def cuda_ms(torch, fn, reps=10, warmup=2) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, n=50) -> float:
    """Milliseconds per call of ``fn``, from CUDA events around the replay
    of a CUDA graph of ``n`` calls: device time without the host's launch
    gaps, which a per-call event pair counts for kernels of a few
    microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


class CharTokenizer:
    """One token per character (no checkpoint vocabulary is in the
    repository); right padding, as the shipped checkpoint declares."""

    bos_token_id = 1
    pad_token_id = 0
    padding_side = "right"

    def __init__(self, vocab: int) -> None:
        self.vocab = vocab

    def __call__(self, text, add_special_tokens=False, max_length=None, truncation=False):
        ids = [ord(ch) % (self.vocab - 2) + 2 for ch in text]
        return {"input_ids": ids[:max_length] if truncation and max_length else ids}


class SparseTokenizer:
    """Splits the synthetic corpus's words and know-path parts (jieba is not
    installed where the card is)."""

    def cut(self, text):
        return re.findall(r"[^\s/#]+", text)


class StubLLM:
    """Instant canned answer in place of the GLM-4 network client."""

    def __init__(self) -> None:
        self.prompts = []

    async def acomplete(self, prompt):
        from easyrag_tpu_torch.generation import CompletionResponse

        self.prompts.append(prompt)
        return CompletionResponse(text="无法确定")


def write_corpus(root: str, rng, np, n_docs: int) -> None:
    """``n_docs`` one-chunk files of ~300 Zipf-distributed words over a 40k
    vocabulary (the shape ``tools/bench_pipeline.py`` uses), in four package
    dirs, with a ``pathmap.json`` of know-paths."""
    zipf = 1.0 / np.arange(1, VOCAB + 1)
    zipf /= zipf.sum()
    lens = np.maximum(30, rng.poisson(300, size=n_docs))
    words = rng.choice(VOCAB, size=int(lens.sum()), p=zipf)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    dirs = ["director", "emsplus", "rcp", "umac"]
    pathmap = {}
    for f in range(n_docs):
        d = dirs[f % 4]
        rel = f"{d}/doc{f}.txt"
        os.makedirs(os.path.join(root, d), exist_ok=True)
        body = " ".join(f"t{t}" for t in words[bounds[f] : bounds[f + 1]])
        with open(os.path.join(root, rel), "w", encoding="utf-8") as fh:
            fh.write(f"文档{f}\n{body}\n")
        pathmap[rel] = ["知识", d, f"doc{f}"]
    with open(os.path.join(root, "pathmap.json"), "w", encoding="utf-8") as fh:
        json.dump(pathmap, fh)


def phase_env(torch):
    say("== phase 0: environment")
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"devices {torch.cuda.device_count()}  device0 {torch.cuda.get_device_name(0)}")
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    say(f"nvidia-smi: {smi}")
    from easyrag_tpu_torch import _build

    say(f"nvcc: {run_text([_build.find_nvcc(), '--version']).splitlines()[-1]}")
    for mod in ("yaml", "jieba", "transformers", "bs4"):
        proc = subprocess.run([sys.executable, "-c", f"import {mod}"], capture_output=True, timeout=300)
        say(f"import {mod}: {'ok' if proc.returncode == 0 else 'missing'}")
    return smi


def phase_build():
    say("== phase 1: kernel build")
    from easyrag_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    say(f"kernel build: {time.perf_counter() - t0:.2f} s ({len(_build.KERNELS)} nvcc processes at once)")
    for name in _build.KERNELS:
        log = _build.build_logs.get(name, "").splitlines()
        usage = [ln.split("info    :")[-1].strip() for ln in log if "registers" in ln or "spill" in ln]
        say(f"{name}: {'; '.join(usage) if usage else 'loaded from the build cache'}")


def k1_case(torch, B, S, H, gen, rope, side, n_real):
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, S, H * 64, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    if side == "left":
        start, end = [S - n for n in n_real], [S] * B
    else:
        start, end = [0] * B, list(n_real)
    kv_s = torch.tensor(start, dtype=torch.int32, device=dev)
    kv_e = torch.tensor(end, dtype=torch.int32, device=dev)
    cos = sin = None
    if rope:
        from easyrag_tpu_torch.models.layers import rope_tables

        cos, sin = rope_tables(S, 64, 10000.0, device=dev)
    return (q, k, v, kv_s, kv_e, 0.125, cos, sin)


def k1_compare(torch, f64, args):
    got = f64.flash64_attention(*args)
    ref = f64.flash64_attention_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), "K1 output has non-finite values")
    q, _, _, kv_s, kv_e = args[:5]
    pos = torch.arange(q.shape[1], device=q.device)
    real = (pos[None, :] >= kv_s[:, None]) & (pos[None, :] < kv_e[:, None])
    # real rows, split into one 64-wide row per head
    g, r = (t.float()[real].reshape(-1, 64) for t in (got, ref))
    diff = (g - r).abs()
    bound = r.abs().amax(dim=1, keepdim=True)
    err = float(diff.max())
    row_rel = float((diff / bound.clamp_min(1e-30)).max())
    check(bool((diff <= K1_ROW_RTOL * bound).all()),
          f"K1 disagrees with its plain version (max abs {err}, {row_rel:.3e} of the row's largest value)")
    return err, row_rel


def k5_case(torch, B, P, N, gen, hard=False):
    """``[B, P]`` postings: ids over ``[0, N]`` (a doc repeats across term
    slices; id N is the sentinel with value 0). With ``hard``, about 2% of the
    ids lie below 0 or above N, and with B > 1 row 0 is all sentinels and the
    last row puts every posting into the first 128-doc tile, as a Zipf head
    would."""
    dev = torch.device("cuda")
    ids = torch.randint(0, N + 1, (B, P), generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
    vals = torch.rand(B, P, generator=gen, device=dev)
    if hard:
        odd = torch.rand(B, P, generator=gen, device=dev)
        ids = torch.where(odd < 0.01, -3, torch.where(odd < 0.02, N + 5, ids)).to(torch.int32)
        if B > 1:
            ids[0] = N
            ids[-1] = torch.randint(0, min(N, 128), (P,), generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
    vals = torch.where(ids == N, 0.0, vals)  # the sentinel carries value 0
    return ids, vals, N


def k5_compare(torch, k5, args, card_plain=True):
    """K5 twice (the same bits), bit for bit against its plain version on the
    CPU, which adds each doc's postings in posting order as the kernel does,
    and (``card_plain``) within ``K5_RTOL`` of its plain version on the card,
    whose ``index_add_`` adds with atomics in another order: at a dozen
    postings a doc that order moves a sum by less than that, not at the
    thousands a doc of the skewed and N = 1 cases. Returns the largest
    difference from the card's plain version."""
    got = k5.bm25_scores(*args)
    again = k5.bm25_scores(*args)
    ref = k5.bm25_scores_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)), "K5 is not deterministic")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if card_plain:
        check(bool(((got - ref).abs() <= K5_RTOL * ref.abs() + 1e-6).all()),
              f"K5 disagrees with its plain version (max abs {err})")
    ids, vals, n = args
    host = k5.bm25_scores_plain(ids.cpu(), vals.cpu(), n)
    check(torch.equal(got.cpu().view(torch.int32), host.view(torch.int32)),
          "K5 differs from the posting-order sums of its plain version on the CPU")
    return err


def k2_case(torch, gen, n_out, half, rows):
    dev = torch.device("cuda")
    w = torch.randint(-128, 128, (n_out, half), generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
    scale = torch.rand(n_out, generator=gen, device=dev) * 2e-3 + 1e-4
    x = torch.randn(rows, 2 * half, generator=gen, device=dev).to(torch.bfloat16)
    return x, w, scale


def k2_compare(torch, k2, x, w, scale):
    got = k2.int4_matvec(x, w, scale)
    ref = k2.int4_matvec_plain(x, w, scale).float()
    torch.cuda.synchronize()
    diff = (got.float() - ref).abs()
    bound = K2_RTOL * ref.abs() + K2_ROW_ATOL * ref.abs().amax(dim=1, keepdim=True)
    ratio = float((diff / bound).max())
    check(bool(torch.isfinite(got.float()).all()) and ratio <= 1.0,
          f"K2 disagrees with its plain version (max abs {float(diff.max())}, {ratio:.3f} of the bound)")
    return got, float(diff.max()), ratio


def k3_case(torch, gen, B, S, lengths, side="left", nh=28, nkv=4, hd=128):
    """K3 inputs, Qwen2-7B-shaped by default (28 query heads of 128 on 4 KV
    heads), each row padded to its own length: on the left as the
    generator's prefill pads, on the right as the gte-Qwen2 embedder pads."""
    dev = torch.device("cuda")
    q = torch.randn(B, S, nh * hd, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, S, nkv * hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    full = torch.full((B,), S, dtype=torch.int32, device=dev)
    kv_s, kv_e = (S - n, full) if side == "left" else (torch.zeros_like(n), n)
    return (q, k, v, kv_s, kv_e, hd ** -0.5, nkv)


def k3_flop(np, args) -> int:
    """Causal QK^T + PV over the (query, key) pairs the key ranges leave, on
    real rows."""
    q, k, _, kv_s, kv_e, _, nkv = args
    return 4 * q.shape[-1] * causal_pairs(np, q.shape[1], kv_s.cpu().numpy(), kv_e.cpu().numpy())


def k3_plain_slices(k3, args, rows):
    """K3's plain version on ``args`` in slices of ``rows`` batch rows (its
    materialised f32 scores of a whole index-build batch would not fit)."""
    q, k, v, kv_s, kv_e, scale, nkv = args
    for lo in range(0, q.shape[0], rows):
        sl = slice(lo, lo + rows)
        yield sl, k3.flash_attention_plain(q[sl], k[sl], v[sl], kv_s[sl], kv_e[sl], scale, nkv)


def k3_compare(torch, k3, args, rows=None):
    """K3 against its plain version on the real rows, per head row (head_dim
    values); the plain version runs over slices of ``rows`` batch rows when
    given. A batch row with no real token must come out zero."""
    got = k3.flash_attention(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), "K3 output has non-finite values (pad rows included)")
    q, k, _, kv_s, kv_e, _, nkv = args
    hd = k.shape[-1] // nkv
    empty = kv_e <= kv_s
    check(bool((got[empty] == 0).all()), "K3: a row with no key is not zero")
    pos = torch.arange(q.shape[1], device=q.device)[None, :]
    real = (pos >= kv_s[:, None]) & (pos < kv_e[:, None])
    err = row_rel = 0.0
    for sl, ref in k3_plain_slices(k3, args, rows or q.shape[0]):
        g, r = (t.float()[real[sl]].reshape(-1, hd) for t in (got[sl], ref))
        diff = (g - r).abs()
        bound = r.abs().amax(dim=1, keepdim=True)
        err, row_rel = max(err, float(diff.max())), max(row_rel, float((diff / bound.clamp_min(1e-30)).max()))
        check(bool((diff <= K3_ROW_RTOL * bound).all()), f"K3 disagrees with its plain version ({row_rel:.3e} of the row)")
        del ref, g, r, diff
    return err, row_rel


def sdpa_ms(torch, q, k, v, nh, nkv, kv_s, kv_e, scale, cos=None, sin=None):
    """Median ms of one ``scaled_dot_product_attention`` call computing what
    K1/K3 compute on these inputs: heads moved to dim 1 (and RoPE applied)
    beforehand, the causal-and-key-range mask as a boolean ``[B, 1, S, S]``,
    ``enable_gqa`` for grouped heads. The port never calls it."""
    from easyrag_tpu_torch.ops.flash64 import apply_rope, key_keep_mask

    B, S, _ = q.shape
    hd = k.shape[-1] // nkv
    qh, kh, vh = (t.reshape(B, S, -1, hd) for t in (q, k, v))
    if cos is not None:
        qh, kh = apply_rope(qh, cos[None], sin[None]), apply_rope(kh, cos[None], sin[None])
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (qh, kh, vh))
    mask = key_keep_mask(kv_s, kv_e, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=scale, enable_gqa=nh != nkv), reps=5)


def cold_weights(w, scale):
    """Calls that cycle through enough copies of ``(w, scale)`` to read
    ``L2_FLUSH_BYTES`` between two uses of one copy: in a decode step every
    layer's weights are distinct and come from HBM, not from a warm L2."""
    copies = [(w.clone(), scale.clone()) for _ in range(-(-L2_FLUSH_BYTES // w.nbytes))]
    return itertools.cycle(copies), len(copies)


def int4pack_library(torch, k2, w, scale):
    """``torch.ops.aten._weight_int4pack_mm``'s operands for ``(w, scale)``
    (``k2.int4pack_operands``, group 128, 8 inner k tiles), made once outside
    any timed loop: ``(packed, scales_and_zeros)``, or the error text where
    the card's torch refuses them. A yardstick only: the port never calls it."""
    try:
        w_u8, sz = k2.int4pack_operands(w, scale, INT4PACK_GROUP)
        return torch.ops.aten._convert_weight_to_int4pack(w_u8, INT4PACK_INNER_K_TILES), sz
    except Exception as e:  # the yardstick may not exist for this card or shape: report it, do not fail
        return str(e).strip().splitlines()[0][:200]


def phase_k2(torch, k2, gen, errs, times, extra):
    """K2 against its plain version at the five shapes and R = 1, 4, 8, 32
    and 64: each within ``K2_RTOL`` / ``K2_ROW_ATOL``, the R=64 launch's
    first rows equal to the smaller launches bit for bit; times, GB/s and
    share of the bound, and ``_weight_int4pack_mm``'s time on the same
    L2-cold weight copies (or the error it gave)."""
    for name, (n_out, half) in K2_SHAPES.items():
        x64, w, scale = k2_case(torch, gen, n_out, half, max(K2_ROWS))
        cold, n_copies = cold_weights(w, scale)
        copies = [next(cold) for _ in range(n_copies)]
        packs = [int4pack_library(torch, k2, *c) for c in copies]
        refused = next((p for p in packs if isinstance(p, str)), None)
        lib_cold = itertools.cycle(packs) if refused is None else None
        by_rows, w_deq = {}, None
        for rows in K2_ROWS:  # decode at B=1 and B=4, verify blocks (spec 7) at B=1 and B=4, the gate's top
            x = x64[:rows].contiguous()
            got, err, ratio = k2_compare(torch, k2, x, w, scale)
            by_rows[rows] = got
            errs["K2"] = max(errs["K2"], err)
            ms = graph_ms(torch, lambda: k2.int4_matvec(x, *next(cold)), n=max(50, n_copies))
            plain = graph_ms(torch, lambda: k2.int4_matvec_plain(x, *next(cold)), n=10)
            b2 = bound(2 * rows * n_out * 2 * half, w.nbytes + scale.nbytes + x.nbytes + rows * n_out * 2)
            lib, lib_text = None, f"_weight_int4pack_mm refused: {refused}"
            if refused is None:
                def lib_call():
                    packed, sz = next(lib_cold)
                    return torch.ops.aten._weight_int4pack_mm(x, packed, INT4PACK_GROUP, sz)

                try:
                    ylib = torch.ops.aten._weight_int4pack_mm(x, packs[0][0], INT4PACK_GROUP, packs[0][1]).float()
                    lib = graph_ms(torch, lib_call, n=max(50, n_copies))
                except Exception as e:  # refused at this R: report it, do not fail
                    lib_text = f"_weight_int4pack_mm refused: {str(e).strip().splitlines()[0][:200]}"
                else:
                    ref = k2.int4_matvec_plain(x, w, scale).float()
                    # K2's bound widened by the bf16 rounding of the scale (2^-8 of each output)
                    wide = (K2_RTOL + 2.0 ** -8) * ref.abs() + K2_ROW_ATOL * ref.abs().amax(dim=1, keepdim=True)
                    lib_ratio = float(((ylib - ref).abs() / wide).max())
                    # the library's own math: each weight dequantized to bf16 (s * bf16(scale), rounded)
                    if w_deq is None:
                        w_deq = (k2.int4pack_dequantize(*k2.int4pack_operands(w, scale, INT4PACK_GROUP))
                                 .to(torch.bfloat16))
                    own = (x.float() @ w_deq.float().t()).to(torch.bfloat16).float()
                    own_bound = K2_RTOL * own.abs() + K2_ROW_ATOL * own.abs().amax(dim=1, keepdim=True)
                    own_ratio = float(((ylib - own).abs() / own_bound).max())
                    rel_l2 = float((ylib - ref).norm() / ref.norm())
                    lib_text = (f"_weight_int4pack_mm {lib:.4f} ms ({lib_ratio:.3f} of the widened bound: "
                                f"{'agrees' if lib_ratio <= 1.0 else 'disagrees'}; relative L2 {rel_l2:.2e}; "
                                f"{own_ratio:.3f} of K2's bound around its own bf16-rounded weights)")
                    del ref, own
            times[(name, rows)] = (ms, plain)
            if (name, rows) == ("gateup", 1):  # the reported shape
                extra["K2"] = (*b2, lib)
            gbs = n_out * half / ms / 1e6
            say(f"K2 {name} [{n_out}, {half}] R={rows}: max_abs_err {err:.3e} ({ratio:.3f} of the bound); "
                f"kernel {ms:.4f} ms ({gbs:.0f} GB/s of packed weights, {b2[0] / ms:.1%} of the bound "
                f"{b2[0]:.4f} ms), plain {plain:.4f} ms, {lib_text}")
        same = all(torch.equal(by_rows[32][:r], by_rows[r]) for r in (1, 4, 8))
        check(same, f"K2 {name}: rows of the R=32 launch differ from the R=1, 4 and 8 launches")
        check(torch.equal(by_rows[64][:32], by_rows[32]), f"K2 {name}: rows of the R=64 launch differ from the R=32 launch")
        say(f"K2 {name}: the first rows of the R=32 launch equal the R=1, 4 and 8 launches bit for bit, "
            f"and the R=64 launch's the R=32 launch's")
        del copies, packs, lib_cold, cold, x64, w, scale, w_deq
        torch.cuda.empty_cache()


def phase_new_kernels(torch, np, k2, k3):
    """K2 and K3 against their plain versions at the generator's shapes;
    K2's bound and library time at gateup R=1 and K3's bound and SDPA time
    at B=1, S=7680."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs, times, extra = {"K2": 0.0, "K3": 0.0}, {}, {}
    phase_k2(torch, k2, gen, errs, times, extra)
    # the prefill's shape and a left-padded batch at head_dim 128 (the main
    # path), then head_dim 64 with grouped KV heads (28 on 4), 192 (16 on 4),
    # 256 (16 on 8), 320 (8 on 2: V's columns in two groups), 576 (4 on 2)
    # and 1024 (4 on 1), both padding sides, ragged rows and an empty one
    ragged = [2048, 1500, 700, 40]
    cases = [(1, 7680, [7680], "left", 28, 4, 128), (4, 2048, ragged, "left", 28, 4, 128)]
    for side in ("left", "right"):
        cases += [(4, 2048, ragged, side, 28, 4, 64), (4, 2048, ragged, side, 16, 4, 192),
                  (4, 2048, ragged, side, 16, 8, 256), (4, 2048, ragged, side, 8, 2, 320),
                  (4, 200, [200, 130, 1, 0], side, 28, 4, 64), (4, 200, [200, 130, 1, 0], side, 16, 8, 256),
                  (4, 200, [200, 130, 1, 0], side, 8, 2, 320),
                  # past 512: Q and K stream through shared memory in 64-dim panels
                  (4, 520, [520, 300, 1, 0], side, 4, 2, 576), (4, 520, [520, 257, 1, 0], side, 4, 1, 1024)]
    for B, S, lengths, side, nh, nkv, hd in cases:
        args = k3_case(torch, gen, B, S, lengths, side, nh, nkv, hd)
        err, row_rel = k3_compare(torch, k3, args)
        errs["K3"] = max(errs["K3"], err)
        ms = cuda_ms(torch, lambda: k3.flash_attention(*args), reps=5)
        plain = cuda_ms(torch, lambda: k3.flash_attention_plain(*args), reps=3, warmup=1)
        times[("K3", B, S, side, hd)] = (ms, plain)
        q, k, v, kv_s, kv_e, scale, nkv = args
        flop = k3_flop(np, args)
        lib = sdpa_ms(torch, q, k, v, nh, nkv, kv_s, kv_e, scale)
        b3 = bound(flop, 2 * q.nbytes + k.nbytes + v.nbytes)
        if B == 1:
            extra["K3"] = (*b3, lib)
        say(f"K3 B={B} S={S} {nh}x{hd} on {nkv} pad={side} lengths {lengths}: max_abs_err {err:.3e} (row-relative "
            f"{row_rel:.3e}), all finite; kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s, {b3[0] / ms:.1%} of the "
            f"bound), plain {plain:.3f} ms, SDPA {lib:.3f} ms (kernel {lib / ms:.2f}x as fast)")
        del args, q, k, v
    return errs, times, extra


def phase_kernels(torch, f64, k5):
    say("== phase 2: kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"K1": 0.0, "K5": 0.0}
    B, S, H = 4, 1064, 36
    for rope in (False, True):
        for side in ("left", "right"):
            args = k1_case(torch, B, S, H, gen, rope, side, [1064, 1000, 700, 40])
            err, row_rel = k1_compare(torch, f64, args)
            errs["K1"] = max(errs["K1"], err)
            ms = cuda_ms(torch, lambda: f64.flash64_attention(*args))
            plain = cuda_ms(torch, lambda: f64.flash64_attention_plain(*args), reps=5)
            say(f"K1 B={B} S={S} H={H} rope={rope} pad={side}: max_abs_err {err:.3e} "
                f"(row-relative {row_rel:.3e}) finite; kernel {ms:.3f} ms, plain {plain:.3f} ms")
    # ragged last q and k tiles; rows of full length, 40, 1 and none (the
    # empty row visits no key tile and writes zeros)
    for S in (1064, 8):
        for rope in (False, True):
            for side in ("left", "right"):
                args = k1_case(torch, 4, S, 8, gen, rope, side, [S, min(40, S), 1, 0])
                err, row_rel = k1_compare(torch, f64, args)
                errs["K1"] = max(errs["K1"], err)
                check(bool((f64.flash64_attention(*args)[3] == 0).all()), "K1: the empty row is not zero")
        say(f"K1 B=4 S={S} H=8, lengths {S}, {min(40, S)}, 1 and 0, RoPE on and off, both paddings: max_abs_err "
            f"{errs['K1']:.3e} so far, every real row within {K1_ROW_RTOL} of its largest value, the empty row zero")
    for B in (1, 4):
        args = k5_case(torch, B, 32768, N_DOCS, gen)
        err = k5_compare(torch, k5, args)
        errs["K5"] = max(errs["K5"], err)
        ms = cuda_ms(torch, lambda: k5.bm25_scores(*args))
        plain = cuda_ms(torch, lambda: k5.bm25_scores_plain(*args))
        say(f"K5 B={B} P=32768 N={N_DOCS}: max_abs_err {err:.3e}; kernel {ms:.3f} ms, plain {plain:.3f} ms")
    # P not a multiple of the 512-posting sub-chunk (1000), empty rows, N
    # not a multiple of the 128-doc tile and N = 1, all-sentinel and skewed rows
    for N in (N_DOCS, 1):
        for B in (1, 3):
            for P in (0, 1000, 32768, 262144):
                k5_compare(torch, k5, k5_case(torch, B, P, N, gen, hard=True), card_plain=False)
    say(f"K5 at P 0, 1000, 32768 and 262144, B 1 and 3, N {N_DOCS} and 1 (duplicates, ids out of range, "
        f"all-sentinel and skewed rows): the same bits twice, equal to the posting-order sums bit for bit")
    return errs


def k6_case(torch, gen, B, N):
    """``[B, N]`` scores built to break a chunk max or a top-k's tie order:
    few distinct values (ties inside and across chunks), a row all ``-inf``
    (a filter that matches nothing), a row all equal, ``-inf`` every 3rd."""
    x = torch.randint(0, 5, (B, N), generator=gen, device="cuda").float()
    x[0] = float("-inf")
    if B > 1:
        x[1] = 2.0
        x[-1, ::3] = float("-inf")
    return x


def phase_chunkmax(torch, k6):
    """K6 (``chunk_max``) against its plain version bit for bit at the path's
    shapes: one query (B=1), a stream batch (B=64), a ragged tail (B=67)
    and the TPU probe's shape; device times per call from CUDA graphs that
    cycle through copies of the input totalling 4x the L2 (every call reads
    HBM), with ``amax`` over contiguous 8, the library call, timed the same
    way. Returns the times per shape (the error is 0: the check is bit for
    bit)."""
    say("== phase 2 (K6): chunk_max vs its plain version")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    times = {}
    for B, N in ((1, 20_000), (64, 20_000), (67, 20_000), (256, 20_480)):
        x = k6_case(torch, gen, B, N)
        got, ref = k6.chunk_max(x), k6.chunk_max_plain(x)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K6 disagrees with its plain version at [{B}, {N}]")
        # the same top-k as the whole row stable-sorted, through K6
        from easyrag_tpu_torch.ops import topk

        for k in (6, 192, 288):
            v, i = topk.topk_desc_reference_order(x, k)
            sv, si = topk._sorted_topk(x, k)
            check(torch.equal(i, si) and torch.equal(v, sv), f"the pruned top-{k} differs from the sort at [{B}, {N}]")
        copies = [x] + [x.clone() for _ in range(max(1, -(-L2_FLUSH_BYTES // x.nbytes)) - 1)]
        n = max(50, len(copies))
        cold = itertools.cycle(copies)
        ms = graph_ms(torch, lambda: k6.chunk_max(next(cold)), n=n)
        plain = graph_ms(torch, lambda: k6.chunk_max_plain(next(cold)), n=n)
        lib = graph_ms(torch, lambda: next(cold).view(B, N // 8, 8).amax(-1), n=n)
        hot = graph_ms(torch, lambda: k6.chunk_max(x))
        nbytes = x.nbytes + x.nbytes // 8
        b6 = bound(B * N, nbytes, PEAK_F32)  # one f32 max per element
        times[(B, N)] = (ms, plain, *b6, lib)
        say(f"K6 [{B}, {N}] (-inf row, tied chunks): equal to the plain version bit for bit, the pruned top-6/192/288 "
            f"equal to the sort; kernel {ms * 1e3:.2f} us from HBM ({nbytes / ms / 1e6:.1f} GB/s, {b6[0] / ms:.1%} "
            f"of the bound), {hot * 1e3:.2f} us from L2; plain {plain * 1e3:.2f} us, amax {lib * 1e3:.2f} us "
            f"(kernel {lib / ms:.2f}x as fast); bound {b6[0] * 1e3:.3f} us ({b6[1]})")
        del copies
    return times


def host_route_check(np, pipeline, query, dir_name, k):
    """The content route's device top-k against the float64 host ranking:
    the true score at every rank must equal the host's sorted score at that
    rank (rel 1e-5), so indices may differ only among tied scores."""
    from easyrag_tpu_torch.schema import QueryBundle

    sr = pipeline.sparse_retriever
    pipeline.filter_dict = sr.filter_dict = {"dir": dir_name} if dir_name else None
    bundle = QueryBundle(query_str=query)
    routes = pipeline._dual_retrieve(bundle)
    dev_nodes = routes[0] if routes is not None else sr.retrieve(bundle)
    idx = sr.index
    s64 = idx.get_scores_host(sr._tokenize_query(query))
    if dir_name:
        s64 = np.where(idx.dir_ids == idx.dir_vocab[dir_name], s64, 0.0)
    order = s64.argsort(kind="stable")[::-1]
    order = order[s64[order] > 0][:k]
    dev_idx = np.array([n.node.idx for n in dev_nodes])
    dev_score = np.array([n.score for n in dev_nodes])
    check(len(dev_idx) == len(order), f"content route returned {len(dev_idx)} nodes, host {len(order)}")
    check(len(set(dev_idx.tolist())) == len(dev_idx), "content route returned a node twice")
    check(bool(np.allclose(s64[dev_idx], s64[order], rtol=1e-5, atol=0)), "content route ranking differs from the host's")
    check(bool(np.allclose(dev_score, s64[dev_idx], rtol=1e-5, atol=0)), "content route scores differ from the host's")
    return len(order), int((dev_idx != order).sum())


def make_queries(np, rng, pipeline):
    """Short (12 words of one node + its doc name), dir-filtered, and long
    (80 distinct words: past the resident path's 64-term budget)."""
    head = {f"t{t}" for t in range(32)}  # the Zipf head, as stopwords would remove it
    tok = pipeline.sparse_tk

    def words(i):
        return [w for w in tok.cut(pipeline.nodes[i].text) if w.startswith("t") and w not in head]

    n = len(pipeline.nodes)
    a, b = (int(x) for x in rng.integers(0, n, size=2))
    short = " ".join(rng.choice(words(a), size=12, replace=False).tolist() + [f"doc{a}"])
    filtered = " ".join(rng.choice(words(b), size=12, replace=False).tolist())
    pool = []
    for i in rng.integers(0, n, size=8):
        pool += [w for w in words(int(i)) if w not in pool]
    long = " ".join(pool[:80])
    dir_b = pipeline.nodes[b].metadata["dir"]
    return [
        ("short", {"query": short}, None),
        ("dir filter", {"query": filtered, "document": dir_b}, dir_b),
        ("long", {"query": long}, None),
    ]


def phase_pipeline(torch, np, f64, k5, k6, tmp):
    say("== phase 3: EasyRAGPipeline.run, default config, 20k chunks, full-width reranker")
    from easyrag_tpu_torch.config import load_config
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.models.layers import DecoderConfig
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline
    from easyrag_tpu_torch.rerankers import LLMRerank
    from easyrag_tpu_torch.schema import QueryBundle
    from easyrag_tpu_torch.utils import events

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    write_corpus(tmp, rng, np, N_DOCS)
    say(f"corpus written: {N_DOCS} files in {time.perf_counter() - t0:.1f} s")

    cfg = load_config(os.path.join(REPO, "configs", "easyrag.yaml"), overrides={"data_path": tmp})
    rr_cfg = DecoderConfig(**RERANKER)
    t0 = time.perf_counter()
    scorer = MiniCPMLayerWiseReranker(
        rr_cfg, CharTokenizer(rr_cfg.vocab_size), start_layer=8, cutoff_layer=28, max_length=MAX_LENGTH,
        use_efficient=cfg.r_use_efficient, device=dev, dtype=torch.bfloat16,
    ).init_random_(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    say(f"reranker: {sum(p.numel() for p in scorer.parameters()) / 1e9:.3f} B parameters on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    reranker = LLMRerank(scorer, top_n=cfg.r_topk, embed_bs=cfg.r_embed_bs, embed_type=cfg.r_embed_type,
                         use_efficient=cfg.r_use_efficient)
    llm = StubLLM()
    t0 = time.perf_counter()
    pipeline = EasyRAGPipeline(
        cfg, llm=llm, reranker=reranker, sparse_tokenizer=SparseTokenizer(),
        # the splitter's default counter wants a tiktoken table, which is not
        # in the repository: count offline, one chunk per one-part file
        splitter=SentenceSplitter(cfg.chunk_size, cfg.chunk_overlap, token_counter=approx_token_count,
                                  sentence_splitter=lambda t: [t]),
        device=dev,
    )
    torch.cuda.synchronize()
    check(len(pipeline.nodes) == N_DOCS, f"expected {N_DOCS} chunks, got {len(pipeline.nodes)}")
    res = pipeline.sparse_retriever._resident
    say(f"pipeline boot: {len(pipeline.nodes)} chunks in {time.perf_counter() - t0:.1f} s; content index "
        f"heavy {tuple(res.heavy.shape)} light_cap {res.light_cap} layout {res.light_layout}")

    queries = make_queries(np, rng, pipeline)
    asyncio.run(pipeline.run(dict(queries[0][1])))  # warm-up, not counted
    torch.cuda.synchronize()

    candidates, stages, batches = [], [], []

    def listen(kind, payload):
        if kind == "reranking" and "candidates" in payload:
            candidates.append(payload["candidates"])
        elif kind == "reranking" and "batch" in payload:
            batches[-1].append(payload["pairs"])
        elif kind == "timing":
            stages.append((payload["name"], payload["seconds"] * 1e3))

    unsubscribe = events.on(listen)
    results = []
    f64.launches = 0
    k5.launches = 0
    k6.launches = 0
    for name, q, _ in queries:
        batches.append([])
        k1_0, k5_0, k6_0 = f64.launches, k5.launches, k6.launches
        t = time.perf_counter()
        out = asyncio.run(pipeline.run(dict(q)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        results.append((name, q, out, ms, f64.launches - k1_0, k5.launches - k5_0, k6.launches - k6_0, dict(stages)))
        stages.clear()
    launches = {"K1": f64.launches, "K5": k5.launches, "K6": k6.launches}
    unsubscribe()

    for (name, q, out, ms, dk1, dk5, dk6, st), n_cand, sizes in zip(results, candidates, batches, strict=True):
        n_terms = len(set(pipeline.sparse_retriever._tokenize_query(q["query"])))
        split = ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        say(f"query {name!r} ({n_terms} distinct terms): {ms:.1f} ms ({split}); {n_cand} candidates in "
            f"{len(sizes)} rerank batches {sizes}, {st['rerank'] / len(sizes):.1f} ms per batch; "
            f"top-6 {[n.node.idx for n in out['nodes']]}; K1 launches {dk1}, K5 launches {dk5}, K6 launches {dk6}")
        check(dk1 > 0, f"K1 did not run on query {name!r}")
        # the content top-192 and the path top-6 over 20,000 take the pruned top-k
        check(dk6 >= 2, f"K6 did not run in both top-ks of query {name!r}")
        check(len(out["nodes"]) == cfg.r_topk and len(out["contexts"]) == cfg.r_topk, f"query {name!r}: wrong result size")
        check(all(np.isfinite(n.score) for n in out["nodes"]), f"query {name!r}: non-finite rerank score")
        check(out["answer"] == "无法确定", f"query {name!r}: unexpected answer")
    check(results[2][5] > 0, "K5 did not run on the long query")
    check(results[0][5] == 0 and results[1][5] == 0, "K5 ran on a query the resident path should take")

    for name, q, dir_name in queries:
        n, ties = host_route_check(np, pipeline, q["query"], dir_name, cfg.f_topk_2)
        say(f"content route vs float64 host, query {name!r}: top-{n} equal ({ties} positions differ by a tie)")

    # the reranker against an f32 CPU copy of its first 8 layers, small input
    pairs = [(queries[0][1]["query"], pipeline.nodes[0].text[:120]), ("文档 t1 t2", pipeline.nodes[1].text[:60])]
    # 8 layers, with scale_depth rescaled so the residual scale
    # scale_depth / sqrt(num_layers) stays the 40-layer model's
    small = dataclasses.replace(
        rr_cfg, num_hidden_layers=8, scale_depth=rr_cfg.scale_depth * (8 / rr_cfg.num_hidden_layers) ** 0.5
    )
    cpu = MiniCPMLayerWiseReranker(small, scorer.tokenizer, start_layer=8, cutoff_layer=8, max_length=MAX_LENGTH,
                                   device="cpu", dtype=torch.float32)
    state = {k: v for k, v in scorer.state_dict().items() if not k.startswith("layers.") or int(k.split(".")[1]) < 8}
    state["heads"] = scorer.heads[:9]
    cpu.load_state_dict({k: v.float().cpu() for k, v in state.items()})
    scorer.cutoff_layer = 8
    card_scores, _ = scorer.score_pairs(pairs)
    scorer.cutoff_layer = 28
    cpu_scores, _ = cpu.score_pairs(pairs)
    rel = float(np.linalg.norm(card_scores - cpu_scores) / np.linalg.norm(cpu_scores))
    say(f"reranker at cutoff 8, card bf16 vs CPU f32: {card_scores.tolist()} vs {cpu_scores.tolist()} (rel {rel:.3e})")
    check(np.isfinite(card_scores).all() and rel <= RERANK_REL_TOL, "reranker disagrees with the CPU reference")

    # the overflow scatter with use_pallas off: K5 on CUDA, the same bits twice
    sr = pipeline.sparse_retriever
    long_tokens = sr._tokenize_query(queries[2][1]["query"])
    sr.use_pallas = False
    k5_0 = k5.launches
    (v1, i1), (v2, i2) = sr._device_topk(long_tokens, -1), sr._device_topk(long_tokens, -1)
    sr.use_pallas = cfg.tpu.use_pallas
    check(k5.launches - k5_0 == 2, "the use_pallas=False overflow scatter did not launch K5")
    check(np.array_equal(v1.view(np.uint32), v2.view(np.uint32)) and np.array_equal(i1, i2),
          "the use_pallas=False overflow scatter differs between two runs")
    say(f"long query, use_pallas off: K5 launched twice, top-{int(np.isfinite(v1).sum())} identical bits in both runs")

    # shapes of the main path, for phase 4
    cand = pipeline.sparse_retriever.retrieve(QueryBundle(query_str=queries[0][1]["query"]))[:32]
    batch = [(queries[0][1]["query"], n.node.text) for n in cand]
    ids, mask = scorer.build_inputs(batch)
    idx = pipeline.sparse_retriever.index
    long_ids, _ = idx.gather_postings(idx.query_term_ids(long_tokens), pad_to=cfg.tpu.max_query_postings, bucket=True)
    return pipeline, reranker, queries, launches, mask, len(long_ids), [r[2]["contexts"] for r in results]


def phase_main_shapes(torch, np, f64, k5, mask, P):
    """K1 and K5 against their plain versions at the pipeline's shapes, with
    their bounds and the time of one PyTorch call computing the same."""
    say("== phase 4: kernels vs plain versions at the pipeline's shapes")
    from easyrag_tpu_torch.models.minicpm import key_ranges

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, S = mask.shape
    start, end = key_ranges(mask)
    args = k1_case(torch, B, S, 36, gen, True, "right", (end - start).tolist())
    err, row_rel = k1_compare(torch, f64, args)
    ms = cuda_ms(torch, lambda: f64.flash64_attention(*args))
    plain = cuda_ms(torch, lambda: f64.flash64_attention_plain(*args), reps=3, warmup=1)
    q, k, v, kv_s, kv_e, scale, cos, sin = args
    lib = sdpa_ms(torch, q, k, v, 36, 36, kv_s, kv_e, scale, cos, sin)
    flop = 4 * 36 * 64 * causal_pairs(np, S, start, end)
    b1 = bound(flop, 4 * q.nbytes + cos.nbytes + sin.nbytes)
    say(f"K1 B={B} S={S} H=36 rope pad=right: max_abs_err {err:.3e} (row-relative {row_rel:.3e}); "
        f"kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s on real rows, {b1[0] / ms:.1%} of the bound), "
        f"plain {plain:.3f} ms, SDPA {lib:.3f} ms (kernel {lib / ms:.2f}x as fast); bound {b1[0]:.4f} ms ({b1[1]})")
    timings = {"K1": (ms, plain, err, *b1, lib)}
    args5 = k5_case(torch, 1, P, N_DOCS, gen)
    err5 = k5_compare(torch, k5, args5)
    ms5 = cuda_ms(torch, lambda: k5.bm25_scores(*args5))
    plain5 = cuda_ms(torch, lambda: k5.bm25_scores_plain(*args5))
    ids, vals, _ = args5
    flat_ids, flat_vals = ids.reshape(-1).long(), vals.reshape(-1)
    acc = torch.zeros(N_DOCS + 1, device=ids.device)  # the sentinel id N lands in the extra slot
    lib5 = cuda_ms(torch, lambda: acc.index_add_(0, flat_ids, flat_vals))
    nbytes = ids.nbytes + vals.nbytes + N_DOCS * 4
    b5 = bound(P, nbytes, PEAK_F32)  # one f32 add per posting
    say(f"K5 B=1 P={P} N={N_DOCS}: max_abs_err {err5:.3e}; kernel {ms5:.4f} ms ({nbytes / ms5 / 1e6:.1f} GB/s of "
        f"postings and scores, {b5[0] / ms5:.1%} of the bound), plain {plain5:.4f} ms, index_add_ {lib5:.4f} ms "
        f"(kernel {lib5 / ms5:.2f}x as fast); bound {b5[0]:.5f} ms ({b5[1]})")
    timings["K5"] = (ms5, plain5, err5, *b5, lib5)
    return timings


class QwenCharTokenizer:
    """One token per character (no checkpoint vocabulary is in the
    repository) on ids below Qwen2's special tokens, and Qwen2's chat
    template with its ``<|im_start|>``/``<|im_end|>`` ids. Decoding maps each
    id to one character, so decoded texts compare token by token."""

    N_PLAIN = 151_643  # the first special id, <|endoftext|>
    IM_START, IM_END = 151_644, 151_645
    pad_token_id = 151_643

    def _ids(self, text):
        return [ord(c) % self.N_PLAIN for c in text]

    def apply_chat_template(self, messages, add_generation_prompt=True):
        ids = []
        for m in messages:
            ids += [self.IM_START] + self._ids(f"{m['role']}\n{m['content']}") + [self.IM_END] + self._ids("\n")
        if add_generation_prompt:
            ids += [self.IM_START] + self._ids("assistant\n")
        return ids

    def decode(self, toks, skip_special_tokens=True):
        # ids at and past the surrogate block shift past it: every id stays one character
        return "".join(chr(t if t < 0xD800 else t + 0x800) for t in toks
                       if not (skip_special_tokens and t >= self.N_PLAIN))


class RecordingModel:
    """Passes ``generate_batch`` through to the generator and keeps the prompts."""

    def __init__(self, model) -> None:
        self.model = model
        self.prompts = []

    def generate_batch(self, prompts):
        self.prompts += list(prompts)
        return self.model.generate_batch(prompts)


def build_generator(torch, seed):
    """Qwen2-7B-Instruct at full width and depth on the card: random bf16
    weights (std 0.02, norms 1) from a seeded generator, quantized layer by
    layer into the ``local_llm_quant: int4`` layout (int4 projections and
    head, int8 embedding table, QKV biases in bf16), then fused."""
    from easyrag_tpu_torch.models.layers import DecoderConfig
    from easyrag_tpu_torch.models.quant import fuse_decode_tree, quantize_linear_int4, quantize_linear_int8

    cfg = DecoderConfig(**QWEN2_7B)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, inter, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hd
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02

    def ones():
        return torch.ones(d, device=dev, dtype=torch.bfloat16)

    layers = []
    for _ in range(cfg.num_hidden_layers):
        attn = {n: {**quantize_linear_int4(rnd(out, d)), "b": rnd(out)}
                for n, out in (("q", nh * hd), ("k", nkv * hd), ("v", nkv * hd))}
        attn["o"] = quantize_linear_int4(rnd(d, nh * hd))
        mlp = {"gate": quantize_linear_int4(rnd(inter, d)), "up": quantize_linear_int4(rnd(inter, d)),
               "down": quantize_linear_int4(rnd(d, inter))}
        layers.append({"input_norm": ones(), "attn": attn, "mlp": mlp, "post_norm": ones()})
    params = {"embed": quantize_linear_int8(rnd(cfg.vocab_size, d)), "layers": layers, "final_norm": ones(),
              "lm_head": quantize_linear_int4(rnd(cfg.vocab_size, d))}
    return cfg, fuse_decode_tree(params)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def generator_vs_cpu(torch, np, cfg, params):
    """A 2-layer cut of the card's int4 tree (the same packed bytes) in bf16
    on the card against the same cut in f32 on the CPU: last-position logits
    of a left-padded batch of 2 in the 256 bucket."""
    from easyrag_tpu_torch.models import decode as td

    cut_cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    cut = {**params, "layers": params["layers"][:2]}

    def to_cpu(t, key=""):
        if isinstance(t, dict):
            return {k: to_cpu(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.cpu() if key in ("w_q", "w_p", "scale") else t.float().cpu()

    rng = np.random.default_rng(SEED + 5)
    S, lengths = 256, [200, 37]
    ids = np.zeros((2, S), np.int32)
    mask = np.zeros((2, S), np.int32)
    for b, n in enumerate(lengths):
        ids[b, S - n:] = rng.integers(0, 151_643, size=n)
        mask[b, S - n:] = 1
    out = {}
    for name, tree in (("card", cut), ("cpu", to_cpu(cut))):
        dev = tree["final_norm"].device
        cache = td.init_cache(cut_cfg, 2, S, tree["final_norm"].dtype, dev)
        with torch.inference_mode():
            h = td._prefill(cut_cfg, tree, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev), cache)
            out[name] = td._lm_logits(cut_cfg, tree, h).float().cpu().numpy()
    card, cpu = out["card"], out["cpu"]
    rel = float(np.linalg.norm(card - cpu) / np.linalg.norm(cpu))
    top_same = int((card.argmax(-1) == cpu.argmax(-1)).sum())
    say(f"generator, 2 layers, card bf16 vs CPU f32: last-position logits rel L2 {rel:.3e}, "
        f"argmax equal on {top_same}/2 rows")
    check(np.isfinite(card).all() and rel <= GEN_REL_TOL, "the generator disagrees with the CPU reference")
    return rel


def phase_generator(torch, np, pipeline, queries, k1, k2, k3, k5):
    say("== phase 5: the on-device answer generator (Qwen2-7B-Instruct, int4, spec 7) in the pipeline")
    from easyrag_tpu_torch.generation import BatchingLocalLLM
    from easyrag_tpu_torch.models.decode import TorchCausalLM
    from easyrag_tpu_torch.utils import events

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = build_generator(torch, SEED + 3)
    torch.cuda.synchronize()
    attn0, mlp0 = params["layers"][0]["attn"], params["layers"][0]["mlp"]
    check("qkv" in attn0 and "gateup" in mlp0, "fuse_decode_tree did not fuse the 7B layers")
    say(f"generator: {tree_bytes(params) / 2**30:.3f} GiB on the card (int4 layers and head, int8 embedding), "
        f"built in {time.perf_counter() - t0:.1f} s; layer 0 linears {sorted(attn0)} {sorted(mlp0)}")
    model = TorchCausalLM.from_params(cfg, params, QwenCharTokenizer(), QWEN2_EOS, max_new_tokens=GEN_MAX_NEW,
                                      max_batch=GEN_BATCH, spec_tokens=GEN_SPEC)
    recorder = RecordingModel(model)
    pipeline.llm = BatchingLocalLLM(recorder, window_ms=pipeline.config.serve_window_ms, max_batch=GEN_BATCH)
    t0 = time.perf_counter()
    model.warmup(pairs=[(7680, 1)])  # one prefill and verify block at the flagship bucket, not counted
    torch.cuda.synchronize()
    say(f"warmup (7680, B=1): {time.perf_counter() - t0:.1f} s")

    stages = []
    unsubscribe = events.on(lambda kind, p: stages.append((p["name"], p["seconds"] * 1e3)) if kind == "timing" else None)
    results = []
    for mod in (k1, k2, k3, k5):
        mod.launches = 0
    for name, q, _ in queries:
        before = (k2.launches, k3.launches)
        t = time.perf_counter()
        out = asyncio.run(pipeline.run(dict(q)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        results.append((name, out, ms, k2.launches - before[0], k3.launches - before[1], dict(stages),
                        model.last_stats[0]))
        stages.clear()
    launches = {"K2": k2.launches, "K3": k3.launches}
    unsubscribe()
    for name, out, ms, dk2, dk3, st, gs in results:
        n_new = gs["new_tokens"][0]
        split = ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        say(f"query {name!r}: prompt {gs['prompt_tokens'][0]} tokens, bucket {gs['bucket']}; prefill "
            f"{gs['prefill_ms']:.1f} ms; {gs['steps']} verify blocks, {n_new} tokens generated, "
            f"{gs['decode_ms'] / n_new:.2f} ms per generated token; run {ms:.1f} ms ({split}); "
            f"K2 launches {dk2}, K3 launches {dk3}")
        check(dk2 > 0 and dk3 > 0, f"query {name!r}: K2 or K3 did not run on the answer")
        check(isinstance(out["answer"], str) and len(out["answer"]) > 0, f"query {name!r}: empty answer")
        check(len(out["nodes"]) == pipeline.config.r_topk, f"query {name!r}: wrong result size")
    check(len(recorder.prompts) == len(queries), "the pipeline did not answer through the generator")

    # the three prompts at once: one dispatch at B=4 (one inactive row)
    prompts = recorder.prompts
    t = time.perf_counter()
    model.generate_batch(prompts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    gs = model.last_stats
    check(len(gs) == 1 and gs[0]["batch"] == 4, f"expected one dispatch at B=4, got {[(s['bucket'], s['batch']) for s in gs]}")
    gs = gs[0]
    n_tok = sum(gs["new_tokens"])
    model.spec_tokens = 0
    model.generate_batch(prompts)
    ps = model.last_stats[0]
    model.spec_tokens = GEN_SPEC
    spec_tok, plain_tok = np.array(gs["tokens"]), np.array(ps["tokens"])
    share = float((spec_tok == plain_tok).mean())
    first_diff = [int(np.argmax(a != b)) if (a != b).any() else None for a, b in zip(spec_tok, plain_tok)]
    say(f"batched: 3 prompts in one dispatch at B=4 (bucket {gs['bucket']}): prefill {gs['prefill_ms']:.1f} ms, "
        f"{gs['steps']} verify blocks, {n_tok} tokens in {secs:.2f} s ({n_tok / secs:.1f} tokens/s, "
        f"{gs['decode_ms'] / max(gs['steps'], 1):.2f} ms per verify block); plain greedy (spec 0) {ps['steps']} "
        f"steps, {ps['decode_ms'] / max(ps['steps'], 1):.2f} ms per step; tokens equal to plain greedy: {share:.3f} "
        f"(first difference per row at {first_diff})")
    # a verify block takes its norms and cache attention one position at a
    # time with the single step's shapes, and K2 sums every output in an order
    # that does not depend on the row count: the tokens are plain greedy's
    check(spec_tok.shape == plain_tok.shape and share == 1.0,
          f"speculative decoding (spec {GEN_SPEC}) differs from plain greedy: {share:.3f} of the tokens equal, "
          f"first difference per row at {first_diff}")
    # blocks of one token through the verify path have the plain steps' shapes
    # (K2 at R=4, attention at Q=1 over the same slots), so their tokens must
    # equal plain greedy's bit for bit too
    from easyrag_tpu_torch.models import decode as td

    bucket, pad_id = gs["bucket"], model._pad_id()
    rows = [td._pad_left(model._encode(p), bucket, pad_id) for p in prompts]
    rows.append(td._pad_left([QWEN2_EOS[0]], bucket, pad_id))
    dev = torch.device("cuda")
    ones = td.generate_greedy_spec(
        cfg, params, torch.tensor([r for r, _ in rows], dtype=torch.int32, device=dev),
        torch.tensor([m for _, m in rows], dtype=torch.int32, device=dev),
        torch.tensor(QWEN2_EOS, dtype=torch.int32, device=dev), GEN_MAX_NEW, draft_len=0,
        active=torch.arange(4, device=dev) < 3,
    )[:3].cpu().numpy()
    same = bool((ones == plain_tok).all())
    say(f"verify path with blocks of one token (draft_len 0): tokens equal to plain greedy on all 3 rows: {same}")
    check(same, "the verify path with draft_len 0 differs from plain greedy decoding")
    rel = generator_vs_cpu(torch, np, cfg, params)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"peak device memory in phase 5: {peak:.2f} GiB")
    return launches, rel, (cfg, params)


def k4_case(torch, gen, B, S, lengths):
    """Gemma2-shaped K4 inputs: 16 query heads of 256 on 8 KV heads, each row
    right-padded to its own length with zero vectors (as after a
    compression); q scaled so the largest logits pass the softcap's knee."""
    dev = torch.device("cuda")
    q = torch.randn(B, S, 16 * 256, generator=gen, device=dev) * 16.0
    k, v = (torch.randn(B, S, 8 * 256, generator=gen, device=dev) for _ in range(2))
    real = torch.arange(S, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    q, k, v = (torch.where(real[..., None], t, 0.0).to(torch.bfloat16) for t in (q, k, v))
    return (q, k, v, 16, 8, 1 / 16, GEMMA2_9B["attn_logit_softcapping"]), real


def k4_cases(torch, np, seed):
    """Phase 6's K4 cases, from ``seed``: ``(B, S, lengths, args, real)`` at
    B=32, S=1152 (layers 0-23) and S=640 (layers 24-27, after the
    compression), rows of their own lengths with one full and one 40 long,
    and at B=4, S=136 ragged."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    for B, S, lengths in ((32, 1152, None), (32, 640, None), (4, 136, [136, 93, 57, 8])):
        if lengths is None:
            lengths = rng.integers(S * 6 // 10, S + 1, size=B).tolist()
            lengths[0], lengths[-1] = S, 40
        yield (B, S, lengths, *k4_case(torch, gen, B, S, lengths))


def k4_row_check(torch, got, ref, real, what):
    """``what``'s output against K4's plain version: every value finite, pad
    rows included, and the per-head-row bound on real rows."""
    check(bool(torch.isfinite(got.float()).all()), f"{what} output has non-finite values (pad rows included)")
    g, r = (t.float()[real].reshape(-1, 256) for t in (got, ref))
    diff = (g - r).abs()
    bound_ = r.abs().amax(dim=1, keepdim=True)
    row_rel = float((diff / bound_.clamp_min(1e-30)).max())
    check(bool((diff <= K4_ROW_RTOL * bound_).all()), f"{what} disagrees with K4's plain version ({row_rel:.3e} of the row)")
    return float(diff.max()), row_rel


def k4_compare(torch, k4, args, real):
    got = k4.flash_softcap_attention(*args)
    ref = k4.flash_softcap_attention_plain(*args)
    torch.cuda.synchronize()
    return k4_row_check(torch, got, ref, real, "K4")


def flex_softcap_ms(torch, k4, args, real):
    """Median ms of one compiled ``flex_attention`` call computing what K4
    computes on these inputs: heads moved to dim 1 beforehand, scale, then
    the softcap as its ``score_mod``, then a causal block mask, with
    ``enable_gqa``. Its output is first held to K4's bound against the plain
    version. The port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    q, k, v, nh, _, scale, cap = args
    B, S, _ = q.shape
    qh, kh, vh = (t.reshape(B, S, -1, 256).transpose(1, 2).contiguous() for t in (q, k, v))
    mask = create_block_mask(lambda b, h, qi, ki: qi >= ki, None, None, S, S, device="cuda")
    flex = torch.compile(flex_attention)

    def call():
        return flex(qh, kh, vh, score_mod=lambda s, b, h, qi, ki: torch.tanh(s / cap) * cap, block_mask=mask,
                    scale=scale, enable_gqa=True)

    got = call().transpose(1, 2).reshape(B, S, nh * 256)
    k4_row_check(torch, got, k4.flash_softcap_attention_plain(*args), real, "flex_attention")
    return cuda_ms(torch, call, reps=5)


def gemma_vs_cpu(torch, np, scorer, pairs):
    """A 2-layer cut of the card's Gemma tree (compression at 1, cutoff 2;
    head 2 takes head 8's weights) in bf16 on the card against the same cut
    in f32 on the CPU: each pair's error within ``GEMMA_PAIR_TOL`` of the
    score's scale, and the score vector's relative L2."""
    from easyrag_tpu_torch.models.gemma import GemmaCostWiseReranker

    head = scorer.heads[GEMMA_START].clone()
    saved = scorer.cutoff_layer, scorer.compress_layer, scorer.heads[2].clone()
    scorer.heads[2] = head
    scorer.cutoff_layer, scorer.compress_layer = 2, (1,)
    card, _ = scorer.score_pairs(pairs)
    scorer.cutoff_layer, scorer.compress_layer = saved[:2]
    scorer.heads[2] = saved[2]
    cut = dataclasses.replace(scorer.cfg, num_hidden_layers=2)
    cpu = GemmaCostWiseReranker(cut, scorer.tokenizer, cutoff_layer=2, compress_layer=(1,), compress_ratio=2,
                                max_length=MAX_LENGTH, device="cpu", dtype=torch.float32)
    state = {k: v for k, v in scorer.state_dict().items() if not k.startswith("layers.") or int(k.split(".")[1]) < 2}
    state["heads"] = torch.stack([torch.zeros_like(head), torch.zeros_like(head), head])
    cpu.load_state_dict({k: v.float().cpu() for k, v in state.items()})
    ref, _ = cpu.score_pairs(pairs)
    rel = float(np.linalg.norm(card - ref) / np.linalg.norm(ref))
    gain = 1.0 + cpu.final_norm.float()
    scale = float(head.float().norm() * gain.norm()) / gain.numel() ** 0.5
    err = np.abs(card - ref)
    say(f"Gemma reranker, 2 layers (compression at 1), card bf16 vs CPU f32: {card.tolist()} vs {ref.tolist()}; "
        f"largest error {err.max():.3e} = {err.max() / scale:.3e} of the score's scale {scale:.3e} "
        f"(bound {GEMMA_PAIR_TOL}); rel L2 {rel:.3e} (bound {RERANK_REL_TOL})")
    check(np.isfinite(card).all() and bool((err <= GEMMA_PAIR_TOL * scale).all()),
          "the Gemma reranker disagrees with the CPU reference on a pair")
    check(rel <= RERANK_REL_TOL, "the Gemma reranker's scores disagree with the CPU reference")
    return rel


def phase_gemma(torch, np, pipeline, queries, mods):
    say("== phase 6: the Gemma2 cost-wise reranker (Gemma2-9B body, K4) in the pipeline")
    from easyrag_tpu_torch.models.gemma import GemmaCostWiseReranker
    from easyrag_tpu_torch.models.layers import DecoderConfig
    from easyrag_tpu_torch.rerankers import LLMRerank
    from easyrag_tpu_torch.utils import events

    k4 = mods["K4"]
    # the MiniCPM reranker and the generator are no longer needed
    pipeline.llm, pipeline.reranker = StubLLM(), None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    err, k4_times = 0.0, {}
    for B, S, lengths, args, real in k4_cases(torch, np, SEED + 6):
        e, row_rel = k4_compare(torch, k4, args, real)
        err = max(err, e)
        ms = cuda_ms(torch, lambda: k4.flash_softcap_attention(*args))
        plain = cuda_ms(torch, lambda: k4.flash_softcap_attention_plain(*args), reps=3, warmup=1)
        library = flex_softcap_ms(torch, k4, args, real) if B == 32 else None
        q, k, v = args[:3]
        # causal QK^T + PV of the real rows only, as K1's and K3's bounds count
        # (right padding: a real row's keys are all real)
        flop = 4 * 16 * 256 * sum(n * (n + 1) // 2 for n in lengths)
        b4 = bound(flop, 2 * q.nbytes + k.nbytes + v.nbytes)
        k4_times[(B, S)] = (ms, plain, *b4, library)
        lib = f"; flex_attention {library:.3f} ms (kernel {library / ms:.2f}x as fast)" if library is not None else ""
        say(f"K4 B={B} S={S} 16x256 on 8, softcap 50: max_abs_err {e:.3e} (row-relative {row_rel:.3e}), all finite; "
            f"kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s on real rows, {b4[0] / ms:.1%} of the bound), "
            f"plain {plain:.3f} ms{lib}; bound {b4[0]:.4f} ms ({b4[1]})")
        del args, real, q, k, v
    torch.cuda.empty_cache()

    cfg = DecoderConfig(**GEMMA2_9B)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scorer = GemmaCostWiseReranker(
        cfg, CharTokenizer(cfg.vocab_size), cutoff_layer=GEMMA_CUTOFF, compress_layer=GEMMA_COMPRESS,
        compress_ratio=2, max_length=MAX_LENGTH, device=dev, dtype=torch.bfloat16,
    ).init_random_(torch.Generator(device=dev).manual_seed(SEED + 7), start_layer=GEMMA_START)
    torch.cuda.synchronize()
    n_param = sum(p.numel() for p in scorer.parameters())
    say(f"Gemma reranker: {n_param / 1e9:.3f} B parameters, "
        f"{sum(p.numel() * p.element_size() for p in scorer.parameters()) / 2**30:.2f} GiB on the card, "
        f"built in {time.perf_counter() - t0:.1f} s")
    pcfg = pipeline.config
    pipeline.reranker = LLMRerank(scorer, top_n=pcfg.r_topk, embed_bs=pcfg.r_embed_bs, embed_type=pcfg.r_embed_type,
                                  use_efficient=pcfg.r_use_efficient)
    t0 = time.perf_counter()
    asyncio.run(pipeline.run(dict(queries[0][1])))  # warm-up, not counted
    torch.cuda.synchronize()
    say(f"warm-up query: {time.perf_counter() - t0:.1f} s")

    batches, stages = [], []

    def listen(kind, payload):
        if kind == "reranking" and "batch" in payload:
            batches[-1].append(payload["pairs"])
        elif kind == "timing":
            stages.append((payload["name"], payload["seconds"] * 1e3))

    unsubscribe = events.on(listen)
    results = []
    for mod in mods.values():
        mod.launches = 0
    for name, q, _ in queries:
        batches.append([])
        k4_0 = k4.launches
        t = time.perf_counter()
        out = asyncio.run(pipeline.run(dict(q)))
        torch.cuda.synchronize()
        results.append((name, out, (time.perf_counter() - t) * 1e3, k4.launches - k4_0, dict(stages)))
        stages.clear()
    launches = {key: mod.launches for key, mod in mods.items()}
    unsubscribe()
    for (name, out, ms, dk4, st), sizes in zip(results, batches, strict=True):
        split = ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        say(f"query {name!r}: {sum(sizes)} pairs in {len(sizes)} batches {sizes}; run {ms:.1f} ms ({split}); "
            f"rerank {st['rerank'] / len(sizes):.1f} ms per batch; K4 launches {dk4}; "
            f"top-6 {[n.node.idx for n in out['nodes']]}")
        check(dk4 == GEMMA_CUTOFF * len(sizes), f"query {name!r}: K4 ran {dk4} times for {len(sizes)} batches")
        check(len(out["nodes"]) == pcfg.r_topk and len(out["contexts"]) == pcfg.r_topk, f"query {name!r}: wrong result size")
        check(all(np.isfinite(n.score) for n in out["nodes"]), f"query {name!r}: non-finite rerank score")
        check(out["answer"] == "无法确定", f"query {name!r}: unexpected answer")
    check(launches["K1"] == 0, "K1 ran with the Gemma reranker")
    say(f"launches over the three queries: {launches}")

    # pairs drawn from the seed: the two short queries against random nodes
    # (the long one would pad every row to 640 tokens for the CPU run)
    nodes = pipeline.nodes
    rng = np.random.default_rng(SEED + 8)
    picks = rng.choice(len(nodes), size=GEMMA_CPU_PAIRS, replace=False)
    pairs = [(queries[i % 2][1]["query"], nodes[j].text[:120]) for i, j in enumerate(picks)]
    rel = gemma_vs_cpu(torch, np, scorer, pairs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"peak device memory in phase 6: {peak:.2f} GiB")
    return launches, err, k4_times, rel


class EmbedCharTokenizer:
    """One token per character on the embedder's vocabulary (no checkpoint
    vocabulary is in the repository), with the HF batch call
    ``GTEEmbedder`` makes: padding on the right to the longest row,
    truncation, numpy arrays. ``lengths`` keeps the real lengths of every
    batch it tokenized, in order."""

    padding_side = "right"

    def __init__(self, vocab: int) -> None:
        self.vocab = vocab
        self.lengths = []

    def __call__(self, texts, max_length=None, padding=True, truncation=True, return_tensors="np"):
        import numpy as np

        rows = [[ord(c) % (self.vocab - 2) + 2 for c in t][:max_length] for t in texts]
        self.lengths.append([len(r) for r in rows])
        ids = np.zeros((len(rows), max(len(r) for r in rows)), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def build_embedder(torch, seed):
    """gte-Qwen2-7B-instruct at full width and depth on the card: random bf16
    weights and QKV biases (std 0.02, norms 1) from a seeded generator; K3
    runs in every layer at ``S % 128 == 0`` (head_dim 128)."""
    from easyrag_tpu_torch.models.layers import DecoderConfig

    cfg = DecoderConfig(**GTE_QWEN2_7B)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, inter, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hd
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02

    def ones():
        return torch.ones(d, device=dev, dtype=torch.bfloat16)

    layers = []
    for _ in range(cfg.num_hidden_layers):
        attn = {n: {"w": rnd(out, d), "b": rnd(out)} for n, out in (("q", nh * hd), ("k", nkv * hd), ("v", nkv * hd))}
        attn["o"] = {"w": rnd(d, nh * hd)}
        mlp = {"gate": {"w": rnd(inter, d)}, "up": {"w": rnd(inter, d)}, "down": {"w": rnd(d, inter)}}
        layers.append({"input_norm": ones(), "attn": attn, "mlp": mlp, "post_norm": ones()})
    return cfg, {"embed": rnd(cfg.vocab_size, d), "layers": layers, "final_norm": ones()}


def k3_path_shapes(embedder, lengths):
    """``(B, S, lengths)`` of the K3 launches behind batches of these real
    lengths, padded as ``GTEEmbedder._embed`` pads them: to the batch and
    sequence buckets, on the right, batch-padding rows one token long. A
    batch in the 64 bucket takes the einsum path and is left out."""
    from easyrag_tpu_torch.models.qwen2 import SEQ_BUCKETS, _bucket

    shapes = []
    for lens in lengths:
        s = _bucket(max(lens), [x for x in SEQ_BUCKETS if x <= embedder.max_length])
        b = _bucket(len(lens), embedder.batch_buckets)
        if s % 128 == 0:
            shapes.append((b, s, list(lens) + [1] * (b - len(lens))))
    return shapes


def k3_embedder_cases(torch, np, k3, boot, queries):
    """K3 against its plain version at the embedder's shapes, right padded:
    every batch of the boot's index build and each query (``boot`` and
    ``queries``, from :func:`k3_path_shapes`), then B=32, S=1024 and B=8,
    S=2048 (ragged, one row full and one 40 long) and B=1, S=128. The plain
    version runs over 8-row slices of a batch (a whole index-build batch's
    materialised scores would not fit). Times of the kernel, of the plain
    version over the same slices and of SDPA (CUDA events) and the bound over
    the real rows, at the first boot batch and each other shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    rng = np.random.default_rng(SEED + 10)
    cases = [("boot", *c) for c in boot] + [("query", *c) for c in queries]
    for B, S in ((32, 1024), (8, 2048), (1, 128)):
        lengths = rng.integers(S * 6 // 10, S + 1, size=B).tolist()
        lengths[0] = S if B > 1 else 100
        lengths[-1] = 40 if B > 1 else lengths[0]
        cases.append(("ragged", B, S, lengths))
    err, times = 0.0, {}
    for kind, B, S, lengths in cases:
        args = k3_case(torch, gen, B, S, lengths, side="right")
        rows = min(B, 8)
        e, row_rel = k3_compare(torch, k3, args, rows)
        err = max(err, e)
        head = (f"K3 embedder {kind} B={B} S={S} right-padded (lengths {min(lengths)}-{max(lengths)}): "
                f"max_abs_err {e:.3e} (row-relative {row_rel:.3e}), all finite")
        if (kind, B, S) in times:  # one time per shape
            say(head)
            del args
            continue

        def plain_call():
            for _ in k3_plain_slices(k3, args, rows):
                pass

        ms = cuda_ms(torch, lambda: k3.flash_attention(*args), reps=5)
        plain = cuda_ms(torch, plain_call, reps=2, warmup=1)
        q, k, v, kv_s, kv_e, scale, nkv = args
        flop = k3_flop(np, args)
        b3 = bound(flop, 2 * q.nbytes + k.nbytes + v.nbytes)
        lib = sdpa_ms(torch, q, k, v, 28, nkv, kv_s, kv_e, scale)
        times[(kind, B, S)] = (ms, plain, *b3, lib)
        say(f"{head}; kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s on real rows, {b3[0] / ms:.1%} of the "
            f"bound), plain {plain:.3f} ms ({-(-B // rows)} slice(s) of {rows} rows), SDPA {lib:.3f} ms (kernel "
            f"{lib / ms:.2f}x as fast); bound {b3[0]:.4f} ms ({b3[1]})")
        del args, q, k, v
        torch.cuda.empty_cache()
    return err, times


def dense_index_checks(torch, np):
    """``DenseIndex`` at the deployment's size (20,000 x 3584, four dirs),
    bf16 and int8: 32 queries' top-288 against the float64 (bf16) or exact
    integer (int8) host ranking, the dir filter, ``query_stream`` against
    row-wise ``query``, and ms per query and per 64-query stream."""
    from easyrag_tpu_torch.index.dense import DenseIndex, l2_normalize

    rng = np.random.default_rng(SEED + 9)
    d, k = GTE_QWEN2_7B["hidden_size"], 288
    emb = rng.standard_normal((INDEX_ROWS, d), dtype=np.float32)
    dirs = [("director", "emsplus", "rcp", "umac")[i % 4] for i in range(INDEX_ROWS)]
    # half the queries near a row (a clear top hit), half random
    near = rng.choice(INDEX_ROWS, size=INDEX_QUERIES // 2, replace=False)
    queries = np.concatenate([
        emb[near] + 0.5 * rng.standard_normal((len(near), d), dtype=np.float32),
        rng.standard_normal((INDEX_QUERIES - len(near), d), dtype=np.float32),
    ])
    qn = l2_normalize(queries)
    times = {}
    for dtype in ("bfloat16", "int8"):
        index = DenseIndex.build(emb, dirs=dirs, dtype=dtype)
        vals, ids = index.query(queries, k)
        check(vals.shape == (INDEX_QUERIES, k) and np.isfinite(vals).all(), f"{dtype} index: wrong top-k")
        if dtype == "int8":
            # the exact integer products (exact in float64: |sums| < 2^53), rescaled in f32 as the index does
            m8, scales = index.matrix.cpu().numpy(), index.scales.cpu().numpy()
            qs = (np.abs(qn).max(axis=1, keepdims=True) * np.float32(1 / 127)).astype(np.float32)
            q8 = np.clip(np.round(qn / np.maximum(qs, np.float32(1e-12))), -127, 127)
            host = ((q8 @ m8.astype(np.float64).T).astype(np.float32) * qs) * scales[None, :]
            order = np.argsort(host, axis=1, kind="stable")[:, ::-1][:, :k]
            check(np.array_equal(ids, order), "int8 index: top-288 differs from the exact host ranking")
            check(np.array_equal(vals, np.take_along_axis(host, order, 1)), "int8 index: scores differ from the host's")
            say(f"int8 index: top-{k} of {INDEX_QUERIES} queries equal the exact integer host ranking, ids and "
                f"score bits")
        else:
            mat = index.matrix.float().cpu().numpy().astype(np.float64)
            qb = torch.from_numpy(qn).to(torch.bfloat16).float().numpy().astype(np.float64)
            host = qb @ mat.T
            order = np.argsort(host, axis=1, kind="stable")[:, ::-1][:, :k]
            true = np.take_along_axis(host, ids, 1)
            check(all(len(set(r)) == k for r in ids.tolist()), "bf16 index: an id twice in a top-k")
            check(bool(np.allclose(true, np.take_along_axis(host, order, 1), atol=DENSE_TIE_ATOL, rtol=0)),
                  "bf16 index: ranking differs from the float64 host's")
            check(bool(np.allclose(vals, true, atol=DENSE_TIE_ATOL, rtol=0)), "bf16 index: scores differ from the host's")
            ties = int((ids != order).sum())
            top1 = float((ids[: len(near), 0] == near).mean())
            say(f"bf16 index: top-{k} of {INDEX_QUERIES} queries equal the float64 host ranking ({ties} positions "
                f"differ by a tie within {DENSE_TIE_ATOL}); top-1 is the perturbed row for {top1:.2f} of the near "
                f"queries")
        fv, fi = index.query(queries[:4], k, dir_value="rcp")
        kept = fi[np.isfinite(fv)]
        check(len(kept) == 4 * min(k, dirs.count("rcp")) and all(dirs[i] == "rcp" for i in kept),
              f"{dtype} index: the dir filter leaks")
        uv, ui = index.query(queries[:4], k, dir_value="nope")
        check(np.isneginf(uv).all() and (ui == INDEX_ROWS).all(), f"{dtype} index: an unknown dir returned rows")
        sv, si = index.query_stream(queries, k)
        rows = [index.query(queries[r], k) for r in range(INDEX_QUERIES)]
        same = all(np.array_equal(sv[r], v[0]) and np.array_equal(si[r], i[0]) for r, (v, i) in enumerate(rows))
        check(same and np.array_equal(sv, vals), f"{dtype} index: query_stream differs from row-wise query")
        q64 = np.concatenate([queries, queries])
        one = cuda_ms(torch, lambda: index.query(queries[:1], k))
        stream = cuda_ms(torch, lambda: index.query_stream(q64, k))
        times[dtype] = (one, stream)
        say(f"{dtype} index {INDEX_ROWS} x {d}: dir filter keeps only its dir, an unknown dir returns nothing, "
            f"query_stream equals row-wise query bit for bit; {one:.3f} ms per query, {stream:.3f} ms per "
            f"64-query stream (host clock around each call, transfers included)")
        del index
    torch.cuda.empty_cache()
    return times


def sub_corpus(src: str, dst: str, n: int) -> None:
    """The files ``doc0`` .. ``doc{n-1}`` of ``write_corpus``'s corpus at
    ``src``, with their part of its ``pathmap.json``, copied to ``dst``."""
    import shutil

    with open(os.path.join(src, "pathmap.json"), encoding="utf-8") as fh:
        pathmap = json.load(fh)
    keep = {rel: v for rel, v in pathmap.items() if int(rel.split("/doc")[1][:-4]) < n}
    for rel in keep:
        os.makedirs(os.path.dirname(os.path.join(dst, rel)), exist_ok=True)
        shutil.copyfile(os.path.join(src, rel), os.path.join(dst, rel))
    with open(os.path.join(dst, "pathmap.json"), "w", encoding="utf-8") as fh:
        json.dump(keep, fh)


def embedder_vs_cpu(torch, np, cfg, params, tokenizer):
    """A 2-layer cut of the card's embedder tree in bf16 on the card against
    the same cut in f32 on the CPU, on eight seeded texts of 100-120
    characters (the 128 bucket, so K3 runs on the card): the relative L2 of
    each normalized embedding."""
    from easyrag_tpu_torch.models.qwen2 import GTEEmbedder

    cut_cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    cut = {**params, "layers": params["layers"][:2]}

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.float().cpu()

    rng = np.random.default_rng(SEED + 11)
    texts = [" ".join(f"t{w}" for w in rng.integers(0, VOCAB, size=40))[: int(rng.integers(100, 121))] for _ in range(8)]
    card = GTEEmbedder(cut_cfg, cut, tokenizer).get_text_embeddings(texts)
    cpu = GTEEmbedder(cut_cfg, to_cpu(cut), tokenizer, device="cpu").get_text_embeddings(texts)
    rel = np.linalg.norm(card - cpu, axis=1) / np.linalg.norm(cpu, axis=1)
    say(f"embedder, 2 layers, card bf16 vs CPU f32 on 8 texts: relative L2 per embedding {rel.min():.3e}-"
        f"{rel.max():.3e} (bound {EMB_REL_TOL})")
    check(np.isfinite(card).all() and bool((rel <= EMB_REL_TOL).all()), "the embedder disagrees with the CPU reference")
    return float(rel.max())


def phase_dense(torch, np, tmp, pipeline, reranker, queries, mods):
    say("== phase 7: the dense route (gte-Qwen2-7B-instruct, K3 at layers.attention, cosine index, RRF)")
    import gc
    import shutil

    from easyrag_tpu_torch.config import load_config
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.models.qwen2 import GTEEmbedder
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline
    from easyrag_tpu_torch.utils import events

    k1, k3 = mods["K1"], mods["K3"]
    # the generator and the Gemma reranker are not on this path
    pipeline.llm, pipeline.reranker = StubLLM(), None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dense_index_checks(torch, np)

    t0 = time.perf_counter()
    cfg, params = build_embedder(torch, SEED + 12)
    torch.cuda.synchronize()
    tokenizer = EmbedCharTokenizer(cfg.vocab_size)
    embedder = GTEEmbedder(cfg, params, tokenizer, embed_type=1)
    say(f"embedder: {tree_bytes(params) / 2**30:.2f} GiB of bf16 weights on the card, built in "
        f"{time.perf_counter() - t0:.1f} s")

    data = os.path.join(tmp, "dense_corpus")
    sub_corpus(tmp, data, DENSE_DOCS)
    pcfg = load_config(os.path.join(REPO, "configs", "easyrag.yaml"), overrides={
        "data_path": data, "retrieval_type": 3, "rerank_fusion_type": 1, "cache_path": os.path.join(tmp, "cache"),
    })

    def boot():
        return EasyRAGPipeline(
            pcfg, llm=StubLLM(), embed_model=embedder, reranker=reranker, sparse_tokenizer=SparseTokenizer(),
            splitter=SentenceSplitter(pcfg.chunk_size, pcfg.chunk_overlap, token_counter=approx_token_count,
                                      sentence_splitter=lambda t: [t]),
            device=torch.device("cuda"),
        )

    # the main path is the boot (the index build) and the three queries:
    # the counts are reset just before the one and read just after the other
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    dense = boot()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st, boot_k3 = dict(embedder.stats), k3.launches
    boot_lengths = list(tokenizer.lengths)
    n = len(dense.nodes)
    check(n == DENSE_DOCS and dense.dense_retriever.index.num_docs == n, f"expected {DENSE_DOCS} indexed chunks, got {n}")
    check(boot_k3 > 0, "K3 did not run during the index build")
    say(f"boot: {n} chunks embedded in {st['batches']} batches and indexed in {secs:.1f} s: {st['tokens']} real tokens "
        f"({st['tokens'] / secs:.0f}/s), {st['padded_tokens']} padded ({st['padded_tokens'] / secs:.0f}/s); "
        f"K3 launches {boot_k3}")

    candidates, stages = [], []

    n_batches = []

    def listen(kind, payload):
        if kind == "reranking" and "candidates" in payload:
            candidates[-1].append(payload["candidates"])
        elif kind == "reranking" and "batch" in payload:
            n_batches[-1] += 1
        elif kind == "timing":
            stages.append((payload["name"], payload["seconds"] * 1e3))

    unsubscribe = events.on(listen)
    results = []
    for name, q, _ in queries:
        candidates.append([])
        n_batches.append(0)
        before, k1_0, k3_0 = embedder.stats["batches"], k1.launches, k3.launches
        t = time.perf_counter()
        out = asyncio.run(dense.run(dict(q)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        split = {}
        for key, v in stages:
            split[key] = split.get(key, 0.0) + v
        results.append((name, out, ms, k1.launches - k1_0, k3.launches - k3_0, embedder.stats["batches"] - before, split))
        stages.clear()
    launches = {key: mod.launches for key, mod in mods.items()}
    unsubscribe()
    for (name, out, ms, dk1, dk3, embedded, split), cand, nb in zip(results, candidates, n_batches, strict=True):
        parts = ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        say(f"query {name!r}: {ms:.1f} ms ({parts}); candidates (dense, sparse) {cand} in {nb} rerank batches, "
            f"{split['rerank'] / nb:.1f} ms per batch; K1 launches {dk1}, "
            f"K3 launches {dk3}; top-6 {[x.node.idx for x in out['nodes']]}")
        check(embedded == 1 and dk1 > 0 and dk3 > 0, f"query {name!r}: the query was not embedded through K3 or reranked through K1")
        check(len(out["nodes"]) == pcfg.r_topk_1 and len(out["contexts"]) == pcfg.r_topk_1, f"query {name!r}: wrong result size")
        check(all(np.isfinite(x.score) and x.score > 0 for x in out["nodes"]), f"query {name!r}: bad fused score")
        check(out["answer"] == "无法确定", f"query {name!r}: unexpected answer")
    query_lengths = tokenizer.lengths[len(boot_lengths):]
    say(f"launches over the boot and the three queries: {launches} (K3 {boot_k3} in the boot, "
        f"{launches['K3'] - boot_k3} in the queries)")

    before = dict(embedder.stats)
    t0 = time.perf_counter()
    again = boot()
    secs = time.perf_counter() - t0
    check(embedder.stats == before, "the reboot embedded the corpus again")
    check([x.text for x in again.nodes] == [x.text for x in dense.nodes], "the reboot gave other nodes")
    check(torch.equal(again.dense_retriever.index.matrix, dense.dense_retriever.index.matrix), "the reboot gave another index")
    say(f"reboot from the saved index: {secs:.1f} s, nothing embedded, the same {n} nodes and index bits")
    del again, dense
    fusion_batch_check(torch, np, dataclasses.replace(pcfg, use_reranker=0), embedder)
    gc.collect()
    shutil.rmtree(data)  # it lies inside phase 3's corpus, which phase 8 reads again

    embedder_vs_cpu(torch, np, cfg, params, tokenizer)
    # K3 at the shapes and paddings the boot and the queries gave it
    boot_shapes = k3_path_shapes(embedder, boot_lengths)
    query_shapes = k3_path_shapes(embedder, query_lengths)
    check(len(boot_shapes) == st["batches"] and len(query_shapes) == len(queries),
          "a batch of the main path did not reach K3's gate")
    del embedder, params
    gc.collect()
    torch.cuda.empty_cache()
    k3_err, k3_times = k3_embedder_cases(torch, np, k3, boot_shapes, query_shapes)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"peak device memory in phase 7: {peak:.2f} GiB")
    return launches, k3_err, k3_times, ("boot", *boot_shapes[0][:2])


def stream_queries(np, rng, pipeline, n, long_every=64):
    """``n`` queries as :func:`make_queries` draws them: 12 words of a random
    node; every 8th (from the 6th) filtered to that node's dir; every
    ``long_every``-th of 80 distinct words (past the 64-term budget: the
    gather path, K5)."""
    head = {f"t{t}" for t in range(32)}  # the Zipf head, as stopwords would remove it
    nodes, tok = pipeline.nodes, pipeline.sparse_tk

    def words(i):
        return [w for w in tok.cut(nodes[i].text) if w.startswith("t") and w not in head]

    out = []
    for i in range(n):
        a = int(rng.integers(0, len(nodes)))
        if i % long_every == long_every - 1:
            pool = []
            for j in rng.integers(0, len(nodes), size=8):
                pool += [w for w in dict.fromkeys(words(int(j))) if w not in pool]
            out.append({"query": " ".join(pool[:80])})
            continue
        q = {"query": " ".join(rng.choice(words(a), size=12, replace=False).tolist())}
        if i % 8 == 5:
            q["document"] = nodes[a].metadata["dir"]
        out.append(q)
    return out


def same_rows(a, b) -> bool:
    """Two result lists with the same nodes, scores (exactly) and contexts."""
    return all(
        x["contexts"] == y["contexts"]
        and [(n.node.idx, n.score) for n in x["nodes"]] == [(n.node.idx, n.score) for n in y["nodes"]]
        for x, y in zip(a, b, strict=True)
    )


def fusion_batch_check(torch, np, cfg, embedder):
    """Phase 7's batch: a pipeline rebooted from the saved index with
    ``use_reranker: 0``, ``run_retrieval_batch`` over 128 queries on the
    fusion path (the queries embedded at B=128, ``DenseIndex.query_stream``,
    the sparse stream, RRF) against ``run`` query by query. The sparse lists
    must equal the per-query ones bit for bit; the dense lists may differ only
    as far as the query embeddings do: the index scores a query in bf16, and
    a query's bf16 embedding at B=128 differs from its embedding alone by
    ``d = ||bf16(e_128) - bf16(e_1)||``, which moves each cosine against a
    (bf16, unit) row by at most ``1.01 d``, so the two lists' scores at every
    rank must lie within that (plus ``DENSE_TIE_ATOL`` of f32 sums) of each
    other. Rows whose dense lists come out equal must give the per-query
    fused rows."""
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline
    from easyrag_tpu_torch.schema import QueryBundle

    pipe = EasyRAGPipeline(
        cfg, llm=StubLLM(), embed_model=embedder, sparse_tokenizer=SparseTokenizer(),
        splitter=SentenceSplitter(cfg.chunk_size, cfg.chunk_overlap, token_counter=approx_token_count,
                                  sentence_splitter=lambda t: [t]),
        device=torch.device("cuda"),
    )
    check(pipe.reranker is None, "the batch pipeline booted with a reranker")
    pipe.re_only = True
    queries = stream_queries(np, np.random.default_rng(SEED + 30), pipe, 128)
    bundles = [QueryBundle(query_str=q["query"]) for q in queries]
    pairs = [pipe.build_filters(q) for q in queries]
    dense_b = pipe.dense_retriever.retrieve_batch(bundles, [p[0] for p in pairs])
    sparse_b = pipe.sparse_retriever.retrieve_batch(bundles, [p[1] for p in pairs])
    dense_1, sparse_1 = [], []
    for b, (dense_f, sparse_f) in zip(bundles, pairs):
        pipe.dense_retriever.filters, pipe.sparse_retriever.filter_dict = dense_f, sparse_f
        dense_1.append(pipe.dense_retriever.retrieve(b))
        sparse_1.append(pipe.sparse_retriever.retrieve(b))
    check(all([(n.node.idx, n.score) for n in x] == [(n.node.idx, n.score) for n in y]
              for x, y in zip(sparse_b, sparse_1)), "a batch row's sparse list differs from its query's alone")
    texts = [q["query"] for q in queries]
    e_b = torch.from_numpy(np.asarray(embedder.get_query_embeddings(texts), np.float32))
    e_1 = torch.from_numpy(np.stack([np.asarray(embedder.get_query_embedding(t), np.float32) for t in texts]))
    drift = (e_b.bfloat16().float() - e_1.bfloat16().float()).norm(dim=1).numpy()
    same_ids = []
    for row, (x, y) in enumerate(zip(dense_b, dense_1)):
        check(len(x) == len(y), "a batch row's dense list has another length")
        gap = float(np.abs(np.array([n.score for n in x]) - np.array([n.score for n in y])).max()) if x else 0.0
        check(gap <= 1.01 * drift[row] + DENSE_TIE_ATOL, f"row {row}: dense scores moved {gap:.3e} for an "
              f"embedding drift of {drift[row]:.3e}")
        same_ids.append([n.node.idx for n in x] == [n.node.idx for n in y])

    t0 = time.perf_counter()
    batch = asyncio.run(pipe.run_retrieval_batch([dict(q) for q in queries]))
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [asyncio.run(pipe.run(dict(q))) for q in queries]
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    check(same_rows([b for b, s in zip(batch, same_ids) if s], [x for x, s in zip(singles, same_ids) if s]),
          "a fused batch row with the per-query dense list differs from its query's run")
    say(f"fusion batch (use_reranker 0, rebooted from the saved index): 128 queries, run_retrieval_batch "
        f"{t_batch * 1e3:.1f} ms ({128 / t_batch:.1f} qps) vs run one by one {t_single * 1e3:.1f} ms "
        f"({128 / t_single:.1f} qps); sparse lists equal bit for bit on all rows; dense lists equal on "
        f"{sum(same_ids)}/128 rows, the rest within the embedding drift (B=128 vs 1: {drift.min():.2e}-"
        f"{drift.max():.2e}); fused rows equal to run's on those {sum(same_ids)}")


class StageClock:
    """Wall milliseconds in each cascade stage's scorer calls: stage 1 is
    ``score_pairs_carry`` (or ``score_pairs`` below the full cutoff), stage 2
    ``score_carried`` (or ``score_pairs`` at it). Every call returns host
    scores, so it ends in a device sync."""

    def __init__(self, scorer, full_cutoff: int) -> None:
        self.ms = {"stage 1": 0.0, "stage 2": 0.0}
        self.scorer, self.full = scorer, full_cutoff
        for name in ("score_pairs", "score_pairs_carry", "score_carried"):
            setattr(scorer, name, self._timed(name, getattr(scorer, name)))

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            stage1 = name == "score_pairs_carry" or (name == "score_pairs" and self.scorer.cutoff_layer < self.full)
            self.ms["stage 1" if stage1 else "stage 2"] += (time.perf_counter() - t) * 1e3
            return out
        return call

    def take(self):
        out = dict(self.ms)
        self.ms = {k: 0.0 for k in self.ms}
        return out

    def remove(self):
        for name in ("score_pairs", "score_pairs_carry", "score_carried"):
            delattr(self.scorer, name)


def candidates(pipeline, query):
    """The fused candidate list of a query (retrieval and fusion, as
    ``generation_with_knowledge_retrieval`` makes it), fresh nodes each call."""
    from easyrag_tpu_torch.retrievers import HybridRetriever
    from easyrag_tpu_torch.schema import QueryBundle

    pipeline.filter_dict = pipeline.sparse_retriever.filter_dict = (
        {"dir": query["document"]} if query.get("document") else None)
    bundle = QueryBundle(query_str=query["query"])
    routes = pipeline._dual_retrieve(bundle)
    if routes is None:
        routes = (pipeline.sparse_retriever.retrieve(bundle), pipeline.path_retriever.retrieve(bundle))
    return HybridRetriever.fusion(list(routes))


def last_hidden(torch, scorer, pairs):
    """The hidden state at each row's last real token after ``cutoff_layer``
    layers, f32 ``[B, D]``."""
    ids, mask = scorer.build_inputs(pairs)
    ranges, last, rope = scorer._prepare(mask)
    dev = scorer.final_norm.device
    with torch.inference_mode():
        from easyrag_tpu_torch.models.layers import embed

        h = embed(scorer.cfg, scorer.embed, torch.from_numpy(ids).to(dev), scorer.final_norm.dtype)
        h = scorer._segment(h, ranges, rope, 0, scorer.cutoff_layer)
        return h[torch.arange(h.shape[0], device=dev), last].float()


def cosines(a, b):
    """Per-row cosine of two ``[B, D]`` f32 tensors (on the CPU)."""
    a, b = a.float().cpu(), b.float().cpu()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def minicpm_w8a8_vs_cpu(torch, np, scorer8, pairs):
    """A 2-layer cut of the card's w8a8 MiniCPM (the same int8 leaves; head 2
    takes head 28's weights) in bf16 on the card against the same cut in f32
    on the CPU. Each activation's bf16 rounding moves about a quarter of its
    int8 codes by one step against the f32 run's, so the two differ by
    w8a8's own noise: the last hidden states' cosine gates at
    tests/test_w8a8.py's 0.99, and the scores are reported."""
    from easyrag_tpu_torch.models.layers import quantize_layers_
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker

    cut = dataclasses.replace(scorer8.cfg, num_hidden_layers=2, act_quant=False)
    state = {k: v for k, v in scorer8.state_dict().items() if not k.startswith("layers.") or int(k.split(".")[1]) < 2}
    head = scorer8.heads[28]
    state["heads"] = torch.stack([torch.zeros_like(head), torch.zeros_like(head), head])
    scores, hidden = {}, {}
    for name, dev, dt in (("card", torch.device("cuda"), torch.bfloat16), ("cpu", torch.device("cpu"), torch.float32)):
        m = quantize_layers_(MiniCPMLayerWiseReranker(cut, scorer8.tokenizer, start_layer=2, cutoff_layer=2,
                                                      max_length=MAX_LENGTH, use_efficient=scorer8.use_efficient,
                                                      device=dev, dtype=dt), "w8a8")
        m.load_state_dict(state)  # copied into each parameter's own device and dtype
        scores[name], hidden[name] = m.score_pairs(pairs)[0], last_hidden(torch, m, pairs)
        del m
    cos = cosines(hidden["card"], hidden["cpu"])
    rel = float(np.linalg.norm(scores["card"] - scores["cpu"]) / np.linalg.norm(scores["cpu"]))
    say(f"w8a8 MiniCPM, 2 layers, card bf16 vs CPU f32: last hidden cosine {[round(float(c), 5) for c in cos]} "
        f"(bound 0.99); scores {scores['card'].tolist()} vs {scores['cpu'].tolist()} (rel L2 {rel:.3e})")
    check(np.isfinite(scores["card"]).all() and float(cos.min()) > 0.99,
          "the w8a8 MiniCPM disagrees with the CPU reference")
    return float(cos.min())


def a8_projection_checks(torch, np, scorer8, scorer16, S):
    """``linear(a8=True)`` on the card bit-equal to the same call on the CPU
    at one MiniCPM projection (gate, [S, 2304] -> 5760); then each
    projection shape of a 32-pair batch (B*S rows, [2304 -> 2304, 5760] and
    [5760 -> 2304]) timed as ``F.linear`` in bf16 and as w8a8's parts: the
    per-token quantization, ``torch._int_mm`` and the rescale."""
    from easyrag_tpu_torch.models.layers import int8_matmul, linear, quantize_tokens, rescale_s32

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    leaf = {k: v.detach() for k, v in scorer8.layers[0].gate.items()}
    x = (torch.randn(S, leaf["w_q"].shape[1], generator=gen, device="cuda") * 3).to(torch.bfloat16)
    card = linear(x, leaf, a8=True).cpu()
    cpu = linear(x.cpu(), {k: v.cpu() for k, v in leaf.items()}, a8=True)
    same = torch.equal(card.view(torch.int16), cpu.view(torch.int16))
    say(f"linear(a8=True) at the gate projection [{S}, 2304] -> 5760: card and CPU bit-equal: {same}")
    check(same, "linear(a8=True) on the card differs from the CPU in bits")
    rows = 32 * S
    times = {}
    for name, n_in, n_out, leaf8, w16 in (
        ("q/k/v/o", 2304, 2304, scorer8.layers[0].q, scorer16.layers[0].q["w"]),
        ("gate/up", 2304, 5760, scorer8.layers[0].gate, scorer16.layers[0].gate["w"]),
        ("down", 5760, 2304, scorer8.layers[0].down, scorer16.layers[0].down["w"]),
    ):
        x = torch.randn(rows, n_in, generator=gen, device="cuda").to(torch.bfloat16)
        w8, scale = leaf8["w_q"].detach(), leaf8["scale"].detach()
        xq, xs = quantize_tokens(x)
        y = int8_matmul(xq, w8)
        t_bf16 = cuda_ms(torch, lambda: torch.nn.functional.linear(x, w16), reps=5)
        t_quant = cuda_ms(torch, lambda: quantize_tokens(x), reps=5)
        t_mm = cuda_ms(torch, lambda: int8_matmul(xq, w8), reps=5)
        t_scale = cuda_ms(torch, lambda: rescale_s32(y, xs, scale, torch.bfloat16), reps=5)
        t_a8 = cuda_ms(torch, lambda: linear(x, leaf8, a8=True), reps=5)
        ops = 2 * rows * n_in * n_out
        times[name] = (t_bf16, t_quant, t_mm, t_scale, t_a8)
        say(f"projection {name} [{rows}, {n_in}] -> {n_out}: F.linear bf16 {t_bf16:.3f} ms "
            f"({ops / t_bf16 / 1e9:.0f} TFLOP/s); w8a8 {t_a8:.3f} ms = quantization {t_quant:.3f} + _int_mm "
            f"{t_mm:.3f} ({ops / t_mm / 1e9:.0f} TOP/s) + rescale {t_scale:.3f}")
        del x, xq, xs, y
    torch.cuda.empty_cache()
    return times


def rerank_stage_ms(torch, pipeline, scorer, cfg, queries):
    """The rerank stage of each query with the w8a8 scorer at
    ``use_efficient`` 0, 3 without the carry and 3 with it (fresh candidates
    each run), and the peak device bytes each run adds to what is resident."""
    from easyrag_tpu_torch.rerankers import LLMRerank
    from easyrag_tpu_torch.schema import QueryBundle

    modes = (("use_efficient 0", 0, False), ("cascade, re-score", 3, False), ("cascade, carry", 3, True))
    out = {}
    for name, q, _ in queries:
        row = {}
        for mode, eff, carry in modes:
            rr = LLMRerank(scorer, top_n=cfg.r_topk, embed_bs=cfg.r_embed_bs, embed_type=cfg.r_embed_type,
                           use_efficient=eff, cascade_keep=cfg.tpu.cascade_keep, cascade_carry=carry)
            nodes = candidates(pipeline, q)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            rr.postprocess_nodes(nodes, QueryBundle(query_str=q["query"]))
            torch.cuda.synchronize()
            row[mode] = ((time.perf_counter() - t) * 1e3, (torch.cuda.max_memory_allocated() - base) / 2**30)
        out[name] = row
        say(f"rerank stage, query {name!r}: " + "; ".join(
            f"{mode} {ms:.1f} ms (peak +{gib:.2f} GiB)" for mode, (ms, gib) in row.items()))
    return out


def phase_yes_logit(torch, np, pairs, mods):
    """The yes-logit scorer on phase 7's gte-Qwen2-7B-width tree, rebuilt
    from its seed (no ``lm_head``: the head is tied to ``embed``): one
    32-pair batch in bf16 and w8a8, K3's launches, and a 2-layer w8a8 cut on
    the card against the CPU in f32 on two short pairs (the last hidden
    states' cosine gates, as for the MiniCPM cut)."""
    from easyrag_tpu_torch.models.layers import forward_hidden
    from easyrag_tpu_torch.models.minicpm import last_real_index
    from easyrag_tpu_torch.models.quant import quantize_decoder_tree
    from easyrag_tpu_torch.models.yes_logit import YesLogitScorer

    k3 = mods["K3"]
    cfg, params = build_embedder(torch, SEED + 12)
    tok = CharTokenizer(cfg.vocab_size)
    results = {}
    for quant in ("", "w8a8"):
        if quant:
            params = quantize_decoder_tree(params, "int8")
            cfg = dataclasses.replace(cfg, act_quant=True)
            torch.cuda.empty_cache()
        scorer = YesLogitScorer(cfg, params, tok, max_length=MAX_LENGTH)
        ids, _ = scorer.build_inputs(pairs)
        scorer.score_pairs(pairs)  # warm-up
        k3.launches = 0
        scores, _ = scorer.score_pairs(pairs)
        n3 = k3.launches
        ms = cuda_ms(torch, lambda: scorer.score_pairs(pairs), reps=3, warmup=0)
        results[quant or "bf16"] = scores
        say(f"yes-logit scorer ({quant or 'bf16'}, {tree_bytes(params) / 2**30:.2f} GiB, head tied to embed): "
            f"{len(pairs)} pairs at S={ids.shape[1]} in {ms:.1f} ms; K3 launches {n3} "
            f"({cfg.num_hidden_layers} layers); scores finite: {bool(np.isfinite(scores).all())}")
        check(np.isfinite(scores).all() and n3 == cfg.num_hidden_layers, "the yes-logit scorer did not run K3 in every layer")
    a, b = results["bf16"], results["w8a8"]
    say(f"yes-logit w8a8 vs bf16: top-6 {[int(i) for i in np.argsort(-b)[:6]]} vs {[int(i) for i in np.argsort(-a)[:6]]}, "
        f"largest difference {float(np.abs(a - b).max()):.3e} at a scale of {float(np.abs(a).max()):.3e}")
    # 2 layers on the card against the CPU in f32 (the same int8 leaves)
    cut_cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    cut = {**params, "layers": params["layers"][:2]}

    def to_cpu(t, key=""):
        if isinstance(t, dict):
            return {k: to_cpu(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.cpu() if key in ("w_q", "w_p", "scale") else t.float().cpu()

    short = [(q, p[:40]) for q, p in pairs[:2]]
    out = {}
    for name, tree, dev in (("card", cut, "cuda"), ("cpu", to_cpu(cut), "cpu")):
        sc = YesLogitScorer(cut_cfg, tree, tok, max_length=MAX_LENGTH, device=dev)
        ids, mask = sc.build_inputs(short)
        with torch.inference_mode():
            h = forward_hidden(cut_cfg, sc.params, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
            last = torch.from_numpy(last_real_index(mask)).to(dev)
            out[name] = (sc.score_pairs(short)[0], h[torch.arange(len(short), device=dev), last])
    cos = cosines(out["card"][1], out["cpu"][1])
    say(f"yes-logit w8a8, 2 layers, card bf16 vs CPU f32: last hidden cosine {[round(float(c), 5) for c in cos]} "
        f"(bound 0.99); scores {out['card'][0].tolist()} vs {out['cpu'][0].tolist()}")
    check(np.isfinite(out["card"][0]).all() and float(cos.min()) > 0.99,
          "the yes-logit scorer disagrees with the CPU reference")
    del params, cut


def save_minicpm_checkpoint(torch, scorer, arch, out_dir, start_layer):
    """The scorer's weights under the Hugging Face names ``hf_loader`` reads
    (``model.layers.{i}.self_attn.q_proj.weight``, ...; the layerwise heads
    as ``lm_head.{j}.linear_head.weight`` from ``start_layer``), in one
    safetensors file, with a ``config.json`` of ``arch``."""
    from safetensors.torch import save_file

    norms = {"input_norm": "input_layernorm", "post_norm": "post_attention_layernorm"}
    projs = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}
    tensors = {}
    for key, t in scorer.state_dict().items():
        parts = key.split(".")
        if key == "heads":
            for layer in range(start_layer, t.shape[0]):
                tensors[f"lm_head.{layer - start_layer}.linear_head.weight"] = t[layer : layer + 1].cpu().contiguous()
            continue
        if key == "embed":
            name = "model.embed_tokens.weight"
        elif key == "final_norm":
            name = "model.norm.weight"
        elif parts[2] in norms:
            name = f"model.layers.{parts[1]}.{norms[parts[2]]}.weight"
        else:
            name = f"model.layers.{parts[1]}.{projs[parts[2]]}.weight"
        tensors[name] = t.cpu().contiguous()
    os.makedirs(out_dir, exist_ok=True)
    save_file(tensors, os.path.join(out_dir, "model.safetensors"))
    with open(os.path.join(out_dir, "config.json"), "w", encoding="utf-8") as fh:
        json.dump({"architectures": ["LayerWiseMiniCPMForCausalLM"], **arch, "start_layer": start_layer}, fh)


def save_word_tokenizer(out_dir, words):
    """A word-level Hugging Face tokenizer over ``words`` (whitespace and
    punctuation split, ``[PAD]`` 0, ``<s>`` 1, ``[UNK]`` 2, right padding),
    saved the way ``tests/test_checkpoint_boot.py::_word_tokenizer`` saves
    one, so ``AutoTokenizer.from_pretrained`` reads it back."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "<s>": 1, "[UNK]": 2}
    for w in words:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]", bos_token="<s>",
                            padding_side="right").save_pretrained(out_dir)


def phase_flagship(torch, np, tmp, scorer16, generator, queries, mods):
    """``configs/four_tenant.yaml`` on the card: phase 3's corpus, phase 3's
    MiniCPM quantized to w8a8, the carried two-stage cascade, phase 5's int4
    generator answering."""
    say("== phase 8: the flagship preset (configs/four_tenant.yaml): w8a8 MiniCPM, carried cascade, int4 answers")
    import copy
    import gc

    from easyrag_tpu_torch.config import load_config
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.models.decode import TorchCausalLM
    from easyrag_tpu_torch.models.layers import quantize_layers_
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline
    from easyrag_tpu_torch.rerankers import LLMRerank
    from easyrag_tpu_torch.utils import events

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(os.path.join(REPO, "configs", "four_tenant.yaml"), overrides={"data_path": tmp})
    check(cfg.r_use_efficient == 3 and cfg.tpu.cascade_carry and cfg.tpu.reranker_quant == "w8a8"
          and cfg.tpu.local_llm_quant == "int4" and cfg.tpu.local_llm_answer, "configs/four_tenant.yaml changed")
    t0 = time.perf_counter()
    scorer = quantize_layers_(copy.deepcopy(scorer16), cfg.tpu.reranker_quant)
    scorer.use_efficient = cfg.r_use_efficient
    torch.cuda.synchronize()
    say(f"reranker: phase 3's MiniCPM quantized to {cfg.tpu.reranker_quant} on the card in "
        f"{time.perf_counter() - t0:.1f} s: {tree_bytes(dict(scorer.state_dict())) / 2**30:.2f} GiB "
        f"(bf16: {tree_bytes(dict(scorer16.state_dict())) / 2**30:.2f} GiB); judge layer {scorer.efficient_layers[0]}, "
        f"cutoff {scorer.cutoff_layer}")
    rr = LLMRerank(scorer, top_n=cfg.r_topk, embed_bs=cfg.r_embed_bs, embed_type=cfg.r_embed_type,
                   use_efficient=cfg.r_use_efficient, cascade_keep=cfg.tpu.cascade_keep,
                   cascade_carry=cfg.tpu.cascade_carry)
    gcfg, gparams = generator
    model = TorchCausalLM.from_params(gcfg, gparams, QwenCharTokenizer(), QWEN2_EOS,
                                      max_new_tokens=cfg.tpu.local_llm_max_new, max_batch=cfg.tpu.local_llm_gen_batch,
                                      spec_tokens=cfg.tpu.local_llm_spec, spec_ngram=cfg.tpu.local_llm_spec_ngram)
    # no checkpoint is in the repository: the pipeline's local generator is
    # phase 5's seeded int4 model, behind the BatchingLocalLLM it builds itself
    saved = EasyRAGPipeline.__dict__["_make_local_llm"]
    EasyRAGPipeline._make_local_llm = staticmethod(lambda c, d: model)
    try:
        t0 = time.perf_counter()
        pipeline = EasyRAGPipeline(
            cfg, reranker=rr, sparse_tokenizer=SparseTokenizer(),
            splitter=SentenceSplitter(cfg.chunk_size, cfg.chunk_overlap, token_counter=approx_token_count,
                                      sentence_splitter=lambda t: [t]),
            device=torch.device("cuda"),
        )
    finally:
        EasyRAGPipeline._make_local_llm = saved
    torch.cuda.synchronize()
    check(len(pipeline.nodes) == N_DOCS and pipeline.local_llm is model, "the flagship pipeline did not boot as configured")
    say(f"pipeline boot: {len(pipeline.nodes)} chunks in {time.perf_counter() - t0:.1f} s; answers by "
        f"{type(pipeline.llm).__name__} (window {cfg.serve_window_ms} ms, batch {cfg.tpu.local_llm_gen_batch})")
    asyncio.run(pipeline.run(dict(queries[0][1])))  # warm-up, not counted
    torch.cuda.synchronize()

    clock = StageClock(scorer, scorer.cutoff_layer)
    stages = []
    unsubscribe = events.on(lambda kind, p: stages.append((p["name"], p["seconds"] * 1e3)) if kind == "timing" else None)
    results = []
    clock.take()
    for mod in mods.values():
        mod.launches = 0
    for name, q, _ in queries:
        before = {key: mod.launches for key, mod in mods.items()}
        t = time.perf_counter()
        out = asyncio.run(pipeline.run(dict(q)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        results.append((name, out, ms, {key: mod.launches - before[key] for key, mod in mods.items()}, dict(stages),
                        clock.take()))
        stages.clear()
    launches = {key: mod.launches for key, mod in mods.items()}
    unsubscribe()
    clock.remove()
    for name, out, ms, dl, st, sc in results:
        split = ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        say(f"query {name!r}: {ms:.1f} ms ({split}); rerank stage 1 {sc['stage 1']:.1f} ms, stage 2 (carried) "
            f"{sc['stage 2']:.1f} ms; K1 {dl['K1']}, K2 {dl['K2']}, K3 {dl['K3']}, K5 {dl['K5']} launches; "
            f"top-6 {[n.node.idx for n in out['nodes']]}")
        check(dl["K1"] > 0 and dl["K2"] > 0 and dl["K3"] > 0, f"query {name!r}: K1, K2 or K3 did not run")
        check(len(out["nodes"]) == cfg.r_topk and all(np.isfinite(n.score) for n in out["nodes"]),
              f"query {name!r}: wrong rerank result")
        check(isinstance(out["answer"], str) and len(out["answer"]) > 0, f"query {name!r}: empty answer")
    check(results[2][3]["K5"] > 0, "K5 did not run on the long query")
    say(f"launches over the three flagship queries: {launches}")

    # (1) the carried stage 2 against the re-score path on the same survivors
    q0 = queries[0][1]
    nodes = candidates(pipeline, q0)
    scores = {}
    for carry in (False, True):
        rr.cascade_carry = carry
        scores[carry] = rr._score_cascade(nodes, q0["query"])
    rr.cascade_carry = cfg.tpu.cascade_carry
    keep = min(max(cfg.tpu.cascade_keep, cfg.r_topk), len(nodes))
    surv = np.argsort(-scores[False], kind="stable")[:keep]
    diff = np.abs(scores[True][surv] - scores[False][surv])
    scale = float(np.abs(scores[False][surv]).max())
    order = [[int(i) for i in np.argsort(-scores[c], kind="stable")[:cfg.r_topk]] for c in (False, True)]
    say(f"carried stage 2 vs re-score, {len(nodes)} candidates, {keep} survivors: largest difference {diff.max():.3e} "
        f"({diff.max() / scale:.3e} of the scores' scale {scale:.3e}, bound {CARRY_TOL}); top-{cfg.r_topk} "
        f"{order[1]} vs {order[0]}")
    check(bool((diff <= CARRY_TOL * scale).all()) and order[0] == order[1],
          "the carried cascade disagrees with the re-score path")

    # (2) w8a8 against the card's bf16 scorer on the same weights, one
    # 32-pair batch: the last hidden states' cosine (tests/test_w8a8.py's
    # bound) gates; the top-6 orders and the scores' gaps are reported. On
    # random weights the pairs' scores lie closer together than w8a8's score
    # error, so their order is not a property of the code (the CPU tests hold
    # the exact ranking at their small size)
    batch = [(q0["query"], n.node.text) for n in nodes[: cfg.r_embed_bs]]
    saved16 = scorer16.cutoff_layer, scorer16.use_efficient
    scorer16.cutoff_layer, scorer16.use_efficient = scorer.cutoff_layer, scorer.use_efficient  # the same head input
    h16, h8 = last_hidden(torch, scorer16, batch), last_hidden(torch, scorer, batch)
    cos = (h16 * h8).sum(-1) / (h16.norm(dim=-1) * h8.norm(dim=-1))
    s16, s8 = scorer16.score_pairs(batch)[0], scorer.score_pairs(batch)[0]
    scorer16.cutoff_layer, scorer16.use_efficient = saved16
    top16, top8 = [int(i) for i in np.argsort(-s16)[:cfg.r_topk]], [int(i) for i in np.argsort(-s8)[:cfg.r_topk]]
    gaps = -np.diff(np.sort(s16)[::-1][: cfg.r_topk + 2])
    say(f"w8a8 vs bf16, {len(batch)} pairs at cutoff {scorer.cutoff_layer}: last hidden cosine min "
        f"{float(cos.min()):.5f}, median {float(cos.median()):.5f} (bound 0.99); scores' largest difference "
        f"{float(np.abs(s8 - s16).max()):.4f}, median {float(np.median(np.abs(s8 - s16))):.4f}, bf16 scores' spread "
        f"{float(s16.max() - s16.min()):.4f}; top-{cfg.r_topk} w8a8 {top8} vs bf16 {top16} "
        f"({'equal' if top8 == top16 else 'different'}); bf16 gaps between the top {cfg.r_topk + 2}: "
        f"{[round(float(g), 4) for g in gaps]}")
    check(float(cos.min()) > 0.99, "w8a8's last hidden states stray from the bf16 scorer's")

    # (3) 2 layers against the CPU; (4) linear(a8) card vs CPU bits and the projections' times
    minicpm_w8a8_vs_cpu(torch, np, scorer, [(q0["query"], nodes[0].node.text[:120]), ("文档 t1 t2", nodes[1].node.text[:60])])
    ids, _ = scorer.build_inputs(batch)
    a8_projection_checks(torch, np, scorer, scorer16, ids.shape[1])

    # times: one 32-pair batch in bf16 and w8a8; the rerank stage in three modes
    t16 = cuda_ms(torch, lambda: scorer16.score_pairs(batch), reps=3)
    t8 = cuda_ms(torch, lambda: scorer.score_pairs(batch), reps=3)
    say(f"one {len(batch)}-pair batch (S={ids.shape[1]}, cutoff {scorer.cutoff_layer}): bf16 {t16:.1f} ms, "
        f"w8a8 {t8:.1f} ms ({t16 / t8:.2f}x)")
    rerank_stage_ms(torch, pipeline, scorer, cfg, queries[:1])

    phase_yes_logit(torch, np, batch, mods)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"peak device memory in phase 8: {peak:.2f} GiB")
    del pipeline, model, scorer



def phase_batch_eval(torch, np, tmp, pipeline, reranker, generator, mods):
    """The batch-evaluation path: ``cli.run_batch`` with the reranker loaded
    by name from a saved checkpoint, ``run_retrieval_batch`` over a 512-query
    stream, ``run_answers_batch`` with the int4 generator. Returns the
    launches of its three runs, each counted from 0 just before the run and
    read just after, and the 512-query stream (phase 11 scores it again)."""
    say("== phase 9: batch evaluation (the registry, the CLI, run_retrieval_batch, run_answers_batch)")
    import gc

    from transformers import AutoTokenizer

    from easyrag_tpu_torch import cli
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.generation import BatchingLocalLLM
    from easyrag_tpu_torch.models.decode import TorchCausalLM
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker

    scorer = reranker.scorer
    cfg = pipeline.config
    counts = {}

    def reset():
        for mod in mods.values():
            mod.launches = 0

    def read(run):
        counts[run] = {key: mod.launches for key, mod in mods.items()}
        return counts[run]

    rng = np.random.default_rng(SEED + 40)
    questions = stream_queries(np, rng, pipeline, BATCH_QUESTIONS, long_every=BATCH_QUESTIONS)
    val = [{"id": i, **q, "answer": "", "keywords": [q["query"].split()[0]]} for i, q in enumerate(questions)]
    with tempfile.TemporaryDirectory(prefix="easyrag_batch_") as work:
        # (1) phase 3's MiniCPM saved as a checkpoint, with a word tokenizer
        model_dir = os.path.join(work, "models", "bge-reranker-v2-minicpm-layerwise")
        t0 = time.perf_counter()
        save_minicpm_checkpoint(torch, scorer, RERANKER, model_dir, scorer.start_layer)
        save_word_tokenizer(model_dir, [f"t{t}" for t in range(VOCAB)] + [f"doc{f}" for f in range(N_DOCS)])
        size = os.path.getsize(os.path.join(model_dir, "model.safetensors"))
        say(f"checkpoint: {size / 2**30:.2f} GiB of bf16 weights and a word tokenizer saved to "
            f"{os.path.relpath(model_dir, work)} in {time.perf_counter() - t0:.1f} s")

        # (2) the CLI on configs/easyrag.yaml over phase 3's corpus, --re-only;
        # the registry loads the reranker by the directory's name
        qa = os.path.join(work, "qa")
        os.makedirs(qa)
        with open(os.path.join(qa, "val.json"), "w", encoding="utf-8") as fh:
            json.dump(val, fh, ensure_ascii=False)
        run_dir = os.path.join(work, "run")
        os.makedirs(run_dir)
        args = cli.parse_args(["--config", os.path.join(REPO, "configs", "easyrag.yaml"), "--split", "val",
                               "--re-only", "--note", "smoke", "--qa-dir", qa, "--set", f"data_path={tmp}",
                               "--set", f"reranker_name={model_dir}"])
        cwd = os.getcwd()
        os.chdir(run_dir)
        reset()
        t0 = time.perf_counter()
        try:
            asyncio.run(cli.run_batch(
                args, sparse_tokenizer=SparseTokenizer(),
                splitter=SentenceSplitter(cfg.chunk_size, cfg.chunk_overlap, token_counter=approx_token_count,
                                          sentence_splitter=lambda t: [t]),
            ))
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        t_cli = time.perf_counter() - t0
        got = read("cli")
        for name in ("outputs/submit_result_val_smoke.jsonl", "submit_result.jsonl", "inter/val_smoke.json"):
            check(os.path.exists(os.path.join(run_dir, name)), f"the CLI did not write {name}")
        with open(os.path.join(run_dir, "inter", "val_smoke.json"), encoding="utf-8") as fh:
            inter = json.load(fh)
        check(len(inter) == BATCH_QUESTIONS and all(len(r["candidates"]) == cfg.r_topk for r in inter),
              "the CLI's inter dump has the wrong shape")
        check(got["K1"] > 0 and got["K5"] > 0 and got["K6"] >= 2 * BATCH_QUESTIONS,
              f"the CLI's run missed a kernel: {got}")
        say(f"CLI (--re-only, {BATCH_QUESTIONS} val questions, one filtered, one of 80 terms; boot, checkpoint "
            f"load and the questions): {t_cli:.1f} s; launches {got}")
        word_tok = AutoTokenizer.from_pretrained(model_dir)
        gc.collect()
        torch.cuda.empty_cache()

    # (3) run_retrieval_batch over a 512-query stream, no reranker, against run
    pipeline.reranker, pipeline.re_only, pipeline.llm = None, True, StubLLM()
    stream = stream_queries(np, rng, pipeline, STREAM_QUERIES)
    n_long = sum(len(set(pipeline.sparse_retriever._tokenize_query(q["query"]))) > cfg.tpu.max_query_terms
                 for q in stream)
    reset()
    t0 = time.perf_counter()
    batch = asyncio.run(pipeline.run_retrieval_batch([dict(q) for q in stream]))
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    got = read("retrieval batch")
    t0 = time.perf_counter()
    singles = [asyncio.run(pipeline.run(dict(q))) for q in stream]
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    check(same_rows(batch, singles), "a batch row differs from its query's run (nodes, scores or contexts)")
    check(got["K5"] == n_long and got["K6"] >= 2 * (-(-STREAM_QUERIES // 64)),
          f"the batch run's launches {got} miss K5 on the {n_long} long rows or K6 in the top-ks")
    say(f"run_retrieval_batch, {STREAM_QUERIES} queries ({n_long} past the term budget, every 8th filtered): "
        f"{t_batch * 1e3:.1f} ms, {STREAM_QUERIES / t_batch:.1f} qps; run one by one {t_single * 1e3:.1f} ms, "
        f"{STREAM_QUERIES / t_single:.1f} qps ({t_single / t_batch:.2f}x); every row equal to run's (nodes, scores, "
        f"contexts); launches {got}")

    # (4) run_answers_batch with the int4 generator (gen batch 4) against run;
    # the reranker takes the checkpoint's tokenizer, so its contexts are the
    # CLI's too
    gcfg, gparams = generator
    model = TorchCausalLM.from_params(gcfg, gparams, QwenCharTokenizer(), QWEN2_EOS, max_new_tokens=BATCH_GEN_NEW,
                                      max_batch=GEN_BATCH, spec_tokens=GEN_SPEC)
    char_tok = scorer.tokenizer
    scorer.tokenizer = word_tok
    pipeline.local_llm, pipeline.reranker, pipeline.re_only = model, reranker, False
    pipeline.llm = BatchingLocalLLM(model, window_ms=cfg.serve_window_ms, max_batch=GEN_BATCH)
    check(pipeline._answers_via_local_llm(), "the staged answers would not use the local generator")
    try:
        reset()
        t0 = time.perf_counter()
        staged = asyncio.run(pipeline.run_answers_batch([dict(q) for q in questions]))
        torch.cuda.synchronize()
        t_staged = time.perf_counter() - t0
        got = read("staged answers")
        dispatches = [(st["bucket"], st["batch"]) for st in model.last_stats]
        t0 = time.perf_counter()
        seq = [asyncio.run(pipeline.run(dict(q))) for q in questions]
        torch.cuda.synchronize()
        t_seq = time.perf_counter() - t0
    finally:
        scorer.tokenizer = char_tok
    check(same_rows(staged, seq), "the staged answers' contexts differ from the sequential run's")
    check([r["contexts"] for r in seq] == [r["candidates"] for r in inter],
          "the CLI's contexts (the reranker loaded by name) differ from the in-memory reranker's")
    check(all(isinstance(r["answer"], str) and r["answer"] for r in staged), "a staged answer is empty")
    check(all(got[key] > 0 for key in ("K1", "K2", "K3", "K5", "K6")), f"the staged run missed a kernel: {got}")
    equal = sum(a["answer"] == b["answer"] for a, b in zip(staged, seq))
    say(f"run_answers_batch, {BATCH_QUESTIONS} questions ({BATCH_GEN_NEW} new tokens, spec {GEN_SPEC}): "
        f"{t_staged:.1f} s in dispatches (bucket, B) {dispatches}; run one by one {t_seq:.1f} s; contexts equal to "
        f"the sequential run's and to the CLI's bit for bit; answers equal on {equal}/{BATCH_QUESTIONS}; "
        f"launches {got}")
    del model, batch, singles
    gc.collect()
    return {key: sum(c[key] for c in counts.values()) for key in mods}, stream


def serve_queries(np, rng, pipeline, n):
    """``n`` queries for the server: :func:`stream_queries`' (12 words of a
    random node, every 8th filtered, the last of 80 words), each naming one
    of the corpus's four products (its dirs), as the dataset's questions
    name products. The know-path route then adds its top 6 past the content
    route's 192 (197-198 candidates: six full batches and a tail the
    coalescer can fill with another request's pairs); naming none, every
    request has exactly 192 candidates, six full batches, nothing to fill."""
    out = stream_queries(np, rng, pipeline, n, long_every=n)
    for q in out:
        q["query"] += " " + ("director", "emsplus", "rcp", "umac")[int(rng.integers(0, 4))]
    return out


def solo_greedy(torch, cfg, params, ids, bucket, max_new):
    """Tokens of ``ids`` alone: ``generate_greedy`` at B=1 at its bucket."""
    from easyrag_tpu_torch.models import decode as td

    dev = torch.device("cuda")
    row, mask = td._pad_left(list(ids), bucket, QwenCharTokenizer.pad_token_id)
    return td.generate_greedy(cfg, params, torch.tensor([row], dtype=torch.int32, device=dev),
                              torch.tensor([mask], dtype=torch.int32, device=dev),
                              torch.tensor(QWEN2_EOS, dtype=torch.int32, device=dev), max_new)[0].tolist()


def pool_schedule(pool, prompts, first_wave: int):
    """Admit ``prompts`` (name -> ids) in order: ``first_wave`` of them at
    the first chunk boundary, then one at each later boundary where a
    fitting tier has a free slot (head of line first). Returns each row's
    tokens and flat slot."""
    pending = list(prompts.items())
    results, slots = {}, {}
    boundary = 0
    while pending or pool.active:
        while pending and pool.can_admit(pending[0][1]) and (boundary > 0 or len(slots) < first_wave):
            name, ids = pending.pop(0)
            slots[name] = pool.insert(ids, name)
            if boundary > 0:
                break
        for handle, toks in pool.run_chunk():
            results[handle] = toks
        boundary += 1
    return results, slots


def replay_step_ops(torch, cfg, params, ids, bucket, toks, k, t_tier, max_new):
    """The first (layer, op) whose output differs between a solo step at B=1
    and the pool's step for the same row, at the forward that gives token
    ``k``: the solo state is rebuilt from the solo tokens; the pool's step
    runs the row in a two-row tier cache of ``t_tier`` slots beside a copy of
    itself (``PoolRows``, K2 at R=2). Each layer's two paths start from the
    solo path's input. None when every op gives the same bits."""
    from easyrag_tpu_torch.models import decode as td
    from easyrag_tpu_torch.models.layers import embed, qkv_proj, rms_norm, rope_tables
    from easyrag_tpu_torch.ops.flash64 import apply_rope

    dev = torch.device("cuda")
    eps, dtype = cfg.rms_norm_eps, params["final_norm"].dtype
    row, mask = td._pad_left(list(ids), bucket, QwenCharTokenizer.pad_token_id)
    s = bucket
    t = s + max_new
    cache = td.init_cache(cfg, 1, t, dtype, dev)
    with torch.inference_mode():
        td._prefill(cfg, params, torch.tensor([row], dtype=torch.int32, device=dev),
                    torch.tensor([mask], dtype=torch.int32, device=dev), cache)
        valid = torch.zeros(1, t, dtype=torch.bool, device=dev)
        valid[0, :s] = torch.tensor(mask, device=dev) > 0
        length = sum(mask)
        for step in range(1, k + 1):  # the forward whose input is token step-1
            pos = s + step - 1
            valid[:, pos] = True
            cos, sin = rope_tables(torch.tensor([[length + step - 1]], device=dev), cfg.hd, cfg.rope_theta)
            h = embed(cfg, params["embed"], torch.tensor([[toks[step - 1]]], device=dev), dtype)
            for li, p in enumerate(params["layers"]):
                if step < k:
                    h = td._decode_layer(cfg, p, h, pos, valid, cos, sin, cache[li])
                    continue
                pool_cache = {n: torch.zeros((2, t_tier + GEN_SPEC) + cache[li][n].shape[2:], dtype=dtype, device=dev)
                              for n in ("k", "v")}
                for n in ("k", "v"):
                    pool_cache[n][:, :t] = cache[li][n][0]
                rows = td.PoolRows(torch.arange(2, device=dev), ((0, t), (1, t)))
                ops = {}
                for name, x, c, norm in (("solo", h, cache[li], rms_norm),
                                         ("pool", h.expand(2, -1, -1).contiguous(), pool_cache,
                                          lambda x, w, e: td._row_norm(x, w, e, per_row=True))):
                    n_out = norm(x, p["input_norm"], eps)
                    q, kk, v = qkv_proj(cfg, p["attn"], n_out)
                    rc, rs = cos.expand(x.shape[0], -1, -1), sin.expand(x.shape[0], -1, -1)
                    q, kk = apply_rope(q, rc, rs), apply_rope(kk, rc, rs)
                    vv = valid.expand(x.shape[0], -1)
                    if name == "solo":
                        c["k"][:, pos], c["v"][:, pos] = kk[:, 0], v[:, 0]
                        att = td._attend_cache(cfg, q, *td._cache_operands(c, t), vv[:, None, :], dtype)
                    else:
                        c["k"][rows.index, pos], c["v"][rows.index, pos] = kk[:, 0], v[:, 0]
                        att = td._attend_rows(cfg, q, c, vv[:, None, :], rows, dtype)
                    out = td.mlp_residual(cfg, p, x, att, norm=norm)
                    ops[name] = {"input norm": n_out[:1], "q": q[:1], "k": kk[:1], "v": v[:1],
                                 "cache attention": att[:1], "layer output": out[:1]}
                for op in ops["solo"]:
                    if not torch.equal(ops["solo"][op], ops["pool"][op]):
                        return f"layer {li}, {op}"
                h = ops["solo"]["layer output"]
    return None


def pool_vs_solo(torch, np, cfg, params, model, smi):
    """(a): six prompts over both tiers, joining at chunk boundaries, one
    overflowing from the full 2048 tier; every row against its solo
    greedy run at B=1, plain and with spec 7."""
    from easyrag_tpu_torch.config import parse_pool_tiers
    from easyrag_tpu_torch.models.decode_pool import DecodePool

    rng = np.random.default_rng(SEED + 50)
    prompts = {f"p{i}:{n}": [int(t) for t in rng.integers(0, QwenCharTokenizer.N_PLAIN, size=n)]
               for i, n in enumerate(POOL_PROMPTS)}
    buckets = {name: model._bucket(len(ids)) for name, ids in prompts.items()}
    t0 = time.perf_counter()
    solo = {name: solo_greedy(torch, cfg, params, ids, buckets[name], model.max_new_tokens)
            for name, ids in prompts.items()}
    torch.cuda.synchronize()
    say(f"(a) solo greedy at B=1 for {len(prompts)} prompts (buckets {sorted(set(buckets.values()))}): "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    tiers = parse_pool_tiers(POOL_TIERS)
    small = tiers[0][0]
    for spec in (0, GEN_SPEC):
        model.spec_tokens = spec
        pool = DecodePool(model, chunk_steps=POOL_CHUNK, tiers=tiers)
        t0 = time.perf_counter()
        results, slots = pool_schedule(pool, prompts, first_wave=3)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = pool.stats
        overflow = [n for n, slot in slots.items() if buckets[n] <= small and slot >= tiers[0][1]]
        equal = {n: results[n] == solo[n] for n in prompts}
        say(f"(a) pool, spec {spec}: {len(prompts)} rows in {secs:.2f} s, {pool.chunks} chunk dispatches, "
            f"{pool.joins} joins into a live pool, slots {slots}, overflowed into the {tiers[1][0]} tier: "
            f"{overflow}; {st['steps']} steps, {st['row_steps'] / st['steps']:.2f} live rows a step, "
            f"{st['live_rows'] / pool.chunks:.2f} a chunk, {st['chunk_ms'] / st['steps']:.2f} ms a step "
            f"(host sync {st['sync_ms'] / st['steps']:.2f} ms of it); rows equal to solo: "
            f"{sum(equal.values())}/{len(prompts)} [{smi}]")
        check(bool(overflow), f"(a) spec {spec}: no request overflowed from the full {small} tier")
        check(pool.joins > 0, f"(a) spec {spec}: no request joined a live pool")
        for name, ok in equal.items():
            if not ok:
                k = next(i for i, (a, b) in enumerate(zip(results[name], solo[name])) if a != b)
                t_tier = next(b for b, _ in sorted(tiers) if b >= buckets[name]) + model.max_new_tokens
                where = replay_step_ops(torch, cfg, params, prompts[name], buckets[name], solo[name], k, t_tier,
                                        model.max_new_tokens)
                say(f"(a) spec {spec}: row {name} leaves its solo run at token {k}; first op that differs "
                    f"when the step is replayed: {where or 'none (every op of the replayed step agrees)'}")
        check(all(equal.values()), f"(a) spec {spec}: a pool row differs from its solo greedy run")
        del pool
    model.spec_tokens = GEN_SPEC
    return solo


async def serve_and_post(torch, app, queries, concurrency):
    """``app`` on 127.0.0.1 at an ephemeral port: ``GET /test``, ``GET
    /ui``, a CORS preflight, one warm request, then ``queries[1:]`` at
    ``concurrency`` (``tools/bench_serving.py``'s pattern). Returns the
    bodies, each request's seconds, the wall seconds and the launches the
    timed requests made (counts reset after the warm request)."""
    from aiohttp import ClientSession, ClientTimeout, web

    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    sem = asyncio.Semaphore(concurrency)
    try:
        async with ClientSession(timeout=ClientTimeout(total=1200)) as sess:
            async with sess.get(f"{base}/test") as r:
                check(r.status == 200 and await r.json() == "hello rag", "GET /test failed")
            async with sess.get(f"{base}/ui") as r:
                check(r.status == 200 and "/v1/rag" in await r.text(), "GET /ui failed")
            async with sess.options(f"{base}/v1/rag") as r:
                check(r.status == 200 and r.headers.get("Access-Control-Allow-Origin") == "*", "CORS preflight failed")

            async def one(q):
                async with sem:
                    t0 = time.perf_counter()
                    async with sess.post(f"{base}/v1/rag", json=q) as r:
                        body = await r.json()
                        check(r.status == 200, f"POST /v1/rag: {r.status} {body}")
                    return body, time.perf_counter() - t0

            await one(queries[0])  # warm, outside the timed window
            torch.cuda.synchronize()
            launches = reset_launches()
            t0 = time.perf_counter()
            out = await asyncio.gather(*(one(q) for q in queries[1:]))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = launches()
    finally:
        await runner.cleanup()
    return [b for b, _ in out], [s for _, s in out], wall, launches


def served(torch, app, queries):
    """:func:`serve_and_post` at ``SERVE_CONCURRENCY``, failing past
    ``SERVE_TIMEOUT_S``."""
    try:
        return asyncio.run(asyncio.wait_for(serve_and_post(torch, app, queries, SERVE_CONCURRENCY), SERVE_TIMEOUT_S))
    except asyncio.TimeoutError:
        raise SmokeFailure(f"the served requests did not finish in {SERVE_TIMEOUT_S} s") from None


def reset_launches():
    """Set every kernel wrapper's count to 0; returns the reader."""
    from easyrag_tpu_torch.ops import chunkmax, flash64, flash_attention, int4_matvec

    mods = {"K1": flash64, "K2": int4_matvec, "K3": flash_attention, "K6": chunkmax}
    for mod in mods.values():
        mod.launches = 0
    return lambda: {key: mod.launches for key, mod in mods.items()}


def latency_line(lat, wall, n_tokens):
    import numpy as np

    lat_ms = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    return (f"p50 {lat_ms[0]:.1f} ms, p99 {lat_ms[1]:.1f} ms, wall {wall:.2f} s, {len(lat) / wall:.3f} requests/s, "
            f"{n_tokens / wall:.1f} generated tokens/s")


def phase_serving(torch, np, tmp, scorer16, generator, smi):
    """The serving path: ``configs/four_tenant.yaml`` with the decode pool,
    through ``serving.api``; returns the launches of the served requests."""
    say("== phase 10: serving (configs/four_tenant.yaml, the decode pool, serving.api over a live socket)")
    import copy
    import gc

    from easyrag_tpu_torch.config import load_config
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.generation import BatchingLocalLLM, ContinuousBatchingLocalLLM
    from easyrag_tpu_torch.models.decode import TorchCausalLM
    from easyrag_tpu_torch.models.layers import quantize_layers_
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline
    from easyrag_tpu_torch.rerankers import LLMRerank
    from easyrag_tpu_torch.serving.api import create_app

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(os.path.join(REPO, "configs", "four_tenant.yaml"), overrides={
        "data_path": tmp, "tpu.local_llm_continuous": True, "tpu.local_llm_pool_tiers": POOL_TIERS,
        "tpu.local_llm_chunk_steps": POOL_CHUNK,
    })
    check((cfg.tpu.local_llm_spec, cfg.tpu.local_llm_max_new, cfg.tpu.local_llm_gen_batch, cfg.tpu.local_llm_warmup)
          == (GEN_SPEC, GEN_MAX_NEW, GEN_BATCH, True), "configs/four_tenant.yaml changed")
    gcfg, gparams = generator
    model = TorchCausalLM.from_params(gcfg, gparams, QwenCharTokenizer(), QWEN2_EOS,
                                      max_new_tokens=cfg.tpu.local_llm_max_new, max_batch=cfg.tpu.local_llm_gen_batch,
                                      spec_tokens=cfg.tpu.local_llm_spec, spec_ngram=cfg.tpu.local_llm_spec_ngram)
    before = reset_launches()
    pool_vs_solo(torch, np, gcfg, gparams, TorchCausalLM.from_params(
        gcfg, gparams, QwenCharTokenizer(), QWEN2_EOS, max_new_tokens=POOL_MAX_NEW,
        max_batch=cfg.tpu.local_llm_gen_batch, spec_tokens=cfg.tpu.local_llm_spec,
        spec_ngram=cfg.tpu.local_llm_spec_ngram), smi)
    got = before()
    say(f"(a) launches: {got}")
    check(got["K2"] > 0 and got["K3"] > 0, f"(a) K2 or K3 did not run: {got}")

    scorer = quantize_layers_(copy.deepcopy(scorer16), cfg.tpu.reranker_quant)
    scorer.use_efficient = cfg.r_use_efficient
    rr = LLMRerank(scorer, top_n=cfg.r_topk, embed_bs=cfg.r_embed_bs, embed_type=cfg.r_embed_type,
                   use_efficient=cfg.r_use_efficient, cascade_keep=cfg.tpu.cascade_keep,
                   cascade_carry=cfg.tpu.cascade_carry)
    # no checkpoint is in the repository: the pipeline's generator is
    # phase 5's seeded int4 model, behind the decode pool it builds itself
    saved = EasyRAGPipeline.__dict__["_make_local_llm"]
    EasyRAGPipeline._make_local_llm = staticmethod(lambda c, d: model)
    try:
        t0 = time.perf_counter()
        pipeline = EasyRAGPipeline(
            cfg, reranker=rr, sparse_tokenizer=SparseTokenizer(),
            splitter=SentenceSplitter(cfg.chunk_size, cfg.chunk_overlap, token_counter=approx_token_count,
                                      sentence_splitter=lambda t: [t]),
            device=torch.device("cuda"),
        )
    finally:
        EasyRAGPipeline._make_local_llm = saved
    torch.cuda.synchronize()
    wrapper = pipeline.llm
    check(isinstance(wrapper, ContinuousBatchingLocalLLM) and pipeline.local_llm is model,
          "the pipeline did not build the decode pool")
    pool = wrapper.pool
    say(f"pipeline boot: {len(pipeline.nodes)} chunks in {time.perf_counter() - t0:.1f} s; answers by the decode "
        f"pool, tiers {[(t.bucket, t.slots) for t in pool.tiers]}, chunk {pool.chunk_steps} steps, spec "
        f"{pool.spec_tokens}; its state {tree_bytes([t.state['caches'] for t in pool.tiers]) / 2**30:.3f} GiB")

    # the references, one query at a time without the server: run's
    # contexts and QA prompt (the carried cascade), then each prompt's
    # solo greedy answer at B=1
    rng = np.random.default_rng(SEED + 60)
    queries = serve_queries(np, rng, pipeline, SERVE_REQUESTS + 1)
    n_cand = [len(candidates(pipeline, q)) for q in queries[1:]]
    recorder = StubLLM()
    pipeline.llm = recorder
    t0 = time.perf_counter()
    ref = [asyncio.run(pipeline.run(dict(q))) for q in queries[1:]]
    t_ref = time.perf_counter() - t0
    pipeline.llm = wrapper
    model.spec_tokens = 0
    t0 = time.perf_counter()
    answers, new_tokens = [], 0
    for prompt in recorder.prompts:
        answers.append(model.generate_batch([prompt])[0])
        check(model.last_stats[0]["batch"] == 1, "a solo answer did not run at B=1")
        new_tokens += model.last_stats[0]["new_tokens"][0]
    model.spec_tokens = GEN_SPEC
    say(f"references: {SERVE_REQUESTS} queries ({n_cand} candidates) through run one at a time (the carried "
        f"cascade, no answer) in "
        f"{t_ref:.1f} s; their solo greedy answers at B=1 ({new_tokens} tokens) in {time.perf_counter() - t0:.1f} s")

    # (b) the server: the coalescer, the decode pool, the boot warmup
    t0 = time.perf_counter()
    app = create_app(pipeline)
    proxy = pipeline.reranker.scorer
    check(getattr(proxy, "coalesce", False) and pipeline.rerank_in_thread, "create_app did not install the coalescer")
    check(not pool.active and pool.chunks > 0, "the boot warmup did not run the pool")
    say(f"create_app (coalescer, kernel build, the pool's warmup over every (tier, bucket)): "
        f"{time.perf_counter() - t0:.1f} s")
    chunks0, stats0, joins0, n_disp = pool.chunks, dict(pool.stats), pool.joins, len(proxy.dispatch_sizes)
    bodies, lat, wall, launches = served(torch, app, queries)
    st = {k: pool.stats[k] - stats0.get(k, 0) for k in pool.stats}
    chunks, joins = pool.chunks - chunks0, pool.joins - joins0
    sizes, owners = list(proxy.dispatch_sizes)[n_disp:], list(proxy.dispatch_requests)[n_disp:]
    same_ctx = [b["contexts"] == r["contexts"] for b, r in zip(bodies, ref)]
    same_ans = [b["answer"] == a for b, a in zip(bodies, answers)]
    say(f"(b) served {SERVE_REQUESTS} requests at concurrency {SERVE_CONCURRENCY}: {latency_line(lat, wall, new_tokens)} "
        f"[{smi}]")
    say(f"(b) decode pool: {chunks} chunk dispatches, {st['live_rows'] / max(chunks, 1):.2f} live rows a chunk, "
        f"{st['row_steps'] / max(st['steps'], 1):.2f} a step, {st['steps']} steps at "
        f"{st['chunk_ms'] / max(st['steps'], 1):.2f} ms a step with the host sync "
        f"({st['sync_ms'] / max(st['steps'], 1):.2f} ms a step waiting in it), {joins} joins into a live pool "
        f"[{smi}]")
    say(f"(b) coalesced rerank dispatches: {len(sizes)}, sizes {sizes}, requests per dispatch {owners}")
    say(f"(b) launches during the timed requests: {launches}; contexts equal to run's: {sum(same_ctx)}/"
        f"{SERVE_REQUESTS}; answers equal to the solo B=1 answers: {sum(same_ans)}/{SERVE_REQUESTS}")
    if not all(same_ctx):
        # where the difference comes from: the same requests one at a time
        # through the coalescer (the cascade re-scores, no other request's
        # pairs in a batch) against the reference (the carried cascade)
        pipeline.llm = StubLLM()
        alone = [asyncio.run(pipeline.run(dict(q)))["contexts"] for q in queries[1:]]
        pipeline.llm = wrapper
        for i, ok in enumerate(same_ctx):
            if not ok:
                say(f"(b) request {i}: contexts alone through the coalescer equal run's: {alone[i] == ref[i]['contexts']}, "
                    f"equal the served ones: {alone[i] == bodies[i]['contexts']}")
    check(all(same_ctx), f"(b) a served response's contexts differ from run's: {same_ctx}")
    check(all(same_ans), f"(b) a served answer differs from its solo B=1 answer: {same_ans}")
    check(max(owners, default=0) > 1, "(b) no coalesced rerank dispatch held more than one request's pairs")
    check(joins > 0, "(b) no request joined a pool that already had a live row")
    check(launches["K1"] > 0 and launches["K2"] > 0 and launches["K3"] > 0, f"(b) K1, K2 or K3 did not run: {launches}")

    # (c) the same requests through BatchingLocalLLM (for comparison only)
    pipeline.llm = BatchingLocalLLM(model, window_ms=cfg.serve_window_ms, max_batch=cfg.tpu.local_llm_gen_batch)
    pipeline.config.tpu.local_llm_warmup = False  # the warm request covers it; nothing compiles per shape
    bodies_c, lat_c, wall_c, launches_c = served(torch, create_app(pipeline), queries)
    same_c = sum(b["answer"] == a for b, a in zip(bodies_c, answers))
    say(f"(c) BatchingLocalLLM (window {cfg.serve_window_ms} ms, batch {cfg.tpu.local_llm_gen_batch}), the same "
        f"requests: {latency_line(lat_c, wall_c, new_tokens)}; contexts equal to run's: "
        f"{sum(b['contexts'] == r['contexts'] for b, r in zip(bodies_c, ref))}/{SERVE_REQUESTS}; answers equal to "
        f"the solo answers: {same_c}/{SERVE_REQUESTS}; launches {launches_c} [{smi}]")
    proxy.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"peak device memory in phase 10: {peak:.2f} GiB")
    del pipeline, model, scorer, wrapper, pool
    gc.collect()
    return launches


def phase_options(torch, np, tmp, sparse, queries, reranker, generator, smi):
    """Phase 11: (a) the resident index in f32, bf16 and int8 and with the K5
    tail over phase 3's content index, phase 9's stream through each; (b)
    ``EasyRAGPipeline`` with the non-default options, cold and from its
    artifact. Returns ``(launches of the K5 tail's stream, the tail's
    timings)``."""
    say("== phase 11: compressed resident BM25 (bf16, int8), the K5 tail, the pipeline's non-default options")
    import gc

    from easyrag_tpu_torch import native
    from easyrag_tpu_torch.automerge import AutoMergingRetriever
    from easyrag_tpu_torch.config import load_config
    from easyrag_tpu_torch.corpus.hierarchical import HierarchicalSplitter
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.generation import BatchingLocalLLM
    from easyrag_tpu_torch.models.decode import TorchCausalLM
    from easyrag_tpu_torch.ops import bm25_resident as res
    from easyrag_tpu_torch.ops import bm25_scatter as k5
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline
    from easyrag_tpu_torch.rerankers import LLMRerank
    from easyrag_tpu_torch.utils import events

    from easyrag_tpu_torch.index.sparse import build_sparse_index

    dev = torch.device("cuda")
    index, tokens, dir_names = sparse["index"], sparse["tokens"], sparse["dirs"]
    # the native index builder against the Python builder on phase 3's content view
    built_by = {}
    for use_native in (True, False):
        native.builds = 0
        t0 = time.perf_counter()
        built_by[use_native] = build_sparse_index(sparse["corpus"], use_native=use_native)
        built_by[use_native] = (built_by[use_native], time.perf_counter() - t0, native.builds)
    (nat, t_nat, n_nat), (py, t_py, _) = built_by[True], built_by[False]
    check(n_nat == 1, "the native index builder did not build")
    check(nat.stats.vocab == py.stats.vocab == index.stats.vocab and all(
        np.array_equal(getattr(nat.stats, a), getattr(py.stats, a)) for a in ("doc_lens", "term_offsets", "post_docs", "post_tfs")
    ) and np.allclose(nat.post_vals, py.post_vals, rtol=1e-12, atol=0) and np.array_equal(nat.post_vals, index.post_vals),
          "the native builder's arrays differ from the Python builder's")
    say(f"native index builder, {nat.num_docs} chunks, {nat.num_postings} postings: {t_nat:.2f} s against the Python "
        f"builder's {t_py:.2f} s ({t_py / t_nat:.1f}x); the same arrays (post_vals within rtol 1e-12) [{smi}]")
    del built_by, nat, py
    cfg = load_config(os.path.join(REPO, "configs", "easyrag.yaml"), overrides={"data_path": tmp})
    T, k = cfg.tpu.max_query_terms, cfg.f_topk_2
    # the resident path's rows (past the 64-term budget a query takes the gather path)
    keep = [i for i, t in enumerate(tokens) if len(set(t)) <= T]
    dir_f = np.asarray([index.dir_vocab.get(d, -2) if d else -1 for d in dir_names], np.int32)[keep]

    # (a) f32, bf16 and int8 heavy storage at the default budget, and the K5 tail
    gc.collect()
    torch.cuda.empty_cache()
    results, built = {}, {}
    tail_launches, tail_times = 0, None
    for dtype, tail in (("float32", "xla"), ("bfloat16", "xla"), ("int8", "xla"), ("float32", "pallas")):
        t0 = time.perf_counter()
        r = res.ResidentSparseIndex(index, max_query_terms=T, heavy_dtype=dtype, tail=tail,
                                    heavy_hbm_budget=cfg.tpu.sparse_heavy_hbm_budget,
                                    light_rows_hbm_budget=cfg.tpu.sparse_light_rows_hbm_budget, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        ids, cnts = r.query_terms_batch([tokens[i] for i in keep])
        r.stream_from_arrays(ids[:64], cnts[:64], dir_f[:64], k)  # warm-up, not counted
        torch.cuda.synchronize()
        k5.launches = 0
        t0 = time.perf_counter()
        tv, ti = r.stream_from_arrays(ids, cnts, dir_f, k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = k5.launches
        n_batches = -(-len(keep) // 64)
        if tail == "pallas":
            check(launched == n_batches, f"the K5 tail launched {launched} times over {n_batches} stream batches")
            tail_launches = launched
        else:
            check(launched == 0, f"K5 launched {launched} times on the {dtype} stream without the tail")
        # a stream row equals its query alone, bit for bit
        for i in range(0, len(keep), 41):
            sv, si = r.score_topk([tokens[keep[i]]], k, dir_values=[dir_names[keep[i]]])
            check(np.array_equal(si[0], ti[i]) and np.array_equal(sv[0].view(np.uint32), tv[i].view(np.uint32)),
                  f"{dtype}/{tail}: stream row {i} differs from its query alone")
        heavy_bytes = r.heavy.numel() * r.heavy.element_size()
        results[(dtype, tail)] = (tv, ti)
        built[(dtype, tail)] = r
        same_cap = r.heavy.shape[0] * r.num_docs * 4  # f32 at this cap
        say(f"(a) {dtype} heavy, {tail} tail: cap {r.light_cap}, layout {r.light_layout}, heavy {tuple(r.heavy.shape)} "
            f"{heavy_bytes / 2**20:.1f} MiB on the card ({heavy_bytes / same_cap:.3f} of f32's at this cap); built in "
            f"{t_build:.1f} s; stream of {len(keep)} queries (top-{k}, every 8th filtered): {ms:.1f} ms, "
            f"{len(keep) / ms * 1e3:.1f} qps; every 41st row equal to its query alone bit for bit; "
            f"K5 launches {launched} [{smi}]")

    # the K5 tail's ranking against the scatter tail's (f32 sums in another order)
    (xv, xi), (pv, pi) = results[("float32", "xla")], results[("float32", "pallas")]
    fin = np.isfinite(xv)
    check(bool(np.array_equal(fin, np.isfinite(pv)) and np.allclose(pv[fin], xv[fin], rtol=1e-6, atol=0)),
          "the K5 tail's scores differ from the scatter tail's beyond f32 order")
    moved = int((pi != xi).sum())
    say(f"(a) K5 tail vs scatter tail, f32: scores within rtol 1e-6, {moved} of {xi.size} top-{k} positions "
        f"differ (ties and f32 order)")
    # bf16 and int8 against the exact f32 ranking: the same docs, nearly
    for dtype in ("bfloat16", "int8"):
        qv, qi = results[(dtype, "xla")]
        overlap = np.mean([len(set(a[np.isfinite(b)]) & set(c[np.isfinite(d)])) / max(1, np.isfinite(d).sum())
                           for a, b, c, d in zip(qi, qv, xi, xv)])
        say(f"(a) {dtype} top-{k} against f32's: mean overlap {overlap:.4f}")
        check(overlap > 0.9, f"the {dtype} ranking lost the f32 ranking (overlap {overlap:.3f})")

    # int8 on the card against the port's CPU run: the heavy part bit for
    # bit (both forms) and the top-k ids
    i8 = built[("int8", "xla")]
    t0 = time.perf_counter()
    cpu = res.ResidentSparseIndex(index, max_query_terms=T, heavy_dtype="int8",
                                  heavy_hbm_budget=cfg.tpu.sparse_heavy_hbm_budget,
                                  light_rows_hbm_budget=cfg.tpu.sparse_light_rows_hbm_budget, device="cpu")
    ids, cnts = cpu.query_terms_batch([tokens[i] for i in keep])
    for form, rows in (("gather", 64), ("onehot", 4)):  # 4 rows: the s8 product pads them to 17
        want = cpu.heavy_part(torch.from_numpy(ids[:rows]), torch.from_numpy(cnts[:rows]), form)
        got = i8.heavy_part(*i8._upload(ids[:rows], cnts[:rows]), form).cpu()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"the int8 heavy part ({form}) on the card differs from the CPU's")
    cv, ci = cpu.stream_from_arrays(ids, cnts, dir_f, k)
    tv8, ti8 = results[("int8", "xla")]
    check(np.array_equal(ci, ti8), "the int8 top-k ids on the card differ from the CPU run's")
    check(bool(np.allclose(cv, tv8, rtol=1e-6, atol=0) & np.array_equal(np.isfinite(cv), np.isfinite(tv8))),
          "the int8 top-k scores on the card differ from the CPU run's beyond f32 order")
    say(f"(a) int8 on the card vs the CPU: heavy part equal bit for bit (gather at 64 rows, one-hot at 4 rows padded "
        f"to 17), top-{k} ids of all {len(keep)} queries equal, scores within rtol 1e-6 ({time.perf_counter() - t0:.1f} "
        f"s with the CPU index build)")
    del cpu

    # K5 at the tail's shape: the first stream batch's light postings as
    # _score_topk sends them, [B, TL*C] int32 ids and f32 values
    tail = built[("float32", "pallas")]
    ids, cnts = tail.query_terms_batch([tokens[i] for i in keep[:64]])
    docs, vals = tail.light_postings(*tail._upload(ids, cnts), tail.light_t_bound(ids))
    args = (docs.reshape(64, -1).to(torch.int32), vals.reshape(64, -1).contiguous(), tail.num_docs)
    saved = k5.launches
    err = k5_compare(torch, k5, args)
    ms5 = cuda_ms(torch, lambda: k5.bm25_scores(*args))
    plain5 = cuda_ms(torch, lambda: k5.bm25_scores_plain(*args))
    t_ids, t_vals, N = args
    B, P = t_ids.shape
    flat_ids = torch.where((t_ids >= 0) & (t_ids < N), torch.arange(B, device=dev)[:, None] * (N + 1) + t_ids,
                           torch.arange(B, device=dev)[:, None] * (N + 1) + N).reshape(-1)
    acc = torch.zeros(B * (N + 1), device=dev)
    lib5 = cuda_ms(torch, lambda: acc.index_add_(0, flat_ids, t_vals.reshape(-1)))
    k5.launches = saved
    nbytes = t_ids.nbytes + t_vals.nbytes + B * N * 4
    b5 = bound(B * P, nbytes, PEAK_F32)  # one f32 add per posting
    real = int(((t_ids >= 0) & (t_ids < N)).sum())
    tail_times = (ms5, plain5, err, *b5, lib5)
    say(f"(a) K5 at the tail's shape [{B}, {P}] ({P // tail.light_cap} light slots of {tail.light_cap}; {real} real "
        f"postings, the rest sentinels): max_abs_err {err:.3e}, equal to the CPU's posting-order sums bit for bit; "
        f"kernel {ms5:.4f} ms ({nbytes / ms5 / 1e6:.1f} GB/s, {b5[0] / ms5:.1%} of the bound), plain {plain5:.4f} ms, "
        f"index_add_ {lib5:.4f} ms (kernel {lib5 / ms5:.2f}x as fast); bound {b5[0]:.5f} ms ({b5[1]}) [{smi}]")
    del built, results, tail, i8
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the pipeline with every non-default option but sharding
    gcfg, gparams = generator
    model = TorchCausalLM.from_params(gcfg, gparams, QwenCharTokenizer(), QWEN2_EOS, max_new_tokens=OPT_GEN_NEW,
                                      max_batch=GEN_BATCH, spec_tokens=GEN_SPEC)
    scorer = reranker.scorer
    with tempfile.TemporaryDirectory(prefix="easyrag_options_") as work:
        ocfg = load_config(os.path.join(REPO, "configs", "easyrag.yaml"), overrides={
            "data_path": tmp, "split_type": 1, "hyde": True, "hyde_merging": True, "compress_method": "bm25_extract",
            "index_artifact_path": os.path.join(work, "artifact"), "tpu.sparse_heavy_dtype": "int8",
        })

        def boot():
            split = [SentenceSplitter(n, ocfg.chunk_overlap, token_counter=approx_token_count,
                                      sentence_splitter=lambda t: [t]) for n in (ocfg.chunk_size * 4, ocfg.chunk_size)]
            rr = LLMRerank(scorer, top_n=ocfg.r_topk, embed_bs=ocfg.r_embed_bs, embed_type=ocfg.r_embed_type,
                           use_efficient=ocfg.r_use_efficient)
            seen = []
            off = events.on(lambda kind, payload: seen.append(kind))
            native.builds = 0
            t0 = time.perf_counter()
            try:
                p = EasyRAGPipeline(ocfg, llm=BatchingLocalLLM(model, window_ms=ocfg.serve_window_ms, max_batch=GEN_BATCH),
                                    reranker=rr, sparse_tokenizer=SparseTokenizer(),
                                    splitter=HierarchicalSplitter(splitters=split), device=dev)
                torch.cuda.synchronize()
            finally:
                off()
            return p, time.perf_counter() - t0, seen, native.builds

        def ask(p, label):
            from easyrag_tpu_torch.ops import chunkmax, flash64, flash_attention, int4_matvec

            mods = {"K1": flash64, "K2": int4_matvec, "K3": flash_attention, "K5": k5, "K6": chunkmax}
            out = []
            for name, q in (("short", dict(queries[0][1])), ("long, dir filter", {"query": queries[2][1]["query"],
                                                                                  "document": queries[1][2]})):
                stages = []
                off = events.on(lambda kind, payload: stages.append((payload["name"], payload["seconds"] * 1e3))
                                if kind == "timing" else None)
                for mod in mods.values():
                    mod.launches = 0
                t0 = time.perf_counter()
                try:
                    r = asyncio.run(p.run(q))
                    torch.cuda.synchronize()
                finally:
                    off()
                ms = (time.perf_counter() - t0) * 1e3
                got = {key: mod.launches for key, mod in mods.items()}
                n_terms = len(set(p.sparse_retriever._base._tokenize_query(q["query"] + q["hyde_query"])))
                split_ms = ", ".join(f"{n} {v:.1f} ms" for n, v in stages)
                say(f"(b) {label}, query {name!r} ({n_terms} distinct terms with its HyDE document, "
                    f"{'past' if n_terms > T else 'within'} the {T}-term budget): {ms:.1f} ms ({split_ms}); "
                    f"{len(r['contexts'])} contexts; launches {got} [{smi}]")
                check(len(r["contexts"]) == ocfg.r_topk and all(np.isfinite(n.score) for n in r["nodes"]),
                      f"(b) query {name!r}: wrong result")
                check(all(got[key] > 0 for key in ("K1", "K2", "K3", "K6")), f"(b) query {name!r} missed a kernel: {got}")
                check((got["K5"] > 0) == (n_terms > T), f"(b) query {name!r}: K5 launches {got['K5']} at {n_terms} terms")
                out.append((r, n_terms > T))
            return out

        gc.collect()
        torch.cuda.empty_cache()
        cold, t_cold, seen, n_native = boot()
        check("ingestion" in seen and "artifact" in seen and os.path.exists(os.path.join(work, "artifact", "manifest.json")),
              "(b) the cold boot did not ingest the corpus and save its artifact")
        check(n_native >= 2, f"(b) the native builder built {n_native} indexes at the cold boot (want both routes)")
        check(isinstance(cold.sparse_retriever, AutoMergingRetriever) and cold._dual_scorer is None
              and len(cold.all_nodes) > len(cold.nodes), "(b) split_type 1 did not take the hierarchical route")
        routes = (cold.sparse_retriever._base._resident, cold.path_retriever._resident)
        check(all(r.heavy_dtype == "int8" and r.heavy.dtype == torch.int8 for r in routes),
              "(b) tpu.sparse_heavy_dtype did not reach both routes")
        say(f"(b) cold boot: {len(cold.all_nodes)} nodes ({len(cold.nodes)} leaves), both indexes by the native builder "
            f"({n_native} builds), int8 heavy {tuple(routes[0].heavy.shape)} cap {routes[0].light_cap}, artifact saved: "
            f"{t_cold:.1f} s [{smi}]")
        first = ask(cold, "cold boot")
        ctx = first[0][0]["contexts"][0]
        packed = cold.compressor.compress(queries[0][1]["query"], ctx)
        check(0 < len(packed) <= len(ctx), "(b) the bm25_extract compressor returned nothing")
        say(f"(b) compressor (bm25_extract, rate {ocfg.compress_rate}): the first context {len(ctx)} -> {len(packed)} chars")
        del cold
        gc.collect()
        torch.cuda.empty_cache()
        warm, t_warm, seen, n_native = boot()
        check("artifact" in seen and "ingestion" not in seen and n_native == 0,
              "(b) the reboot did not come from the artifact")
        say(f"(b) reboot from the artifact: {len(warm.all_nodes)} nodes, no ingestion, no index build: {t_warm:.1f} s "
            f"(cold {t_cold:.1f} s) [{smi}]")
        second = ask(warm, "artifact reboot")
        for (a, _), (b, _) in zip(first, second):
            check(a["contexts"] == b["contexts"] and a["answer"] == b["answer"],
                  "(b) the artifact reboot's contexts or answer differ from the cold boot's")
        say(f"(b) the artifact reboot gives the cold boot's contexts and answers on {len(first)} of {len(first)} queries; "
            f"{sum(o for _, o in first)} of {len(first)} HyDE queries past the term budget (K5's overflow path)")
        del warm
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return tail_launches, tail_times


def crc_embedding(np, nodes):
    """An 8-wide vector per node from the CRC-32 of its text: the same in every
    process (the all-gather's payload where no embedder runs)."""
    import zlib

    return np.stack([np.full(8, (zlib.crc32(n.text.encode("utf-8")) % 1000) / 1000.0, np.float32) for n in nodes]) \
        if nodes else np.zeros((0, 8), np.float32)


def parse_files(docs):
    """Phase 3's chunking of ``docs`` (``configs/easyrag.yaml``'s chunk size,
    one chunk per one-part file)."""
    from easyrag_tpu_torch.config import load_config
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count

    cfg = load_config(os.path.join(REPO, "configs", "easyrag.yaml"))
    return SentenceSplitter(cfg.chunk_size, cfg.chunk_overlap, token_counter=approx_token_count,
                            sentence_splitter=lambda t: [t]).parse_documents(docs)


def multihost_worker(pid: int, nproc: int, port: int, corpus: str, out_dir: str) -> None:
    """One host of phase 12 (d): join the gloo group on a local port, parse
    and save its round-robin share of ``corpus``, all-gather the shards'
    vectors, save what came back."""
    import numpy as np
    import torch.distributed as dist

    from easyrag_tpu_torch.corpus.reader import read_data
    from easyrag_tpu_torch.parallel.multihost import allgather_shard_embeddings, build_shard, init_distributed

    init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    nodes = build_shard(read_data(corpus), pid, nproc, parse_files, out_dir, embed_fn=lambda n: crc_embedding(np, n))
    np.save(os.path.join(out_dir, f"gathered_{pid}.npy"), allgather_shard_embeddings(crc_embedding(np, nodes)))
    dist.destroy_process_group()


def phase_sharded(torch, np, tmp, sparse, queries, reranker, phase3_contexts, mods, smi):
    """Phase 12: sharded retrieval on one card. (a) phase 3's content index as
    ``ShardedResidentSparseIndex`` at D = 4 and 3 on ``["cuda:0"] * D`` in f32,
    bf16 and int8, rows and CSR, at the single-chip index's cap, phase 9's
    stream and phase 3's queries against the single-chip index bit for bit;
    (b) phase 7's 20,000 x 3584 index as ``ShardedDenseIndex`` at D = 4 in bf16
    and int8, a 64-query top-288 stream against ``DenseIndex``; (c)
    ``EasyRAGPipeline`` on ``configs/easyrag.yaml`` with ``tpu.shard_index`` and
    an injected 4-shard mesh, phase 3's queries against phase 3's contexts; (d)
    two gloo processes building shards of 512 files, all-gathered and
    assembled, against a one-process build."""
    say("== phase 12: sharded retrieval on one card (resident BM25, dense, the pipeline, the multi-host build)")
    import gc
    import shutil
    import socket

    from easyrag_tpu_torch.config import load_config
    from easyrag_tpu_torch.corpus.reader import read_data
    from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
    from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
    from easyrag_tpu_torch.index.dense import DenseIndex
    from easyrag_tpu_torch.index.sparse import build_sparse_index
    from easyrag_tpu_torch.ops.bm25_resident import ResidentSparseIndex
    from easyrag_tpu_torch.parallel.mesh import make_mesh
    from easyrag_tpu_torch.parallel.multihost import assemble_shards, shard_documents
    from easyrag_tpu_torch.parallel.sharded import ShardedDenseIndex, ShardedResidentSparseIndex
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline

    dev = torch.device("cuda")
    k5, k6 = mods["K5"], mods["K6"]
    label = "shards on one card, not a scaling figure"

    def bits_equal(a, b):
        (av, ai), (bv, bi) = a, b
        return np.array_equal(ai, bi) and np.array_equal(np.asarray(av).view(np.uint32), np.asarray(bv).view(np.uint32))

    def timed(fn):
        fn()  # warm-up, not counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # (a) the resident index, sharded at the single-chip index's cap and layout
    index, tokens, dir_names = sparse["index"], sparse["tokens"], sparse["dirs"]
    cfg = load_config(os.path.join(REPO, "configs", "easyrag.yaml"), overrides={"data_path": tmp})
    T, k = cfg.tpu.max_query_terms, cfg.f_topk_2
    keep = [i for i, t in enumerate(tokens) if len(set(t)) <= T]
    dir_f = np.asarray([index.dir_vocab.get(d, -2) if d else -1 for d in dir_names], np.int32)[keep]
    n_batches = -(-len(keep) // 64)
    tok = SparseTokenizer()
    named = [(name, toks, q.get("document")) for (name, q, _), toks in zip(queries, sparse["queries"], strict=True)]
    for dtype in ("float32", "bfloat16", "int8"):
        for rows in (True, False):
            single = ResidentSparseIndex(index, max_query_terms=T, heavy_dtype=dtype, light_rows=rows,
                                         heavy_hbm_budget=cfg.tpu.sparse_heavy_hbm_budget,
                                         light_rows_hbm_budget=cfg.tpu.sparse_light_rows_hbm_budget, device=dev)
            ids, cnts = single.query_terms_batch([tokens[i] for i in keep])
            want, ms1 = timed(lambda: single.stream_from_arrays(ids, cnts, dir_f, k))
            single_mib = sum(t.numel() * t.element_size() for t in (
                single.heavy, single.heavy_scales, single.post_docs, single.post_vals, single.t_starts,
                single.t_light_lens, single.t_heavy_row, single.dir_col) if t is not None) / 2**20
            for d in (4, 3):
                mesh = make_mesh([d], devices=["cuda:0"] * d)
                t0 = time.perf_counter()
                sh = ShardedResidentSparseIndex(mesh, index, light_cap=single.light_cap, max_query_terms=T,
                                                heavy_dtype=dtype, light_rows=rows)
                torch.cuda.synchronize()
                t_build = time.perf_counter() - t0
                check(len(sh.shards) == d and sh.light_layout == single.light_layout and sh.H == single.heavy.shape[0],
                      f"(a) {dtype}: the sharded index does not hold the single-chip split")
                sh.stream_from_arrays(ids[:64], cnts[:64], dir_f[:64], k)  # warm-up, not counted
                torch.cuda.synchronize()
                k6.launches = k5.launches = 0
                t0 = time.perf_counter()
                got = sh.stream_from_arrays(ids, cnts, dir_f, k)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                l6, l5 = k6.launches, k5.launches
                check(bits_equal(got, want), f"(a) {dtype}/{single.light_layout}, D={d}: the sharded stream's "
                      "top-k differs from the single-chip index's")
                check(l6 == d * n_batches and l5 == 0,
                      f"(a) D={d}: K6 launched {l6} times (want {d} shards x {n_batches} batches), K5 {l5}")
                alone = 0
                for name, toks, dname in named:
                    if len(set(toks)) > T:
                        continue  # past the term budget: the gather path, (c) runs it
                    a = sh.score_topk([toks], k, dir_values=[dname])
                    check(bits_equal(a, single.score_topk([toks], k, dir_values=[dname])),
                          f"(a) {dtype}, D={d}: query {name!r} alone differs from the single-chip index")
                    alone += 1
                per = [b / 2**20 for b in sh.device_bytes()]
                say(f"(a) {dtype} heavy, {sh.light_layout} (cap {sh.light_cap}, H {sh.H}), D={d} ({label}): "
                    f"shards of {[s.num_docs for s in sh.shards]} docs, {', '.join(f'{m:.1f}' for m in per)} MiB "
                    f"on the card each (single-chip {single_mib:.1f} MiB); built in {t_build:.1f} s; stream of "
                    f"{len(keep)} queries: {ms:.1f} ms sharded vs {ms1:.1f} ms single-chip; top-{k} equal bit for "
                    f"bit, and phase 3's {alone} queries within the budget alone; K6 launches {l6} "
                    f"({l6 // d} per shard, one a batch), K5 {l5} [{smi}]")
                del sh
            del single
            gc.collect()
            torch.cuda.empty_cache()

    # (b) the dense index at phase 7's size, 4 shards, bf16 and int8
    rng = np.random.default_rng(SEED + 9)
    dim, kd = GTE_QWEN2_7B["hidden_size"], 288
    emb = rng.standard_normal((INDEX_ROWS, dim), dtype=np.float32)
    dirs = [("director", "emsplus", "rcp", "umac")[i % 4] for i in range(INDEX_ROWS)]
    near = rng.choice(INDEX_ROWS, size=32, replace=False)
    q64 = np.concatenate([emb[near] + 0.5 * rng.standard_normal((32, dim), dtype=np.float32),
                          rng.standard_normal((32, dim), dtype=np.float32)])
    dvals = [("rcp" if i % 8 == 5 else None) for i in range(64)]
    mesh4 = make_mesh([4], devices=["cuda:0"] * 4)
    for dtype in ("bfloat16", "int8"):
        single = DenseIndex.build(emb, dirs=dirs, dtype=dtype, device=dev)
        sh = ShardedDenseIndex.build(mesh4, emb, dirs=dirs, dtype=dtype)
        want, ms1 = timed(lambda: single.query_stream(q64, kd, dir_values=dvals))
        k6.launches = 0
        got, ms = timed(lambda: sh.query_stream(q64, kd, dir_values=dvals))
        l6 = k6.launches
        exact = bits_equal(got, want)
        (gv, gi), (wv, wi) = got, want
        if dtype == "int8":
            check(exact, "(b) int8: the sharded top-288 differs from DenseIndex's (exact integer products)")
        else:
            check(bool(np.allclose(gv, wv, rtol=1e-5, atol=0)), "(b) bf16: sharded scores differ beyond rtol 1e-5")
            moved = gi != wi
            close = np.abs(np.diff(wv, axis=1)) <= 1e-5 * np.abs(wv[:, 1:])
            tied = np.zeros_like(moved)
            tied[:, 1:] |= close
            tied[:, :-1] |= close
            check(not (moved & ~tied).any(), "(b) bf16: a sharded index differs where the scores are distinct")
        check(l6 == 2 * 4, f"(b) {dtype}: K6 launched {l6} times, want 4 shards x 1 batch (x2 with the warm-up)")
        per = [b / 2**20 for b in sh.device_bytes()]
        say(f"(b) {dtype} dense {INDEX_ROWS} x {dim}, D=4 ({label}): shards of {[s.width for s in sh.shards]} rows, "
            f"{', '.join(f'{m:.1f}' for m in per)} MiB on the card each; 64-query top-{kd} stream (every 8th "
            f"filtered): {ms:.2f} ms sharded vs {ms1:.2f} ms single-chip; "
            f"{'equal bit for bit' if exact else 'ids equal where scores are distinct, scores within rtol 1e-5'}; "
            f"K6 launches {l6 // 2} a stream (one per shard) [{smi}]")
        del single, sh
    del emb
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the pipeline with tpu.shard_index over an injected 4-shard mesh
    cfg = load_config(os.path.join(REPO, "configs", "easyrag.yaml"), overrides={"data_path": tmp, "tpu.shard_index": True})
    t0 = time.perf_counter()
    pipeline = EasyRAGPipeline(
        cfg, llm=StubLLM(), reranker=reranker, sparse_tokenizer=SparseTokenizer(),
        splitter=SentenceSplitter(cfg.chunk_size, cfg.chunk_overlap, token_counter=approx_token_count,
                                  sentence_splitter=lambda t: [t]),
        device=dev, mesh=mesh4,
    )
    torch.cuda.synchronize()
    res = pipeline.sparse_retriever._resident
    check(isinstance(res, ShardedResidentSparseIndex) and pipeline._dual_scorer is None,
          "(c) tpu.shard_index did not shard the resident index")
    say(f"(c) pipeline boot with tpu.shard_index over 4 shards on one card: {time.perf_counter() - t0:.1f} s; content "
        f"index cap {res.light_cap}, layout {res.light_layout}, H {res.H}, shards of "
        f"{[s.num_docs for s in res.shards]} docs")
    for (name, q, _), want_ctx in zip(queries, phase3_contexts, strict=True):
        for mod in mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        out = asyncio.run(pipeline.run(dict(q)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {key: mod.launches for key, mod in mods.items()}
        n_terms = len(set(pipeline.sparse_retriever._tokenize_query(q["query"])))
        check(out["contexts"] == want_ctx, f"(c) query {name!r}: contexts differ from phase 3's pipeline")
        check(got["K1"] > 0 and got["K6"] >= 4, f"(c) query {name!r}: K1 or the per-shard K6 did not run: {got}")
        check((got["K5"] > 0) == (n_terms > T), f"(c) query {name!r} ({n_terms} terms): K5 launches {got['K5']}")
        say(f"(c) query {name!r} ({n_terms} distinct terms): {ms:.1f} ms; contexts equal to phase 3's pipeline; "
            f"launches {got}")
    del pipeline, res
    gc.collect()

    # (d) two gloo processes build shards of 512 files, all-gather, assemble
    work = tempfile.mkdtemp(prefix="easyrag_multihost_")
    corpus, out = os.path.join(work, "corpus"), os.path.join(work, "shards")
    sub_corpus(tmp, corpus, 512)
    os.makedirs(out)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    code = "import sys, chip_smoke; chip_smoke.multihost_worker(int(sys.argv[1]), 2, int(sys.argv[2]), sys.argv[3], sys.argv[4])"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid), str(port), corpus, out], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    t_mh = time.perf_counter() - t0
    for p, log in zip(procs, logs):
        check(p.returncode == 0, f"(d) a gloo worker failed: {log[-1500:]}")
    nodes, assembled = assemble_shards(out)
    docs = read_data(corpus)
    direct = [n for pid in range(2) for n in parse_files(shard_documents(docs, pid, 2))]
    gathered = [np.load(os.path.join(out, f"gathered_{pid}.npy")) for pid in range(2)]
    check([n.text for n in nodes] == [n.text for n in direct] and [n.metadata for n in nodes] == [n.metadata for n in direct],
          "(d) the assembled nodes differ from the one-process build")
    want_emb = crc_embedding(np, direct)
    check(all(np.array_equal(g, want_emb) for g in gathered) and np.array_equal(assembled, want_emb),
          "(d) the all-gathered vectors differ from the one-process build's")
    toks = [tok.cut(n.text) for n in nodes]
    a, b = build_sparse_index(toks), build_sparse_index([tok.cut(n.text) for n in direct])
    check(np.array_equal(a.stats.post_docs, b.stats.post_docs) and np.array_equal(a.post_vals, b.post_vals),
          "(d) the index over the assembled nodes differs from the one-process build's")
    sizes = [len(np.load(os.path.join(out, d, "emb.npy"))) for d in sorted(os.listdir(out)) if d.startswith("shard_")]
    say(f"(d) two gloo processes on the card's host: shards of {sizes} chunks of {len(docs)} files, all-gathered and "
        f"assembled in {t_mh:.1f} s (process start included); nodes, vectors and the BM25 index equal to the "
        f"one-process build")
    shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from easyrag_tpu_torch.ops import bm25_scatter as k5
        from easyrag_tpu_torch.ops import flash64 as f64
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 1
    # torch.compile's caches (the flex_attention yardstick) stay in the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(REPO, "build", sub))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from easyrag_tpu_torch.corpus.views import get_node_content
    from easyrag_tpu_torch.ops import chunkmax as k6
    from easyrag_tpu_torch.ops import flash_attention as k3
    from easyrag_tpu_torch.ops import flash_softcap as k4
    from easyrag_tpu_torch.ops import int4_matvec as k2

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(name):
        """Say the seconds a phase took (the smoke must end inside its time limit)."""
        laps.append(time.perf_counter())
        say(f"[{name}: {laps[-1] - laps[-2]:.1f} s, {laps[-1] - t_start:.1f} s in all]")

    try:
        smi = phase_env(torch)
        phase_build()
        errs = phase_kernels(torch, f64, k5)
        k6_times = phase_chunkmax(torch, k6)
        new_errs, new_times, extra = phase_new_kernels(torch, np, k2, k3)
        lap("phases 0-2")
        with tempfile.TemporaryDirectory(prefix="easyrag_smoke_") as tmp:
            pipeline, minicpm, queries, launches, mask, P, contexts3 = phase_pipeline(torch, np, f64, k5, k6, tmp)
            timings = phase_main_shapes(torch, np, f64, k5, mask, P)
            lap("phases 3-4")
            gen_launches, _, generator = phase_generator(torch, np, pipeline, queries, f64, k2, k3, k5)
            lap("phase 5")
            mods = {"K1": f64, "K2": k2, "K3": k3, "K4": k4, "K5": k5, "K6": k6}
            gemma_launches, k4_err, k4_times, _ = phase_gemma(torch, np, pipeline, queries, mods)
            lap("phase 6")
            dense_launches, k3e_err, k3e_times, k3e_main = phase_dense(torch, np, tmp, pipeline, minicpm, queries, mods)
            lap("phase 7")
            phase_flagship(torch, np, tmp, minicpm.scorer, generator, queries, mods)
            lap("phase 8")
            batch_launches, stream = phase_batch_eval(torch, np, tmp, pipeline, minicpm, generator, mods)
            sr = pipeline.sparse_retriever
            sparse = {"index": sr.index, "tokens": [sr._tokenize_query(q["query"]) for q in stream],
                      "dirs": [q.get("document") for q in stream],
                      "queries": [sr._tokenize_query(q["query"]) for _, q, _ in queries],
                      "corpus": [sr._tokenize_query(get_node_content(n, sr.embed_type)) for n in pipeline.nodes]}
            del pipeline, sr
            lap("phase 9")
            serve_launches = phase_serving(torch, np, tmp, minicpm.scorer, generator, smi)
            lap("phase 10")
            tail_launches, tail_times = phase_options(torch, np, tmp, sparse, queries, minicpm, generator, smi)
            lap("phase 11")
            phase_sharded(torch, np, tmp, sparse, queries, minicpm, contexts3, mods, smi)
            lap("phase 12")
        loaded = [m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "easyrag_tpu")]
        check(not loaded, f"something imported JAX or the JAX package: {sorted(loaded)[:5]}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s; phase 10's served requests "
        f"launched {serve_launches}")
    def entry(name, source, replaces, n, err, ms, plain, bound_ms, bound_by, library_ms):
        return {"name": name, "route": "cuda", "source": f"easyrag_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    k1, k5t = timings["K1"], timings["K5"]
    kernels = [
        entry("flash64_attention", "flash64.cu", "easyrag_tpu/ops/flash64.py:198", launches["K1"],
              max(errs["K1"], k1[2]), k1[0], k1[1], *k1[3:]),
        entry("bm25_scores", "bm25_scatter.cu", "easyrag_tpu/ops/bm25_pallas.py:88", launches["K5"],
              max(errs["K5"], k5t[2]), k5t[0], k5t[1], *k5t[3:]),
        entry("int4_matvec", "int4_matvec.cu", "easyrag_tpu/ops/int4_matvec.py:112", gen_launches["K2"],
              new_errs["K2"], *new_times[("gateup", 1)], *extra["K2"]),
        entry("flash_attention", "flash_attention.cu", "easyrag_tpu/models/decode.py:130", gen_launches["K3"],
              new_errs["K3"], *new_times[("K3", 1, 7680, "left", 128)], *extra["K3"]),
        entry("flash_softcap_attention", "flash_softcap.cu", "easyrag_tpu/ops/flash_softcap.py:136",
              gemma_launches["K4"], k4_err, *k4_times[(32, 1152)]),
        entry("flash_attention", "flash_attention.cu", "easyrag_tpu/models/layers.py:351", dense_launches["K3"],
              k3e_err, *k3e_times[k3e_main]),
        entry("chunk_max", "chunkmax.cu", "tools/exp_chunkmax.py:131", batch_launches["K6"], 0.0,
              *k6_times[(64, 20_000)]),
        entry("bm25_scores", "bm25_scatter.cu", "easyrag_tpu/ops/bm25_resident.py:141", tail_launches,
              tail_times[2], tail_times[0], tail_times[1], *tail_times[3:]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
