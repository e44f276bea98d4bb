#!/usr/bin/env python3
"""Smoke test of easyrag_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one raises on failure; nothing falls back to the CPU):

0. environment: Python/torch/CUDA versions, the card's ``nvidia-smi`` name
   and power limit, ``nvcc``, and which of yaml/jieba/transformers import;
1. build both CUDA kernels from ``easyrag_tpu_torch/csrc`` with ``nvcc``;
2. each kernel against its plain PyTorch version on the card: K1
   (``flash64_attention``) at B=4, S=1064, H=36 with and without RoPE on
   both padding sides, K5 (``bm25_scores``) at P=32768, N=20000 for B=1
   and B=4; max error and median times from CUDA events;
3. the port's ``EasyRAGPipeline.run`` on ``configs/easyrag.yaml`` over a
   seeded synthetic corpus of 20,000 chunks, with the full-width
   bge-reranker-v2-minicpm-layerwise (hidden 2304, 36x64 heads, 40 layers,
   vocab 122,753; random bf16 weights from a seeded ``torch.Generator``), a
   character tokenizer with right padding, and a stub in place of the GLM-4
   client. Three queries: a short one, one with a ``document`` dir filter,
   one with more than 64 distinct terms. Kernel launch counts are reset just
   before the three runs and read just after; K1 must run on every query
   and K5 on the long one. The content route's top-192 must equal the
   float64 host ranking (ties aside) and the reranker must agree with an f32
   CPU run of its first 8 layers on a small input;
4. both kernels against their plain versions at the pipeline's own shapes.

Prints one JSON line of kernel results, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import asyncio
import dataclasses
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
RERANKER = dict(
    vocab_size=122_753, hidden_size=2304, intermediate_size=5760, num_hidden_layers=40,
    num_attention_heads=36, num_key_value_heads=36, scale_emb=12.0, scale_depth=1.4,
    dim_model_base=256.0,
)


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
        from easyrag_tpu.generation import CompletionResponse

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
    for mod in ("yaml", "jieba", "transformers"):
        proc = subprocess.run([sys.executable, "-c", f"import {mod}"], capture_output=True, timeout=300)
        say(f"import {mod}: {'ok' if proc.returncode == 0 else 'missing'}")
    return smi


def phase_build():
    say("== phase 1: kernel build")
    from easyrag_tpu_torch import _build

    t0 = time.perf_counter()
    for name in ("flash64", "bm25_scatter"):
        _build.load(name)
        usage = [ln.strip() for ln in _build.build_logs.get(name, "").splitlines() if "registers" in ln]
        say(f"{name}: {usage[0] if usage else 'loaded from the build cache'}")
    say(f"kernel build: {time.perf_counter() - t0:.2f} s")


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


def k5_case(torch, B, P, N, gen):
    dev = torch.device("cuda")
    ids = torch.randint(0, N + 1, (B, P), generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
    vals = torch.rand(B, P, generator=gen, device=dev)
    vals = torch.where(ids == N, 0.0, vals)  # the sentinel carries value 0
    return ids, vals, N


def k5_compare(torch, k5, args):
    got = k5.bm25_scores(*args)
    again = k5.bm25_scores(*args)
    ref = k5.bm25_scores_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "K5 is not deterministic")
    err = float((got - ref).abs().max())
    check(bool(((got - ref).abs() <= K5_RTOL * ref.abs() + 1e-6).all()), f"K5 disagrees with its plain version (max abs {err})")
    return err


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
    for B in (1, 4):
        args = k5_case(torch, B, 32768, N_DOCS, gen)
        err = k5_compare(torch, k5, args)
        errs["K5"] = max(errs["K5"], err)
        ms = cuda_ms(torch, lambda: k5.bm25_scores(*args))
        plain = cuda_ms(torch, lambda: k5.bm25_scores_plain(*args))
        say(f"K5 B={B} P=32768 N={N_DOCS}: max_abs_err {err:.3e}; kernel {ms:.3f} ms, plain {plain:.3f} ms")
    return errs


def host_route_check(np, pipeline, query, dir_name, k):
    """The content route's device top-k against the float64 host ranking:
    the true score at every rank must equal the host's sorted score at that
    rank (rel 1e-5), so indices may differ only among tied scores."""
    from easyrag_tpu.schema import QueryBundle

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


def phase_pipeline(torch, np, f64, k5, tmp):
    say("== phase 3: EasyRAGPipeline.run, default config, 20k chunks, full-width reranker")
    from easyrag_tpu.config import load_config
    from easyrag_tpu.corpus.splitter import SentenceSplitter
    from easyrag_tpu.corpus.tokenizer import approx_token_count
    from easyrag_tpu.rerankers import LLMRerank
    from easyrag_tpu.schema import QueryBundle
    from easyrag_tpu.utils import events
    from easyrag_tpu_torch.models.layers import DecoderConfig
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline

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

    candidates, stages = [], []

    def listen(kind, payload):
        if kind == "reranking" and "candidates" in payload:
            candidates.append(payload["candidates"])
        elif kind == "timing":
            stages.append((payload["name"], payload["seconds"] * 1e3))

    unsubscribe = events.on(listen)
    results = []
    f64.launches = 0
    k5.launches = 0
    for name, q, _ in queries:
        k1_0, k5_0 = f64.launches, k5.launches
        t = time.perf_counter()
        out = asyncio.run(pipeline.run(dict(q)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        results.append((name, q, out, ms, f64.launches - k1_0, k5.launches - k5_0, dict(stages)))
        stages.clear()
    launches = {"K1": f64.launches, "K5": k5.launches}
    unsubscribe()

    for (name, q, out, ms, dk1, dk5, st), n_cand in zip(results, candidates, strict=True):
        n_terms = len(set(pipeline.sparse_retriever._tokenize_query(q["query"])))
        split = ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        say(f"query {name!r} ({n_terms} distinct terms): {ms:.1f} ms ({split}); {n_cand} candidates; "
            f"top-6 {[n.node.idx for n in out['nodes']]}; K1 launches {dk1}, K5 launches {dk5}")
        check(dk1 > 0, f"K1 did not run on query {name!r}")
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

    # shapes of the main path, for phase 4
    cand = pipeline.sparse_retriever.retrieve(QueryBundle(query_str=queries[0][1]["query"]))[:32]
    batch = [(queries[0][1]["query"], n.node.text) for n in cand]
    ids, mask = scorer.build_inputs(batch)
    long_tokens = pipeline.sparse_retriever._tokenize_query(queries[2][1]["query"])
    idx = pipeline.sparse_retriever.index
    long_ids, _ = idx.gather_postings(idx.query_term_ids(long_tokens), pad_to=cfg.tpu.max_query_postings, bucket=True)
    return launches, mask, len(long_ids)


def phase_main_shapes(torch, f64, k5, mask, P):
    say("== phase 4: kernels vs plain versions at the pipeline's shapes")
    from easyrag_tpu_torch.models.minicpm import key_ranges

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, S = mask.shape
    start, end = key_ranges(mask)
    args = k1_case(torch, B, S, 36, gen, True, "right", (end - start).tolist())
    err, row_rel = k1_compare(torch, f64, args)
    ms = cuda_ms(torch, lambda: f64.flash64_attention(*args))
    plain = cuda_ms(torch, lambda: f64.flash64_attention_plain(*args), reps=3, warmup=1)
    say(f"K1 B={B} S={S} H=36 rope pad=right: max_abs_err {err:.3e} (row-relative {row_rel:.3e}); "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
    timings = {"K1": (ms, plain, err)}
    args5 = k5_case(torch, 1, P, N_DOCS, gen)
    err5 = k5_compare(torch, k5, args5)
    ms5 = cuda_ms(torch, lambda: k5.bm25_scores(*args5))
    plain5 = cuda_ms(torch, lambda: k5.bm25_scores_plain(*args5))
    say(f"K5 B=1 P={P} N={N_DOCS}: max_abs_err {err5:.3e}; kernel {ms5:.3f} ms, plain {plain5:.3f} ms")
    timings["K5"] = (ms5, plain5, err5)
    return timings


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = phase_env(torch)
        phase_build()
        errs = phase_kernels(torch, f64, k5)
        with tempfile.TemporaryDirectory(prefix="easyrag_smoke_") as tmp:
            launches, mask, P = phase_pipeline(torch, np, f64, k5, tmp)
        timings = phase_main_shapes(torch, f64, k5, mask, P)
        check(not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules), "something imported JAX")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        {"name": "flash64_attention", "route": "cuda", "source": "easyrag_tpu_torch/csrc/flash64.cu",
         "replaces": "easyrag_tpu/ops/flash64.py:198", "launches": launches["K1"],
         "max_abs_err": max(errs["K1"], timings["K1"][2]), "ms": timings["K1"][0], "plain_ms": timings["K1"][1]},
        {"name": "bm25_scores", "route": "cuda", "source": "easyrag_tpu_torch/csrc/bm25_scatter.cu",
         "replaces": "easyrag_tpu/ops/bm25_pallas.py:88", "launches": launches["K5"],
         "max_abs_err": max(errs["K5"], timings["K5"][2]), "ms": timings["K5"][0], "plain_ms": timings["K5"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
