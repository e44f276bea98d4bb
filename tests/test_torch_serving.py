"""The port's serving layer (``easyrag_tpu_torch/serving``) against the JAX
package's.

The analogues of ``tests/test_batcher.py`` (the retrieval micro-batcher),
``tests/test_coalesce.py`` (cross-request reranker coalescing: fused
dispatches keep exact scores, the judge protocol stays unfused with a
per-thread cutoff, errors fan out, tails pad to their bucket, the yes-logit
scorer, concurrent full-RAG requests over a live socket) and
``tests/test_pipeline.py::test_webui_client_against_live_api``, each on the
port's pipeline on the CPU. Where JAX's test runs its pipeline, the port's
contexts and answers are held to JAX's ``run`` on the same corpus and
config. The full-RAG server also runs with the decode pool
(``tpu.local_llm_continuous``) and a tiny MiniCPM reranker given to both
packages from one tree. ``tests/test_coalesce.py``'s cold-tail test has no
analogue: it tests JAX's compile-warm bookkeeping, which the port leaves
out.
"""

import asyncio
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from easyrag_tpu.pipeline import EasyRAGPipeline as JaxPipeline
from easyrag_tpu.rerankers import LLMRerank as JaxLLMRerank
from easyrag_tpu_torch.generation import CompletionResponse, ContinuousBatchingLocalLLM
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from easyrag_tpu_torch.rerankers import LLMRerank
from easyrag_tpu_torch.schema import NodeWithScore, QueryBundle, TextNode
from easyrag_tpu_torch.serving.api import RetrievalBatcher, create_app
from easyrag_tpu_torch.serving.coalesce import CoalescingScorer
from test_torch_decode import tiny_causal_checkpoint  # noqa: F401  (a fixture)
from test_torch_pipeline import QUERIES, configs, make_corpus, offline_counter  # noqa: F401  (a fixture)

torch.set_num_threads(1)


# -- the retrieval micro-batcher (tests/test_batcher.py) ------------------------


class FakePipeline:
    def __init__(self):
        self.calls = []

    async def run_retrieval_batch(self, queries):
        self.calls.append(len(queries))
        return [{"answer": "", "nodes": [], "contexts": [q["query"]]} for q in queries]


def test_window_coalescing():
    pipeline = FakePipeline()
    batcher = RetrievalBatcher(pipeline, window_ms=10, max_batch=8)

    async def drive():
        return await asyncio.gather(*(batcher.run({"query": f"q{i}"}) for i in range(3)))

    results = asyncio.run(drive())
    assert [r["contexts"] for r in results] == [["q0"], ["q1"], ["q2"]]
    assert pipeline.calls == [3]  # one coalesced device batch


def test_max_batch_flushes_immediately():
    pipeline = FakePipeline()
    batcher = RetrievalBatcher(pipeline, window_ms=1000, max_batch=2)

    async def drive():
        return await asyncio.gather(*(batcher.run({"query": f"q{i}"}) for i in range(4)))

    results = asyncio.run(asyncio.wait_for(drive(), timeout=2))
    assert len(results) == 4
    assert all(c == 2 for c in pipeline.calls)  # flushed at max_batch, not at the window


def test_error_fans_out_to_all_waiters():
    class Boom:
        async def run_retrieval_batch(self, queries):
            raise RuntimeError("index gone")

    batcher = RetrievalBatcher(Boom(), window_ms=5, max_batch=8)

    async def drive():
        return await asyncio.gather(batcher.run({"query": "a"}), batcher.run({"query": "b"}), return_exceptions=True)

    assert all(isinstance(e, RuntimeError) for e in asyncio.run(drive()))


def test_batching_llm_serves_arrivals_during_a_dispatch():
    """Requests that arrive while ``BatchingLocalLLM`` dispatches a batch are
    flushed after it, also when no later request comes (JAX's flusher arms
    no successor from inside its own dispatch: they would wait forever)."""
    from easyrag_tpu_torch.generation import BatchingLocalLLM

    class Slow:
        def __init__(self):
            self.batches = []

        def generate_batch(self, prompts):
            self.batches.append(list(prompts))
            time.sleep(0.2)
            return [p.upper() for p in prompts]

    model = Slow()
    llm = BatchingLocalLLM(model, window_ms=5, max_batch=4)

    async def drive():
        async def late(p, delay):
            await asyncio.sleep(delay)
            return await llm.acomplete(p)

        return await asyncio.gather(late("a", 0), late("b", 0.05), late("c", 0.1))

    out = asyncio.run(asyncio.wait_for(drive(), timeout=10))
    assert [r.text for r in out] == ["A", "B", "C"]
    assert model.batches == [["a"], ["b", "c"]]


# -- the reranker coalescer (tests/test_coalesce.py) -----------------------------


class FakeScorer:
    """Deterministic, composition-independent pair scorer: a score encodes
    the active cutoff, so tests see which depth scored each pair."""

    def __init__(self, judge_layer=12):
        self.cutoff_layer = 28
        self.judge_layer = judge_layer
        self.calls = []  # (n_pairs, judge, cutoff)
        self._lock = threading.Lock()

    def score_pairs(self, pairs, judge=False):
        with self._lock:
            self.calls.append((len(pairs), judge, self.cutoff_layer))
        if judge:
            return np.array([float(len(p)) for _, p in pairs], np.float32), self.judge_layer
        return np.array([self.cutoff_layer * 1000.0 + len(p) for _, p in pairs], np.float32), self.cutoff_layer


def _nodes(prefix, n):
    return [NodeWithScore(TextNode(text=prefix * (i + 1)), score=0.5) for i in range(n)]


def test_concurrent_requests_share_dispatches():
    fake = FakeScorer()
    proxy = CoalescingScorer(fake, max_batch=4, window_ms=80)
    reranker = LLMRerank(proxy, top_n=100, embed_bs=4, embed_type=0)
    sizes = [5, 6, 7]
    barrier = threading.Barrier(len(sizes))

    def run(i):
        barrier.wait()
        return reranker.postprocess_nodes(_nodes(chr(ord("a") + i), sizes[i]), QueryBundle(query_str=f"q{i}"))

    with ThreadPoolExecutor(len(sizes)) as pool:
        outs = list(pool.map(run, range(len(sizes))))
    proxy.close()
    for i, out in enumerate(outs):  # a composition-independent scorer: the serial run's scores
        serial = LLMRerank(FakeScorer(), top_n=100, embed_bs=4, embed_type=0)
        expect = serial.postprocess_nodes(_nodes(chr(ord("a") + i), sizes[i]), QueryBundle(query_str=f"q{i}"))
        assert [n.score for n in out] == [n.score for n in expect]
    # 18 pairs in chunks of 4: at most 5 dispatches once fused (6 one request at a time)
    assert sum(n for n, _, _ in fake.calls) >= 18
    assert len(fake.calls) <= 5, fake.calls
    assert all(n == 4 for n, _, _ in fake.calls)
    assert max(proxy.dispatch_requests) > 1  # a dispatch held several requests' pairs


def test_judge_protocol_unfused_with_cutoff_isolation():
    fake = FakeScorer(judge_layer=12)
    proxy = CoalescingScorer(fake, max_batch=4, window_ms=60)
    reranker = LLMRerank(proxy, top_n=100, embed_bs=4, embed_type=0, use_efficient=1)
    barrier = threading.Barrier(2)

    def run(i):
        barrier.wait()
        return reranker.postprocess_nodes(_nodes("xy"[i], 6), QueryBundle(query_str=f"q{i}"))

    with ThreadPoolExecutor(2) as pool:
        outs = list(pool.map(run, range(2)))
    proxy.close()
    judge_calls = [c for c in fake.calls if c[1]]
    rest_calls = [c for c in fake.calls if not c[1]]
    assert len(judge_calls) == 2 and all(n == 4 for n, _, _ in judge_calls)  # each request judged alone
    assert all(cut == 12 for _, _, cut in rest_calls)  # the rest at the discovered layer
    for out in outs:
        tail_scores = sorted(n.score for n in out)[-2:]
        assert all(12000 <= s < 13000 for s in tail_scores)
    assert fake.cutoff_layer == 28  # restored after each group
    assert proxy.cutoff_layer == 28  # this thread's view is still the default


def test_default_cutoff_is_not_a_dispatch_in_flight():
    """A thread that set no cutoff sees the scorer's cutoff from when the
    proxy was built, also while the dispatcher has set a group's cutoff on
    the scorer for a dispatch (JAX's proxy reads the scorer's live
    attribute there: a cascade starting meanwhile took the judge layer as
    its full depth)."""

    class Slow(FakeScorer):
        def score_pairs(self, pairs, judge=False):
            started.set()
            release.wait(5)
            return super().score_pairs(pairs, judge)

    started, release = threading.Event(), threading.Event()
    fake = Slow()
    proxy = CoalescingScorer(fake, max_batch=4, window_ms=1)

    def stage_one():
        proxy.cutoff_layer = 12
        return proxy.score_pairs([("q", "p")])

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(stage_one)
        assert started.wait(5) and fake.cutoff_layer == 12  # the dispatch in flight
        seen = proxy.cutoff_layer
        release.set()
        scores, layer = fut.result(timeout=5)
    proxy.close()
    assert seen == 28 and layer == 12 and fake.cutoff_layer == 28


def test_coalescer_tolerates_yes_logit_scorer():
    """``YesLogitScorer`` exposes ``cutoff_layer`` (the scorer protocol), so
    it coalesces; its coalesced scores equal JAX's scorer's on one tree."""
    import jax
    import jax.numpy as jnp

    from easyrag_tpu.models.layers import DecoderConfig as JaxConfig
    from easyrag_tpu.models.layers import init_params
    from easyrag_tpu.models.yes_logit import YesLogitScorer as JaxYesLogit
    from easyrag_tpu.serving.coalesce import CoalescingScorer as JaxCoalescing
    from easyrag_tpu_torch.models.convert import causal_lm_params_from_jax
    from easyrag_tpu_torch.models.layers import DecoderConfig
    from easyrag_tpu_torch.models.yes_logit import YesLogitScorer

    arch = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=2)
    jcfg = JaxConfig(dtype=jnp.float32, **arch)
    params = init_params(jcfg, jax.random.key(0))

    class FakeTok:
        bos_token_id = 1
        pad_token_id = 0

        def __call__(self, text, add_special_tokens=False, max_length=None, truncation=False):
            ids = [ord(ch) % 120 + 2 for ch in text]
            return {"input_ids": ids[:max_length] if truncation and max_length is not None else ids}

    tp = causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", torch.float32)
    scorer = YesLogitScorer(DecoderConfig(**arch), tp, FakeTok(), max_length=64, device="cpu")
    assert scorer.cutoff_layer == 2
    pairs = [("q", "p"), ("q2", "p2"), ("q3", "a longer passage")]
    ref = JaxCoalescing(JaxYesLogit(jcfg, params, FakeTok(), max_length=64), max_batch=2, window_ms=10)
    proxy = CoalescingScorer(scorer, max_batch=2, window_ms=10)
    try:
        scores, layer = proxy.score_pairs(pairs)
        want, _ = ref.score_pairs(pairs)
    finally:
        proxy.close()
        ref.close()
    assert scores.shape == (3,) and layer == 2
    np.testing.assert_allclose(scores, np.asarray(want), rtol=1e-4, atol=1e-5)
    assert list(proxy.dispatch_sizes) == [2, 1]


def test_error_fans_out_to_all_fused_requests():
    class Boom(FakeScorer):
        def score_pairs(self, pairs, judge=False):
            raise RuntimeError("device gone")

    proxy = CoalescingScorer(Boom(), max_batch=4, window_ms=40)
    barrier = threading.Barrier(2)

    def run(i):
        barrier.wait()
        with pytest.raises(RuntimeError, match="device gone"):
            proxy.score_pairs([("q", "p")], judge=False)
        return True

    with ThreadPoolExecutor(2) as pool:
        assert all(pool.map(run, range(2)))
    proxy.close()


def test_coalesced_tail_chunk_pads_to_bucket():
    """38 fused pairs at max_batch 32 dispatch as 32 + 8 (the halving
    bucket), from the first request on: the port compiles nothing per
    shape, so no tail waits for a warm program."""
    fake = FakeScorer()
    proxy = CoalescingScorer(fake, max_batch=32, window_ms=20)
    reranker = LLMRerank(proxy, top_n=100, embed_bs=32, embed_type=0)
    for prefix in "ab":
        out = reranker.postprocess_nodes(_nodes(prefix, 38), QueryBundle(query_str="q"))
        assert len(out) == 38
    proxy.close()
    assert [(n, j) for n, j, _ in fake.calls] == [(32, False), (8, False)] * 2
    assert sum(proxy.dispatch_sizes) == 38 * 2  # real pair counts


# -- the HTTP API over a live socket ---------------------------------------------


class FakeLLM:
    def __init__(self):
        self.prompts = []

    async def acomplete(self, prompt):
        self.prompts.append(prompt)
        return CompletionResponse(text=f"答案{len(prompt)}")


async def serving(app, client):
    """Run ``client(base_url)`` against ``app`` on an ephemeral local port."""
    from aiohttp import web

    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    try:
        return await client(f"http://127.0.0.1:{port}")
    finally:
        await runner.cleanup()


async def post_all(base, queries, concurrency=4):
    """POST each query to ``/v1/rag``, at most ``concurrency`` at a time;
    the JSON bodies in order."""
    from aiohttp import ClientSession

    sem = asyncio.Semaphore(concurrency)
    async with ClientSession() as sess:
        async def post(q):
            async with sem, sess.post(f"{base}/v1/rag", json=q) as resp:
                assert resp.status == 200, await resp.text()
                return await resp.json()

        return await asyncio.gather(*(post(q) for q in queries))


SERVE_QUERIES = [dict(q) for q in QUERIES] + [{"query": f"{q['query']} {i}"} for i, q in enumerate(QUERIES)]


def test_api_concurrent_full_rag_shares_reranker_dispatches(tmp_path, offline_counter):
    """Concurrent POST /v1/rag on a full-RAG pipeline (reranker and answer)
    over a live socket share reranker dispatches, and every response's
    contexts and answer equal JAX's pipeline's ``run`` of the query."""
    data_path = make_corpus(tmp_path / "corpus")
    kw = dict(re_only=False, retrieval_type=2, use_reranker=2, chunk_size=64, chunk_overlap=10, data_path=data_path,
              f_topk_2=8, f_topk_3=2, r_topk=2, serve_window_ms=60.0,
              tpu=dict(use_pallas=False, max_query_postings=2048))
    jcfg, cfg = configs(**kw)
    ref = JaxPipeline(jcfg, llm=FakeLLM(), reranker=JaxLLMRerank(FakeScorer(), top_n=2, embed_bs=4, embed_type=1))
    want = [asyncio.run(ref.run(dict(q))) for q in SERVE_QUERIES]
    fake = FakeScorer()
    pipeline = EasyRAGPipeline(cfg, llm=FakeLLM(), reranker=LLMRerank(fake, top_n=2, embed_bs=4, embed_type=1),
                               device="cpu")
    app = create_app(pipeline)
    assert isinstance(pipeline.reranker.scorer, CoalescingScorer) and pipeline.rerank_in_thread
    try:
        got = asyncio.run(serving(app, lambda base: post_all(base, SERVE_QUERIES)))
    finally:
        pipeline.reranker.scorer.close()
    for a, b in zip(want, got):
        assert b["contexts"] == a["contexts"] and b["answer"] == a["answer"]
    total_pairs = sum(n for n, _, _ in fake.calls)
    per_request = total_pairs // len(SERVE_QUERIES)
    assert total_pairs >= 2 * len(SERVE_QUERIES)  # every request had candidates
    assert len(fake.calls) < len(SERVE_QUERIES) * -(-per_request // 4), (fake.calls, per_request)
    assert max(pipeline.reranker.scorer.dispatch_requests) > 1


def test_api_routes_cors_and_errors(tmp_path, offline_counter):
    """``GET /test``, ``GET /ui``, a CORS preflight, 400 on a body that is
    not JSON, and a clean JSON 500 when the pipeline raises."""
    from aiohttp import ClientSession

    _, cfg = configs(data_path=make_corpus(tmp_path / "corpus"), re_only=True, retrieval_type=2, use_reranker=0,
                     chunk_size=64, chunk_overlap=10, tpu=dict(use_pallas=False))
    pipeline = EasyRAGPipeline(cfg, device="cpu")
    app = create_app(pipeline)

    async def client(base):
        async with ClientSession() as sess:
            async with sess.get(f"{base}/test") as r:
                hello = (r.status, await r.json(), r.headers["Access-Control-Allow-Origin"])
            async with sess.get(f"{base}/ui") as r:
                ui = (r.status, r.content_type, await r.text())
            async with sess.options(f"{base}/v1/rag") as r:
                pre = (r.status, r.headers["Access-Control-Allow-Methods"], r.headers["Access-Control-Allow-Headers"])
            async with sess.post(f"{base}/v1/rag", data=b"not json") as r:
                bad = (r.status, await r.json())
            pipeline.run_retrieval_batch = boom
            async with sess.post(f"{base}/v1/rag", json={"query": "q"}) as r:
                err = (r.status, await r.json())
        return hello, ui, pre, bad, err

    async def boom(queries):
        raise RuntimeError("index gone")

    hello, ui, pre, bad, err = asyncio.run(serving(app, client))
    assert hello == (200, "hello rag", "*")
    assert ui[0] == 200 and ui[1] == "text/html" and "/v1/rag" in ui[2]
    assert pre == (200, "*", "*")
    assert bad == (400, {"error": "body must be JSON"})
    assert err == (500, {"error": "index gone"})


def test_webui_client_against_live_api(tmp_path, offline_counter):
    """The web UI's HTTP client (``ask``) round-trips against a live socket,
    无 mapped to an empty document, with JAX's contexts."""
    from easyrag_tpu_torch.serving.webui import ask

    kw = dict(data_path=make_corpus(tmp_path / "corpus"), re_only=True, retrieval_type=2, use_reranker=0,
              chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2, tpu=dict(use_pallas=False))
    jcfg, cfg = configs(**kw)
    want = asyncio.run(JaxPipeline(jcfg).run({"query": QUERIES[0]["query"]}))
    app = create_app(EasyRAGPipeline(cfg, device="cpu"))

    async def client(base):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: ask(QUERIES[0]["query"], "无", f"{base}/v1/rag"))

    res = asyncio.run(serving(app, client))
    assert res["answer"] == "" and res["contexts"] == want["contexts"] and res["contexts"]


def test_api_with_decode_pool_matches_jax(tmp_path, offline_counter, tiny_causal_checkpoint):
    """The flagship's serving shape on the CPU: a tiny MiniCPM reranker
    (one JAX tree for both packages) behind the coalescer, answers from the
    decode pool (``tpu.local_llm_continuous``, two tiers, speculation) over
    one tiny saved Qwen2 checkpoint. Concurrent requests over a live socket
    give JAX's ``run``'s contexts and answers, one query at a time; the
    boot warmup ran the pool and left it empty."""
    from easyrag_tpu.models.minicpm import MiniCPMLayerWiseReranker as JaxReranker
    from easyrag_tpu_torch.models.convert import minicpm_from_jax
    from easyrag_tpu_torch.models.layers import DecoderConfig
    from test_torch_minicpm import ARCH, CharTok, tiny_params

    kw = dict(data_path=make_corpus(tmp_path / "corpus"), chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2,
              r_topk=2, r_embed_bs=4, local_llm_name=tiny_causal_checkpoint, cache_path=str(tmp_path / "cache"),
              serve_window_ms=40.0,
              tpu=dict(use_pallas=False, local_llm_answer=True, local_llm_quant="", local_llm_max_new=4,
                       local_llm_gen_batch=2, local_llm_spec=2, local_llm_continuous=True, local_llm_chunk_steps=2,
                       local_llm_pool_tiers="256:1,512:1", local_llm_warmup=True))
    jcfg, cfg = configs(**kw)
    jarch, params, params_np = tiny_params()
    opts = dict(start_layer=1, cutoff_layer=3, max_length=64)
    rerank = dict(top_n=2, embed_bs=4, embed_type=1)
    ref = JaxPipeline(jcfg, reranker=JaxLLMRerank(JaxReranker(jarch, params, CharTok("right"), **opts), **rerank))
    want = [asyncio.run(ref.run(dict(q))) for q in SERVE_QUERIES]
    scorer = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok("right"), **opts)
    pipeline = EasyRAGPipeline(cfg, reranker=LLMRerank(scorer, **rerank), device="cpu")
    assert isinstance(pipeline.llm, ContinuousBatchingLocalLLM)
    assert [t.bucket for t in pipeline.llm.pool.tiers] == [256, 512]
    app = create_app(pipeline)
    pool = pipeline.llm.pool
    assert pool.chunks > 0 and not pool.active and len(pool.free) == 2  # the warmup ran and reset
    try:
        got = asyncio.run(serving(app, lambda base: post_all(base, SERVE_QUERIES)))
    finally:
        pipeline.reranker.scorer.close()
    for a, b in zip(want, got):
        assert b["contexts"] == a["contexts"]
        assert b["answer"] == a["answer"] and b["answer"]
    assert pipeline.llm.dispatches > 0 and not pool.active


def test_serve_defaults_to_the_card(tmp_path, offline_counter):
    """``serve`` and the module's ``main`` boot the pipeline on the card
    unless ``--device cpu`` is passed; without a card they raise."""
    from easyrag_tpu_torch.serving import api

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps({"data_path": make_corpus(tmp_path / "corpus"), "use_reranker": 0,
                                "re_only": True}), encoding="utf-8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.main(["--config", os.fspath(path)])
    served = []
    real = api.create_app
    api.create_app = lambda p: served.append(p.device.type) or real(p)
    try:
        import aiohttp.web

        run_app = aiohttp.web.run_app
        aiohttp.web.run_app = lambda app, **kw: served.append(kw)
        try:
            api.main(["--config", os.fspath(path), "--device", "cpu", "--port", "0"])
        finally:
            aiohttp.web.run_app = run_app
    finally:
        api.create_app = real
    assert served == ["cpu", {"host": "0.0.0.0", "port": 0}]
