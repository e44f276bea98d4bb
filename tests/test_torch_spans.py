"""The port's spans (``easyrag_tpu_torch.utils.events.trace``): payloads,
nesting by context (asyncio tasks, ``to_thread`` workers), errors, the
``record_function`` ranges under a recording ``torch.profiler`` and none
without one, the collector's ``gc`` spans and their hook's lifetime, and
the reranker's per-batch spans in a reranked ``run``."""

import asyncio
import gc

import pytest
import torch

from easyrag_tpu_torch.models.layers import DecoderConfig
from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from easyrag_tpu_torch.rerankers import LLMRerank
from easyrag_tpu_torch.utils import events
from test_torch_minicpm import ARCH, CharTok
from test_torch_pipeline import QUERIES, configs, make_corpus, offline_counter  # noqa: F401  (a fixture)

torch.set_num_threads(1)


@pytest.fixture
def spans():
    """The ``timing`` payloads emitted while the test runs, ``gc`` left out."""
    got = []
    off = events.on(lambda kind, p: got.append(p) if kind == "timing" and p["name"] != "gc" else None)
    yield got
    off()


def by_name(spans):
    out = {}
    for p in spans:
        out.setdefault(p["name"], []).append(p)
    return out


def test_nested_payloads(spans):
    with events.trace("outer"):
        with events.trace("mid"):
            with events.trace("inner"):
                pass
        with events.trace("sibling"):
            pass
    s = {k: v[0] for k, v in by_name(spans).items()}
    assert [p["name"] for p in spans] == ["inner", "mid", "sibling", "outer"]
    for p in spans:
        assert p["start"] <= p["end"] and p["seconds"] == p["end"] - p["start"]
        assert p["request"] == s["outer"]["id"] and "error" not in p
    assert s["outer"]["parent"] is None
    assert s["mid"]["parent"] == s["sibling"]["parent"] == s["outer"]["id"]
    assert s["inner"]["parent"] == s["mid"]["id"]
    assert len({p["id"] for p in spans}) == 4
    assert s["outer"]["start"] <= s["mid"]["start"] <= s["inner"]["start"] <= s["inner"]["end"] <= s["mid"]["end"]


def test_concurrent_roots_and_threads(spans):
    async def request(tag):
        with events.trace(f"root-{tag}"):
            await asyncio.sleep(0.01)
            with events.trace(f"child-{tag}"):
                await asyncio.sleep(0.01)
            await asyncio.to_thread(thread_work, tag)

    def thread_work(tag):
        with events.trace(f"thread-{tag}"):
            pass

    async def main():
        await asyncio.gather(request("a"), request("b"))

    asyncio.run(main())
    s = {k: v[0] for k, v in by_name(spans).items()}
    for tag in "ab":
        root = s[f"root-{tag}"]
        assert root["parent"] is None and root["request"] == root["id"]
        for kid in (f"child-{tag}", f"thread-{tag}"):
            assert s[kid]["parent"] == root["id"] and s[kid]["request"] == root["id"]
    assert s["root-a"]["request"] != s["root-b"]["request"]
    # the two requests overlapped in time
    assert s["root-a"]["start"] < s["root-b"]["end"] and s["root-b"]["start"] < s["root-a"]["end"]


def test_raising_block_closes_with_error(spans):
    with pytest.raises(KeyError):
        with events.trace("outer"):
            with events.trace("failing"):
                raise KeyError("x")
    s = {k: v[0] for k, v in by_name(spans).items()}
    assert s["failing"]["error"] is True and s["outer"]["error"] is True
    assert s["failing"]["parent"] == s["outer"]["id"]
    # the context was restored: a new span is a root again
    with events.trace("after"):
        pass
    assert by_name(spans)["after"][0]["parent"] is None


def test_profiler_ranges_nest_as_the_spans():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with events.trace("span.outer"):
            with events.trace("span.inner"):
                torch.ones(8).sum()
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("span.")}
    assert set(ranges) == {"span.outer", "span.inner"}
    assert all(e.is_user_annotation() for e in ranges.values())
    outer, inner = ranges["span.outer"], ranges["span.inner"]
    assert outer.start_ns() <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer.start_ns() + outer.duration_ns()


def test_no_profiler_no_range(monkeypatch, spans):
    import torch.profiler

    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with events.trace("quiet"):
        pass
    assert entered == [] and [p["name"] for p in spans] == ["quiet"]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with events.trace("recorded"):
            pass
    assert entered == ["recorded"]


def test_gc_span_and_hook_lifetime(monkeypatch, request):
    # start from no listener, whatever an earlier test in this process left
    monkeypatch.setattr(events, "_listeners", [])
    if events._on_gc in gc.callbacks:
        gc.callbacks.remove(events._on_gc)
        request.addfinalizer(lambda: gc.callbacks.append(events._on_gc))
    got = []
    off_a = events.on(lambda kind, p: got.append(p) if kind == "timing" else None)
    off_b = events.on(lambda kind, p: None)
    assert gc.callbacks.count(events._on_gc) == 1
    with events.trace("holder"):
        gc.collect()
    full = [p for p in got if p["name"] == "gc" and p["generation"] == 2]
    holder = [p for p in got if p["name"] == "holder"][0]
    assert full and full[-1]["parent"] == holder["id"] and full[-1]["request"] == holder["id"]
    assert holder["start"] <= full[-1]["start"] <= full[-1]["end"] <= holder["end"]
    assert full[-1]["seconds"] == full[-1]["end"] - full[-1]["start"]
    off_a()
    assert events._on_gc in gc.callbacks
    off_b()
    assert events._on_gc not in gc.callbacks
    n = len(got)
    gc.collect()
    assert len(got) == n


def test_trace_dir_writes_nothing(tmp_path, monkeypatch, spans):
    monkeypatch.setenv("EASYRAG_TRACE_DIR", str(tmp_path / "traces"))
    with events.trace("block"):
        torch.ones(4).sum()
    assert [p["name"] for p in spans] == ["block"]
    assert not (tmp_path / "traces").exists() and list(tmp_path.iterdir()) == []


def test_reranked_run_spans_each_batch(tmp_path, offline_counter, spans):  # noqa: F811
    data_path = make_corpus(tmp_path / "corpus")
    _, cfg = configs(data_path=data_path, re_only=True, chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2,
                     r_topk=3, r_embed_bs=2, tpu=dict(max_query_terms=8, max_query_postings=2048))
    scorer = MiniCPMLayerWiseReranker(DecoderConfig(**ARCH), CharTok(), start_layer=1, cutoff_layer=3,
                                      max_length=64, device="cpu", dtype=torch.float32)
    scorer.init_random_(torch.Generator().manual_seed(0))
    got = EasyRAGPipeline(cfg, reranker=LLMRerank(scorer, top_n=3, embed_bs=2, embed_type=1), device="cpu")
    batches = []
    off = events.on(lambda kind, p: batches.append(p) if kind == "reranking" and "batch" in p else None)
    try:
        asyncio.run(got.run(dict(QUERIES[0])))
    finally:
        off()
    s = by_name(spans)
    (request,), (rerank,) = s["request"], s["rerank"]
    assert len(batches) >= 2 and len(s["rerank.prep"]) == len(s["rerank.forward"]) == len(batches)
    for p in s["rerank.prep"] + s["rerank.forward"]:
        assert p["parent"] == rerank["id"] and p["request"] == request["id"]
        assert rerank["start"] <= p["start"] <= p["end"] <= rerank["end"]
    for prep, fwd in zip(s["rerank.prep"], s["rerank.forward"]):
        assert prep["end"] <= fwd["start"]
    assert rerank["parent"] == request["id"] and request["parent"] is None
