"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result line's fields.

A cell is found by its name in ``BENCHMARK.json``: its configuration file,
its traffic file ``traffic/<traffic>.json`` and one reader file
``metrics/<metric>.py`` for each metric it reports. Nothing here names a
cell, a configuration or a metric.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import judge
from .corpus import Corpus, dir_filter, make_corpus, make_questions
from .trace import TraceSummary, WindowTrace

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable[["Readings"], Optional[float]]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_reader(name: str) -> Callable:
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: Dict[str, Any], workload: str, reported: List[str]) -> bool:
    """Whether a cell reports a metric: the cells its ``workloads`` list,
    else every cell, or for a per-layer metric every cell that reports the
    end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(workload: str) -> Cell:
    """The cell named ``workload`` of ``BENCHMARK.json`` with its files."""
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"]), encoding="utf-8") as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"), encoding="utf-8") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in manifest["per_layer"] if _applies(m, workload, names)]
    return Cell(
        name=workload, chips=w["chips"], config=config, traffic=traffic,
        end_to_end=[Metric(m["name"], m["unit"], load_reader(m["name"])) for m in e2e],
        per_layer=[Metric(m["name"], m["unit"], load_reader(m["name"])) for m in layer],
    )


@dataclass
class Readings:
    """What the metric readers read."""

    config: Dict[str, Any]
    traffic: Dict[str, Any]
    setup_s: float = 0.0
    window: Any = None  # drivers.Window
    spans: Dict[str, List[float]] = field(default_factory=dict)  # timing event -> seconds, in the window
    rerank_batches: List[int] = field(default_factory=list)  # real pairs of each rerank batch
    batches: List[tuple] = field(default_factory=list)  # traced: (B, S, [real lengths], layers) of each batch
    k6: List[tuple] = field(default_factory=list)  # traced: (rows, cols) of each K6 call
    trace: TraceSummary = field(default_factory=TraceSummary)

    def latencies(self) -> List[float]:
        return [r.end - r.start for r in self.window.requests if r.ok]

    def questions_done(self) -> int:
        return sum(len(r.questions) for r in self.window.requests if r.ok)

    def span_ms(self, name: str) -> Optional[float]:
        got = self.spans.get(name)
        return statistics.median(got) * 1e3 if got else None


class Listener:
    """The program's events (``utils.events``), kept with the host clock."""

    def __init__(self) -> None:
        self.timings: List[tuple] = []  # (end, name, seconds)
        self.batches: List[tuple] = []  # (time, real pairs)

    def __call__(self, kind: str, payload: Dict[str, Any]) -> None:
        if kind == "timing":
            self.timings.append((time.perf_counter(), payload["name"], payload["seconds"]))
        elif kind == "reranking" and "pairs" in payload:
            self.batches.append((time.perf_counter(), payload["pairs"]))


def _keep(seed: int, share: float) -> Callable[[int], bool]:
    """Which requests' outputs are kept for the check: the first, and a
    share of the others drawn from the seed."""
    draws = np.random.default_rng([seed, 3]).random(1 << 16)
    return lambda n: n == 0 or bool(draws[n % len(draws)] < share)


@dataclass
class Outcome:
    """What a run leaves for the check and the readers, the program freed."""

    corpus: Corpus
    readings: Readings
    records: List[Dict[str, Any]]  # the reranker's calls in the window (system.RerankRecorder)
    doc_of: List[int]  # node idx -> doc
    top_n: int
    memory_peak: int


class Hooks:
    """What happens as the window opens and closes: the recorders' counts
    are read and the trace starts and stops."""

    def __init__(self, system, tracer: WindowTrace) -> None:
        self.system, self.tracer = system, tracer
        self.counters: Dict[str, Dict[str, Any]] = {}

    def open(self) -> None:
        self.counters["open"] = self.system.snapshot()
        self.tracer.open()

    def close(self) -> None:
        self.tracer.close()
        self.counters["close"] = self.system.snapshot()


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t0: Optional[float] = None,
            log=print) -> Outcome:
    """Set-up, warm-up and the window; then the program's state is freed."""
    import torch

    from easyrag_tpu_torch.utils import events

    from .drivers import ClosedLoop
    from .system import System

    t0 = time.perf_counter() if t0 is None else t0
    cfg, traffic = cell.config, cell.traffic
    root = os.path.join(tempfile.gettempdir(), "easyrag_benchmark_corpus")
    try:
        corpus = make_corpus(root, seed, cfg["corpus"])
        system = System(cfg, traffic, corpus, seed, device, trace)
        listener = Listener()
        unsubscribe = events.on(listener)
        try:
            loop = ClosedLoop(system.pipeline, make_questions(corpus, seed, traffic), traffic,
                              _keep(seed, traffic.get("check_share", 1.0)))
            loop.warm()
            if device != "cpu":
                torch.cuda.synchronize()
            tracer = WindowTrace(trace, cuda=device != "cpu")
            hooks = Hooks(system, tracer)
            window = loop.run(seconds, hooks)
        finally:
            unsubscribe()
        memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        readings = Readings(config=cfg, traffic=traffic, setup_s=window.start - t0, window=window)
        t = time.perf_counter()
        readings.trace = tracer.summarize([(e - s, e, n) for e, n, s in listener.timings])
        if trace:
            log(f"trace reduced in {time.perf_counter() - t:.1f} s")
        inside = lambda t: window.start <= t <= window.end  # noqa: E731
        for t, name, s in listener.timings:
            if inside(t):
                readings.spans.setdefault(name, []).append(s)
        opened, closed = hooks.counters["open"], hooks.counters["close"]
        for key in ("batches", "k6"):
            setattr(readings, key, getattr(system.shapes, key)[opened[key]:closed[key]])
        readings.rerank_batches = [n for t, n in listener.batches if inside(t)]
        records = system.reranks.records[opened["records"]:closed["records"]] if system.reranks is not None else []
        out = Outcome(corpus=corpus, readings=readings, records=records, doc_of=system.doc_of,
                      top_n=system.cfg.r_topk, memory_peak=memory_peak)
        system.close()
        del system, loop
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t0: Optional[float] = None,
             log=print) -> Dict[str, Any]:
    """Run the cell once and return the result line's fields."""
    oc = execute(cell, seed, seconds, trace, device, t0, log)
    values = check(cell, oc, seed, device, log)
    correct, checks = judge.verdict(values, cell.config.get("limits", {}))
    window = oc.readings.window
    failed = sum(1 for r in window.requests if not r.ok)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(oc.readings)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    out: Dict[str, Any] = {"correct": correct and failed == 0, "attempted": len(window.requests), "failed": failed,
                           "metrics": metrics, "device": {}}
    if trace:
        out["breakdown"] = oc.readings.trace.breakdown()
        out["_busy_s"], out["_window_s"] = oc.readings.trace.busy_s, oc.readings.trace.window_s
    out["checks"] = checks
    out["_errors"] = sorted({r.error for r in window.requests if not r.ok})[:5]
    out["_memory_peak"] = oc.memory_peak
    return out


def produced(oc: Outcome) -> List[tuple]:
    """What retrieval produced in the window, ``[(question, [(doc,
    score)])]``: the candidates handed to the reranker, or the batch entry's
    kept outputs."""
    out = []
    window, doc_of = oc.readings.window, oc.doc_of
    if oc.records:
        by_query = {}
        for r in window.requests:
            if r.ok:
                by_query.setdefault(r.questions[0]["query"], r.questions[0])
        for rec in oc.records:
            q = by_query.get(rec["query"])
            if q is not None:
                out.append((q, [(doc_of[i], s) for i, s in rec["candidates"]]))
    else:
        for r in window.requests:
            if r.ok and r.output is not None:
                out += [(q, [(doc_of[i], s) for i, s in o]) for q, o in zip(r.questions, r.output)]
    return out


def check(cell: Cell, oc: Outcome, seed: int, device, log, control: bool = False) -> Dict[str, float]:
    """The numbers that decide ``correct`` (``judge``), from the window's
    outputs and the reference. ``control``: the reference one precision
    below the configuration's (TF32 BM25 sums, a w8a8 reranker) stands in
    the program's place, on the same questions and candidates."""
    from ..reference.bm25 import DualRouteReference

    cfg = cell.config
    preset = cfg["preset"]
    k_content, k_path = preset["f_topk_2"], preset["f_topk_3"]
    corpus = oc.corpus
    n = len(corpus.texts)
    t = time.perf_counter()
    views = ([corpus.know_path(d) for d in range(n)], corpus.dirs, corpus.texts)
    ref = DualRouteReference(*views)
    lower = DualRouteReference(*views, precision="tf32") if control else None
    got = produced(oc)
    gaps = []
    for q, prog in got:
        f = dir_filter(q)
        c, p, allowed = ref.routes(q["query"], f)
        if control:
            prog = lower.fused(q["query"], f, k_content, k_path)
        want = ref.fused(q["query"], f, k_content, k_path, prefer=[d for d, _ in prog])
        gaps.append(judge.retrieval_gap(prog, want, c, p, allowed))
    values = {"retrieval_gap": judge.widest(gaps) if got else math.inf}
    log(f"reference: {len(got)} retrieval outputs compared in {time.perf_counter() - t:.1f} s")
    if oc.records:
        values.update(check_rerank(cell, oc, seed, device, log, control))
    return values


def sample_records(records, seed: int, n: int) -> List[Dict[str, Any]]:
    """``n`` of the records drawn from the seed, the one with the most
    candidates (then the longest query) always among them."""
    if not records:
        return []
    longest = max(range(len(records)), key=lambda i: (len(records[i]["candidates"]), len(records[i]["query"])))
    rest = [i for i in range(len(records)) if i != longest]
    rng = np.random.default_rng([seed, 4])
    picked = [longest] + [rest[int(i)] for i in rng.permutation(len(rest))[: max(n - 1, 0)]]
    return [records[i] for i in picked]


def rerank_rows(cfg, corpus: Corpus, rec, doc_of) -> List[List[int]]:
    """The token rows of a request's pairs, as the reference builds them:
    the query and each candidate's file path under the corpus root and its
    text without the blanks at its ends (``r_embed_type`` 1 of a one-chunk
    file)."""
    from ..reference.minicpm import pair_ids
    from ..reference.tokenizers import CharTokenizer

    tk = CharTokenizer(cfg["vocab_size"])
    max_len = cfg["reranker"]["max_length"]
    rows = []
    for i, _ in rec["candidates"]:
        d = doc_of[i]
        passage = f"###\n{corpus.rel_path(d)}\n\n{corpus.texts[d].strip()}"
        rows.append(pair_ids(tk, rec["query"], passage, max_len))
    return rows


def check_rerank(cell: Cell, oc: Outcome, seed: int, device, log, control: bool = False) -> Dict[str, float]:
    """``rerank_error`` on the sample and ``top_mismatch`` on every request
    (``judge``); with ``control``, the w8a8 reference's scores and its own
    top stand in the program's."""
    import torch

    from ..reference.minicpm import MiniCPMReference
    from ..reference.weights import minicpm_weights

    cfg = cell.config
    t = time.perf_counter()
    sample = sample_records(oc.records, seed, cell.traffic.get("rerank_sample", 3))
    cutoff = cfg["reranker"]["cutoff_layer"]
    rows = [rerank_rows(cfg, oc.corpus, rec, oc.doc_of) for rec in sample]
    weights = minicpm_weights(cfg, seed, device, getattr(torch, cfg["reranker"]["dtype"]))
    plain = [MiniCPMReference(cfg, weights).score(r, cutoff) for r in rows]
    got = [rec["scores"] for rec in sample]
    tops = [(rec["candidates"], rec["scores"], rec["top"]) for rec in oc.records]
    if control:
        lower = MiniCPMReference(cfg, weights, quant="w8a8")
        got = [lower.score(r, cutoff) for r in rows]
        tops = []
        for rec, s in zip(sample, got):
            order = np.argsort(-s, kind="stable")[: oc.top_n]
            tops.append((rec["candidates"], list(s), [(rec["candidates"][k][0], s[k]) for k in order]))
        del lower
    yardstick = MiniCPMReference(cfg, weights, precision="tf32" if device != "cpu" else "f32")
    ref = [yardstick.score(r, cutoff) for r in rows]
    del yardstick, weights
    mismatch = sum(judge.top_mismatch([i for i, _ in c], s, top, oc.top_n) for c, s, top in tops)
    log(f"reference: {len(sample)} rerank requests compared in {time.perf_counter() - t:.1f} s")
    return {"rerank_error": judge.rerank_error(got, ref, plain) if sample else math.inf,
            "top_mismatch": float(mismatch)}

