"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result line's fields.

A cell is found by its name in a manifest (``BENCHMARK.json``): its
configuration file, which names the configuration's system module
(``"system"``), its traffic file ``traffic/<traffic>.json`` and one reader
file ``metrics/<metric>.py`` for each metric it reports, all under the
manifest's first path. Nothing here names a cell, a configuration, a model,
a reference or a metric.

A system module provides ``build(config, traffic, corpus, seed, device,
trace)``, which returns the system under test (``pipeline``, ``snapshot()``,
``close()``, ``doc_of`` and optionally ``readings(opened, closed)``, a dict
for the configuration's own readers in ``Readings.extra``); ``check(cell,
outcome, seed, device, log, control=False)``, the numbers that
``judge.verdict`` holds to the configuration's ``limits``; ``entries``, a
traffic file's ``entry`` -> an async call ``(system, questions)`` that
returns one output per question; and optionally ``questions(corpus, seed,
traffic)`` in place of the general generator.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import judge
from .corpus import Corpus, make_corpus, make_questions
from .trace import TraceSummary, WindowTrace

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


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
    system: Any  # the configuration's system module
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_module(path: str, name: str):
    """The Python file at ``path``, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    return load_module(path, f"benchmark_metric_{name.replace('.', '_')}").read


def _applies(metric: Dict[str, Any], workload: str, reported: List[str]) -> bool:
    """Whether a cell reports a metric: the cells its ``workloads`` list,
    else every cell, or for a per-layer metric every cell that reports the
    end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(workload: str, manifest: str = MANIFEST) -> Cell:
    """The cell named ``workload`` of the manifest with its files: the
    configuration file and its system module by their paths from the
    manifest's directory, the traffic and the readers under the manifest's
    first path."""
    root = os.path.dirname(os.path.abspath(manifest))
    with open(manifest, encoding="utf-8") as f:
        spec = json.load(f)
    bench_dir = os.path.join(root, spec["paths"][0])
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {manifest} (have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"]), encoding="utf-8") as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"), encoding="utf-8") as f:
        traffic = json.load(f)
    system = load_module(os.path.join(root, config["system"]), f"benchmark_system_{conf['name'].replace('.', '_')}")
    if traffic["entry"] not in getattr(system, "entries", {}):
        raise KeyError(f"{config['system']} has no entry {traffic['entry']!r}")
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in spec["per_layer"] if _applies(m, workload, names)]
    return Cell(
        name=workload, chips=w["chips"], config=config, traffic=traffic, system=system,
        end_to_end=[Metric(m["name"], m["unit"], load_reader(m["name"], bench_dir)) for m in e2e],
        per_layer=[Metric(m["name"], m["unit"], load_reader(m["name"], bench_dir)) for m in layer],
    )


@dataclass
class Readings:
    """What the metric readers read."""

    config: Dict[str, Any]
    traffic: Dict[str, Any]
    setup_s: float = 0.0
    window: Any = None  # drivers.Window
    spans: Dict[str, List[float]] = field(default_factory=dict)  # timing event -> seconds, in the window
    events: List[tuple] = field(default_factory=list)  # the program's other events in the window: (kind, payload)
    extra: Dict[str, Any] = field(default_factory=dict)  # the system's own readings (its ``readings()``)
    trace: TraceSummary = field(default_factory=TraceSummary)

    def latencies(self) -> List[float]:
        return [r.end - r.start for r in self.window.requests if r.ok]

    def span_ms(self, name: str) -> Optional[float]:
        got = self.spans.get(name)
        return statistics.median(got) * 1e3 if got else None


class Listener:
    """The program's events (``utils.events``), kept with the host clock."""

    def __init__(self) -> None:
        self.timings: List[tuple] = []  # (end, name, seconds)
        self.events: List[tuple] = []  # (time, kind, payload)

    def __call__(self, kind: str, payload: Dict[str, Any]) -> None:
        if kind == "timing":
            self.timings.append((time.perf_counter(), payload["name"], payload["seconds"]))
        else:
            self.events.append((time.perf_counter(), kind, payload))


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
    system: Any  # the system, closed: its recorders kept, the program's state freed
    counters: Dict[str, Dict[str, Any]]  # its ``snapshot()`` as the window opened ("open") and closed ("close")
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

    t0 = time.perf_counter() if t0 is None else t0
    cfg, traffic = cell.config, cell.traffic
    root = os.path.join(tempfile.gettempdir(), "easyrag_benchmark_corpus")
    try:
        corpus = make_corpus(root, seed, cfg["corpus"])
        system = cell.system.build(cfg, traffic, corpus, seed, device, trace)
        questions = getattr(cell.system, "questions", make_questions)(corpus, seed, traffic)
        listener = Listener()
        unsubscribe = events.on(listener)
        try:
            loop = ClosedLoop(system, cell.system.entries[traffic["entry"]], questions, traffic,
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
        readings.events = [(kind, payload) for t, kind, payload in listener.events if inside(t)]
        if hasattr(system, "readings"):
            readings.extra = system.readings(hooks.counters["open"], hooks.counters["close"])
        system.close()
        out = Outcome(corpus=corpus, readings=readings, system=system, counters=hooks.counters,
                      memory_peak=memory_peak)
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
    values = cell.system.check(cell, oc, seed, device, log)
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
