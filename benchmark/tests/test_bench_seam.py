"""The configuration seam: a configuration brings its system, entries,
readings and check as files of its own, found from the manifest, and the
harness names none of them.

The toy configuration below lives only in this file: each test that needs
it lays its files out under a temporary directory as the benchmark's own
are laid out (a manifest, ``configs/``, ``traffic/``, ``metrics/``,
``systems/``, ``reference/``) and runs it through the unchanged harness.
"""

from __future__ import annotations

import ast
import json
import os
import tempfile
import time

import pytest
import torch

from benchmark.harness import drivers
from benchmark.harness.cell import BENCH_DIR, MANIFEST, Hooks, execute, load_cell, run_cell
from benchmark.tests.conftest import QUERY, SEED, lay_out

quiet = lambda *a: None  # noqa: E731

TOY_REFERENCE = '''
"""The toy answer model, plain: float64 NumPy over the seed's weights."""

import numpy as np


def weights(seed, vocab, width):
    rng = np.random.default_rng([seed, 7])
    return {"emb": rng.standard_normal((vocab, width)).astype(np.float32),
            "out": rng.standard_normal((width, vocab)).astype(np.float32)}


def ids(prompt, vocab):
    return [ord(c) % vocab for c in prompt]


def logits(w, tokens):
    h = w["emb"][tokens].astype(np.float64).mean(axis=0)
    return np.tanh(h) @ w["out"].astype(np.float64)


def answer_gap(w, prompt, served):
    """The widest gap by which a served token's logit lies below the best,
    over the logits' spread."""
    gap = 0.0
    for i, t in enumerate(served):
        z = logits(w, prompt + served[:i])
        gap = max(gap, (z.max() - z[t]) / (z.max() - z.min()))
    return gap
'''

TOY_SYSTEM = '''
"""The toy configuration's system: the port's pipeline with no reranker and
a tiny seeded answer model in its LLM slot."""

import os

import numpy as np
import torch

from benchmark.harness.cell import load_module
from benchmark.reference.tokenizers import SparseTokenizer

REF = load_module(os.path.join(os.path.dirname(__file__), "..", "reference", "toy_lm.py"), "toy_lm_reference")


class ToyLM:
    """Greedy answers from the mean of the prompt's embeddings; every
    answer's prompt ids and served ids recorded."""

    def __init__(self, w, vocab, max_new, device):
        self.emb = torch.tensor(w["emb"], device=device)
        self.out = torch.tensor(w["out"], device=device)
        self.vocab, self.max_new = vocab, max_new
        self.records, self.steps = [], 0

    def pick(self, logits):
        return int(torch.argmax(logits))

    async def acomplete(self, prompt):
        from easyrag_tpu_torch.generation import CompletionResponse

        ids, served = REF.ids(prompt, self.vocab), []
        for _ in range(self.max_new):
            h = self.emb[torch.tensor(ids + served)].mean(dim=0)
            served.append(self.pick(torch.tanh(h) @ self.out))
            self.steps += 1
        self.records.append((ids, served))
        return CompletionResponse(text=" ".join(f"w{t}" for t in served))


class System:
    def __init__(self, config, traffic, corpus, seed, device, trace):
        from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
        from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
        from easyrag_tpu_torch.pipeline import EasyRAGPipeline

        self.lm = ToyLM(REF.weights(seed, config["vocab"], config["width"]), config["vocab"], config["max_new"],
                        device)
        splitter = SentenceSplitter(1024, 200, token_counter=approx_token_count, sentence_splitter=lambda t: [t])
        self.pipeline = EasyRAGPipeline(dict(config["preset"], data_path=corpus.root), llm=self.lm,
                                        sparse_tokenizer=SparseTokenizer(), splitter=splitter, device=device)
        self.doc_of = [int(n.metadata["file_name"][3:-4]) for n in self.pipeline.nodes]

    def snapshot(self):
        return {"answers": len(self.lm.records), "steps": self.lm.steps}

    def readings(self, opened, closed):
        return {"decode_steps": closed["steps"] - opened["steps"]}

    def close(self):
        self.pipeline = None


build = System


async def _answer(system, qs):
    res = await system.pipeline.run(dict(qs[0]))
    return [res["answer"]]


entries = {"answer": _answer}


def questions(corpus, seed, traffic):
    rng = np.random.default_rng([seed, 2])
    docs = rng.integers(0, len(corpus.texts), size=traffic["cycle"])
    return [{"query": " ".join(corpus.texts[int(d)].split()[1:1 + traffic["words"]])} for d in docs]


def check(cell, oc, seed, device, log, control=False):
    """``answer_gap`` over the window's answers (the toy has no control)."""
    cfg = cell.config
    w = REF.weights(seed, cfg["vocab"], cfg["width"])
    records = oc.system.lm.records[oc.counters["open"]["answers"]:oc.counters["close"]["answers"]]
    gaps = [REF.answer_gap(w, p, s) for p, s in records]
    return {"answer_gap": max(gaps) if gaps else float("inf")}
'''

TOY_CONFIG = {
    "name": "toy_answer", "system": "benchmark/systems/toy_answer.py", "vocab": 97, "width": 16, "max_new": 4,
    "corpus": {"files": 40, "vocab": 200, "mean_words": 20, "min_words": 5, "head_words": 4, "dirs": ["a", "b"]},
    "preset": {"re_only": False, "retrieval_type": 2, "use_reranker": 0, "f_topk_2": 3, "f_topk_3": 1,
               "stopwords_path": ""},
    "limits": {"answer_gap": 1e-4},
}

TOY_MANIFEST = {
    "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"], "run_seconds": 10,
    "configs": [{"name": "toy_answer", "source": "this test", "file": "benchmark/configs/toy_answer.json",
                 "reduced": [], "why": "a seeded answer model in the LLM slot"}],
    "workloads": [{"name": "toy_answer.ask", "config": "toy_answer", "traffic": "ask", "chips": 1,
                   "why": "one client asking for answers"}],
    "end_to_end": [{"name": "answer_p50_ms", "unit": "ms", "better": "lower", "bound": 0.05, "source": "host_clock"},
                   {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}],
    "per_layer": [{"name": "decode_steps.toy", "unit": "steps", "better": "higher", "source": "program_counter",
                   "layer": "generator", "moves": "answer_p50_ms"}],
}

TOY_FILES = {
    "BENCHMARK.json": json.dumps(TOY_MANIFEST),
    "benchmark/configs/toy_answer.json": json.dumps(TOY_CONFIG),
    "benchmark/traffic/ask.json": json.dumps({"entry": "answer", "clients": 1, "cycle": 8, "words": 6}),
    "benchmark/systems/toy_answer.py": TOY_SYSTEM,
    "benchmark/reference/toy_lm.py": TOY_REFERENCE,
    "benchmark/metrics/answer_p50_ms.py":
        "import statistics\n\n\ndef read(rec):\n    lat = rec.latencies()\n"
        "    return statistics.median(lat) * 1e3 if lat else None\n",
    "benchmark/metrics/setup_s.py": "def read(rec):\n    return rec.setup_s\n",
    "benchmark/metrics/decode_steps.toy.py":
        "def read(rec):\n    n = rec.extra.get('decode_steps')\n    return float(n) if n else None\n",
}


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "altered_token"])
def test_toy_configuration(fault, tmp_path, monkeypatch):
    """A configuration made only of new files runs through the harness: its
    own system, entry, questions, readings, reader and check. A served token
    altered where it is produced (the second best in place of the best) reads
    ``correct: false``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cell = load_cell("toy_answer.ask", lay_out(str(tmp_path / "toy"), TOY_FILES))
    if fault:
        monkeypatch.setattr(cell.system.ToyLM, "pick", lambda self, z: int(torch.argsort(z, descending=True)[1]))
    out = run_cell(cell, SEED, 1.0, True, device="cpu", log=quiet)
    assert out["correct"] is not fault, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["decode_steps.toy"]["value"] == 4 * out["attempted"]


def test_load_cell_from_an_explicit_manifest(tmp_path):
    """Every path resolves from the manifest's directory: its own traffic
    file, not the repository's; a missing workload or entry raises."""
    with open(MANIFEST, encoding="utf-8") as f:
        manifest = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", "query_c1.json"), encoding="utf-8") as f:
        traffic = dict(json.load(f), cycle=5)
    path = lay_out(str(tmp_path), {"BENCHMARK.json": json.dumps(manifest),
                                   "benchmark/traffic/query_c1.json": json.dumps(traffic)},
                   link=("configs", "systems", "metrics"))
    cell = load_cell(QUERY, path)
    assert cell.traffic["cycle"] == 5 and load_cell(QUERY).traffic["cycle"] != 5
    assert [m.name for m in cell.per_layer] == [m.name for m in load_cell(QUERY).per_layer]
    with pytest.raises(KeyError):
        load_cell("easyrag_minicpm.nothing", path)
    with open(os.path.join(tmp_path, "benchmark", "traffic", "query_c1.json"), "w", encoding="utf-8") as f:
        json.dump(dict(traffic, entry="nothing"), f)
    with pytest.raises(KeyError):
        load_cell(QUERY, path)


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield "." * node.level + node.module


@pytest.mark.parametrize("name", ["cell.py", "drivers.py"])
def test_harness_names_no_configuration(name):
    """The harness imports nothing of a configuration's system or of a
    reference, and names no model."""
    path = os.path.join(BENCH_DIR, "harness", name)
    for module in _imports(path):
        assert not any(part in ("systems", "reference") for part in module.lstrip(".").split(".")), module
    with open(path, encoding="utf-8") as f:
        text = f.read().lower()
    assert not any(word in text for word in ("minicpm", "bm25", "rerank")), name


# The check's numbers of the tiny query cell over its first three requests,
# recorded with the harness before the seam (``System`` and ``check`` in the
# harness) at four threads: the program's, then the control's.
PARENT = ({"retrieval_gap": 2.686218726458509e-08, "rerank_error": 0.00010186384064981663, "top_mismatch": 0.0},
          {"retrieval_gap": 0.00013904427086854795, "rerank_error": 3.70982453032801, "top_mismatch": 0.0})


def test_query_cell_checks_as_before(tiny_cell, monkeypatch):
    """The same seed gives the same check values through the system module
    as through the harness before it, bit for bit. The window is closed after
    three requests (the drivers' clock jumps past the deadline), so the
    values do not depend on this machine's speed."""
    real, state = time.perf_counter, {"open": False, "done": 0, "offset": 0.0}

    class Clock:
        @staticmethod
        def perf_counter():
            return real() + state["offset"]

    inner_open, inner_call = Hooks.open, drivers.ClosedLoop._call

    def hooks_open(self):
        state["open"] = True
        inner_open(self)

    async def call(self, qs):
        out = await inner_call(self, qs)
        if state["open"]:
            state["done"] += 1
            if state["done"] == 3:
                state["offset"] = 1e6
        return out

    monkeypatch.setattr(drivers, "time", Clock)
    monkeypatch.setattr(Hooks, "open", hooks_open)
    monkeypatch.setattr(drivers.ClosedLoop, "_call", call)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        cell = tiny_cell(QUERY)
        oc = execute(cell, SEED, 1e5, False, "cpu", log=quiet)
        got = tuple(cell.system.check(cell, oc, SEED, "cpu", quiet, control=c) for c in (False, True))
    finally:
        torch.set_num_threads(threads)
    assert len(oc.readings.window.requests) == 3
    assert got == PARENT
