"""The check fails what it must: the control (the reference one precision
below the configuration's in the program's place) and faults planted in the
timed path. Each test skips the harness's look for a card and drives the
rest of a run at a tiny size on the CPU, under the cell's own limits."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark.harness import judge
from benchmark.harness.cell import execute, run_cell
from benchmark.run import finite, result_line
from benchmark.tests.conftest import BATCH, QUERY, SEED

quiet = lambda *a: None  # noqa: E731


def run(cell, trace=False):
    return run_cell(cell, SEED, 2.0, trace, device="cpu", log=quiet)


@pytest.mark.parametrize("workload", [QUERY, BATCH])
def test_sound_run_is_correct(workload, tiny_cell):
    out = run(tiny_cell(workload))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", [QUERY, BATCH])
def test_result_line_keys(workload, tiny_cell):
    out = run(tiny_cell(workload), trace=True)
    line, notes = result_line(out, {"platform": "gpu", "kind": "test", "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert {"memory_peak_bytes", "busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert notes[-len(line["checks"]):] == [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                                            for k, v in line["checks"].items()]
    json.loads(json.dumps(finite(line)))
    plain, _ = result_line(run(tiny_cell(workload)), {"platform": "gpu", "kind": "test", "count": 1})
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert "setup_s" in plain["metrics"]


@pytest.mark.parametrize("workload", [QUERY, BATCH])
def test_control_is_not_correct(workload, tiny_cell):
    cell = tiny_cell(workload)
    oc = execute(cell, SEED, 2.0, False, "cpu", log=quiet)
    ok, checks = judge.verdict(cell.system.check(cell, oc, SEED, "cpu", quiet, control=True), cell.config["limits"])
    assert not ok, checks


def test_altered_score_is_caught(tiny_cell, monkeypatch):
    """A score altered where it is produced: the first pair of every batch
    put a spread above the batch's best."""
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker

    inner = MiniCPMLayerWiseReranker.score_pairs

    def score_pairs(self, pairs, judge=False):
        scores, layer = inner(self, pairs, judge)
        scores = np.array(scores)
        scores[0] = 2 * scores.max() - scores.min()
        return scores, layer

    monkeypatch.setattr(MiniCPMLayerWiseReranker, "score_pairs", score_pairs)
    assert not run(tiny_cell(QUERY))["correct"]


def test_half_batch_left_out_is_caught(tiny_cell, monkeypatch):
    """Half of every rerank batch left out, its scores the mean of the rest."""
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker

    inner = MiniCPMLayerWiseReranker.score_pairs

    def score_pairs(self, pairs, judge=False):
        half = max(len(pairs) // 2, 1)
        scores, layer = inner(self, pairs[:half], judge)
        return np.concatenate([scores, np.full(len(pairs) - half, scores.mean())]), layer

    monkeypatch.setattr(MiniCPMLayerWiseReranker, "score_pairs", score_pairs)
    assert not run(tiny_cell(QUERY))["correct"]


def test_half_of_the_retrieval_batch_left_out_is_caught(tiny_cell, monkeypatch):
    """Half of every retrieval call's questions left out, the first half's
    answers given in their place."""
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline

    inner = EasyRAGPipeline.run_retrieval_batch

    async def run_retrieval_batch(self, queries):
        half = await inner(self, queries[: max(len(queries) // 2, 1)])
        return (half * 2)[: len(queries)]

    monkeypatch.setattr(EasyRAGPipeline, "run_retrieval_batch", run_retrieval_batch)
    assert not run(tiny_cell(BATCH))["correct"]


@pytest.mark.parametrize("workload", [QUERY, BATCH])
def test_altered_candidates_are_caught(workload, tiny_cell, monkeypatch):
    """A retrieval answer altered where it is produced: the content route's
    last candidate dropped."""
    from easyrag_tpu_torch.retrievers import HybridRetriever

    inner = HybridRetriever.fusion.__func__

    def fusion(cls, lists, topk=256):
        return inner(cls, [lists[0][:-1]] + list(lists[1:]), topk)

    monkeypatch.setattr(HybridRetriever, "fusion", classmethod(fusion))
    from easyrag_tpu_torch.pipeline import EasyRAGPipeline

    inner_fuse = EasyRAGPipeline._fuse_corpus_lists
    monkeypatch.setattr(EasyRAGPipeline, "_fuse_corpus_lists",
                        lambda self, lists: inner_fuse(self, [lists[0][:-1]] + list(lists[1:])))
    assert not run(tiny_cell(workload))["correct"]

