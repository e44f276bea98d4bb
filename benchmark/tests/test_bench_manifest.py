"""Every cell of BENCHMARK.json resolves its files, and the manifest keeps
the contract's shape."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.harness.cell import BENCH_DIR, ROOT, load_cell

with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
    MANIFEST = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves(workload):
    cell = load_cell(workload)
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in [m.name for m in cell.end_to_end]
    assert all(callable(m.read) for m in cell.end_to_end + cell.per_layer)
    assert cell.traffic["entry"] in cell.system.entries
    assert callable(cell.system.build) and callable(cell.system.check)


def test_manifest_shape():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert all(os.path.isdir(os.path.join(ROOT, p)) for p in m["paths"])
    assert os.path.isfile(os.path.join(ROOT, m["command"][1]))
    names = [x["name"] for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"] and "assumed" in conf
        assert conf["system"].startswith(m["paths"][0] + "/systems/") and os.path.isfile(os.path.join(ROOT, conf["system"]))
    cells = {w["name"]: w for w in m["workloads"]}
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace") and UNIT.match(x["unit"])
    for x in m["per_layer"]:
        assert x["moves"] in e2e and UNIT.match(x["unit"]) and "\n" not in x["layer"]
        for w in x["workloads"]:
            assert w in cells
            assert "workloads" not in e2e[x["moves"]] or w in e2e[x["moves"]]["workloads"]
    for x in m["end_to_end"] + m["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics", f"{x['name']}.py"))
    # the full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) < 64 * 1024


def test_no_card_no_result():
    """Without a CUDA card the command fails and prints no result line."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        return  # the look for a card passes here; the chip runs exercise the rest
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload", MANIFEST["workloads"][0]["name"],
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode != 0 and "{" not in proc.stdout
