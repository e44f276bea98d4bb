"""The benchmark of ``easyrag_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: builds the
cell's corpus, questions and weights from the seed, warms up, measures for
``--seconds``, checks the window's outputs against the plain reference under
``benchmark/reference/``, and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics from a ``torch.profiler`` trace of
the window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit (also printed, as the last
lines of standard error). It fails without a CUDA card, or without as many
as the cell asks for, and when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "easyrag_tpu")


def cache_env() -> None:
    """Compile caches inside the checkout, at fixed paths; no library may
    pull in JAX through transformers; no per-block trace export."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("EASYRAG_TRACE_DIR", None)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def finite(x):
    """JSON-safe numbers: a non-finite value becomes None."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cache_env()
    sys.path.insert(0, ROOT)

    from benchmark.harness.cell import load_cell, run_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0, log=log)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    line, notes = result_line(out, device)
    for note in notes:
        log(note)
    bad = loaded_forbidden()
    if bad:
        log(f"forbidden modules loaded in the benchmark's process: {bad}")
        return 3
    print(json.dumps(finite(line)), flush=True)
    return 0


def result_line(out, device):
    """``run_cell``'s fields -> the result line (``checks`` its last key)
    and the lines for standard error (failed requests, then each compared
    number with its limit)."""
    out = dict(out)
    device = dict(device, memory_peak_bytes=out.pop("_memory_peak"))
    if "_busy_s" in out:
        device["busy_s"], device["window_s"] = out.pop("_busy_s"), out.pop("_window_s")
    notes = [f"failed request: {e}" for e in out.pop("_errors")]
    checks = out.pop("checks")
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = device
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    notes += [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]
    return line, notes


if __name__ == "__main__":
    sys.exit(main())
