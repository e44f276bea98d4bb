"""The readings the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control 3 --seconds 12

For each seed, in one process: one run of the cell with a short window at
its own load (``cell.execute``), then the numbers the check compares for the
program, and, on the first ``--control`` seeds, for the control: the
reference one precision below the configuration's standing in the
program's place on the same questions and candidates (the configuration's
system module's ``check`` with ``control``). ``--override`` runs the program
with its own lower-precision path switched on instead (then its numbers are
a control's). Prints one JSON line per seed and, last, the largest reading
of the program and the smallest of the control for each number.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from benchmark.run import cache_env, card_line, finite  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds (the first ones) that also read the control")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--override", default="",
                    help="JSON merged into the traffic's overrides, e.g. the program's own lower-precision path")
    args = ap.parse_args()
    cache_env()
    from benchmark.harness.cell import execute, load_cell

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    cell = load_cell(args.workload)
    check = cell.system.check
    for key, value in (json.loads(args.override) if args.override else {}).items():
        over = cell.traffic.setdefault("overrides", {})
        if key == "tpu":
            over.setdefault("tpu", {}).update(value)
        else:
            over[key] = value
    lower: dict = {}
    upper: dict = {}
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        oc = execute(cell, seed, args.seconds, False, "cuda", log=log)
        reqs = oc.readings.window.requests
        line = {"seed": seed, "requests": len(reqs), "failed": sum(not r.ok for r in reqs),
                "setup_s": oc.readings.setup_s, "program": check(cell, oc, seed, "cuda", log)}
        for name, v in line["program"].items():
            lower[name] = max(lower.get(name, -math.inf), v)
        if k < args.control:
            line["control"] = check(cell, oc, seed, "cuda", log, control=True)
            for name, v in line["control"].items():
                upper[name] = min(upper.get(name, math.inf), v)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(finite(line)), flush=True)
        del oc
    print(json.dumps(finite({"lower": lower, "upper": upper})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
