#!/usr/bin/env python3
"""H100 probes for K1 (``easyrag_tpu_torch/csrc/probe_k1.cu``).

Run from the root of a checkout, on a machine with an NVIDIA GPU:
``python3 tools/torch_probe_k1.py``. It builds the probe library with the
port's ``_build`` (``nvcc`` for sm_90a), then asks the two questions that
``tools/bench_mxu_k64.py`` and ``tools/bench_vpu.py`` asked of the TPU:

* the tensor cores' bf16 rate at contraction depth 64 against 128, through
  ``mma.sync`` m16n8k16 fed by ``ldmatrix`` from a swizzled shared tile (K1's
  route) and through ``wgmma`` m64nNk16 from shared-memory descriptors, with
  a wait after each product;
* the rates of ``ex2.approx``, ``max.f32`` and a compare-and-select, the
  instructions of K1's online softmax.

Each line gives the CUDA-event time, the rate per second and per clock per
SM (the clock from the blocks' ``clock64`` counts over the event time), and
the card's ``nvidia-smi`` name and power limit. The same lines go to
``build/probe_k1.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NT = 256


def timed(torch, launch, blocks, reps=5):
    """``(ms, cycles)``: median CUDA-event ms of ``launch(cycles, sink)`` and
    the largest block cycle count of the last run."""
    cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
    sink = torch.empty(blocks * NT, dtype=torch.float32, device="cuda")
    launch(cycles, sink)  # warm-up
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(cycles, sink)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2], int(cycles.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_probe_k1: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from easyrag_tpu_torch import _build

    lib = _build.load("probe_k1")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_mma.argtypes = [i, i, i, p, p, p]
    lib.probe_wgmma.argtypes = [i, i, i, i, p, p, p]
    lib.probe_sfu.argtypes = [i, i, i, p, p, p]
    for fn in (lib.probe_mma, lib.probe_wgmma, lib.probe_sfu):
        fn.restype = ctypes.c_int
    log = _build.build_logs.get("probe_k1", "").splitlines()
    for line in log:
        if "registers" in line or "spill" in line:
            print("ptxas:", line.split("info    :")[-1].strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rows = []

    def record(kind, what, ops, ms, cyc, unit):
        ghz = cyc / (ms * 1e6)
        row = {"probe": kind, "case": what, "ms": ms, "rate": ops / ms / 1e9, "unit": unit,
               "per_clock_per_sm": ops / (cyc * sms), "clock_ghz": ghz, "card": smi}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    # tensor cores: two 256-thread blocks per SM for mma.sync, one for wgmma
    iters = 4096
    for depth in (64, 128):
        blocks = 2 * sms

        def mma(c, s, depth=depth, blocks=blocks):
            check(lib.probe_mma(depth, iters // (depth // 64), blocks, c.data_ptr(), s.data_ptr(), stream), "probe_mma")

        ms, cyc = timed(torch, mma, blocks)
        # per warp and iteration: 16 x 64 outputs, depth deep
        flop = blocks * 8 * (iters // (depth // 64)) * 2 * 16 * 64 * depth
        record("mma.sync m16n8k16 (ldmatrix B)", f"depth {depth}", flop, ms, cyc, "TFLOP/s")
    for n in (64, 128):
        for depth in (64, 128):
            blocks = sms

            def wg(c, s, n=n, depth=depth, blocks=blocks):
                check(lib.probe_wgmma(n, depth, iters // (depth // 64), blocks, c.data_ptr(), s.data_ptr(), stream),
                      "probe_wgmma")

            ms, cyc = timed(torch, wg, blocks)
            flop = blocks * 2 * (iters // (depth // 64)) * 2 * 64 * n * depth  # two warpgroups a block
            record(f"wgmma m64n{n}k16 (smem A and B, wait per product)", f"depth {depth}", flop, ms, cyc, "TFLOP/s")
    # softmax instructions: four 256-thread blocks per SM, eight chains a thread
    for op, name in ((0, "ex2.approx.ftz.f32"), (1, "max.f32"), (2, "setp + selp (one masked logit)")):
        blocks, n_it = 4 * sms, 1 << 14

        def sfu(c, s, op=op, blocks=blocks):
            check(lib.probe_sfu(op, n_it, blocks, c.data_ptr(), s.data_ptr(), stream), "probe_sfu")

        ms, cyc = timed(torch, sfu, blocks)
        record(name, "8 chains a thread", blocks * NT * n_it * 8, ms, cyc, "Top/s")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "probe_k1.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
