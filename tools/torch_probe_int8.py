#!/usr/bin/env python3
"""H100 probe of s8 x s8 against bf16 tensor-core products
(``easyrag_tpu_torch/csrc/probe_int8.cu``).

Run from the root of a checkout, on a machine with an NVIDIA GPU:
``python3 tools/torch_probe_int8.py [--reps 2048]``. It builds the probe
library with the port's ``_build`` (``nvcc`` for sm_90a) and asks the
question ``tools/exp_attn_int8.py`` asked of the TPU, at its three shapes:
does an s8 product run at twice the bf16 rate at contraction depth 64 (K1's
QK^T, ``[384, 64] @ [64, 1152]``), or only at depth S (PV, ``[384, 1152] @
[1152, 128]``)? ``[512, 512] @ [512, 512]`` checks the peak. For each of
``wgmma.mma_async`` (m64n128k32 s8 against m64n128k16 bf16) and
``mma.sync`` (m16n8k32 s8 against m16n8k16 bf16), every SM computes the
whole product ``--reps`` times with its operands resident in shared memory
and its accumulators carried from one product to the next.

Each JSON line gives the CUDA-event time (median of five launches), the
chip's rate in TOP/s (every SM's products over the time), the microseconds
one SM takes per product, its share of the card's dense peak for the type
(989 TFLOP/s bf16, 1,979 TOP/s int8, NVIDIA's data sheet), the SM clock from
the blocks' ``clock64`` counts, and the card's ``nvidia-smi`` name and power
limit; then the s8/bf16 rate ratio per instruction and shape. The same lines
go to ``build/probe_int8.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NT = 256
SHAPES = ((384, 64, 1152), (384, 1152, 128), (512, 512, 512))  # tools/exp_attn_int8.py's (m, k, n)
PEAK = {"bf16": 989e12, "s8": 1979e12}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2048, help="products per SM per launch")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_probe_int8: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from easyrag_tpu_torch import _build

    lib = _build.load("probe_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_int8.argtypes = [i, i, i, i, i, i, i, p, p, p]
    lib.probe_int8.restype = ctypes.c_int
    for line in _build.build_logs.get("probe_int8", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.split("info    :")[-1].strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    sink = torch.empty(sms * NT, dtype=torch.float32, device="cuda")
    rows, rates = [], {}
    for inst, wg in (("wgmma", 1), ("mma.sync", 0)):
        for m, k, n in SHAPES:
            for dtype, int8 in (("bf16", 0), ("s8", 1)):
                def launch():
                    rc = lib.probe_int8(wg, int8, m, k, n, args.reps, sms, cycles.data_ptr(), sink.data_ptr(), stream)
                    if rc != 0:
                        raise RuntimeError(f"probe_int8 {inst} {dtype} [{m},{k}]@[{k},{n}]: CUDA error {rc}")

                launch()  # warm-up
                torch.cuda.synchronize()
                times = []
                for _ in range(5):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    launch()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                ms = sorted(times)[2]
                ops = 2 * m * k * n * args.reps * sms
                rate = ops / ms / 1e9  # TOP/s
                rates[(inst, m, k, n, dtype)] = rate
                row = {"probe": inst, "dtype": dtype, "shape": f"[{m},{k}]@[{k},{n}]", "reps": args.reps,
                       "ms": ms, "top_s": rate, "us_per_product_per_sm": ms * 1e3 / args.reps,
                       "share_of_peak": rate * 1e12 / PEAK[dtype], "clock_ghz": int(cycles.max()) / (ms * 1e6),
                       "card": smi}
                rows.append(row)
                print(json.dumps(row), flush=True)
    for inst in ("wgmma", "mma.sync"):
        for m, k, n in SHAPES:
            ratio = rates[(inst, m, k, n, "s8")] / rates[(inst, m, k, n, "bf16")]
            row = {"probe": inst, "shape": f"[{m},{k}]@[{k},{n}]", "s8_over_bf16": ratio, "card": smi}
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "probe_int8.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
