#!/usr/bin/env python3
"""H100 probe of the chunk-max forms and of chunk-max pruning
(``easyrag_tpu_torch/csrc/probe_chunkmax.cu`` beside K6,
``easyrag_tpu_torch/csrc/chunkmax.cu``).

Run from the root of a checkout, on a machine with an NVIDIA GPU:
``python3 tools/torch_probe_chunkmax.py``. It asks ``tools/exp_chunkmax.py``'s
questions of the H100, at the TPU probe's shape ``[256, 20480]`` and a
stream batch's ``[64, 20000]``:

1. the max of each 8-element chunk, four ways: PyTorch's ``amax`` over
   contiguous 8 (``minor8``, K6's function and its library call), ``amax``
   over 8 rows of 128 (``strided``, ``pallas_sublane``'s function, another
   chunk), K6, and the strided kernel. Each is timed as device time per call
   (CUDA events around a CUDA graph of 50 calls) on one input (``hot``: the
   input stays in the 50 MB L2, as the scores a top-k reads have just been
   written) and cycling through copies that total 200 MB (``cold``: every
   call reads HBM), in GB/s of input read plus output written and as a share
   of 3.35 TB/s. K6 and the strided kernel are held to their ``amax`` forms
   bit for bit;
2. the selection of the top 288 chunks from the chunk maxima: the flip and a
   stable descending sort (what the port does) against the two-key sort the
   strided layout needs (two stable sorts: by the chunk's argmax index,
   then by value);
3. the whole top-k both ways, the full stable sort against the chunk-max
   pruned path, at B = 1 and 64, n = 20,000, k = 6, 192 and 288 (CUDA-event
   medians, host launches included, as the pipeline pays them), each pair
   held equal index for index.

The last JSON line says, per (B, k), how many times faster the pruned path
ran than the full sort: whether pruning pays on this card. Every line also
goes to ``build/probe_chunkmax.json``; the card's ``nvidia-smi`` name and
power limit are in the first.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES = 3.35e12
COLD_BYTES = 200 << 20
SHAPES = ((256, 20480), (64, 20000))
TOPK = [(b, 20000, k) for b in (1, 64) for k in (6, 192, 288)]


def graph_ms(torch, calls, n=50) -> float:
    """Device milliseconds per call: CUDA events around the replay of a
    graph of ``n`` calls taken in turn from ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            calls[i % len(calls)]()
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def event_ms(torch, fn, reps=20) -> float:
    """Median milliseconds of ``fn`` between two CUDA events, host launches
    included."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_probe_chunkmax: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from easyrag_tpu_torch import _build
    from easyrag_tpu_torch.ops import chunkmax, topk

    _build.build(["chunkmax", "probe_chunkmax"])
    lib = _build.load("probe_chunkmax")
    lib.strided_max_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.strided_max_launch.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    lines = [{"card": smi, "ptxas": {name: [ln.split("info    :")[-1].strip() for ln in
                                            _build.build_logs.get(name, "").splitlines()
                                            if "registers" in ln or "spill" in ln]
                                     for name in ("chunkmax", "probe_chunkmax")}}]
    print(json.dumps(lines[-1]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def strided(x, out):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.strided_max_launch(x.data_ptr(), out.data_ptr(), out.numel() // 128, stream),
                     "strided_max_launch")
        return out

    for B, N in SHAPES:
        nbytes = B * N * 4
        copies = [torch.randn(B, N, generator=gen, device="cuda") for _ in range(-(-COLD_BYTES // nbytes))]
        x = copies[0]
        outs_s = [torch.empty(B * N // 1024, 128, device="cuda") for _ in copies]
        k6, ref8 = chunkmax.chunk_max(x), x.view(B, N // 8, 8).amax(-1)
        st, ref_s = strided(x, outs_s[0]), x.view(-1, 8, 128).amax(1)
        exact = bool(torch.equal(k6, ref8)) and bool(torch.equal(st, ref_s))
        forms = {
            "minor8 amax": lambda i: copies[i].view(B, N // 8, 8).amax(-1),
            "strided amax": lambda i: copies[i].view(-1, 8, 128).amax(1),
            "K6": lambda i: chunkmax.chunk_max(copies[i]),
            "strided kernel": lambda i: strided(copies[i], outs_s[i]),
        }
        row = {"shape": [B, N], "bytes": nbytes + nbytes // 8, "exact": exact}
        for name, fn in forms.items():
            hot = graph_ms(torch, [lambda fn=fn: fn(0)])
            cold = graph_ms(torch, [lambda fn=fn, i=i: fn(i) for i in range(len(copies))])
            gbs = row["bytes"] / cold / 1e6
            row[name] = {"hot_ms": hot, "cold_ms": cold, "cold_GBps": gbs, "share": gbs * 1e9 / PEAK_BYTES,
                         "hot_GBps": row["bytes"] / hot / 1e6}
        # the selection of the top 288 chunks from K6's maxima
        cmax = k6
        nc = cmax.shape[1]
        tk = min(288, nc)
        carg = torch.arange(nc, device="cuda") * 8 + x.view(B, nc, 8).argmax(-1)

        def sel_flip():
            return (nc - 1) - torch.sort(cmax.flip(-1), dim=-1, descending=True, stable=True).indices[:, :tk]

        def sel_two_key():
            by_idx = torch.sort(carg, dim=-1, descending=True).indices
            v = torch.gather(cmax, 1, by_idx)
            return torch.gather(by_idx, 1, torch.sort(v, dim=-1, descending=True, stable=True).indices[:, :tk])

        row["select flip+stable sort ms"] = event_ms(torch, sel_flip)
        row["select two-key sort ms"] = event_ms(torch, sel_two_key)
        lines.append(row)
        print(json.dumps(lines[-1]), flush=True)
        del copies, outs_s

    verdict = {}
    for B, n, k in TOPK:
        s = torch.rand(B, n, generator=gen, device="cuda")
        s = torch.where(torch.rand(B, n, generator=gen, device="cuda") < 0.5, float("-inf"), s)
        full = topk._sorted_topk(s, k)
        pruned = topk._chunkmax_pruned_topk(s, k)
        same = bool(torch.equal(full[1], pruned[1])) and bool(torch.equal(full[0], pruned[0]))
        t_full = event_ms(torch, lambda: topk._sorted_topk(s, k))
        t_pruned = event_ms(torch, lambda: topk._chunkmax_pruned_topk(s, k))
        lines.append({"topk": [B, n, k], "full_sort_ms": t_full, "pruned_ms": t_pruned, "equal": same,
                      "pruned_speedup": t_full / t_pruned})
        verdict[f"B={B},k={k}"] = t_full / t_pruned
        print(json.dumps(lines[-1]), flush=True)
        if not same:
            print("torch_probe_chunkmax: the pruned top-k differs from the full sort", file=sys.stderr)
            return 1
    lines.append({"pruning_pays": all(v > 1 for v in verdict.values()), "speedup_by_case": verdict})
    print(json.dumps(lines[-1]), flush=True)
    if not all(row.get("exact", True) for row in lines):
        print("torch_probe_chunkmax: a kernel differs from its amax form", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "probe_chunkmax.json"), "w") as f:
        f.write("\n".join(json.dumps(line) for line in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
