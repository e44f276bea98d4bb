#!/usr/bin/env python3
"""H100 probe of the MiniCPM decoder layer's fused elementwise chain
(``easyrag_tpu_torch/ops/fused_norm.py``, ``csrc/fused_norm.cu``).

Run from the root of a checkout, on a machine with an NVIDIA GPU:
``python3 tools/torch_probe_fused_norm.py [--no-compile] [--batches 3]``.

1. The kernels' ptxas report (registers, spills).
2. At the reranker's shape (T = 32 x 1216 rows, D = 2304, intermediate
   5760, bf16), each pass of the chain: the input norm, the mid-layer
   residual add + norm, the layer-end residual add, SiLU * up. Bits against
   the plain version (the new residual and the activation equal; the norm's
   largest distance in bf16 steps and the share of elements off by one);
   device ms per call (CUDA events around 20 calls; every input is 180 MB or
   more, so each call reads HBM) of the kernel, the plain version (the eager
   ops the layer ran before) and ``torch.compile`` of the plain version (the
   library call: timed here, never called by the port); the bound, the bytes
   read once and written once over 3.35 TB/s.
3. One full-width MiniCPM ``DecoderLayer`` at B=32, S=1216, right padded:
   the fused layer against the eager ops' layer, the output's largest
   distance in bf16 steps and over its row's largest value, and each
   layer's ms.
4. ``MiniCPMLayerWiseReranker`` at the width and depth of
   bge-reranker-v2-minicpm-layerwise (cutoff 28, random bf16 weights from a
   seed), ``--batches`` 32-pair batches of ~1,200 tokens: wall ms a batch
   with the fused chain and with the eager ops, the ``fused_chain`` events'
   counts, and the scores' largest gap between the two.

JSON lines, also in ``build/probe_fused_norm.json``; the first holds the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES = 3.35e12
B, S, D, I = 32, 1216, 2304, 5760
EPS = 1e-5


def event_ms(torch, fn, reps=20, rounds=5) -> float:
    """Median over ``rounds`` of the device ms per call of ``reps`` calls
    between two CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def ulps(torch, a, b) -> "torch.Tensor":
    """bf16 steps between ``a`` and ``b`` (same sign; 65536 across signs)."""
    ia, ib = a.view(torch.int16).int(), b.view(torch.int16).int()
    return torch.where((ia < 0) == (ib < 0), (ia - ib).abs(), torch.where(a == b, 0, 1 << 16))


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-compile", action="store_true", help="skip the torch.compile yardstick")
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_probe_fused_norm: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # torch.compile's caches stay in the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(REPO, "build", sub))
    import chip_smoke as cs
    from easyrag_tpu_torch import _build
    from easyrag_tpu_torch.models import layers
    from easyrag_tpu_torch.models.layers import DecoderConfig, DecoderLayer, linear, rms_norm
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker
    from easyrag_tpu_torch.ops import fused_norm as fn
    from easyrag_tpu_torch.utils import events

    out_path = os.path.join(REPO, "build", "probe_fused_norm.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    sink = open(out_path, "w")

    def say(line):
        print(json.dumps(line), flush=True)
        sink.write(json.dumps(line) + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["fused_norm"])
    say({"card": smi, "build_s": round(time.perf_counter() - t0, 2),
         "ptxas": [ln.split("info    :")[-1].strip() for ln in _build.build_logs.get("fused_norm", "").splitlines()
                   if "registers" in ln or "spill" in ln]})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    T = B * S
    r = cs.RERANKER["scale_depth"] / cs.RERANKER["num_hidden_layers"] ** 0.5

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    x, h, w = randn(T, D), randn(T, D, scale=4.0), (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).bfloat16()
    gate, up = randn(T, I, scale=3.0), randn(T, I)
    n_el = T * D
    passes = {  # name: (kernel, plain, bytes read once and written once)
        "input_norm": (lambda: fn.residual_rms_norm_kernel(x, w, EPS), lambda: fn.residual_rms_norm_plain(x, w, EPS),
                       4 * n_el + 2 * D),
        "add_norm": (lambda: fn.residual_rms_norm_kernel(x, w, EPS, h, r),
                     lambda: fn.residual_rms_norm_plain(x, w, EPS, h, r), 8 * n_el + 2 * D),
        "residual_add": (lambda: fn.residual_add_kernel(x, h, r), lambda: fn.residual_add_plain(x, h, r), 6 * n_el),
        "silu_mul": (lambda: fn.silu_mul_kernel(gate, up), lambda: fn.silu_mul_plain(gate, up), 6 * T * I),
    }
    compiled = {}
    if not args.no_compile:
        compiled = {
            "input_norm": torch.compile(lambda: fn.residual_rms_norm_plain(x, w, EPS)),
            "add_norm": torch.compile(lambda: fn.residual_rms_norm_plain(x, w, EPS, h, r)),
            "residual_add": torch.compile(lambda: fn.residual_add_plain(x, h, r)),
            "silu_mul": torch.compile(lambda: fn.silu_mul_plain(gate, up)),
        }
    total = {"kernel_ms": 0.0, "plain_ms": 0.0, "compile_ms": 0.0, "bound_ms": 0.0}
    for name, (kern, plain, nbytes) in passes.items():
        got, ref = kern(), plain()
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        torch.cuda.synchronize()
        row = {"pass": name, "shape": [T, I if name == "silu_mul" else D]}
        if name in ("input_norm", "add_norm"):
            d = ulps(torch, got[1], ref[1])
            row.update(residual_equal=bool(torch.equal(got[0], ref[0])), normed_max_ulps=int(d.max()),
                       normed_off_share=float((d > 0).float().mean()))
        else:
            row["equal"] = bool(torch.equal(got[0], ref[0]))
        row["kernel_ms"] = event_ms(torch, kern)
        row["plain_ms"] = event_ms(torch, plain)
        if name in compiled:
            c = compiled[name]()
            c = c if isinstance(c, tuple) else (c,)
            row["compile_equal"] = [bool(torch.equal(a, b)) for a, b in zip(c, ref)]
            row["compile_ms"] = event_ms(torch, compiled[name])
        row["bound_ms"] = nbytes / PEAK_BYTES * 1e3
        row["kernel_share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        for k in total:
            total[k] += row.get(k, 0.0)
        say(row)
    # a layer's chain: the input norm, the add + norm, the layer-end add, SiLU * up
    say({"pass": "chain", **total})
    del x, h, gate, up
    torch.cuda.empty_cache()

    cfg = DecoderConfig(**cs.RERANKER)
    layer = DecoderLayer(cfg, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        for name in layers.PROJECTIONS:
            p = getattr(layer, name)["w"]
            p.copy_(torch.randn(p.shape, generator=gen, device=dev).bfloat16() * 0.02)
        for norm in (layer.input_norm, layer.post_norm):
            norm.copy_(1 + 0.1 * torch.randn(D, generator=gen, device=dev))
    hx = randn(B, S, D)
    n_real = [S - 37 * (i % 9) for i in range(B)]
    kv_start = torch.zeros(B, dtype=torch.int32, device=dev)
    kv_end = torch.tensor(n_real, dtype=torch.int32, device=dev)
    cos, sin = layers.rope_tables(S, cfg.hd, cfg.rope_theta, device=dev)

    def eager_layer():
        q, k, v = layers.qkv_proj(cfg, layer.tree()["attn"], rms_norm(hx, layer.input_norm, EPS))
        h1 = linear(layers.attention(cfg, q, k, v, kv_start, kv_end, cos, sin), layer.o)
        x1 = hx + h1 * r
        m = rms_norm(x1, layer.post_norm, EPS)
        return x1 + linear(F.silu(linear(m, layer.gate)) * linear(m, layer.up), layer.down) * r

    with torch.inference_mode():
        got, ref = layer(hx, kv_start, kv_end, cos, sin), eager_layer()
        d = ulps(torch, got, ref)
        rel = ((got.float() - ref.float()).abs().amax(-1) / ref.float().abs().amax(-1)).max()
        say({"layer": [B, S, D], "max_ulps": int(d.max()), "off_share": float((d > 0).float().mean()),
             "max_diff_over_row_max": float(rel), "fused_ms": event_ms(torch, lambda: layer(hx, kv_start, kv_end, cos, sin), reps=5),
             "eager_ms": event_ms(torch, eager_layer, reps=5)})
    del layer, hx
    torch.cuda.empty_cache()

    scorer = MiniCPMLayerWiseReranker(
        cfg, cs.CharTokenizer(cfg.vocab_size), start_layer=8, cutoff_layer=28, max_length=cs.MAX_LENGTH,
        device=dev, dtype=torch.bfloat16,
    ).init_random_(gen.manual_seed(cs.SEED))
    import tools.torch_profile_rerank as prof_tool

    pairs = prof_tool.make_pairs(32, cs.SEED)
    counts = []
    off = events.on(lambda kind, p: counts.append(p) if kind == "fused_chain" else None)
    plain_chain = layers.Chain(fn.residual_rms_norm_plain, fn.residual_add_plain, fn.silu_mul_plain)
    fused_chain = layers.FUSED

    def batches(chain):
        layers.FUSED = chain  # the rerankers' layers read the chain at each call
        scores = scorer.score_pairs(pairs)[0]  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.batches):
            t = time.perf_counter()
            scorer.score_pairs(pairs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        return scores, walls

    try:
        fused_scores, fused_walls = batches(fused_chain)
        fused_counts = list(counts)
        eager_scores, eager_walls = batches(plain_chain)
        fused_scores2, fused_walls2 = batches(fused_chain)
    finally:
        off()
        layers.FUSED = fused_chain
    say({"reranker": "minicpm cutoff 28", "padded_length": int(scorer.build_inputs(pairs)[0].shape[1]),
         "fused_batch_ms": fused_walls + fused_walls2, "eager_batch_ms": eager_walls,
         "fused_chain_events": fused_counts[:2], "events_per_batch": len(fused_counts) / (1 + args.batches),
         "scores_max_gap": float(abs(fused_scores - eager_scores).max()),
         "scores_spread": float(eager_scores.max() - eager_scores.min()),
         "fused_repeat_equal": bool((fused_scores == fused_scores2).all())})
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
