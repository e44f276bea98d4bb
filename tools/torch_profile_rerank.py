"""Where the time of one reranker batch goes on the card.

Builds one of the port's rerankers at full width and depth with random bf16
weights from a seed, at the reference's operating point (``max_length``
1024), and scores ``--batches`` 32-pair batches of ~1100-token pairs with
CUDA-event timing, then one batch under ``torch.profiler``:

* ``--model gemma``: ``GemmaCostWiseReranker`` at the width and depth of
  bge-reranker-v2.5-gemma2-lightweight (Gemma2-9B body; cutoff 28,
  compression at layer 24 by 2), attention through K4;
* ``--model minicpm``: ``MiniCPMLayerWiseReranker`` at the width and depth of
  bge-reranker-v2-minicpm-layerwise (cutoff 28, heads from layer 8, right
  padding), attention through K1.

``--quant w8a8`` quantizes the scorer's projections on the card
(``layers.quantize_layers_``: int8 weights, activations quantized per token at run time),
as ``configs/four_tenant.yaml``'s ``tpu.reranker_quant`` asks.

Prints the wall time per batch, the device's busy and idle shares of the
profiled batch, the device time by kind (the attention kernel, the GEMMs:
cuBLAS in bf16, ``torch._int_mm`` under w8a8; under w8a8 the per-token
quantization passes and the rescales of the s32 products; MiniCPM's fused
norms, residual adds and SiLU * up; the rest, the eager elementwise ops)
and the kernels that take the most time.

Run on a machine with one CUDA card:
    python tools/torch_profile_rerank.py [--model gemma|minicpm] [--quant w8a8] [--batches 3] [--batch 32]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from easyrag_tpu_torch.models.gemma import GemmaCostWiseReranker  # noqa: E402
from easyrag_tpu_torch.models import layers  # noqa: E402
from easyrag_tpu_torch.models.layers import DecoderConfig  # noqa: E402
from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker  # noqa: E402
from easyrag_tpu_torch.ops import flash64 as k1  # noqa: E402
from easyrag_tpu_torch.ops import flash_softcap as k4  # noqa: E402

GEMM_MARKS = ("gemm", "cutlass", "nvjet", "xmma", "sm90_")
# the MiniCPM layer's norms, residual adds and SiLU * up (csrc/fused_norm.cu)
FUSED_MARKS = ("residual_rms_norm_kernel", "pair_kernel")
# the w8a8 passes, profiled as named ranges: range name -> the function in models/layers.py
LABELS = {"a8 quantization": "quantize_tokens", "a8 rescale": "rescale_s32"}


def kind(name: str) -> str:
    low = name.lower()
    if "attn_sm90" in low:  # K4's kernel body (shared with K3, which no reranker runs)
        return "K4"
    if "flash64" in low or "rope_k" in low:
        return "K1"
    if any(m in low for m in GEMM_MARKS):
        return "GEMM"
    if any(m in low for m in FUSED_MARKS):
        return "fused chain"
    return "other"


def ranged(fn, label):
    """``fn`` inside a ``torch.profiler.record_function`` range ``label``."""
    def call(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return call


def make_pairs(batch: int, seed: int):
    """Query/passage pairs shaped like the pipeline's: a short query and a
    ~300-word passage of the synthetic corpus's words."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(batch):
        query = " ".join(f"t{t}" for t in rng.integers(0, 4000, size=12))
        passage = f"文档{i}\n" + " ".join(f"t{t}" for t in rng.zipf(1.3, size=300) % 40_000)
        pairs.append((query, passage))
    return pairs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("gemma", "minicpm"), default="gemma")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--quant", choices=("", "w8a8"), default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0])
    gen = torch.Generator(device=dev)
    if args.model == "gemma":
        cfg = DecoderConfig(**cs.GEMMA2_9B)
        scorer = GemmaCostWiseReranker(
            cfg, cs.CharTokenizer(cfg.vocab_size), cutoff_layer=cs.GEMMA_CUTOFF, compress_layer=cs.GEMMA_COMPRESS,
            compress_ratio=2, max_length=cs.MAX_LENGTH, device=dev, dtype=torch.bfloat16,
        ).init_random_(gen.manual_seed(cs.SEED + 7), start_layer=cs.GEMMA_START)
        attn, mod = "K4", k4
    else:
        cfg = DecoderConfig(**cs.RERANKER)
        scorer = MiniCPMLayerWiseReranker(
            cfg, cs.CharTokenizer(cfg.vocab_size), start_layer=8, cutoff_layer=28, max_length=cs.MAX_LENGTH,
            device=dev, dtype=torch.bfloat16,
        ).init_random_(gen.manual_seed(cs.SEED))
        attn, mod = "K1", k1
    if args.quant:
        layers.quantize_layers_(scorer, args.quant)
        torch.cuda.synchronize()
        print(f"projections quantized to {args.quant}")
    # the w8a8 passes as named ranges: their kernels' device time is read off them
    for name, label in LABELS.items():
        setattr(layers, label, ranged(getattr(layers, label), name))
    pairs = make_pairs(args.batch, cs.SEED)
    ids = scorer.build_inputs(pairs)[0]
    print(f"batch {args.batch} pairs, padded length {ids.shape[1]}")
    scorer.score_pairs(pairs)  # warm-up
    torch.cuda.synchronize()

    walls = []
    for _ in range(args.batches):
        t0 = time.perf_counter()
        scorer.score_pairs(pairs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"wall per batch: median {statistics.median(walls):.1f} ms over {len(walls)} "
          f"({', '.join(f'{w:.1f}' for w in walls)})")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launches_0 = mod.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.score_pairs(pairs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind = {attn: 0.0, "GEMM": 0.0, "fused chain": 0.0, "other": 0.0}
    kernels, ranges = [], {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.key in LABELS:  # a range's span on the device, not a kernel
            ranges[e.key] = us / 1e3
            continue
        by_kind[kind(e.key)] = by_kind.get(kind(e.key), 0.0) + us / 1e3
        kernels.append((us / 1e3, e.count, e.key))
    for key, ms in ranges.items():  # their kernels are elementwise ones, counted under "other" by name
        by_kind[key] = ms
        by_kind["other"] -= ms
    busy = sum(by_kind.values())
    print(f"profiled batch: wall {wall:.1f} ms, device busy {busy:.1f} ms ({busy / wall:.1%}), "
          f"idle {1 - busy / wall:.1%}; {attn} launches {mod.launches - launches_0}")
    for name, ms in by_kind.items():
        print(f"  {name}: {ms:.1f} ms ({ms / busy:.1%} of device time)")
    print("kernels by device time:")
    for ms, n, name in sorted(kernels, reverse=True)[:12]:
        print(f"  {ms:9.2f} ms  {n:5d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
