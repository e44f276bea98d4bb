"""The yardstick's peaks and the operations and bytes of the work measured.

Peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense, 700 W): 989
TFLOP/s in bf16, 67 TFLOP/s in f32 outside the tensor cores, 3.35 TB/s of
HBM. A kernel's bound is the larger of its operations
over the peak and its bytes over the bandwidth, with every input byte read
once and every output byte written once, over real rows only
(``chip_smoke.py``'s ``bound``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def bound_s(ops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """Least seconds the card could take for ``ops`` at ``peak`` and ``nbytes``."""
    return max(ops / peak, nbytes / PEAK_BYTES)


def causal_pairs(length: int) -> int:
    """(query, key) pairs of causal attention over ``length`` real tokens."""
    return length * (length + 1) // 2


def decoder_flops(cfg: Dict, lengths: Iterable[int], layers: int) -> float:
    """Useful forward FLOPs of ``layers`` decoder layers over rows of the
    given real lengths: the projections (2 per weight per token) and causal
    attention (QK^T and PV, 4 * head width per pair and head)."""
    d, inter = cfg["hidden_size"], cfg["intermediate_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // nh
    weights = d * nh * hd * 2 + d * nkv * hd * 2 + 3 * d * inter
    total = 0.0
    for n in lengths:
        total += 2.0 * weights * n + 4.0 * hd * nh * causal_pairs(n)
    return total * layers


def k1_launch(lengths: Sequence[int], padded: int, heads: int) -> Tuple[float, float]:
    """``(ops, bytes)`` of one K1 launch (causal head_dim-64 attention with
    RoPE) over rows of the given real lengths: q, k and v read and the output
    written on real rows, the key ranges, and the ``[S, 64]`` f32 cos and sin
    tables."""
    hd = 64
    ops = sum(4.0 * hd * heads * causal_pairs(n) for n in lengths)
    nbytes = sum(4.0 * n * heads * hd * 2 for n in lengths) + 8.0 * len(lengths) + 2.0 * padded * hd * 4
    return ops, nbytes


def k6_launch(rows: int, cols: int) -> Tuple[float, float]:
    """``(ops, bytes)`` of one K6 launch: ``[rows, cols]`` f32 read, one
    compare per element, ``[rows, cols / 8]`` f32 written."""
    return float(rows * cols), rows * cols * 4.0 + rows * (cols // 8) * 4.0


def rerank_flops(rec) -> float:
    """Useful forward FLOPs of the window's rerank batches: each batch's
    real pairs (the program's ``reranking`` events; the tail's padding
    duplicates left out), their real tokens, through the layers the batch
    ran. Needs the traced run's batch shapes (``extra["batches"]``)."""
    batches = rec.extra.get("batches")
    pairs = [p["pairs"] for kind, p in rec.events if kind == "reranking" and "pairs" in p]
    if not batches or len(batches) != len(pairs):
        return 0.0
    return sum(decoder_flops(rec.config, lengths[:n], layers)
               for (_, _, lengths, layers), n in zip(batches, pairs))
