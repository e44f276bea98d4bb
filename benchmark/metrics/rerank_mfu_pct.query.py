"""Useful MiniCPM forward FLOPs of the pairs reranked in the window (real
tokens of real pairs, to the cutoff layer; the benchmark's own count) over
the seconds of the ``rerank`` spans at the bf16 peak, in percent."""

from benchmark.harness import flops


def read(rec):
    useful = flops.rerank_flops(rec)
    secs = sum(rec.spans.get("rerank", []))
    return 100.0 * useful / (secs * flops.PEAK_BF16) if useful and secs else None
