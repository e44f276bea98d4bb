"""Useful MiniCPM forward FLOPs of the pairs reranked in the window over
the whole window's seconds at the bf16 peak, in percent: the whole step's
share of the card, which bounds every kernel's gain."""

from benchmark.harness import flops


def read(rec):
    useful = flops.rerank_flops(rec)
    return 100.0 * useful / (rec.window.seconds * flops.PEAK_BF16) if useful else None
