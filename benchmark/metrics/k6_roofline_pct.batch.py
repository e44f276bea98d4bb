"""K6 (``ops/chunkmax.py``) in the window: the summed bound of every call
at the shapes the top-k handed it over K6's device seconds from the trace,
in percent."""

from benchmark.harness import flops


def read(rec):
    secs = rec.trace.seconds("chunk_max_kernel")
    if not secs or not rec.k6:
        return None
    bound = sum(flops.bound_s(*flops.k6_launch(r, c), peak=flops.PEAK_F32) for r, c in rec.k6)
    return 100.0 * bound / secs
