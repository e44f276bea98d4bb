"""K1 (``ops/flash64.py``: the RoPE prologue and the attention kernel) in
the window: the summed bound of every launch at the shapes the scorer built
(one launch per layer run per batch) over K1's device seconds from the
trace, in percent."""

from benchmark.harness import flops


def read(rec):
    secs = rec.trace.seconds("flash64_kernel", "rope_k_kernel")
    batches = rec.extra.get("batches")
    if not secs or not batches:
        return None
    heads = rec.config["num_attention_heads"]
    bound = sum(flops.bound_s(*flops.k1_launch(lengths, S, heads)) * layers for _, S, lengths, layers in batches)
    return 100.0 * bound / secs
