"""The yardstick's operation and byte counts at known shapes."""

from __future__ import annotations

import math

from benchmark.harness import flops


def test_decoder_flops_by_hand():
    cfg = {"hidden_size": 4, "intermediate_size": 6, "num_attention_heads": 2, "num_key_value_heads": 1}
    # weights: q 4x4, k 4x2, v 4x2, o 4x4, gate/up/down 3 x 4x6 = 16+8+8+16+72 = 120
    # one row of 3 tokens: 2*120*3 projections + 4*2*2*(1+2+3) attention = 720 + 96
    assert flops.decoder_flops(cfg, [3], layers=1) == 816
    assert flops.decoder_flops(cfg, [3, 3], layers=2) == 4 * 816


def test_kernel_counts():
    ops, nbytes = flops.k1_launch([2, 1], padded=4, heads=3)
    assert ops == 4 * 64 * 3 * (3 + 1)
    assert nbytes == 4 * 3 * 3 * 64 * 2 + 8 * 2 + 2 * 4 * 64 * 4
    ops, nbytes = flops.k6_launch(2, 16)
    assert (ops, nbytes) == (32.0, 2 * 16 * 4 + 2 * 2 * 4)
    assert math.isclose(flops.bound_s(989e12, 0), 1.0)
    assert math.isclose(flops.bound_s(0, 3.35e12), 1.0)
    assert flops.causal_pairs(4) == 10


def test_rerank_flops_from_events_and_shapes():
    """The reranked pairs come from the program's ``reranking`` events, the
    shapes from the system's readings; the tail's padding rows are left out,
    and a count that does not pair up reads nothing."""
    from benchmark.harness.cell import Readings

    cfg = {"hidden_size": 4, "intermediate_size": 6, "num_attention_heads": 2, "num_key_value_heads": 1}
    events = [("reranking", {"candidates": 3}), ("reranking", {"pairs": 1}), ("fused_chain", {"kernel": 4})]
    rec = Readings(config=cfg, traffic={}, events=events, extra={"batches": [(2, 3, [3, 3], 1)]})
    assert flops.rerank_flops(rec) == 816
    rec.events = events + [("reranking", {"pairs": 2})]
    assert flops.rerank_flops(rec) == 0.0
