"""The port's two-stage cascade with the carry against its re-score path and
against the JAX package's.

The analogues of ``tests/test_cascade.py``'s carry cases (:180-206): a tiny
MiniCPM (``test_torch_minicpm``'s tree) behind ``LLMRerank`` with
``use_efficient=3``; stage 2 from the carried judge-layer hidden states must
give the re-score path's order and scores (f32, rtol 1e-4, atol 1e-5) on
both padding sides and with survivors from chunks of different sequence
buckets, and so must the JAX package's carried cascade on the same tree. A
scorer without ``score_pairs_carry`` takes the re-score path, and the scorer's
cutoff comes back even when a batch raises.
"""

import numpy as np
import pytest
import torch

from easyrag_tpu.models.minicpm import MiniCPMLayerWiseReranker as JaxReranker
from easyrag_tpu.rerankers import LLMRerank as JaxLLMRerank
from easyrag_tpu.schema import NodeWithScore as JaxNode
from easyrag_tpu.schema import QueryBundle as JaxQuery
from easyrag_tpu.schema import TextNode as JaxText
from easyrag_tpu_torch.models.convert import minicpm_from_jax
from easyrag_tpu_torch.models.layers import DecoderConfig
from easyrag_tpu_torch.models.minicpm import gather_padded_rows
from easyrag_tpu_torch.rerankers import LLMRerank
from easyrag_tpu_torch.schema import NodeWithScore, QueryBundle, TextNode
from test_torch_minicpm import ARCH, CharTok, tiny_params

torch.set_num_threads(1)

OPTS = dict(start_layer=1, cutoff_layer=4, max_length=64, efficient_layers=(2,), use_efficient=3)


def _texts(n):
    # varied passage lengths force different per-chunk sequence buckets
    return ["doc " + "x y z " * (3 + 7 * (i % 3)) + str(i) for i in range(n)]


def _run(package, carry, side="left", n=11, bs=4, keep=4, seq_bucket=64):
    jcfg, params, params_np = tiny_params()
    if package == "jax":
        scorer = JaxReranker(jcfg, params, CharTok(side), seq_bucket=seq_bucket, **OPTS)
        rr = JaxLLMRerank(scorer, top_n=2, embed_bs=bs, use_efficient=3, cascade_keep=keep, cascade_carry=carry)
        nodes = [JaxNode(node=JaxText(text=t, metadata={}), score=0.5) for t in _texts(n)]
        out = rr.postprocess_nodes(nodes, JaxQuery(query_str="q u e r y"))
    else:
        scorer = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok(side),
                                  seq_bucket=seq_bucket, **OPTS)
        rr = LLMRerank(scorer, top_n=2, embed_bs=bs, use_efficient=3, cascade_keep=keep, cascade_carry=carry)
        nodes = [NodeWithScore(node=TextNode(text=t, metadata={}), score=0.5) for t in _texts(n)]
        out = rr.postprocess_nodes(nodes, QueryBundle(query_str="q u e r y"))
    assert scorer.cutoff_layer == 4  # restored after the query
    return [nd.node.text for nd in out], [nd.score for nd in out]


CASES = {
    "left": dict(side="left"),
    "right": dict(side="right"),
    "mixed-buckets-left": dict(side="left", seq_bucket=8, n=13, keep=6),
    "mixed-buckets-right": dict(side="right", seq_bucket=8, n=13, keep=6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_carry_matches_rescore_and_jax(case):
    kw = CASES[case]
    texts_a, scores_a = _run("port", carry=False, **kw)
    texts_b, scores_b = _run("port", carry=True, **kw)
    assert texts_b == texts_a
    np.testing.assert_allclose(scores_b, scores_a, rtol=1e-4, atol=1e-5)
    texts_j, scores_j = _run("jax", carry=True, **kw)
    assert texts_b == texts_j
    np.testing.assert_allclose(scores_b, scores_j, rtol=1e-4, atol=1e-5)


def test_carry_skips_the_first_layers():
    """Stage 2 resumes at the judge layer: the carried path runs every pair
    through layers [0, 2) once, the re-score path runs the survivors there
    twice."""
    _, _, params_np = tiny_params()
    counts = {}
    for carry in (False, True):
        scorer = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok("left"), **OPTS)
        calls = []
        for i, layer in enumerate(scorer.layers):
            layer.register_forward_hook(lambda m, a, o, i=i: calls.append((i, a[0].shape[0])))
        rr = LLMRerank(scorer, top_n=2, embed_bs=4, use_efficient=3, cascade_keep=4, cascade_carry=carry)
        rr.postprocess_nodes([NodeWithScore(node=TextNode(text=t, metadata={}), score=0.5) for t in _texts(11)],
                             QueryBundle(query_str="q"))
        counts[carry] = {i: sum(b for j, b in calls if j == i) for i in range(4)}
    # stage 1: 11 pairs in batches of 4, 4, 4 (the tail padded to 4); stage 2: 4 survivors
    assert counts[False] == {0: 16, 1: 16, 2: 4, 3: 4}
    assert counts[True] == {0: 12, 1: 12, 2: 4, 3: 4}


class LayerScorer:
    """A scorer without ``score_pairs_carry`` (as ``tests/test_cascade.py``'s):
    passage length ranks at the judge layer, its negative at full depth."""

    def __init__(self, fail_at=None):
        self.cutoff_layer = 28
        self.efficient_layers = (12,)
        self.calls = []
        self.fail_at = fail_at

    def score_pairs(self, pairs, judge=False):
        self.calls.append((len(pairs), self.cutoff_layer))
        if self.cutoff_layer == self.fail_at:
            raise RuntimeError("batch failed")
        sign = -1.0 if self.cutoff_layer == 28 else 1.0
        return np.asarray([sign * len(p) for _, p in pairs], np.float32), self.cutoff_layer


def _nodes(n):
    return [NodeWithScore(node=TextNode(text="x" * (i + 1), metadata={}), score=0.5) for i in range(n)]


def test_carry_falls_back_for_incapable_scorers():
    scorer = LayerScorer()
    rr = LLMRerank(scorer, top_n=2, embed_bs=4, use_efficient=3, cascade_keep=4, cascade_carry=True)
    out = rr.postprocess_nodes(_nodes(9), QueryBundle(query_str="q"))
    assert len(out) == 2 and [len(n.node.text) for n in out] == [6, 7]
    assert {c for _, c in scorer.calls} == {12, 28}  # both stages ran through score_pairs


@pytest.mark.parametrize("carry", [False, True])
def test_cutoff_restored_when_a_batch_raises(carry):
    _, _, params_np = tiny_params()
    scorer = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok("left"), **OPTS)

    def broken(*a, **k):
        raise RuntimeError("stage 2 failed")

    scorer.score_carried = broken
    scorer.score_pairs = broken if not carry else scorer.score_pairs
    rr = LLMRerank(scorer, top_n=2, embed_bs=4, use_efficient=3, cascade_keep=4, cascade_carry=carry)
    with pytest.raises(RuntimeError, match="failed"):
        rr.postprocess_nodes(_nodes(9), QueryBundle(query_str="q"))
    assert scorer.cutoff_layer == 4


@pytest.mark.parametrize("pad_left", [True, False])
def test_gather_padded_rows(pad_left):
    a = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2) + 1
    b = torch.arange(3 * 5 * 2, dtype=torch.float32).reshape(3, 5, 2) + 100
    got = gather_padded_rows([a, b], torch.tensor([4, 0, 1]), pad_left)
    assert got.shape == (3, 5, 2)
    torch.testing.assert_close(got[0], b[2], rtol=0, atol=0)
    pad = (slice(0, 2), slice(2, 5)) if pad_left else (slice(3, 5), slice(0, 3))
    for row, src in ((1, a[0]), (2, a[1])):
        assert (got[row, pad[0]] == 0).all()
        torch.testing.assert_close(got[row, pad[1]], src, rtol=0, atol=0)
