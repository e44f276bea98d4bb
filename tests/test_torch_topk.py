"""The port's deterministic top-k against the JAX package's: values and
indices identical, ties (by descending index) included, on rows small enough
for ``lax.top_k`` and large enough for the JAX package's pruned paths."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from easyrag_tpu.ops.topk import topk_desc_reference_order as jax_topk
from easyrag_tpu_torch.ops.topk import topk_desc_reference_order

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "shape,k",
    [((200,), 50), ((3, 200), 50), ((2, 20000), 192), ((4, 4100), 6), ((2, 30), 64)],
)
def test_topk_matches_jax_with_ties(shape, k):
    rng = np.random.default_rng(sum(shape) + k)
    scores = rng.integers(0, 7, size=shape).astype(np.float32)  # many ties
    scores[..., ::5] = -np.inf  # filtered entries
    rv, ri = jax_topk(jnp.asarray(scores), k)
    gv, gi = topk_desc_reference_order(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    flat = scores.reshape(-1, shape[-1])
    ref = np.stack([row.argsort(kind="stable")[::-1][: min(k, shape[-1])] for row in flat])
    np.testing.assert_array_equal(gi.numpy().reshape(ref.shape), ref)
