"""The port's deterministic top-k against the JAX package's: values and
indices identical, ties (by descending index) included, on rows small enough
for ``lax.top_k`` and large enough for the pruned paths, which both packages
take by the same gates: the chunk-max pruned path (K6's plain version here;
K6 itself on the card, in the ``cuda`` case) and the two-stage path, on rows
built to break a tie order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from easyrag_tpu.ops.topk import topk_desc_reference_order as jax_topk
from easyrag_tpu_torch.ops.chunkmax import chunk_max, chunk_max_plain
from easyrag_tpu_torch.ops.topk import _sorted_topk, topk_desc_reference_order

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


# (n, k) on both sides of the JAX package's gates: the pruned path needs
# n >= 4096, n % 8 == 0, k <= n // 8 and 16 k <= n; else the two-stage path
# where a chunk count divides n (4096 at k=257: 4 chunks; 4100: 10; 20000 at
# k=1251: 5), else the whole row (4095)
GATES = [(4096, 6, "pruned"), (4096, 256, "pruned"), (4096, 257, "two-stage"), (4100, 6, "two-stage"),
         (20000, 6, "pruned"), (20000, 192, "pruned"), (20000, 288, "pruned"), (20000, 1250, "pruned"),
         (20000, 1251, "two-stage"), (20480, 288, "pruned"), (4095, 6, "sort")]


def tie_rows(B, n, seed):
    """Rows built to break a top-k's tie order: few distinct values (ties
    inside and across every chunk edge), rows all ``-inf`` (a filter that
    matches nothing), all equal, one finite value, and ``-inf`` every 5th."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, size=(B, n)).astype(np.float32)
    s[0::5] = -np.inf
    s[1::5] = 2.0
    s[2::5, ::5] = -np.inf
    s[3::5] = -np.inf
    s[3::5, n // 2] = 1.0
    return s


@pytest.mark.parametrize("B", [1, 67])
@pytest.mark.parametrize("n,k,path", GATES)
def test_pruned_and_two_stage_paths_match_jax(monkeypatch, n, k, path, B):
    from easyrag_tpu_torch.ops import topk as tk

    calls = []
    monkeypatch.setattr(tk, "chunk_max", lambda x: calls.append(x.shape) or chunk_max_plain(x))
    scores = tie_rows(B, n, n + k + B)
    rv, ri = jax_topk(jnp.asarray(scores), k)
    gv, gi = topk_desc_reference_order(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    assert calls == ([(B, n)] if path == "pruned" else [])
    if path != "pruned":
        assert (tk._pick_chunks(n, k) > 1) == (path == "two-stage")
    sv, si = tk._sorted_topk(torch.from_numpy(scores), k)  # the whole row sorted: the same
    assert torch.equal(si, gi) and torch.equal(sv, gv)
    if B == 1:  # a rank-1 row takes the same path
        v1, i1 = topk_desc_reference_order(torch.from_numpy(scores[0]), k)
        assert torch.equal(i1, gi[0]) and torch.equal(v1, gv[0])


def test_chunk_max_plain_matches_jax_and_refuses_other_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    x[0] = -np.inf
    x[1, ::3] = -np.inf
    want = np.asarray(jnp.asarray(x).reshape(3, 512, 8).max(-1))
    np.testing.assert_array_equal(chunk_max(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(chunk_max_plain(torch.from_numpy(x)).numpy(), want)
    for bad, err in ((torch.zeros(2, 12), ValueError), (torch.zeros(16), ValueError),
                     (torch.zeros(2, 16, dtype=torch.float64), TypeError), (torch.zeros(16, 2).t(), ValueError)):
        with pytest.raises(err):
            chunk_max(bad)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K6 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 20000), (64, 20000), (67, 20000), (256, 20480), (3, 8)])
def test_chunk_max_kernel_matches_plain_on_card(cuda, B, n):
    from easyrag_tpu_torch.ops import chunkmax

    x = torch.from_numpy(tie_rows(B, n, B + n)).to(cuda)
    before = chunkmax.launches
    got = chunk_max(x)
    assert chunkmax.launches == before + 1
    assert torch.equal(got, chunk_max_plain(x))
    for k in (6, 192, 288):
        if k <= n // 8 and 16 * k <= n:
            v, i = topk_desc_reference_order(x, k)
            sv, si = _sorted_topk(x, k)
            assert torch.equal(i, si) and torch.equal(v, sv)
