"""The port's dense cosine index against the JAX package's.

The same seeded numpy embeddings go to both ``DenseIndex`` builds. On
dyadic rows (16 entries of +-1/4 in 64 columns, so every norm is exactly 1
and every score a multiple of 1/16) all three storages give exactly JAX's
scores and ids, which also holds the tie order (descending index) over the
many exact ties. On Gaussian rows int8 storage is exact as well (int32
accumulation, the same f32 rescale); f32 and bf16 scores agree within
1e-6 (f32 sums in another order), and ids may differ only between docs
whose float64 scores lie within 2e-6. Dir filters -1 (none), a known dir
and -2 (unknown: every score ``-inf``, every id the sentinel ``N``) and
``k`` past ``N`` are covered; ``query_stream`` equals ``query`` row by row
(both run 64-row products), and each package reads the artifact the other
wrote.
"""

import numpy as np
import pytest
import torch

from easyrag_tpu.index import dense as jd
from easyrag_tpu_torch.index import dense as td

torch.set_num_threads(1)

DIRS = ["a", "b", "c"]


def dyadic(rng, n, d=64, nnz=16):
    x = np.zeros((n, d), np.float32)
    for row in x:
        cols = rng.choice(d, size=nnz, replace=False)
        row[cols] = rng.choice([-0.25, 0.25], size=nnz)
    return x


def data(kind, n=300, d=100, q=5, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "dyadic":
        emb, queries = dyadic(rng, n), dyadic(rng, q)
    else:  # N and D not multiples of 8: the int8 product pads both
        emb = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q, d)).astype(np.float32)
    dirs = [DIRS[i % 3] for i in range(n)]
    return emb, queries, dirs


def indexes(kind, dtype, **kw):
    emb, queries, dirs = data(kind, **kw)
    ref = jd.DenseIndex.build(emb, dirs=dirs, dtype=dtype)
    got = td.DenseIndex.build(emb, dirs=dirs, dtype=dtype, device="cpu")
    return ref, got, queries


def exact64(index, queries):
    """float64 scores of the stored rows against the rounded queries."""
    mat = index.matrix.float().numpy().astype(np.float64)
    q = td.l2_normalize(np.asarray(queries, np.float32))
    q = torch.from_numpy(q).to(index.matrix.dtype).float().numpy().astype(np.float64)
    return q @ mat.T


def assert_same(got, ref, exact, scores64=None):
    (gv, gi), (rv, ri) = got, ref
    assert gv.shape == rv.shape and gi.shape == ri.shape
    assert np.array_equal(np.isfinite(gv), np.isfinite(rv))
    n_docs = None if scores64 is None else scores64.shape[1]
    if exact:
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(gi, ri)
        return
    np.testing.assert_allclose(gv, rv, atol=1e-6, rtol=0)
    for r, c in zip(*np.nonzero(gi != ri)):  # an id may move only between near-tied docs
        a, b = int(gi[r, c]), int(ri[r, c])
        assert a < n_docs and b < n_docs and abs(scores64[r, a] - scores64[r, b]) <= 2e-6


@pytest.mark.parametrize("kind", ["dyadic", "gauss"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_query_matches_jax(kind, dtype):
    ref, got, queries = indexes(kind, dtype)
    exact = kind == "dyadic" or dtype == "int8"
    scores64 = None if exact else exact64(got, queries)
    assert got.num_docs == ref.num_docs == 300
    for dir_value in (None, "b", "nope"):
        for k in (16, 400):  # k past N is capped at N
            want = ref.query(queries, k, dir_value=dir_value)
            have = got.query(queries, k, dir_value=dir_value)
            assert_same(have, want, exact, scores64)
            if dir_value == "b":
                ids = have[1][np.isfinite(have[0])]
                assert len(ids) == 100 * len(queries) if k == 400 else len(ids) > 0
                assert {got.dir_ids[i] for i in ids} == {got.dir_vocab["b"]}
    vals, ids = got.query(queries, 16, dir_value="nope")
    assert np.isneginf(vals).all() and (ids == 300).all()  # the sentinel contract
    vals, ids = got.query(queries[0], 400)
    assert vals.shape == (1, 300) and sorted(ids[0].tolist()) == list(range(300))


def test_ties_break_by_descending_index():
    rng = np.random.default_rng(4)
    base = dyadic(rng, 40)
    emb = np.concatenate([base, base])  # every score appears twice
    got = td.DenseIndex.build(emb, dtype="bfloat16", device="cpu")
    vals, ids = got.query(base[:3], 80)
    for v, i in zip(vals, ids):
        for a in range(79):
            assert v[a] > v[a + 1] or (v[a] == v[a + 1] and i[a] > i[a + 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_query_stream_matches_query(dtype):
    ref, got, queries = indexes("gauss", dtype, q=70)  # two batches of 64
    dir_values = ([None, "a", "nope", "c", None, "b", "b", None, "a", "zz"] * 7)
    vals, ids = got.query_stream(queries, 32, dir_values=dir_values)
    assert vals.shape == ids.shape == (70, 32)
    for r, dv in enumerate(dir_values):
        v, i = got.query(queries[r], 32, dir_value=dv)
        np.testing.assert_array_equal(vals[r], v[0])
        np.testing.assert_array_equal(ids[r], i[0])
    rv, ri = ref.query_stream(queries, 32, dir_values=dir_values)
    exact = dtype == "int8"
    assert_same((vals, ids), (rv, ri), exact, None if exact else exact64(got, queries))
    empty_v, empty_i = got.query_stream(np.zeros((0, 100), np.float32), 8)
    assert empty_v.shape == empty_i.shape == (0, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_artifacts_are_interchangeable(tmp_path, dtype):
    ref, got, queries = indexes("gauss", dtype)
    got.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "jax"))
    for a, b in zip(td.load_dense_arrays(str(tmp_path / "port")), jd.load_dense_arrays(str(tmp_path / "jax"))):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    from_jax = td.DenseIndex.load(str(tmp_path / "jax"), device="cpu")
    from_port = jd.DenseIndex.load(str(tmp_path / "port"))
    assert from_jax.matrix.dtype == got.matrix.dtype and torch.equal(from_jax.matrix, got.matrix)
    assert from_jax.dir_vocab == got.dir_vocab and np.array_equal(from_jax.dir_ids, got.dir_ids)
    for dv in (None, "c"):
        np.testing.assert_array_equal(from_jax.query(queries, 8, dv)[1], got.query(queries, 8, dv)[1])
        np.testing.assert_array_equal(from_port.query(queries, 8, dv)[1], ref.query(queries, 8, dv)[1])


def test_int8_matrix_is_padded_once(monkeypatch):
    """N = 300 and D = 100 are not multiples of 8: the index keeps one
    padded copy beside the artifact's matrix, no query pads it again, and
    the padded and unpadded operands give the same bits."""
    _, got, queries = indexes("gauss", "int8")
    assert got.matrix.shape == (300, 100) and got.scored.shape == (304, 104)
    assert not got.scored[300:].any() and not got.scored[:, 100:].any()
    pads = []
    real_pad = td.F.pad
    monkeypatch.setattr(td.F, "pad", lambda *a, **kw: pads.append(a[0].shape) or real_pad(*a, **kw))
    vals, ids = got.query(queries, 16)
    assert pads == []
    q = torch.from_numpy(td.l2_normalize(queries))
    unpadded = td.dense_score_topk(q, got.matrix, 16, scales=got.scales)
    assert pads == [(300, 100)]
    np.testing.assert_array_equal(unpadded[0].numpy(), vals)
    np.testing.assert_array_equal(unpadded[1].numpy(), ids)
    none_v, none_i = got.query(queries, 16, dir_value="nope")
    assert (none_i == 300).all()  # the sentinel is N, not the padded row count


def test_index_without_dirs_and_the_card_default():
    emb, queries, _ = data("gauss", n=50)
    got = td.DenseIndex.build(emb, dtype="float32", device="cpu")
    assert got.dir_col is None
    vals, ids = got.query(queries, 5, dir_value="a")  # no dir column: the filter is ignored, as in JAX
    np.testing.assert_array_equal(ids, jd.DenseIndex.build(emb, dtype="float32").query(queries, 5, dir_value="a")[1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.DenseIndex.build(emb)
