"""The port's sharded indexes (``easyrag_tpu_torch/parallel``) on the CPU.

The analogues of ``tests/test_sharded.py`` (its tensor-parallel case aside),
each at D = 1, 2, 3 and 4 shards on a repeated ``cpu`` device: the port's
sharded dense index (f32, bf16, int8; dir filters, the artifact, the stream),
resident BM25 index (f32, bf16, int8 heavy storage; rows and CSR; light and
heavy terms mixed; the stream) and gathered-postings scorer. With an explicit
``light_cap`` the sharded index holds the single-chip split, so its scores
and indices must equal the port's single-chip index bit for bit; against the
JAX package's sharded index on the first D of its 8 virtual CPU devices, the
values must agree within rtol 1e-5 (int8: 1e-6) and the indices wherever the
scores are distinct. Also: equal scores in two shards resolve by descending
global index, uneven and empty shard ranges return only real docs (also on
all ``-inf`` rows), the automatic cap equals JAX's, and ``make_mesh``
checks its shape and takes no CPU default without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from easyrag_tpu.index.dense import DenseIndex as JaxDenseIndex
from easyrag_tpu.index.sparse import build_sparse_index as jax_build_sparse_index
from easyrag_tpu.parallel import mesh as jmesh
from easyrag_tpu.parallel import sharded as jsharded
from easyrag_tpu_torch.index.dense import DenseIndex, l2_normalize
from easyrag_tpu_torch.index.sparse import build_sparse_index
from easyrag_tpu_torch.ops.bm25 import bm25_score_topk
from easyrag_tpu_torch.ops.bm25_resident import ResidentSparseIndex
from easyrag_tpu_torch.parallel.mesh import data_model_mesh, make_mesh
from easyrag_tpu_torch.parallel.sharded import (
    ShardedDenseIndex,
    ShardedResidentSparseIndex,
    ShardedSparseScorer,
    shard_width,
)
from oracles import synthetic_corpus

torch.set_num_threads(1)

SHARDS = [1, 2, 3, 4]


def port_mesh(d):
    return make_mesh([d], devices=["cpu"] * d)


def jax_mesh(d):
    return jmesh.make_mesh([d], ("data",))  # the first d of the 8 virtual CPU devices


def same_bits(got, want):
    """Scores and indices equal bit for bit."""
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gv).view(np.uint32), np.asarray(wv).view(np.uint32))
    np.testing.assert_array_equal(gi, wi)


def close_to(got, want, rtol):
    """Values within ``rtol`` (the same ``-inf`` entries, index ``N``), and
    equal indices wherever the reference's score is distinct from its
    neighbours' in the row."""
    (gv, gi), (wv, wi) = (np.asarray(a) for a in got), (np.asarray(a) for a in want)
    assert gv.shape == wv.shape
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=rtol)
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    for row in range(wv.shape[0]):
        v = wv[row]
        for j in np.nonzero(fin[row])[0]:
            near = [v[n] for n in (j - 1, j + 1) if 0 <= n < len(v) and np.isfinite(v[n])]
            if all(abs(x - v[j]) > rtol * abs(v[j]) for x in near):
                assert gi[row, j] == wi[row, j], (row, j)


def both_indexes(corpus, dirs=None):
    """(the port's, JAX's) sparse index of one corpus."""
    return build_sparse_index(corpus, bm25_type=0, dirs=dirs), jax_build_sparse_index(corpus, bm25_type=0, dirs=dirs)


def test_make_mesh_shapes():
    m = data_model_mesh(8, model_parallel=2, devices=["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2} == dict(jmesh.data_model_mesh(8, model_parallel=2).shape)
    assert [d.type for d in m.data_devices()] == ["cpu"] * 4
    with pytest.raises(ValueError):
        data_model_mesh(8, model_parallel=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        make_mesh([4], devices=["cpu"] * 2)
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3}
    if not torch.cuda.is_available():  # no CPU default: a mesh without a card raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh([1])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh([2], devices=["cuda:0", "cuda:0"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", SHARDS)
def test_sharded_dense_matches_single_chip(d, dtype):
    rng = np.random.default_rng(0)
    n, dim, b, k = 500, 64, 4, 17  # not divisible by 3 or 8: every D gives D shards, the last one shorter
    matrix = l2_normalize(rng.normal(size=(n, dim)).astype(np.float32))
    queries = l2_normalize(rng.normal(size=(b, dim)).astype(np.float32))
    single = DenseIndex(matrix=torch.from_numpy(matrix).to(getattr(torch, dtype)))
    sharded = ShardedDenseIndex(port_mesh(d), matrix, dtype=dtype)
    assert len(sharded.shards) == d
    got = sharded.query(queries, k)
    same_bits(got, single.query(queries, k))
    ref = jsharded.ShardedDenseIndex(jax_mesh(d), matrix, dtype=jnp.dtype(dtype))
    close_to(got, ref.query(queries, k), rtol=1e-5)


@pytest.mark.parametrize("heavy_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", SHARDS)
def test_sharded_resident_matches_single_chip(d, heavy_dtype):
    corpus = synthetic_corpus(num_docs=500, vocab=300, seed=4)
    index, jindex = both_indexes(corpus)
    queries = [["w3", "w14", "w15"], ["w0"], ["w9", "w9"], ["w1", "w2", "w5"], []]
    k = 11
    kw = dict(light_cap=16, max_query_terms=16, heavy_dtype=heavy_dtype)
    single = ResidentSparseIndex(index, device="cpu", **kw)
    sharded = ShardedResidentSparseIndex(port_mesh(d), index, **kw)
    assert len(sharded.shards) == d
    got = sharded.score_topk(queries, k)
    same_bits(got, single.score_topk(queries, k))
    assert np.isneginf(got[0][4]).all() and (got[1][4] == index.num_docs).all()  # the empty query
    ref = jsharded.ShardedResidentSparseIndex(jax_mesh(d), jindex, **kw)
    close_to(got, ref.score_topk(queries, k), rtol=1e-6 if heavy_dtype == "int8" else 1e-5)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_stream_matches_per_batch(d):
    """The stream (batches of 2 and a tail) equals the per-batch path, dir
    filters included, and JAX's sharded stream."""
    corpus = synthetic_corpus(num_docs=500, vocab=300, seed=6)
    dirs = [f"d{i % 3}" for i in range(len(corpus))]
    index, jindex = both_indexes(corpus, dirs)
    sharded = ShardedResidentSparseIndex(port_mesh(d), index, light_cap=16, max_query_terms=16)
    queries = [["w3", "w14"], ["w1", "w2"], ["w0"], ["w9", "w9"], ["w5"]]
    dvals = ["d1", None, "zzz", None, "d2"]
    rv, ri = sharded.score_topk(queries, 9, dir_values=dvals)
    same_bits(sharded.stream_score_topk(queries, 9, batch=2, dir_values=dvals), (rv, ri))
    ref = jsharded.ShardedResidentSparseIndex(jax_mesh(d), jindex, light_cap=16, max_query_terms=16)
    close_to((rv, ri), ref.stream_score_topk(queries, 9, batch=2, dir_values=dvals), rtol=1e-5)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_dir_filters_match_single_chip(d):
    rng = np.random.default_rng(5)
    corpus = synthetic_corpus(num_docs=500, vocab=300, seed=6)
    dirs = [f"d{i % 3}" for i in range(len(corpus))]
    index, jindex = both_indexes(corpus, dirs)
    single = ResidentSparseIndex(index, light_cap=16, max_query_terms=16, device="cpu")
    sharded = ShardedResidentSparseIndex(port_mesh(d), index, light_cap=16, max_query_terms=16)
    queries = [["w3", "w14"], ["w1", "w2"], ["w0"]]
    dvals = ["d1", None, "zzz"]
    got = sharded.score_topk(queries, 9, dir_values=dvals)
    same_bits(got, single.score_topk(queries, 9, dir_values=dvals))
    assert all(dirs[i] == "d1" for i in got[1][0][np.isfinite(got[0][0])])
    assert np.isneginf(got[0][2]).all()  # an unknown dir matches nothing
    ref = jsharded.ShardedResidentSparseIndex(jax_mesh(d), jindex, light_cap=16, max_query_terms=16)
    close_to(got, ref.score_topk(queries, 9, dir_values=dvals), rtol=1e-5)

    # dense: filtered sharded == filtered single-chip, by name and by filter ints
    n, dim = 500, 32
    matrix = l2_normalize(rng.normal(size=(n, dim)).astype(np.float32))
    q = l2_normalize(rng.normal(size=(2, dim)).astype(np.float32))
    dnames = [f"d{i % 3}" for i in range(n)]
    single_d = DenseIndex.build(matrix, dirs=dnames, dtype="float32", device="cpu")
    sd = ShardedDenseIndex.build(port_mesh(d), matrix, dirs=dnames, dtype="float32")
    got_d = sd.query(q, 7, dir_filter=np.array([1, -1], np.int32))
    same_bits(got_d, single_d.query_stream(q, 7, dir_values=["d1", None]))
    same_bits(sd.query(q, 7, dir_value="d2"), single_d.query(q, 7, dir_value="d2"))
    ref = jsharded.ShardedDenseIndex(jax_mesh(d), matrix, dtype=jnp.float32,
                                     dir_ids=np.array([i % 3 for i in range(n)], np.int32))
    close_to(got_d, ref.query(q, 7, dir_filter=np.array([1, -1], np.int32)), rtol=1e-5)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_sparse_matches_single_chip(d):
    corpus = synthetic_corpus(num_docs=500, vocab=300, seed=3)
    index, _ = both_indexes(corpus)
    queries = [["w3", "w14", "w15"], ["w0"], ["w9", "w9"], ["w1", "w2", "w5"]]
    gathered = [index.gather_postings(index.query_term_ids(q), pad_to=2048) for q in queries]
    ids = np.stack([g[0] for g in gathered])
    vals = np.stack([g[1] for g in gathered])
    k = 13
    sv, si = bm25_score_topk(torch.from_numpy(ids), torch.from_numpy(vals), index.num_docs, k)
    got = ShardedSparseScorer(port_mesh(d), index.num_docs).score_topk(ids, vals, k)
    same_bits(got, (sv.numpy(), si.numpy()))
    ref = jsharded.ShardedSparseScorer(jax_mesh(d), index.num_docs).score_topk(ids, vals, k)
    close_to(got, ref, rtol=1e-5)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_int8_dense_matches_single_chip(d):
    """int8 rows + per-row scales shard without dequantization: the
    single-chip int8 scores bit for bit (one q8 for every shard)."""
    rng = np.random.default_rng(11)
    n, dim, k = 500, 64, 9
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    dirs = [f"d{i % 3}" for i in range(n)]
    single = DenseIndex.build(emb, dirs=dirs, dtype="int8", device="cpu")
    sharded = ShardedDenseIndex.build(port_mesh(d), emb, dirs=dirs, dtype="int8")
    assert all(sh.matrix.dtype == torch.int8 for sh in sharded.shards)  # rows stay quantized
    q = l2_normalize(rng.normal(size=(4, dim)).astype(np.float32))
    got = sharded.query(q, k)
    same_bits(got, single.query(q, k))
    dvals = ["d1", None, "zzz", "d0"]
    got_s = sharded.query_stream(q, k, dir_values=dvals, batch=2)
    same_bits(got_s, single.query_stream(q, k, dir_values=dvals, batch=2))
    ref = jsharded.ShardedDenseIndex.build(jax_mesh(d), emb, dirs=dirs, dtype="int8")
    close_to(got, ref.query(q, k), rtol=1e-6)
    close_to(got_s, ref.query_stream(q, k, dir_values=dvals, batch=2), rtol=1e-6)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_int8_sparse_heavy_matches_single_chip(d):
    """heavy_dtype int8: the same per-doc-column scales over the global heavy
    set as the single-chip index, so the same scores, per batch and
    streamed."""
    corpus = synthetic_corpus(num_docs=500, vocab=300, seed=12)
    dirs = [f"d{i % 3}" for i in range(len(corpus))]
    index, jindex = both_indexes(corpus, dirs)
    kw = dict(light_cap=8, max_query_terms=16, heavy_dtype="int8")
    single = ResidentSparseIndex(index, device="cpu", **kw)
    sharded = ShardedResidentSparseIndex(port_mesh(d), index, **kw)
    queries = [["w3", "w14"], ["w1", "w2"], ["w0", "w5", "w9"]]
    dvals = ["d1", None, "zzz"]
    got = sharded.score_topk(queries, 9, dir_values=dvals)
    same_bits(got, single.score_topk(queries, 9, dir_values=dvals))
    got_s = sharded.stream_score_topk(queries, 9, batch=2, dir_values=dvals)
    same_bits(got_s, single.stream_score_topk(queries, 9, batch=2, dir_values=dvals))
    ref = jsharded.ShardedResidentSparseIndex(jax_mesh(d), jindex, **kw)
    close_to(got, ref.score_topk(queries, 9, dir_values=dvals), rtol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("d", SHARDS)
def test_sharded_dense_load_matches_dense_load(tmp_path, d, writer):
    """``ShardedDenseIndex.load`` reads the dense artifact on the host (the
    port's or JAX's) and answers as the single-chip index loaded from it."""
    rng = np.random.default_rng(13)
    n, dim, k = 500, 32, 5
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    dirs = [f"d{i % 2}" for i in range(n)]
    if writer == "port":
        DenseIndex.build(emb, dirs=dirs, dtype="float32", device="cpu").save(str(tmp_path / "art"))
    else:
        JaxDenseIndex.build(emb, dirs=dirs, dtype="float32").save(str(tmp_path / "art"))
    single = DenseIndex.load(str(tmp_path / "art"), device="cpu")
    loaded = ShardedDenseIndex.load(port_mesh(d), str(tmp_path / "art"))
    assert loaded.num_docs == n and loaded.dir_vocab == single.dir_vocab
    q = l2_normalize(rng.normal(size=(2, dim)).astype(np.float32))
    same_bits(loaded.query(q, k), single.query(q, k))
    same_bits(ShardedDenseIndex.from_dense(port_mesh(d), single).query(q, k, dir_value="d1"),
              single.query(q, k, dir_value="d1"))


@pytest.mark.parametrize("light_rows", [True, False])
@pytest.mark.parametrize("d", SHARDS)
def test_sharded_mixed_light_heavy_matches_single_chip(d, light_rows):
    """A corpus with real light and heavy mass, both light layouts and the
    stream: the non-vacuous form of the resident parity."""
    corpus = synthetic_corpus(num_docs=500, vocab=1000, seed=9)
    dirs = [f"d{i % 3}" for i in range(len(corpus))]
    index, jindex = both_indexes(corpus, dirs)
    lens = np.diff(index.stats.term_offsets)
    assert ((lens > 0) & (lens <= 16)).sum() > 50 and (lens > 16).sum() > 20

    rng = np.random.default_rng(7)
    queries = []
    for _ in range(9):
        doc = corpus[rng.integers(0, len(corpus))]
        take = rng.choice(len(doc), size=min(8, len(doc)), replace=False)
        queries.append([doc[i] for i in take])
    dvals = ["d1", None, "zzz"] * 3
    kw = dict(light_cap=16, max_query_terms=16, light_rows=light_rows)
    single = ResidentSparseIndex(index, device="cpu", **kw)
    sharded = ShardedResidentSparseIndex(port_mesh(d), index, **kw)
    assert sharded.light_layout == ("rows" if light_rows else "csr") and len(sharded.shards) == d
    ids, _ = sharded.query_terms_batch(queries)
    assert (sharded._host_light_lens[ids] > 0).any()  # light terms are scored
    assert sum(int(sh.P) for sh in sharded.shards) == int(single._host_light_lens.sum())
    got = sharded.score_topk(queries, 9, dir_values=dvals)
    same_bits(got, single.score_topk(queries, 9, dir_values=dvals))
    got_s = sharded.stream_score_topk(queries, 9, batch=4, dir_values=dvals)
    same_bits(got_s, single.stream_score_topk(queries, 9, batch=4, dir_values=dvals))
    ref = jsharded.ShardedResidentSparseIndex(jax_mesh(d), jindex, **kw)
    close_to(got, ref.score_topk(queries, 9, dir_values=dvals), rtol=1e-5)
    close_to(got_s, ref.stream_score_topk(queries, 9, batch=4, dir_values=dvals), rtol=1e-5)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_ties_across_shards_resolve_by_descending_index(d):
    """Copies of one document, one in every shard, score alike: they come
    back by descending global index, as the single-chip index and JAX order
    them."""
    n = 400
    w = shard_width(n, d)
    pos = [s * w + 3 for s in range(d)]
    corpus = [list(doc) for doc in synthetic_corpus(num_docs=n, vocab=50, seed=2)]
    for p in pos:
        corpus[p] = ["w7", "w8", "w9", "w7"]
    index, jindex = both_indexes(corpus)
    queries = [["w7", "w8"], ["w9"]]
    kw = dict(light_cap=8, max_query_terms=8)
    sharded = ShardedResidentSparseIndex(port_mesh(d), index, **kw)
    assert sharded.shard_size == w
    got = sharded.score_topk(queries, 6)
    same_bits(got, ResidentSparseIndex(index, device="cpu", **kw).score_topk(queries, 6))
    assert got[1][0][:d].tolist() == pos[::-1] and len(set(got[0][0][:d].tolist())) == 1
    close_to(got, jsharded.ShardedResidentSparseIndex(jax_mesh(d), jindex, **kw).score_topk(queries, 6), rtol=1e-6)
    # the dense index: equal rows in every shard
    rng = np.random.default_rng(3)
    m = l2_normalize(rng.normal(size=(n, 16)).astype(np.float32))
    m[pos] = m[5]
    q = m[5:6] + 0.01
    single = DenseIndex(matrix=torch.from_numpy(m)).query(q, 6)
    got_d = ShardedDenseIndex(port_mesh(d), m, dtype="float32").query(q, 6)
    same_bits(got_d, single)
    assert got_d[1][0][: d + 1].tolist() == sorted(pos + [5], reverse=True)


@pytest.mark.parametrize("d", [3, 4])
def test_uneven_shards_return_only_real_docs(d):
    """N = 150 over 3 or 4 shards: ranges of 64, the last one of 22 docs (at
    D = 4 the fourth range is empty and no shard is built for it). A dense
    query that scores every row below 0, a top-k larger than N, a filter
    that matches nothing and a query with no term: every index is a real
    doc's, and ``-inf`` entries carry index N."""
    n = 150
    m = np.abs(np.random.default_rng(4).normal(size=(n, 8)).astype(np.float32)) + 0.1
    dirs = ["a", "b"] * (n // 2)
    sd = ShardedDenseIndex.build(port_mesh(d), m, dirs=dirs, dtype="float32")
    assert [sh.width for sh in sd.shards] == [64, 64, 22]
    neg = -np.ones((1, 8), np.float32)
    v, i = sd.query(neg, 200)
    assert v.shape == (1, n) and (v < 0).all() and sorted(i[0].tolist()) == list(range(n))
    same_bits((v, i), DenseIndex.build(m, dirs=dirs, dtype="float32", device="cpu").query(neg, 200))
    v, i = sd.query(neg, 9, dir_value="zzz")
    assert np.isneginf(v).all() and (i == n).all()
    corpus = synthetic_corpus(num_docs=n, vocab=400, seed=5)
    index = build_sparse_index(corpus, dirs=dirs)
    kw = dict(light_cap=8, max_query_terms=4)
    sr = ShardedResidentSparseIndex(port_mesh(d), index, **kw)
    assert [sh.num_docs for sh in sr.shards] == [64, 64, 22]
    queries, dvals = [["w1"], ["nothing"], ["w2"]], [None, None, "zzz"]
    v, i = sr.score_topk(queries, 200, dir_values=dvals)
    assert v.shape == (3, n) and (i[np.isfinite(v)] < n).all() and (i[~np.isfinite(v)] == n).all()
    assert np.isfinite(v[0]).any() and np.isneginf(v[1:]).all()
    same_bits((v, i), ResidentSparseIndex(index, device="cpu", **kw).score_topk(queries, 200, dir_values=dvals))
    ids, vals = index.gather_postings(index.query_term_ids(["w1", "w3"]), pad_to=512)
    v, i = ShardedSparseScorer(port_mesh(d), n).score_topk(ids, vals, 200)
    assert (i[np.isfinite(v)] < n).all() and (i[~np.isfinite(v)] == n).all()
    sv, si = bm25_score_topk(torch.from_numpy(ids), torch.from_numpy(vals), n, 200)
    same_bits((v, i), (sv.numpy()[None], si.numpy()[None]))


@pytest.mark.parametrize("budget_mib", [1, 4, 512])
@pytest.mark.parametrize("heavy_dtype", ["float32", "int8"])
@pytest.mark.parametrize("d", [2, 4])
def test_auto_light_cap_matches_jax(d, heavy_dtype, budget_mib):
    """Without a cap both packages pick the same one per shard (the
    single-chip cost model over a shard's doc count, ``kappa_scale=0.5``,
    the CSR re-pick) and the same layout; then the scores agree."""
    corpus = synthetic_corpus(num_docs=400, vocab=600, seed=8, max_len=120)
    index, jindex = both_indexes(corpus)
    kw = dict(max_query_terms=16, heavy_dtype=heavy_dtype, heavy_hbm_budget=budget_mib * 2**10 * 100,
              light_rows_hbm_budget=budget_mib * 2**10 * 10)
    got = ShardedResidentSparseIndex(port_mesh(d), index, **kw)
    ref = jsharded.ShardedResidentSparseIndex(jax_mesh(d), jindex, **kw)
    assert (got.light_cap, got.light_layout, got.H) == (ref.light_cap, ref.light_layout, ref.H)
    queries = [corpus[i][:6] for i in (0, 17, 211)]
    close_to(got.score_topk(queries, 12), ref.score_topk(queries, 12), rtol=1e-6 if heavy_dtype == "int8" else 1e-5)
