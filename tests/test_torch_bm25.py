"""The port's BM25 path against the JAX package's, on one seeded corpus.

Tolerances: the sparse index arrays of both Python builders
(``use_native=False``) are equal; scatter, resident, dual and
overflow scoring give identical indices and scores within rtol 1e-6 (f32 sums
in a different order). K5's JAX side runs with ``interpret=True``, as the JAX
package's own tests run it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from easyrag_tpu.index.sparse import build_sparse_index as jax_build
from easyrag_tpu.ops import bm25 as jbm25
from easyrag_tpu.ops import bm25_resident as jres
from easyrag_tpu.ops.bm25_pallas import bm25_scores_pallas
from easyrag_tpu_torch.index.sparse import build_sparse_index
from easyrag_tpu_torch.ops import bm25 as tbm25
from easyrag_tpu_torch.ops import bm25_resident as tres
from easyrag_tpu_torch.ops import bm25_scatter

torch.set_num_threads(1)

DIRS = ["director", "emsplus", "rcp", "umac"]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    zipf = 1.0 / np.arange(1, 301)
    zipf /= zipf.sum()
    docs = [[f"t{t}" for t in rng.choice(300, size=int(rng.integers(5, 60)), p=zipf)] for _ in range(80)]
    docs[7] = list(docs[3])  # exact score ties between two docs
    dirs = [DIRS[i % 4] for i in range(len(docs))]
    queries = [list(rng.choice(docs[i], size=6)) + ["t7", "unknown"] for i in (1, 9, 33)]
    queries.append(list(docs[3][:4]))
    queries.append([])
    return docs, dirs, queries


def _indexes(corpus, bm25_type=0):
    docs, dirs, _ = corpus
    return jax_build(docs, bm25_type=bm25_type, dirs=dirs, use_native=False), build_sparse_index(
        docs, bm25_type=bm25_type, dirs=dirs, use_native=False
    )


@pytest.mark.parametrize("bm25_type", [0, 1])
def test_sparse_index_arrays_equal_reference_python_path(corpus, bm25_type):
    ref, got = _indexes(corpus, bm25_type)
    assert got.stats.vocab == ref.stats.vocab
    assert got.stats.num_docs == ref.stats.num_docs and got.stats.avgdl == ref.stats.avgdl
    for name in ("doc_lens", "term_offsets", "post_docs", "post_tfs"):
        np.testing.assert_array_equal(getattr(got.stats, name), getattr(ref.stats, name))
    np.testing.assert_array_equal(got.post_vals, ref.post_vals)
    np.testing.assert_array_equal(got.dir_ids, ref.dir_ids)
    assert got.dir_vocab == ref.dir_vocab
    for q in corpus[2]:
        assert got.query_term_ids(q) == ref.query_term_ids(q)
        np.testing.assert_array_equal(got.get_scores_host(q), ref.get_scores_host(q))
        for kw in ({"pad_to": 2048}, {"pad_to": 8, "bucket": True}):
            for a, b in zip(got.gather_postings(got.query_term_ids(q), **kw),
                            ref.gather_postings(ref.query_term_ids(q), **kw)):
                np.testing.assert_array_equal(a, b)


def test_scatter_plain_matches_pallas_interpret(corpus):
    ref_idx, idx = _indexes(corpus)
    rows = [idx.gather_postings(idx.query_term_ids(q), pad_to=1024) for q in corpus[2]]
    ids = np.stack([r[0] for r in rows])
    vals = np.stack([r[1] for r in rows])
    ref = np.asarray(bm25_scores_pallas(jnp.asarray(ids), jnp.asarray(vals), idx.num_docs, interpret=True))
    got = bm25_scatter.bm25_scores(torch.from_numpy(ids), torch.from_numpy(vals), idx.num_docs).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    single = bm25_scatter.bm25_scores(torch.from_numpy(ids[0]), torch.from_numpy(vals[0]), idx.num_docs)
    np.testing.assert_array_equal(single.numpy(), got[0])
    np.testing.assert_allclose(got[0], ref_idx.get_scores_host(corpus[2][0]), rtol=1e-6)


def test_scatter_drops_out_of_range_ids():
    ids = torch.tensor([0, 5, 4, -1, 6, 5], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    got = bm25_scatter.bm25_scores(ids, vals, 5)
    np.testing.assert_array_equal(got.numpy(), [1.0, 0, 0, 0, 3.0])
    empty = bm25_scatter.bm25_scores(ids[None, :0], vals[None, :0], 5)
    assert empty.shape == (1, 5) and (empty == 0).all()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dir_f", [-1, -2, 1])
def test_score_topk_matches_reference(corpus, use_pallas, dir_f):
    ref_idx, idx = _indexes(corpus)
    for q in corpus[2]:
        ids, vals = idx.gather_postings(idx.query_term_ids(q), pad_to=2048, bucket=True)
        rv, ri = jbm25.bm25_score_topk(
            jnp.asarray(ids), jnp.asarray(vals), idx.num_docs, 20,
            dir_col=jnp.asarray(ref_idx.dir_ids), dir_filter=jnp.int32(dir_f),
        )
        gv, gi = tbm25.bm25_score_topk(
            torch.from_numpy(ids), torch.from_numpy(vals), idx.num_docs, 20,
            dir_col=torch.from_numpy(idx.dir_ids), dir_filter=torch.tensor(dir_f, dtype=torch.int32),
            use_pallas=use_pallas,
        )
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-6)


def _residents(corpus, light_rows, light_cap=4):
    ref_idx, idx = _indexes(corpus)
    kw = dict(light_cap=light_cap, max_query_terms=16, light_rows=light_rows)
    return jres.ResidentSparseIndex(ref_idx, **kw), tres.ResidentSparseIndex(idx, device="cpu", **kw)


@pytest.mark.parametrize("light_rows", [True, False])
@pytest.mark.parametrize("heavy_form", ["gather", "matmul"])
def test_resident_matches_reference(corpus, light_rows, heavy_form):
    ref, got = _residents(corpus, light_rows)
    assert got.light_layout == ref.light_layout
    queries = corpus[2]
    rid, rcnt = ref.query_terms_batch(queries)
    gid, gcnt = got.query_terms_batch(queries)
    np.testing.assert_array_equal(gid, rid)
    np.testing.assert_array_equal(gcnt, rcnt)
    dir_f = np.array([-1, 0, -2, 3, -1], np.int32)
    rv, ri = jres._resident_score_topk(
        ref.heavy, ref.t_heavy_row, ref.t_starts, ref.t_light_lens, ref.post_docs, ref.post_vals,
        ref.dir_col, jnp.asarray(rid), jnp.asarray(rcnt), jnp.asarray(dir_f),
        k=24, num_docs=ref.num_docs, light_cap=ref.light_cap, P=ref.P,
        light=ref.light_layout, heavy_form=heavy_form,
    )
    # the port's one heavy form against each of JAX's two
    gv, gi = got._score_topk(
        torch.from_numpy(gid), torch.from_numpy(gcnt), 24, torch.from_numpy(dir_f), light_t=got.light_t_bound(gid),
    )
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-6)


def test_resident_score_topk_and_stream_match_host_oracle(corpus):
    _, got = _residents(corpus, True)
    idx = got.host_index
    queries = corpus[2]
    dirs = [None, "umac", "nowhere", None, "rcp"]
    tv, ti = got.score_topk(queries, 12, dir_values=dirs)
    sv, si = got.stream_score_topk(queries, 12, batch=2, dir_values=dirs)
    np.testing.assert_array_equal(si, ti)
    np.testing.assert_array_equal(sv, tv)
    for q, d, vals, inds in zip(queries, dirs, tv, ti):
        host = idx.get_scores_host(q)
        if d is not None:
            host = np.where(np.asarray(corpus[1]) == d, host, 0.0)
        order = host.argsort(kind="stable")[::-1]
        order = order[host[order] > 0][:12]
        n = int(np.isfinite(vals).sum())
        np.testing.assert_array_equal(inds[:n], order)
        assert (inds[n:] == idx.num_docs).all()
        np.testing.assert_allclose(vals[:n], host[order], rtol=1e-6)


def test_dual_scorer_matches_reference(corpus):
    docs, dirs, queries = corpus
    paths = [[f"p{i % 5}", f"p{i % 3}x"] for i in range(len(docs))]
    ref_c, got_c = _residents(corpus, True)
    ref_p = jres.ResidentSparseIndex(jax_build(paths, dirs=dirs, use_native=False), light_cap=4, max_query_terms=16)
    got_p = tres.ResidentSparseIndex(build_sparse_index(paths, dirs=dirs, use_native=False), light_cap=4, max_query_terms=16, device="cpu")
    qs = [q + ["p1", "p2x"] for q in queries]
    dir_fs = [-1, 2, -2, -1, 0]
    (rv1, ri1), (rv2, ri2) = jres.DualResidentScorer(ref_c, ref_p).score_topk(qs, 10, 3, dir_fs)
    dual = tres.DualResidentScorer(got_c, got_p)
    (gv1, gi1), (gv2, gi2) = dual.score_topk(qs, 10, 3, dir_fs)
    np.testing.assert_array_equal(gi1, ri1)
    np.testing.assert_array_equal(gi2, ri2)
    np.testing.assert_allclose(gv1, rv1, rtol=1e-6)
    np.testing.assert_allclose(gv2, rv2, rtol=1e-6)
    (sv1, si1), (sv2, si2) = dual.stream_score_topk(qs, 10, 3, dir_fs, batch=2)
    np.testing.assert_array_equal(si1, gi1)
    np.testing.assert_array_equal(si2, gi2)


def test_resident_auto_cap_and_limits(corpus):
    ref_idx, idx = _indexes(corpus)
    lens = np.diff(idx.stats.term_offsets)
    # the reference's cost-model cap, not the smallest that fits the budget
    r = tres.ResidentSparseIndex(idx, heavy_hbm_budget=1 << 30, device="cpu")
    assert r.light_cap == jres.ResidentSparseIndex(ref_idx, heavy_hbm_budget=1 << 30).light_cap
    tight = int((lens > 32).sum()) * idx.num_docs * 4
    for budget in (tight, 0):
        assert tres.auto_light_cap(lens, idx.num_docs, 4, budget, 64) == jres.auto_light_cap(
            lens, idx.num_docs, 4, budget, 64)
    assert tres.auto_light_cap(lens, idx.num_docs, 4, 0, 64) == idx.num_docs
    with pytest.raises(ValueError):
        tres.ResidentSparseIndex(idx, max_query_terms=2, device="cpu").query_terms(["t1", "t2", "t3"])
    # compressed heavy storage and the K5 tail construct and score
    for kw in ({"heavy_dtype": "bfloat16"}, {"heavy_dtype": "int8"}, {"tail": "pallas"}):
        tv, _ = tres.ResidentSparseIndex(idx, device="cpu", **kw).score_topk(corpus[2][:1], 5)
        assert np.isfinite(tv[0, 0])
    with pytest.raises(ValueError):
        tres.ResidentSparseIndex(idx, heavy_dtype="float16", device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
def test_scatter_kernel_matches_plain_on_card(cuda, B):
    rng = np.random.default_rng(B)
    N, P = 3000, 5000
    ids = rng.integers(-2, N + 3, size=(B, P)).astype(np.int32)  # out-of-range ids too
    vals = rng.random((B, P)).astype(np.float32)
    ids_t, vals_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(vals).to(cuda)
    before = bm25_scatter.launches
    got = bm25_scatter.bm25_scores(ids_t, vals_t, N)
    again = bm25_scatter.bm25_scores(ids_t, vals_t, N)
    torch.cuda.synchronize()
    assert bm25_scatter.launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits every run
    ref = bm25_scatter.bm25_scores_plain(torch.from_numpy(ids), torch.from_numpy(vals), N)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    empty = bm25_scatter.bm25_scores(ids_t[:, :0].contiguous(), vals_t[:, :0].contiguous(), N)
    torch.cuda.synchronize()
    assert empty.shape == (B, N) and (empty == 0).all()


@pytest.mark.cuda
def test_overflow_route_without_pallas_runs_k5_on_card(cuda, corpus):
    # use_pallas=False still scatters through K5 on CUDA: a float-atomic
    # scatter-add would reorder the sums and flip near-ties between runs
    _, idx = _indexes(corpus)
    q = sorted({t for doc in corpus[0][:12] for t in doc})  # many terms: the overflow gather path
    ids, vals = idx.gather_postings(idx.query_term_ids(q), pad_to=2048, bucket=True)
    args = (torch.from_numpy(ids).to(cuda), torch.from_numpy(vals).to(cuda), idx.num_docs, 20)
    kw = dict(dir_col=torch.from_numpy(idx.dir_ids).to(cuda), dir_filter=torch.tensor(-1, dtype=torch.int32, device=cuda))
    before = bm25_scatter.launches
    (v1, i1), (v2, i2) = (tbm25.bm25_score_topk(*args, use_pallas=False, **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert bm25_scatter.launches == before + 2
    assert torch.equal(v1.view(torch.int32), v2.view(torch.int32)) and torch.equal(i1, i2)
    rv, ri = tbm25.bm25_score_topk(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                                   dir_col=torch.from_numpy(idx.dir_ids), dir_filter=torch.tensor(-1, dtype=torch.int32))
    np.testing.assert_array_equal(i1.cpu().numpy(), ri.numpy())
    np.testing.assert_allclose(v1.cpu().numpy(), rv.numpy(), rtol=1e-6)


def _k5_rows(seed, B, P, N):
    """``[B, P]`` postings of the overflow scatter's kinds: random term slices
    (a doc repeats across slices), ids out of range on both sides, sentinel
    postings (id N, value 0). With B = 3, row 1 is all sentinels and row 2
    puts every posting into the first doc tile, as a Zipf head would."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, size=(B, P)).astype(np.int32)
    vals = (rng.random((B, P)) * 8).astype(np.float32)
    odd = rng.random((B, P))
    ids[odd < 0.02] = -1 - rng.integers(0, 3, size=int((odd < 0.02).sum()))
    ids[(odd >= 0.02) & (odd < 0.04)] = N + 7
    sentinel = (odd >= 0.04) & (odd < 0.1)
    ids[sentinel], vals[sentinel] = N, 0.0
    if B == 3:
        ids[1], vals[1] = N, 0.0
        ids[2] = rng.integers(0, min(N, bm25_scatter.TILE_DOCS), size=P)
    return ids, vals


def _posting_order(ids, vals, N):
    """f32 sums of each doc's in-range postings in posting order."""
    out = np.zeros((ids.shape[0], N), np.float32)
    for r in range(ids.shape[0]):
        ok = (ids[r] >= 0) & (ids[r] < N)
        np.add.at(out[r], ids[r][ok], vals[r][ok])
    return out


@pytest.mark.parametrize("B,P,N", [(1, 1000, 20_000), (3, 5000, 3000), (3, 700, 1)])
def test_plain_scatter_sums_in_posting_order(B, P, N):
    # the CPU plain version is K5's oracle bit for bit: it adds each doc's
    # postings in posting order, as the kernel does
    ids, vals = _k5_rows(B + P, B, P, N)
    got = bm25_scatter.bm25_scores_plain(torch.from_numpy(ids), torch.from_numpy(vals), N).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _posting_order(ids, vals, N).view(np.uint32))


@pytest.mark.parametrize("B,P,N", [(1, 262_144, 20_000), (3, 0, 1), (2, 1000, 131_072), (1, 513, 131_073),
                                   (1, 4096, 5_000_000)])
def test_scatter_layout_covers_every_doc(B, P, N):
    tile, n_tiles, n_sub, n_scratch = bm25_scatter.scatter_layout(B, P, N)
    assert tile % bm25_scatter.TILE_DOCS == 0 and n_tiles <= bm25_scatter.MAX_TILES
    assert (n_tiles - 1) * tile < N <= n_tiles * tile  # every doc in one tile, no empty tile
    assert tile == bm25_scatter.TILE_DOCS or N > bm25_scatter.TILE_DOCS * bm25_scatter.MAX_TILES
    assert (n_sub - 1) * bm25_scatter.SUB < P <= n_sub * bm25_scatter.SUB or P == n_sub == 0
    assert n_scratch == B * (n_tiles * n_sub + n_tiles + 2 * P)
    if (B, P, N) == (1, 262_144, 20_000):  # the smoke's long query
        assert (tile, n_tiles, n_sub) == (128, 157, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [0, 1000, 32_768, 262_144])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N", [20_000, 1])
def test_scatter_kernel_in_posting_order_on_card(cuda, B, P, N):
    # N = 20000 is not a multiple of the 128-doc tile; P = 1000 is not a
    # multiple of the 512-posting sub-chunk; row 2 of B = 3 is skewed
    ids, vals = _k5_rows(B * 7 + P + N, B, P, N)
    ids_t, vals_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(vals).to(cuda)
    before = bm25_scatter.launches
    got = bm25_scatter.bm25_scores(ids_t, vals_t, N)
    again = bm25_scatter.bm25_scores(ids_t, vals_t, N)
    torch.cuda.synchronize()
    assert bm25_scatter.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    ref = bm25_scatter.bm25_scores_plain(torch.from_numpy(ids), torch.from_numpy(vals), N)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), ref.numpy().view(np.uint32))
    if B == 3:
        assert (got[1] == 0).all()


@pytest.mark.cuda
def test_scatter_kernel_wide_tiles_on_card(cuda):
    # more docs than MAX_TILES tiles of 128: each tile holds 256 docs and the
    # sum walks them 128 at a time
    N = bm25_scatter.TILE_DOCS * bm25_scatter.MAX_TILES + 5
    ids, vals = _k5_rows(5, 3, 40_000, N)
    got = bm25_scatter.bm25_scores(torch.from_numpy(ids).to(cuda), torch.from_numpy(vals).to(cuda), N)
    ref = bm25_scatter.bm25_scores_plain(torch.from_numpy(ids), torch.from_numpy(vals), N)
    assert bm25_scatter.scatter_layout(3, 40_000, N)[0] == 2 * bm25_scatter.TILE_DOCS
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), ref.numpy().view(np.uint32))
