"""The port's compressed resident BM25 index and its K5 light tail against
the JAX package's, on one seeded Zipf corpus.

Tolerances: ``auto_light_cap`` and the split it makes are equal to JAX's; the
heavy arrays (bf16 bits, int8 values and scales) are equal; int8's heavy part
is equal bit for bit (sums of small integers, exact in f32 in any order, and
scaled once), so on queries whose every term is heavy the top-k is equal bit
for bit; with light terms the ids are equal and the values within rtol 1e-6
(the same f32 sums in another order), as are bf16's and the K5 tail's. JAX's
K5 tail runs with ``tail="pallas_interpret"``, as the JAX package's tests run
it. A stream row equals its query's single row bit for bit in the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from easyrag_tpu.index.sparse import build_sparse_index as jax_build
from easyrag_tpu.ops import bm25_resident as jres
from easyrag_tpu_torch.index.sparse import build_sparse_index
from easyrag_tpu_torch.ops import bm25_resident as tres
from easyrag_tpu_torch.ops import bm25_scatter

torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16", "int8")
FORMS = ("gather", "onehot")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    zipf = 1.0 / np.arange(1, 401)
    zipf /= zipf.sum()
    docs = [[f"t{t}" for t in rng.choice(400, size=int(rng.integers(5, 80)), p=zipf)] for _ in range(203)]
    docs[9] = list(docs[4])  # exact ties
    dirs = [("a", "b", "c")[i % 3] for i in range(len(docs))]
    queries = [list(rng.choice(docs[i], size=8)) + ["t3", "unknown"] for i in (1, 17, 40, 77)]
    queries += [list(docs[4][:5]), ["t0", "t0", "t1"], []]
    return docs, dirs, queries


@pytest.fixture(scope="module")
def indexes(corpus):
    docs, dirs, _ = corpus
    return jax_build(docs, dirs=dirs, use_native=False), build_sparse_index(docs, dirs=dirs, use_native=False)


def _pair(indexes, **kw):
    ref_idx, idx = indexes
    jkw = dict(kw)
    if jkw.get("tail") == "pallas":
        jkw["tail"] = "pallas_interpret"
    return jres.ResidentSparseIndex(ref_idx, **jkw), tres.ResidentSparseIndex(idx, device="cpu", **kw)


def _jax_topk(ref, ids, cnts, dir_f, k, heavy_form="auto"):
    tv, ti = jres._resident_score_topk(
        ref.heavy, ref.t_heavy_row, ref.t_starts, ref.t_light_lens, ref.post_docs, ref.post_vals, ref.dir_col,
        jnp.asarray(ids), jnp.asarray(cnts), None if dir_f is None else jnp.asarray(dir_f), ref.heavy_scales,
        k=k, num_docs=ref.num_docs, light_cap=ref.light_cap, P=ref.P, tail=ref.tail, light=ref.light_layout,
        heavy_form="gather" if heavy_form == "gather" else "matmul",
    )
    return np.asarray(tv), np.asarray(ti)


def _port_topk(got, ids, cnts, dir_f, k, heavy_form="auto"):
    tv, ti = got._score_topk(torch.from_numpy(ids), torch.from_numpy(cnts), k,
                             None if dir_f is None else torch.from_numpy(dir_f),
                             light_t=got.light_t_bound(ids), heavy_form=heavy_form)
    return tv.numpy(), ti.numpy()


def _zipf_lens(num_docs, vocab, tokens):
    """Document frequencies of a Zipf vocabulary: the r-th word's count,
    capped at the doc count (the smoke corpus's shape at 20,000 docs)."""
    counts = tokens / (np.log(vocab) + 0.5772) / np.arange(1, vocab + 1)
    return np.minimum(num_docs, np.ceil(counts)).astype(np.int64)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_auto_light_cap_matches_reference(corpus, indexes, itemsize):
    lens_sets = [
        np.diff(indexes[1].stats.term_offsets),
        _zipf_lens(20_000, 40_000, 6_000_000),  # the smoke's corpus: V 40,000, ~6M tokens
        _zipf_lens(2_000, 5_000, 300_000),
        np.random.default_rng(3).integers(1, 5_000, size=3_000),
    ]
    budgets = [0, 1 << 20, 64 << 20, 512 << 20, 1 << 30, 4 << 30, 16 << 30]
    for lens in lens_sets:
        n = int(lens.max())
        for budget in budgets:
            for terms in (16, 64):
                for kappa in (1.0, 0.5):
                    want = jres.auto_light_cap(lens.astype(np.int32), n, itemsize, budget, terms, kappa_scale=kappa)
                    got = tres.auto_light_cap(lens, n, itemsize, budget, terms, kappa_scale=kappa)
                    assert got == want, (n, budget, terms, kappa)
    # the cases where the smallest cap that fits is not the reference's
    smoke = _zipf_lens(20_000, 40_000, 6_000_000)
    assert tres.auto_light_cap(smoke, 20_000, 1, 1 << 30, 64, 0.5) == jres.auto_light_cap(
        smoke.astype(np.int32), 20_000, 1, 1 << 30, 64, 0.5)
    assert tres.auto_light_cap(smoke, 20_000, itemsize, 4 << 30, 64, 0.5) > 8


@pytest.mark.parametrize("light_rows", [None, True, False])
@pytest.mark.parametrize("heavy_dtype", DTYPES)
def test_constructor_split_matches_reference(indexes, light_rows, heavy_dtype):
    # budgets small enough to move the cap, and a rows table that fits only
    # small caps: the reference re-picks the cap for the CSR layout
    V = len(indexes[1].stats.vocab)
    for heavy_budget in (2_000, 20_000, 1 << 30):
        for rows_budget in ((V + 1) * 8 * 8, 256 << 20):
            kw = dict(heavy_dtype=heavy_dtype, light_rows=light_rows, heavy_hbm_budget=heavy_budget,
                      light_rows_hbm_budget=rows_budget, max_query_terms=16)
            ref, got = _pair(indexes, **kw)
            assert (got.light_cap, got.light_layout, got.V, got.P) == (ref.light_cap, ref.light_layout, ref.V, ref.P)
            np.testing.assert_array_equal(got.t_heavy_row.numpy(), np.asarray(ref.t_heavy_row))


def test_heavy_storage_matches_reference(indexes):
    for dtype in DTYPES:
        ref, got = _pair(indexes, heavy_dtype=dtype, light_cap=8, max_query_terms=16)
        want = np.asarray(ref.heavy.astype(jnp.float32)) if dtype == "bfloat16" else np.asarray(ref.heavy)
        assert got.heavy.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
        assert got.heavy.shape == ref.heavy.shape
        np.testing.assert_array_equal(got.heavy.float().numpy(), want.astype(np.float32))
        if dtype == "int8":
            np.testing.assert_array_equal(got.heavy_scales.numpy(), np.asarray(ref.heavy_scales))
            assert ref.heavy.dtype == jnp.int8
        else:
            assert got.heavy_scales is None
    f32 = tres.ResidentSparseIndex(indexes[1], light_cap=8, device="cpu")
    i8 = tres.ResidentSparseIndex(indexes[1], light_cap=8, heavy_dtype="int8", device="cpu")
    assert i8.heavy.nbytes * 4 == f32.heavy.nbytes  # a quarter of f32's bytes at one cap


def _heavy_queries(got, n=4, seed=5):
    """Queries whose every term is heavy (with counts > 1)."""
    rng = np.random.default_rng(seed)
    id2tok = {t: w for w, t in got.host_index.stats.vocab.items()}
    heavy = [id2tok[t] for t in np.where(got._host_light_lens[: got.V] == 0)[0]]
    assert len(heavy) >= 6
    return [list(rng.choice(heavy, size=int(rng.integers(2, 7)))) + [heavy[0]] for _ in range(n)]


@pytest.mark.parametrize("light_rows", [True, False])
@pytest.mark.parametrize("heavy_form", FORMS)
def test_int8_heavy_part_bit_exact(indexes, light_rows, heavy_form):
    ref, got = _pair(indexes, heavy_dtype="int8", light_cap=8, max_query_terms=16, light_rows=light_rows)
    queries = _heavy_queries(got)
    ids, cnts = got.query_terms_batch(queries)
    np.testing.assert_array_equal(ids, ref.query_terms_batch(queries)[0])
    assert got.light_t_bound(ids) == 0
    rv, ri = _jax_topk(ref, ids, cnts, None, 40, heavy_form)
    gv, gi = _port_topk(got, ids, cnts, None, 40, heavy_form)
    np.testing.assert_array_equal(gv.view(np.uint32), rv.view(np.uint32))
    np.testing.assert_array_equal(gi, ri)
    # the two heavy forms of the port: the same bits
    t_ids, t_cnts = torch.from_numpy(ids), torch.from_numpy(cnts)
    a, b = (got.heavy_part(t_ids, t_cnts, f) for f in FORMS)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("light_rows", [True, False])
@pytest.mark.parametrize("heavy_form", FORMS)
def test_int8_topk_matches_reference(corpus, indexes, light_rows, heavy_form):
    ref, got = _pair(indexes, heavy_dtype="int8", light_cap=8, max_query_terms=16, light_rows=light_rows)
    queries = corpus[2]
    ids, cnts = got.query_terms_batch(queries)
    dir_f = np.array([-1, 0, -2, 2, -1, 1, -1], np.int32)
    rv, ri = _jax_topk(ref, ids, cnts, dir_f, 30, heavy_form)
    gv, gi = _port_topk(got, ids, cnts, dir_f, 30, heavy_form)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gv, rv, rtol=1e-6)


def _same_ranking_up_to_ties(gv, gi, rv, ri, rtol=1e-6):
    """Equal values within ``rtol`` at every rank, and equal ids wherever the
    neighbouring scores are not within ``rtol`` of each other."""
    np.testing.assert_allclose(gv, rv, rtol=rtol)
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    for row in range(rv.shape[0]):
        v = rv[row][fin[row]]
        tied = np.zeros(len(v), bool)
        close = np.abs(np.diff(v)) <= rtol * np.abs(v[1:])
        tied[1:] |= close
        tied[:-1] |= close
        np.testing.assert_array_equal(gi[row][: len(v)][~tied], ri[row][: len(v)][~tied])
        assert sorted(gi[row][: len(v)][tied]) == sorted(ri[row][: len(v)][tied]) or tied.all()


@pytest.mark.parametrize("light_rows", [True, False])
def test_bf16_topk_matches_reference(corpus, indexes, light_rows):
    ref, got = _pair(indexes, heavy_dtype="bfloat16", light_cap=8, max_query_terms=16, light_rows=light_rows)
    queries = corpus[2] + _heavy_queries(got)
    ids, cnts = got.query_terms_batch(queries)
    for form in FORMS:
        rv, ri = _jax_topk(ref, ids, cnts, None, 30, form)
        gv, gi = _port_topk(got, ids, cnts, None, 30, form)
        _same_ranking_up_to_ties(gv, gi, rv, ri)


@pytest.mark.parametrize("heavy_dtype", DTYPES)
@pytest.mark.parametrize("light_rows", [True, False])
def test_pallas_tail_matches_reference(corpus, indexes, heavy_dtype, light_rows):
    kw = dict(heavy_dtype=heavy_dtype, light_cap=8, max_query_terms=16, light_rows=light_rows)
    ref, got = _pair(indexes, tail="pallas", **kw)
    assert got.tail == "pallas" and ref.tail == "pallas_interpret"
    queries = corpus[2]
    dirs = [None, "a", "nowhere", None, "c", None, None]
    rv, ri = ref.score_topk(queries, 25, dir_values=dirs)
    gv, gi = got.score_topk(queries, 25, dir_values=dirs)
    _same_ranking_up_to_ties(gv, gi, np.asarray(rv), np.asarray(ri))
    # the XLA tail of the port: the same ranking, sums in another order
    xv, xi = tres.ResidentSparseIndex(indexes[1], device="cpu", **kw).score_topk(queries, 25, dir_values=dirs)
    _same_ranking_up_to_ties(gv, gi, xv, xi)
    # "pallas_interpret", the reference's CPU spelling, is the same route
    iv, ii = tres.ResidentSparseIndex(indexes[1], device="cpu", tail="pallas_interpret", **kw).score_topk(
        queries, 25, dir_values=dirs)
    np.testing.assert_array_equal(ii, gi)
    np.testing.assert_array_equal(iv.view(np.uint32), gv.view(np.uint32))


def test_pallas_tail_goes_through_the_scatter_wrapper(corpus, indexes, monkeypatch):
    _, got = _pair(indexes, tail="pallas", light_cap=8, max_query_terms=16)
    calls = []
    plain = bm25_scatter.bm25_scores

    def spy(ids, vals, n):
        calls.append((tuple(ids.shape), ids.dtype, vals.dtype))
        return plain(ids, vals, n)

    monkeypatch.setattr(bm25_scatter, "bm25_scores", spy)
    ids, cnts = got.query_terms_batch(corpus[2])
    TL = got.light_t_bound(ids)
    got._score_topk(torch.from_numpy(ids), torch.from_numpy(cnts), 5, light_t=TL)
    assert calls == [((len(corpus[2]), TL * got.light_cap), torch.int32, torch.float32)]
    # a batch of heavy terms only gathers no light slot: the tail adds nothing
    hids, hcnt = got.query_terms_batch(_heavy_queries(got))
    got._score_topk(torch.from_numpy(hids), torch.from_numpy(hcnt), 5, light_t=got.light_t_bound(hids))
    assert len(calls) == 1


@pytest.mark.parametrize("tail", ["xla", "pallas"])
@pytest.mark.parametrize("heavy_dtype", DTYPES)
def test_stream_rows_equal_single_rows(corpus, indexes, heavy_dtype, tail):
    got = tres.ResidentSparseIndex(indexes[1], heavy_dtype=heavy_dtype, tail=tail, light_cap=8,
                                   max_query_terms=16, device="cpu")
    queries = corpus[2] + _heavy_queries(got)
    dirs = [None, "b", None, "a", None, "nowhere", None, None, "c", None, None]
    sv, si = got.stream_score_topk(queries, 20, batch=3, dir_values=dirs)
    for i, (q, d) in enumerate(zip(queries, dirs)):
        v, idx = got.score_topk([q], 20, dir_values=[d])
        np.testing.assert_array_equal(si[i], idx[0])
        np.testing.assert_array_equal(sv[i].view(np.uint32), v[0].view(np.uint32))


@pytest.mark.parametrize("dtype,rtol,min_overlap", [("bfloat16", 6e-3, 9), ("int8", 3e-2, 8)])
def test_quantized_heavy_close_to_exact(corpus, indexes, dtype, rtol, min_overlap):
    # tests/test_resident.py's case: scores within the storage's rounding of
    # the exact ones and the top-10 nearly the same, in both packages alike
    exact = tres.ResidentSparseIndex(indexes[1], light_cap=2, max_query_terms=16, device="cpu")
    ref, quant = _pair(indexes, light_cap=2, max_query_terms=16, heavy_dtype=dtype)
    queries = corpus[2][:4]
    tv0, ti0 = exact.score_topk(queries, 10)
    tv1, ti1 = quant.score_topk(queries, 10)
    rv, ri = ref.score_topk(queries, 10)
    np.testing.assert_allclose(tv1, np.asarray(rv), rtol=1e-6)
    for row in range(len(queries)):
        keep0 = {int(i) for i, v in zip(ti0[row], tv0[row]) if np.isfinite(v)}
        keep1 = {int(i) for i, v in zip(ti1[row], tv1[row]) if np.isfinite(v)}
        assert len(keep0 & keep1) >= min(min_overlap, len(keep0))
        both = np.isfinite(tv0[row]) & np.isfinite(tv1[row])
        np.testing.assert_allclose(tv1[row][both], tv0[row][both], rtol=rtol)
    tvs, tis = quant.stream_score_topk(queries, 10, batch=2)
    np.testing.assert_array_equal(tis, ti1)


def test_int8_auto_light_cap_gets_headroom(indexes):
    budget = 40_000  # bytes: small enough to move the cap
    caps = {}
    for dtype in DTYPES:
        ref, got = _pair(indexes, heavy_hbm_budget=budget, heavy_dtype=dtype)
        assert got.light_cap == ref.light_cap
        caps[dtype] = got.light_cap
    assert caps["int8"] <= caps["bfloat16"] <= caps["float32"]


@pytest.mark.parametrize("rows", [1, 5, 17])
def test_int8_onehot_form_at_every_row_count(corpus, indexes, rows):
    # the s8 product (``int8_matmul``: rows padded to 17, the doc count 203
    # padded to a multiple of 8) against the gather, bit for bit
    got = tres.ResidentSparseIndex(indexes[1], heavy_dtype="int8", light_cap=8, max_query_terms=16, device="cpu")
    assert got.num_docs % 8 and got.heavy.shape == (got.heavy.shape[0], got.num_docs)
    queries = (corpus[2] + _heavy_queries(got, n=12))[:rows]
    ids, cnts = (torch.from_numpy(a) for a in got.query_terms_batch(queries))
    a, b = (got.heavy_part(ids, cnts, f) for f in FORMS)
    assert a.shape == (rows, got.num_docs) and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("TL", [1, 4, 12])
def test_k5_tail_shapes_match_plain_on_card(cuda, indexes, TL):
    # the tail's [64, TL*C] postings: sentinel-padded windows of light terms
    got = tres.ResidentSparseIndex(indexes[1], light_cap=8, max_query_terms=16, device="cpu")
    rng = np.random.default_rng(TL)
    light = np.where(got._host_light_lens[: got.V] > 0)[0]
    ids = np.full((64, TL), got.V, np.int64)
    ids[:, :TL] = rng.choice(light, size=(64, TL))
    cnts = rng.integers(1, 4, size=(64, TL)).astype(np.float32)
    docs = got.post_docs[torch.from_numpy(ids)].reshape(64, -1).to(torch.int32)
    vals = (got.post_vals[torch.from_numpy(ids)] * torch.from_numpy(cnts)[:, :, None]).reshape(64, -1)
    before = bm25_scatter.launches
    card = bm25_scatter.bm25_scores(docs.to(cuda), vals.to(cuda), got.num_docs)
    torch.cuda.synchronize()
    assert bm25_scatter.launches == before + 1
    plain = bm25_scatter.bm25_scores_plain(docs, vals, got.num_docs)
    np.testing.assert_array_equal(card.cpu().numpy().view(np.uint32), plain.numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("heavy_form", FORMS)
def test_int8_heavy_part_on_card_equals_cpu(cuda, corpus, indexes, heavy_form):
    kw = dict(heavy_dtype="int8", light_cap=8, max_query_terms=16)
    cpu = tres.ResidentSparseIndex(indexes[1], device="cpu", **kw)
    card = tres.ResidentSparseIndex(indexes[1], device=cuda, **kw)
    ids, cnts = cpu.query_terms_batch(corpus[2] + _heavy_queries(cpu))
    for rows in (1, 3, len(ids)):  # the s8 product pads 1 and 3 rows to 17
        want = cpu.heavy_part(torch.from_numpy(ids[:rows]), torch.from_numpy(cnts[:rows]), heavy_form)
        got = card.heavy_part(torch.from_numpy(ids[:rows]).to(cuda), torch.from_numpy(cnts[:rows]).to(cuda), heavy_form)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    tv, ti = card.stream_score_topk(corpus[2], 20, batch=3)
    cv, ci = cpu.stream_score_topk(corpus[2], 20, batch=3)
    np.testing.assert_array_equal(ti, ci)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 64])
def test_int8_onehot_on_card_pads_rows(cuda, corpus, indexes, m):
    # torch._int_mm takes more than 16 rows and a K-contiguous second
    # operand on the card: the one-hot form pads the rows and hands it a
    # doc-major copy, and gives the CPU's bits
    kw = dict(heavy_dtype="int8", light_cap=8, max_query_terms=16)
    cpu = tres.ResidentSparseIndex(indexes[1], device="cpu", **kw)
    card = tres.ResidentSparseIndex(indexes[1], device=cuda, **kw)
    queries = (corpus[2] + _heavy_queries(cpu, n=64))[:m]
    ids, cnts = (torch.from_numpy(a) for a in cpu.query_terms_batch(queries))
    want = cpu.heavy_part(ids, cnts, "onehot")
    got = card.heavy_part(ids.to(cuda), cnts.to(cuda), "onehot")
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
