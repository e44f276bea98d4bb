"""The port's non-default pipeline options against the JAX package's.

Covered: the sparse artifact (``save_sparse_index`` / ``load_sparse_index``)
and the corpus artifact (``index/artifact.py``) read and written across the
packages; the native index builder (``native.py``, the port's own copy of
the C++ source, built into ``build/native/``) against the Python builder and
JAX's native builder; ``HierarchicalSplitter``; ``AutoMergingRetriever``;
``HyDETransform``; ``ContextCompressor``; and ``EasyRAGPipeline.run`` under
``split_type`` 1, HyDE with ``hyde_merging``, the corpus artifact, the
compressor and int8 heavy storage, whose contexts (and, with the tiny
MiniCPM reranker, scores within atol 1e-4, and the prompts sent to a
recording LLM) must equal JAX's on the same corpus. Tolerances: index
arrays equal; the native builder's ``post_vals`` equal JAX's native builder's
bit for bit and the Python builder's within rtol 1e-12 (an IDF mean summed in
another order), as ``tests/test_native.py`` holds JAX's.
"""

import asyncio
import json
import os
import time
import zlib

import numpy as np
import pytest
import torch

from easyrag_tpu.automerge import AutoMergingRetriever as JaxAutoMerge
from easyrag_tpu.compressors import ContextCompressor as JaxCompressor
from easyrag_tpu.corpus.hierarchical import HierarchicalSplitter as JaxHierarchical
from easyrag_tpu.index import artifact as jartifact
from easyrag_tpu.index.sparse import build_sparse_index as jax_build
from easyrag_tpu.index.sparse import load_sparse_index as jax_load
from easyrag_tpu.index.sparse import save_sparse_index as jax_save
from easyrag_tpu.models.minicpm import MiniCPMLayerWiseReranker as JaxReranker
from easyrag_tpu.pipeline import EasyRAGPipeline as JaxPipeline
from easyrag_tpu.rerankers import LLMRerank as JaxLLMRerank
from easyrag_tpu.schema import Document as JaxDocument
from easyrag_tpu.schema import NodeRelationship as JaxRel
from easyrag_tpu.schema import NodeWithScore as JaxNWS
from easyrag_tpu.schema import QueryBundle as JaxQB
from easyrag_tpu.schema import TextNode as JaxNode
from easyrag_tpu_torch import native
from easyrag_tpu_torch.automerge import AutoMergingRetriever
from easyrag_tpu_torch.compressors import ContextCompressor
from easyrag_tpu_torch.corpus import HierarchicalSplitter, get_leaf_nodes, get_root_nodes
from easyrag_tpu_torch.corpus.hierarchical import get_deeper_nodes
from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
from easyrag_tpu_torch.generation import CompletionResponse, HyDETransform
from easyrag_tpu_torch.index import artifact
from easyrag_tpu_torch.index.sparse import build_sparse_index, load_sparse_index, save_sparse_index
from easyrag_tpu_torch.models.convert import minicpm_from_jax
from easyrag_tpu_torch.models.layers import DecoderConfig
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from easyrag_tpu_torch.rerankers import LLMRerank
from easyrag_tpu_torch.retrievers import BM25Retriever
from easyrag_tpu_torch.schema import Document, NodeRelationship, NodeWithScore, QueryBundle, TextNode
from easyrag_tpu_torch.utils import events
from test_torch_minicpm import ARCH, CharTok, tiny_params
from test_torch_pipeline import DOCS, QUERIES, RecordingLLM, configs, offline_counter  # noqa: F401

torch.set_num_threads(1)

LONG_DOC = ("扩容手册\n" + "".join(f"CDU扩容第{i}步，检查资源池容量并调整虚机个数。" for i in range(14))
            + "\n\n\n" + "".join(f"备份第{i}步，检查共享存储上的备份文件。" for i in range(8)))
HIER_QUERIES = QUERIES + [{"query": "CDU扩容 检查资源池 虚机个数"}, {"query": "备份 共享存储", "document": "director"}]


def seeded_corpus(seed, num_docs, vocab, lo=5, hi=60):
    """Zipf token lists from a numpy seed; CJK tokens exercise the native
    builder's multibyte hashing."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    docs = [[f"w{t}" for t in rng.choice(vocab, size=int(rng.integers(lo, hi)), p=zipf)] for _ in range(num_docs)]
    docs[0] = ["扩容", "虚机", "扩容", "步长"]
    docs[1] = ["虚机", "备份"]
    return docs


def make_corpus(root, long=True):
    docs = dict(DOCS)
    if long:
        docs["director/long.txt"] = (["运维", "手册"], LONG_DOC)
    for rel, (_, text) in docs.items():
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        with open(os.path.join(root, rel), "w", encoding="utf-8") as f:
            f.write(text)
    with open(os.path.join(root, "pathmap.json"), "w", encoding="utf-8") as f:
        json.dump({rel: path for rel, (path, _) in docs.items()}, f)
    return str(root)


def assert_same_index(got, ref, vals_rtol=0.0):
    assert got.stats.vocab == ref.stats.vocab and got.num_docs == ref.num_docs
    assert got.stats.avgdl == ref.stats.avgdl
    for name in ("doc_lens", "term_offsets", "post_docs", "post_tfs"):
        np.testing.assert_array_equal(getattr(got.stats, name), getattr(ref.stats, name))
    if vals_rtol:
        np.testing.assert_allclose(got.post_vals, ref.post_vals, rtol=vals_rtol)
    else:
        np.testing.assert_array_equal(got.post_vals, ref.post_vals)
    assert (got.bm25_type, got.k1, got.b, got.epsilon) == (ref.bm25_type, ref.k1, ref.b, ref.epsilon)
    np.testing.assert_array_equal(got.dir_ids, ref.dir_ids)
    assert got.dir_vocab == ref.dir_vocab


# -- the sparse artifact and the native builder --------------------------------


@pytest.mark.parametrize("bm25_type", [0, 1])
def test_sparse_artifact_loads_across_packages(tmp_path, bm25_type):
    docs = seeded_corpus(3, 90, 150)
    dirs = [("a", "b")[i % 2] for i in range(len(docs))]
    ref = jax_build(docs, bm25_type=bm25_type, k1=1.2, b=0.7, epsilon=0.3, dirs=dirs, use_native=False)
    got = build_sparse_index(docs, bm25_type=bm25_type, k1=1.2, b=0.7, epsilon=0.3, dirs=dirs, use_native=False)
    assert_same_index(got, ref)
    jax_save(ref, str(tmp_path / "jax"))
    save_sparse_index(got, str(tmp_path / "port"))
    assert_same_index(load_sparse_index(str(tmp_path / "jax")), ref)  # a JAX-written artifact in the port
    assert_same_index(jax_load(str(tmp_path / "port")), got)
    for name in ("sparse_meta.json",):
        with open(tmp_path / "jax" / name, encoding="utf-8") as a, open(tmp_path / "port" / name, encoding="utf-8") as b:
            assert json.load(a) == json.load(b)
    nodir = build_sparse_index(docs[:5], use_native=False)
    save_sparse_index(nodir, str(tmp_path / "nodir"))
    assert load_sparse_index(str(tmp_path / "nodir")).dir_ids is None


@pytest.mark.parametrize("bm25_type", [0, 1])
def test_native_matches_python_builder(bm25_type):
    corpus = seeded_corpus(11, 120, 140)
    py = build_sparse_index(corpus, bm25_type=bm25_type, use_native=False)
    before = native.builds
    nat = build_sparse_index(corpus, bm25_type=bm25_type, use_native=True)
    assert native.builds == before + 1
    assert_same_index(nat, py, vals_rtol=1e-12)
    # JAX's native builder over the same tokens: the same bits
    assert_same_index(nat, jax_build(corpus, bm25_type=bm25_type, use_native=True))
    q = ["w3", "扩容", "unknown"]
    np.testing.assert_allclose(nat.get_scores_host(q), py.get_scores_host(q), rtol=1e-12)
    # the library is the port's own build, never the repository's native/
    assert os.path.dirname(native._lib_path()) == native.BUILD_DIR
    assert os.path.basename(native.BUILD_DIR) == "native" and os.path.exists(native._lib_path())


def test_native_auto_selection_and_refusal(monkeypatch):
    corpus = seeded_corpus(5, 40, 60)
    before = native.builds
    auto = build_sparse_index(corpus)  # use_native=None takes the native builder when it builds
    assert native.builds == before + 1
    assert_same_index(auto, build_sparse_index(corpus, use_native=False), vals_rtol=1e-12)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native index builder"):
        build_sparse_index(corpus, use_native=True)
    assert_same_index(build_sparse_index(corpus), build_sparse_index(corpus, use_native=False))


def test_native_empty_and_single_doc():
    nat = build_sparse_index([[]], use_native=True)
    assert nat.num_docs == 1 and nat.num_postings == 0
    nat2 = build_sparse_index([["a", "a", "b"]], use_native=True)
    assert nat2.num_postings == 2 and nat2.stats.vocab == {"a": 0, "b": 1}
    np.testing.assert_array_equal(nat2.stats.post_tfs, [2, 1])


def test_native_build_speed():
    corpus = seeded_corpus(2, 2000, 5000, lo=100, hi=400)

    def best_of(fn, n=2):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    # timing on a shared machine is noisy: retry the comparison before
    # declaring the C++ builder slow (as tests/test_native.py does)
    attempts = []
    for _ in range(3):
        t_native = best_of(lambda: native.build_index_native(corpus))
        t_python = best_of(lambda: build_sparse_index(corpus, use_native=False))
        attempts.append((t_native, t_python))
        if t_native < t_python * 1.2:
            return
    raise AssertionError(f"the native builder never beat the Python builder: {attempts}")


def test_retriever_takes_a_prebuilt_index(tmp_path):
    nodes = [TextNode(text=t, metadata={"dir": d}) for t, d in (("a b c", "x"), ("b c", "y"), ("c d", "x"))]
    for i, n in enumerate(nodes):
        n.idx = i

    class Cut:
        def cut(self, text):
            return text.split()

    built = BM25Retriever(nodes, Cut(), set(), similarity_top_k=3, embed_type=0, device="cpu")
    save_sparse_index(built.index, str(tmp_path / "s"))
    loaded = BM25Retriever(nodes, Cut(), set(), similarity_top_k=3, embed_type=0, device="cpu",
                           index=load_sparse_index(str(tmp_path / "s")))
    assert_same_index(loaded.index, built.index)
    q = QueryBundle(query_str="a d")
    assert [(n.node.idx, n.score) for n in loaded.retrieve(q)] == [(n.node.idx, n.score) for n in built.retrieve(q)]


# -- nodes, the corpus artifact ------------------------------------------------


def test_nodes_jsonl_roundtrip_across_packages(tmp_path):
    a = TextNode(text="甲", metadata={"dir": "d", "file_path": "d/a.txt"})
    b = TextNode(text="乙", metadata={"dir": "d"})
    b.relationships[NodeRelationship.PREVIOUS] = a.node_id
    a.relationships[NodeRelationship.CHILD] = [b.node_id]
    path = str(tmp_path / "nodes.jsonl")
    artifact.save_nodes([a, b], path)
    for loader in (artifact.load_nodes, jartifact.load_nodes):
        loaded = loader(path)
        assert [n.node_id for n in loaded] == [a.node_id, b.node_id]
        assert loaded[0].metadata == a.metadata
        # either package's NodeRelationship is a str enum: its value keys it
        assert loaded[1].relationships["previous"] == a.node_id
        assert loaded[0].relationships["child"] == [b.node_id]
    ja = JaxNode(text="丙", metadata={"dir": "e"})
    ja.relationships[JaxRel.PARENT] = "p"
    jartifact.save_nodes([ja], str(tmp_path / "j.jsonl"))
    (got,) = artifact.load_nodes(str(tmp_path / "j.jsonl"))
    assert (got.node_id, got.text, got.metadata, got.relationships) == (ja.node_id, "丙", {"dir": "e"},
                                                                         {NodeRelationship.PARENT: "p"})


def test_corpus_artifact_across_packages(tmp_path):
    nodes = [TextNode(text=f"n{i}", metadata={"dir": "d"}) for i in range(3)]
    idx = build_sparse_index([["x", "y"], ["y"], ["z"]], dirs=["d"] * 3, use_native=False)
    art = artifact.CorpusArtifact(str(tmp_path / "a"))
    assert not art.exists()
    art.save(nodes, {"k": 1}, sparse_content=idx, all_nodes=nodes + [TextNode(text="parent")])
    ref = jartifact.CorpusArtifact(str(tmp_path / "a"))
    assert ref.matches({"k": 1}) and art.matches({"k": 1}) and not art.matches({"k": 2})
    assert [n.text for n in ref.load_nodes()] == [n.text for n in art.load_nodes()] == ["n0", "n1", "n2"]
    assert [n.text for n in art.load_all_nodes()] == ["n0", "n1", "n2", "parent"]
    assert art.load_sparse("path") is None and ref.load_sparse("path") is None
    assert_same_index(art.load_sparse("content"), ref.load_sparse("content"))
    assert art.manifest() == ref.manifest()


# -- the hierarchical split, auto-merge, HyDE, compression ---------------------


def _structure(nodes, rel_parent, rel_child):
    """Texts, metadata and the parent/child links as list positions (node ids
    are random)."""
    pos = {n.node_id: i for i, n in enumerate(nodes)}
    return [(n.text, n.metadata, pos.get(n.relationships.get(rel_parent)),
             [pos[c] for c in n.relationships.get(rel_child, [])]) for n in nodes]


def test_hierarchical_splitter_matches_reference():
    split = dict(token_counter=approx_token_count)
    docs = [("doc a", LONG_DOC, {"dir": "d"}), ("doc b", DOCS["director/scale.txt"][1], {"dir": "e"})]
    got = HierarchicalSplitter(splitters=[SentenceSplitter(n, 5, **split) for n in (96, 32, 16)]).parse_documents(
        [Document(text=t, metadata=m, doc_id=i) for i, t, m in docs])
    from easyrag_tpu.corpus.splitter import SentenceSplitter as JaxSplitter
    from easyrag_tpu.corpus.tokenizer import approx_token_count as japprox

    ref = JaxHierarchical(splitters=[JaxSplitter(n, 5, token_counter=japprox) for n in (96, 32, 16)]).parse_documents(
        [JaxDocument(text=t, metadata=m, doc_id=i) for i, t, m in docs])
    assert _structure(got, NodeRelationship.PARENT, NodeRelationship.CHILD) == _structure(ref, JaxRel.PARENT, JaxRel.CHILD)
    leaves, roots = get_leaf_nodes(got), get_root_nodes(got)
    assert 0 < len(roots) < len(got) and len(leaves) > len(roots)
    assert [n.node_id for n in get_deeper_nodes(got, 2)] == [n.node_id for n in leaves if n not in roots]
    with pytest.raises(ValueError):
        get_deeper_nodes(got, -1)


def _family(pkg_node, pkg_rel, n_children=4):
    parent = pkg_node(text="PARENT")
    children = [pkg_node(text=f"c{i}") for i in range(n_children)]
    for c in children:
        c.relationships[pkg_rel.PARENT] = parent.node_id
    parent.relationships[pkg_rel.CHILD] = [c.node_id for c in children]
    return parent, children


@pytest.mark.parametrize("hits", [3, 1])
def test_automerge_matches_reference(hits):
    out = {}
    for name, node_cls, nws, rel, qb, merger in (
        ("jax", JaxNode, JaxNWS, JaxRel, JaxQB, JaxAutoMerge),
        ("port", TextNode, NodeWithScore, NodeRelationship, QueryBundle, AutoMergingRetriever),
    ):
        parent, children = _family(node_cls, rel)
        lone = node_cls(text="lone")

        class Base:
            filter_dict = None

            def retrieve(self, _):
                return [nws(node=c, score=s) for c, s in zip(children[:hits], (3.0, 2.0, 1.0))] + [
                    nws(node=lone, score=2.5)]

        am = merger(Base(), [parent, *children, lone], simple_ratio_thresh=0.4)
        am.filter_dict = {"dir": "x"}
        assert am._base.filter_dict == {"dir": "x"}
        out[name] = [(n.node.text, n.score) for n in asyncio.run(am.aretrieve(qb(query_str="q")))]
    assert out["port"] == out["jax"]
    if hits == 3:  # 3 of 4 children (0.75 > 0.4): the parent, at the mean score
        assert out["port"] == [("lone", 2.5), ("PARENT", 2.0)]
    else:
        assert out["port"] == [("lone", 2.5), ("c0", 3.0)][::-1]


def test_hyde_transform_bundle():
    class FakeLLM:
        async def acomplete(self, prompt):
            assert "问题X" in prompt
            return CompletionResponse(text="伪文档")

    bundle = asyncio.run(HyDETransform(FakeLLM(), "上下文:{context_str}", include_original=True).acall("问题X"))
    assert bundle.custom_embedding_strs == ["伪文档", "问题X"] and bundle.query_str == "问题X"


class SeededEmbedder:
    """Unit vectors drawn from a numpy seed that hashes the text (crc32)."""

    dim = 32

    def _vec(self, text):
        v = np.random.default_rng(zlib.crc32(text.encode())).normal(size=self.dim)
        return v / np.linalg.norm(v)

    def get_query_embedding(self, query):
        return self._vec(query)

    def get_text_embeddings(self, texts):
        return np.stack([self._vec(t) for t in texts])


def test_compressors_match_reference(tmp_path, offline_counter):  # noqa: F811
    data_path = make_corpus(tmp_path / "corpus")
    jcfg, cfg = configs(data_path=data_path, re_only=True, use_reranker=0, chunk_size=64, chunk_overlap=10,
                        compress_method="bm25_extract", compress_rate=0.4,
                        tpu=dict(use_pallas=False, max_query_postings=2048))
    ref, got = JaxPipeline(jcfg), EasyRAGPipeline(cfg, device="cpu")
    context = "CDU虚机每次扩容的最大SC个数为15。备份文件存储在共享存储上。鉴权日志位于日志目录。扩容前需要检查资源池容量。"
    out = got.compressor.compress("CDU扩容个数", context)
    assert out == ref.compressor.compress("CDU扩容个数", context)
    assert 0 < len(out) < len(context) and "扩容" in out
    ctx = "CDU扩容上限为15。备份存储说明。鉴权日志位置。扩容步长为3。"
    e = ContextCompressor("embed_extract", rate=0.4, embed_model=SeededEmbedder()).compress("CDU扩容", ctx)
    assert e == JaxCompressor("embed_extract", rate=0.4, embed_model=SeededEmbedder()).compress("CDU扩容", ctx)
    pos = [ctx.index(s + "。") for s in e.split("。") if s]
    assert 0 < len(e) < len(ctx) and pos == sorted(pos)
    for bad in (dict(method="bm25_extract"), dict(method="embed_extract"), dict(method="nope")):
        with pytest.raises(ValueError):
            ContextCompressor(**bad)
    with pytest.raises(ImportError, match="llmlingua"):
        ContextCompressor("llmlingua")


# -- the pipeline under each option, against JAX's run ---------------------------


def _rerankers(side="right"):
    jcfg, params, params_np = tiny_params()
    opts = dict(start_layer=1, cutoff_layer=3, max_length=64)
    ref = JaxLLMRerank(JaxReranker(jcfg, params, CharTok(side), **opts), top_n=3, embed_bs=4, embed_type=1)
    scorer = minicpm_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, CharTok(side), **opts)
    return ref, LLMRerank(scorer, top_n=3, embed_bs=4, embed_type=1)


def _both(tmp_path, rerank=False, jax_kw=None, port_kw=None, **kw):
    """Both packages' pipelines on one corpus with the same options: each
    with a recording LLM (and the tiny reranker with ``rerank``)."""
    data_path = make_corpus(tmp_path / "corpus")
    base = dict(data_path=data_path, chunk_size=64, chunk_overlap=10, f_topk_2=8, f_topk_3=2)
    base.update((k, kw.pop(k)) for k in ("chunk_size", "chunk_overlap") if k in kw)
    tpu = kw.pop("tpu", {})
    jcfg, _ = configs(**base, **{"use_reranker": 2 if rerank else 0, **kw, **(jax_kw or {})},
                      tpu={"use_pallas": False, "max_query_postings": 2048, **tpu})
    _, pcfg = configs(**base, **{"use_reranker": 2 if rerank else 0, **kw, **(port_kw or {})},
                      tpu={"max_query_postings": 2048, **tpu})
    jr, pr = _rerankers() if rerank else (None, None)
    jllm, pllm = RecordingLLM(), RecordingLLM()
    return (JaxPipeline(jcfg, llm=jllm, reranker=jr), jllm), (EasyRAGPipeline(pcfg, llm=pllm, reranker=pr, device="cpu"), pllm)


def _assert_same_runs(ref, got, queries, atol=1e-4, answers=True):
    for q in queries:
        a, b = asyncio.run(ref.run(dict(q))), asyncio.run(got.run(dict(q)))
        assert b["contexts"] == a["contexts"], q
        assert [n.node.text for n in b["nodes"]] == [n.node.text for n in a["nodes"]]
        assert [n.node.idx for n in b["nodes"]] == [n.node.idx for n in a["nodes"]]
        np.testing.assert_allclose([n.score for n in b["nodes"]], [n.score for n in a["nodes"]], atol=atol, rtol=0)
        assert b["answer"] == a["answer"] or not answers


@pytest.mark.parametrize("rerank", [False, True])
def test_split_type_1_matches_jax_pipeline(tmp_path, offline_counter, rerank):  # noqa: F811
    (ref, jllm), (got, pllm) = _both(tmp_path, rerank=rerank, split_type=1, chunk_size=32, chunk_overlap=0)
    assert isinstance(got.sparse_retriever, AutoMergingRetriever) and got._dual_scorer is None
    assert len(got.all_nodes) == len(ref.all_nodes) > len(got.nodes) == len(ref.nodes)
    assert [n.text for n in got.all_nodes] == [n.text for n in ref.all_nodes]
    _assert_same_runs(ref, got, HIER_QUERIES)
    assert pllm.prompts == jllm.prompts
    merged = asyncio.run(got.run(dict(HIER_QUERIES[3])))
    assert any(len(c) > 40 for c in merged["contexts"])  # a parent replaced its leaves
    # the batch entry points fall back to run, query by query
    if not rerank:
        got.re_only = ref.re_only = True
        batch = asyncio.run(got.run_retrieval_batch([dict(q) for q in HIER_QUERIES]))
        assert [r["contexts"] for r in batch] == [asyncio.run(ref.run(dict(q)))["contexts"] for q in HIER_QUERIES]


@pytest.mark.parametrize("merging", [False, True])
def test_hyde_matches_jax_pipeline(tmp_path, offline_counter, merging):  # noqa: F811
    (ref, jllm), (got, pllm) = _both(tmp_path, rerank=True, hyde=True, hyde_merging=merging)
    stages = []
    off = events.on(lambda kind, payload: stages.append(payload["name"]) if kind == "timing" else None)
    _assert_same_runs(ref, got, QUERIES)
    off()
    # the HyDE prompt, (with hyde_merging) the merge prompt, then the QA
    # prompt, each query: the same prompts as JAX's
    assert pllm.prompts == jllm.prompts and len(pllm.prompts) == len(QUERIES) * (3 if merging else 2)
    assert stages.count("hyde") == len(QUERIES) and stages.count("hyde_merging") == (len(QUERIES) if merging else 0)
    q = dict(QUERIES[0])
    asyncio.run(got.run(q))
    assert q["hyde_query"] == f"answer-{len(pllm.prompts) - (2 if merging else 1)}"
    # the batch entry points fall back to run under HyDE
    got.reranker = None
    got.re_only = True
    n = len(pllm.prompts)
    asyncio.run(got.run_retrieval_batch([dict(q) for q in QUERIES]))
    assert len(pllm.prompts) == n + len(QUERIES)  # one HyDE prompt a query: run, not the stream
    staged = asyncio.run(got.run_answers_batch([dict(q) for q in QUERIES]))
    assert len(staged) == len(QUERIES) and len(pllm.prompts) == n + 2 * len(QUERIES)


def test_int8_heavy_pipeline_matches_jax(tmp_path, offline_counter):  # noqa: F811
    (ref, _), (got, _) = _both(tmp_path, rerank=True, tpu={"sparse_heavy_dtype": "int8"})
    for route in (got.sparse_retriever, got.path_retriever):
        assert route._resident.heavy_dtype == "int8" and route._resident.heavy.dtype == torch.int8
    assert got.sparse_retriever._resident.light_cap == ref.sparse_retriever._resident.light_cap
    _assert_same_runs(ref, got, QUERIES)
    got.reranker, got.re_only = None, True
    batch = asyncio.run(got.run_retrieval_batch([dict(q) for q in QUERIES]))
    singles = [asyncio.run(got.run(dict(q))) for q in QUERIES]
    assert [[(n.node.idx, n.score) for n in r["nodes"]] for r in batch] == [
        [(n.node.idx, n.score) for n in r["nodes"]] for r in singles]


def test_artifact_fast_boot_matches_jax_pipeline(tmp_path, offline_counter):  # noqa: F811
    (ref, _), (got, _) = _both(tmp_path, rerank=False, jax_kw={"index_artifact_path": str(tmp_path / "jax_art")},
                               port_kw={"index_artifact_path": str(tmp_path / "port_art")}, split_type=1,
                               chunk_size=32, chunk_overlap=0)
    cfg = got.config
    assert artifact.CorpusArtifact(cfg.index_artifact_path).exists()
    seen = []
    off = events.on(lambda kind, payload: seen.append(kind))
    again = EasyRAGPipeline(cfg, llm=RecordingLLM(), device="cpu")
    off()
    assert "artifact" in seen and "ingestion" not in seen
    assert len(again.all_nodes) > len(again.nodes)
    # the recording LLMs count their prompts: each pipeline answers its own
    _assert_same_runs(ref, again, HIER_QUERIES, answers=False)
    # the port boots from JAX's artifact (the same fingerprint and format)
    seen.clear()
    off = events.on(lambda kind, payload: seen.append(kind))
    from_jax = EasyRAGPipeline(dict(cfg.to_dict(), index_artifact_path=str(tmp_path / "jax_art")), llm=RecordingLLM(),
                               device="cpu")
    off()
    assert "ingestion" not in seen
    _assert_same_runs(ref, from_jax, HIER_QUERIES, answers=False)
    # a changed corpus file invalidates the artifact: rebuilt from disk
    os.remove(os.path.join(cfg.data_path, "director", "scale.txt"))
    rebuilt = EasyRAGPipeline(cfg, llm=RecordingLLM(), device="cpu")
    res = asyncio.run(rebuilt.run(dict(QUERIES[0])))
    assert all("CDU虚机每次扩容的最大SC个数为15" not in c for c in res["contexts"])
    # so does a fingerprint knob
    seen.clear()
    off = events.on(lambda kind, payload: seen.append(kind))
    EasyRAGPipeline(dict(cfg.to_dict(), chunk_size=48), llm=RecordingLLM(), device="cpu")
    off()
    assert "ingestion" in seen
