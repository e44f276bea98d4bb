"""At tiny sizes the plain reference agrees with the port's CPU path, and
the reference keeps to itself."""

from __future__ import annotations

import ast
import os

import numpy as np
import torch

from benchmark.harness import judge
from benchmark.harness.cell import BENCH_DIR
from benchmark.harness.corpus import make_corpus, make_questions
from benchmark.reference.bm25 import DualRouteReference
from benchmark.reference.minicpm import MiniCPMReference
from benchmark.reference.weights import minicpm_weights
from benchmark.tests.conftest import QUERY, SEED


def test_minicpm_reference_matches_the_port(tiny_cell):
    cell = tiny_cell(QUERY)
    cfg = cell.config
    scorer = cell.system.make_minicpm(cfg, SEED, "cpu", 0)
    pairs = [("t1 t2 t3 doc4", "###\nrcp/doc4.txt\n\n文档4\nt5 t6 t7"),
             ("t9 t2", "###\numac/doc9.txt\n\n文档9\n" + " ".join(f"t{i}" for i in range(300)))]
    got, _ = scorer.score_pairs(pairs)
    ids, mask = scorer.build_inputs(pairs)
    ref = MiniCPMReference(cfg, minicpm_weights(cfg, SEED, "cpu", torch.float32), precision="f32")
    want = ref.score([list(ids[i][: mask[i].sum()]) for i in range(len(pairs))], cfg["reranker"]["cutoff_layer"])
    assert np.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pairs_and_routes_match_the_port(tmp_path, tiny_cell):
    """The reference's pair rows equal the port's, and its fused candidates
    the port's dual route and fusion, on every kind of question."""
    from easyrag_tpu_torch.corpus.tokenizer import default_stopwords
    from easyrag_tpu_torch.corpus.views import get_node_content
    from easyrag_tpu_torch.retrievers import HybridRetriever
    from easyrag_tpu_torch.schema import QueryBundle

    cell = tiny_cell(QUERY)
    cfg = cell.config
    corpus = make_corpus(str(tmp_path / "c"), SEED, cfg["corpus"])
    system = cell.system.build(cfg, cell.traffic, corpus, SEED, "cpu", False)
    p = system.pipeline
    tokens = {t for text in corpus.texts for t in text.split()} | {"知识", *corpus.dirs}
    assert not tokens & default_stopwords()
    n = len(corpus.texts)
    ref = DualRouteReference([corpus.know_path(d) for d in range(n)], corpus.dirs, corpus.texts)
    for q in make_questions(corpus, SEED, cell.traffic)[:32]:
        filters = p.build_filters(q)[1]
        p.filter_dict = p.sparse_retriever.filter_dict = filters
        bundle = QueryBundle(query_str=q["query"])
        routes = p._dual_retrieve(bundle) or (p.sparse_retriever.retrieve(bundle), p.path_retriever.retrieve(bundle))
        fused = HybridRetriever.fusion(list(routes))
        got = [(system.doc_of[nw.node.idx], nw.score) for nw in fused]
        want = ref.fused(q["query"], q.get("document"), cfg["preset"]["f_topk_2"], cfg["preset"]["f_topk_3"],
                         prefer=[d for d, _ in got])
        c, pth, allowed = ref.routes(q["query"], q.get("document"))
        assert judge.retrieval_gap(got, want, c, pth, allowed) < 1e-6
        rec = {"query": q["query"], "candidates": [(nw.node.idx, nw.score) for nw in fused[:4]]}
        rows = cell.system.rerank_rows(cfg, corpus, rec, system.doc_of)
        pairs = [(q["query"], get_node_content(nw.node, p.config.r_embed_type)) for nw in fused[:4]]
        ids, mask = system.scorer.build_inputs(pairs)
        assert rows == [list(ids[i][: mask[i].sum()]) for i in range(len(rows))]


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_import_scan():
    """Nothing under benchmark/ imports JAX or the JAX package (whole
    top-level names: the port's name starts with the JAX package's), and the
    reference imports nothing of the program either."""
    for dirpath, _, files in os.walk(BENCH_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                found = set(_imports(path))
                assert not found & {"jax", "jaxlib", "flax", "easyrag_tpu"}, path
                if os.path.basename(dirpath) == "reference":
                    assert "easyrag_tpu_torch" not in found, path
