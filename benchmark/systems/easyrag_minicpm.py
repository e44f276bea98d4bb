"""The system of the ``easyrag_minicpm`` configuration: the port's pipeline
with the MiniCPM layerwise reranker, its entries and its check.

The pipeline is built from the configuration file, a traffic file's
overrides and the seed. The reranker's weights come from the benchmark's own
seeded draw (``reference/weights.py``) and are copied into the port's
modules; the tokenizers are the benchmark's. Two recorders watch the timed
path at public seams: what the pipeline hands its reranker and what comes
back (:class:`RerankRecorder`, every run), and, in a traced run only, the
shapes the scorer builds and K6 is handed (:class:`ShapeRecorder`).

The check (:func:`check`) holds what the window produced to the plain
references under ``reference/``: the sparse dual route and its fusion
against float64 BM25, and the reranker's scores against a float32 MiniCPM
(``harness/judge.py`` has the numbers).
"""

from __future__ import annotations

import copy
import math
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import judge
from benchmark.harness.corpus import Corpus, dir_filter
from benchmark.reference.tokenizers import CharTokenizer, SparseTokenizer
from benchmark.reference.weights import iter_minicpm_weights


def preset(config: Dict[str, Any], traffic: Dict[str, Any], data_path: str) -> Dict[str, Any]:
    """The configuration's preset with the traffic's overrides (``tpu``
    merged key by key) and the corpus path."""
    out = copy.deepcopy(config["preset"])
    for key, value in traffic.get("overrides", {}).items():
        if key == "tpu":
            out["tpu"].update(value)
        else:
            out[key] = value
    out["data_path"] = data_path
    return out


def decoder_config(cfg: Dict[str, Any]):
    from easyrag_tpu_torch.models.layers import DecoderConfig

    keys = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "rms_norm_eps", "rope_theta", "scale_emb", "scale_depth", "dim_model_base")
    return DecoderConfig(**{k: cfg[k] for k in keys if k in cfg})


@torch.no_grad()
def make_minicpm(config: Dict[str, Any], seed: int, device, use_efficient: int, quant: str = ""):
    """The port's layerwise scorer with the benchmark's seeded weights."""
    from easyrag_tpu_torch.models.layers import PROJECTIONS, quantize_layers_
    from easyrag_tpu_torch.models.minicpm import MiniCPMLayerWiseReranker

    run = config["reranker"]
    dtype = getattr(torch, run["dtype"])
    scorer = MiniCPMLayerWiseReranker(
        decoder_config(config), CharTokenizer(config["vocab_size"]), start_layer=config["start_layer"],
        cutoff_layer=run["cutoff_layer"], max_length=run["max_length"], use_efficient=use_efficient,
        device=device, dtype=dtype,
    )
    for name, value in iter_minicpm_weights(config, seed, device, dtype):
        if name == "embed":
            scorer.embed.copy_(value)
        elif name == "heads":
            scorer.heads.copy_(value)
        else:
            assert name in PROJECTIONS
            for layer, w in zip(scorer.layers, value):
                getattr(layer, name)["w"].copy_(w)
        del value
    if quant:
        quantize_layers_(scorer, quant)
    return scorer


class RerankRecorder:
    """Wraps a reranker's ``postprocess_nodes``: for each call, the query,
    the candidates as handed over ``[(node idx, retrieval score)]``, their
    rerank scores and the nodes returned ``[(node idx, score)]``."""

    def __init__(self, reranker) -> None:
        self.inner = reranker.postprocess_nodes
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        reranker.postprocess_nodes = self

    def __call__(self, nodes, query_bundle=None):
        cands = [(n.node.idx, n.score) for n in nodes]
        out = self.inner(nodes, query_bundle)
        rec = {"query": query_bundle.query_str, "candidates": cands, "scores": [n.score for n in nodes],
               "top": [(n.node.idx, n.score) for n in out]}
        with self._lock:
            self.records.append(rec)
        return out


class ShapeRecorder:
    """In a traced run: the padded shape, real lengths and depth of every
    batch the scorer builds, and the shape of every K6 call."""

    def __init__(self) -> None:
        self.batches: List[tuple] = []  # (B, S, [real lengths], layers run)
        self.k6: List[tuple] = []  # (rows, cols)
        self._undo: List = []

    def watch_scorer(self, scorer) -> None:
        inner = scorer.build_inputs

        def build_inputs(pairs):
            ids, mask = inner(pairs)
            self.batches.append((ids.shape[0], ids.shape[1], mask.sum(axis=1).tolist(), scorer.cutoff_layer))
            return ids, mask

        scorer.build_inputs = build_inputs
        self._undo.append(lambda: delattr(scorer, "build_inputs"))

    def watch_k6(self) -> None:
        from easyrag_tpu_torch.ops import topk

        inner = topk.chunk_max

        def chunk_max(x):
            self.k6.append((x.shape[0], x.shape[1]))
            return inner(x)

        topk.chunk_max = chunk_max
        self._undo.append(lambda: setattr(topk, "chunk_max", inner))

    def close(self) -> None:
        for undo in self._undo:
            undo()
        self._undo.clear()


class System:
    """The pipeline of one cell and what watches it."""

    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any], corpus: Corpus, seed: int, device,
                 trace: bool) -> None:
        from easyrag_tpu_torch.config import EasyRAGConfig
        from easyrag_tpu_torch.corpus.splitter import SentenceSplitter
        from easyrag_tpu_torch.corpus.tokenizer import approx_token_count
        from easyrag_tpu_torch.pipeline import EasyRAGPipeline
        from easyrag_tpu_torch.rerankers import LLMRerank

        self.cfg = cfg = EasyRAGConfig.from_dict(preset(config, traffic, corpus.root))
        self.shapes = ShapeRecorder()
        self.scorer = None
        reranker = None
        if cfg.use_reranker == 2:
            self.scorer = make_minicpm(config, seed, device, cfg.r_use_efficient, cfg.tpu.reranker_quant)
            reranker = LLMRerank(
                self.scorer, top_n=cfg.r_topk, embed_bs=cfg.r_embed_bs, embed_type=cfg.r_embed_type,
                use_efficient=cfg.r_use_efficient, cascade_keep=cfg.tpu.cascade_keep,
                cascade_carry=cfg.tpu.cascade_carry,
            )
        elif cfg.use_reranker != 0:
            raise ValueError(f"use_reranker {cfg.use_reranker} has no seeded model in the benchmark")
        # one chunk per file, tokens counted offline (no tiktoken table on the card's machine)
        splitter = SentenceSplitter(cfg.chunk_size, cfg.chunk_overlap, token_counter=approx_token_count,
                                    sentence_splitter=lambda t: [t])
        self.pipeline = EasyRAGPipeline(cfg, llm=None, reranker=reranker, sparse_tokenizer=SparseTokenizer(),
                                        splitter=splitter, device=device)
        self.reranks: Optional[RerankRecorder] = RerankRecorder(reranker) if reranker is not None else None
        # node idx -> doc number of the benchmark's corpus (files are doc<N>.txt)
        self.doc_of = [int(n.metadata["file_name"][3:-4]) for n in self.pipeline.nodes]
        if trace:
            if self.scorer is not None:
                self.shapes.watch_scorer(self.scorer)
            self.shapes.watch_k6()

    def snapshot(self) -> Dict[str, int]:
        """How many records each recorder holds, read as the window opens
        and closes."""
        return {"batches": len(self.shapes.batches), "k6": len(self.shapes.k6),
                "records": len(self.reranks.records) if self.reranks is not None else 0}

    def readings(self, opened: Dict[str, int], closed: Dict[str, int]) -> Dict[str, Any]:
        """What the window's readers read of the recorders: the scorer's
        batch shapes and the K6 calls (a traced run's)."""
        return {key: getattr(self.shapes, key)[opened[key]:closed[key]] for key in ("batches", "k6")}

    def close(self) -> None:
        """Unhook the recorders and drop the program's state; the records
        stay for the check."""
        self.shapes.close()
        if self.reranks is not None:
            self.reranks.inner = None
        self.pipeline = self.scorer = None


build = System


async def _run(system: System, qs):
    res = await system.pipeline.run(dict(qs[0]))
    return [[(nw.node.idx, nw.score) for nw in res["nodes"]]]


async def _retrieval_batch(system: System, qs):
    out = await system.pipeline.run_retrieval_batch([dict(q) for q in qs])
    return [[(nw.node.idx, nw.score) for nw in res["nodes"]] for res in out]


# a traffic file's ``entry`` -> the call of one request: ``run`` takes one
# question, ``retrieval_batch`` (the CLI's evaluation path) a batch; each
# gives, per question, the nodes it returned as ``[(node idx, score)]``
entries = {"run": _run, "retrieval_batch": _retrieval_batch}


def window_records(oc) -> List[Dict[str, Any]]:
    """The reranker's calls in the window (:class:`RerankRecorder`)."""
    if oc.system.reranks is None:
        return []
    return oc.system.reranks.records[oc.counters["open"]["records"]:oc.counters["close"]["records"]]


def produced(oc) -> List[tuple]:
    """What retrieval produced in the window, ``[(question, [(doc,
    score)])]``: the candidates handed to the reranker, or the batch entry's
    kept outputs."""
    out = []
    window, doc_of = oc.readings.window, oc.system.doc_of
    records = window_records(oc)
    if records:
        by_query = {}
        for r in window.requests:
            if r.ok:
                by_query.setdefault(r.questions[0]["query"], r.questions[0])
        for rec in records:
            q = by_query.get(rec["query"])
            if q is not None:
                out.append((q, [(doc_of[i], s) for i, s in rec["candidates"]]))
    else:
        for r in window.requests:
            if r.ok and r.output is not None:
                out += [(q, [(doc_of[i], s) for i, s in o]) for q, o in zip(r.questions, r.output)]
    return out


def check(cell, oc, seed: int, device, log, control: bool = False) -> Dict[str, float]:
    """The numbers that decide ``correct`` (``judge``), from the window's
    outputs and the reference. ``control``: the reference one precision
    below the configuration's (TF32 BM25 sums, a w8a8 reranker) stands in
    the program's place, on the same questions and candidates."""
    from benchmark.reference.bm25 import DualRouteReference

    cfg = cell.config
    preset = cfg["preset"]
    k_content, k_path = preset["f_topk_2"], preset["f_topk_3"]
    corpus = oc.corpus
    n = len(corpus.texts)
    t = time.perf_counter()
    views = ([corpus.know_path(d) for d in range(n)], corpus.dirs, corpus.texts)
    ref = DualRouteReference(*views)
    lower = DualRouteReference(*views, precision="tf32") if control else None
    got = produced(oc)
    gaps = []
    for q, prog in got:
        f = dir_filter(q)
        c, p, allowed = ref.routes(q["query"], f)
        if control:
            prog = lower.fused(q["query"], f, k_content, k_path)
        want = ref.fused(q["query"], f, k_content, k_path, prefer=[d for d, _ in prog])
        gaps.append(judge.retrieval_gap(prog, want, c, p, allowed))
    values = {"retrieval_gap": judge.widest(gaps) if got else math.inf}
    log(f"reference: {len(got)} retrieval outputs compared in {time.perf_counter() - t:.1f} s")
    if window_records(oc):
        values.update(check_rerank(cell, oc, seed, device, log, control))
    return values


def sample_records(records, seed: int, n: int) -> List[Dict[str, Any]]:
    """``n`` of the records drawn from the seed, the one with the most
    candidates (then the longest query) always among them."""
    if not records:
        return []
    longest = max(range(len(records)), key=lambda i: (len(records[i]["candidates"]), len(records[i]["query"])))
    rest = [i for i in range(len(records)) if i != longest]
    rng = np.random.default_rng([seed, 4])
    picked = [longest] + [rest[int(i)] for i in rng.permutation(len(rest))[: max(n - 1, 0)]]
    return [records[i] for i in picked]


def rerank_rows(cfg, corpus: Corpus, rec, doc_of) -> List[List[int]]:
    """The token rows of a request's pairs, as the reference builds them:
    the query and each candidate's file path under the corpus root and its
    text without the blanks at its ends (``r_embed_type`` 1 of a one-chunk
    file)."""
    from benchmark.reference.minicpm import pair_ids

    tk = CharTokenizer(cfg["vocab_size"])
    max_len = cfg["reranker"]["max_length"]
    rows = []
    for i, _ in rec["candidates"]:
        d = doc_of[i]
        passage = f"###\n{corpus.rel_path(d)}\n\n{corpus.texts[d].strip()}"
        rows.append(pair_ids(tk, rec["query"], passage, max_len))
    return rows


def check_rerank(cell, oc, seed: int, device, log, control: bool = False) -> Dict[str, float]:
    """``rerank_error`` on the sample and ``top_mismatch`` on every request
    (``judge``); with ``control``, the w8a8 reference's scores and its own
    top stand in the program's."""
    from benchmark.reference.minicpm import MiniCPMReference
    from benchmark.reference.weights import minicpm_weights

    cfg = cell.config
    t = time.perf_counter()
    records = window_records(oc)
    top_n = oc.system.cfg.r_topk
    sample = sample_records(records, seed, cell.traffic.get("rerank_sample", 3))
    cutoff = cfg["reranker"]["cutoff_layer"]
    rows = [rerank_rows(cfg, oc.corpus, rec, oc.system.doc_of) for rec in sample]
    weights = minicpm_weights(cfg, seed, device, getattr(torch, cfg["reranker"]["dtype"]))
    plain = [MiniCPMReference(cfg, weights).score(r, cutoff) for r in rows]
    got = [rec["scores"] for rec in sample]
    tops = [(rec["candidates"], rec["scores"], rec["top"]) for rec in records]
    if control:
        lower = MiniCPMReference(cfg, weights, quant="w8a8")
        got = [lower.score(r, cutoff) for r in rows]
        tops = []
        for rec, s in zip(sample, got):
            order = np.argsort(-s, kind="stable")[:top_n]
            tops.append((rec["candidates"], list(s), [(rec["candidates"][k][0], s[k]) for k in order]))
        del lower
    yardstick = MiniCPMReference(cfg, weights, precision="tf32" if device != "cpu" else "f32")
    ref = [yardstick.score(r, cutoff) for r in rows]
    del yardstick, weights
    mismatch = sum(judge.top_mismatch([i for i, _ in c], s, top, top_n) for c, s, top in tops)
    log(f"reference: {len(sample)} rerank requests compared in {time.perf_counter() - t:.1f} s")
    return {"rerank_error": judge.rerank_error(got, ref, plain) if sample else math.inf,
            "top_mismatch": float(mismatch)}
