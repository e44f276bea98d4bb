"""The system under test: the port's pipeline, built from a configuration
file, a traffic file's overrides and the seed.

Only this module and the drivers import ``easyrag_tpu_torch``. The models'
weights come from the benchmark's own seeded draw (``reference/weights.py``)
and are copied into the port's modules; the tokenizers are the benchmark's.
Two recorders watch the timed path at public seams: what the pipeline hands
its reranker and what comes back (:class:`RerankRecorder`, every run), and,
in a traced run only, the shapes the scorer builds and K6 is handed
(:class:`ShapeRecorder`).
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict, List, Optional

import torch

from ..reference.tokenizers import CharTokenizer, SparseTokenizer
from ..reference.weights import iter_minicpm_weights
from .corpus import Corpus


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

    def close(self) -> None:
        """Unhook the recorders and drop the program's state."""
        self.shapes.close()
        self.pipeline = self.scorer = None
