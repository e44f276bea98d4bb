"""Layerwise MiniCPM cross-encoder reranker (port of
``easyrag_tpu/models/minicpm.py``).

bge-reranker-v2-minicpm-layerwise: a MiniCPM decoder with one score head per
layer in ``[start_layer, num_layers]``; the score of cutoff ``L`` is head
``L`` on ``norm(hidden after L layers)`` at each row's last real token. The
non-efficient path scales the head input by ``1/(hidden_size/dim_model_base)``;
the early-exit variant applies the head to the unscaled hidden, a reference
inconsistency kept on purpose (``easyrag_tpu/models/minicpm.py:14-20``).

Early exit (``use_efficient`` 1 or 2) runs layers ``[0, judge)``, scores, and
continues to the cutoff only if the batch's score distribution does not
clear ``efficient_t``. The cascade's carry (``use_efficient`` 3 with
``cascade_carry``): :meth:`~MiniCPMLayerWiseReranker.score_pairs_carry`
keeps each stage-1 batch's hidden states on the device, and
:meth:`~MiniCPMLayerWiseReranker.score_carried` gathers the survivors' rows
and resumes at the judge layer. The module drives the port's
``rerankers.LLMRerank`` through ``score_pairs``, ``score_pairs_carry``,
``score_carried``, ``cutoff_layer`` and ``padding_side``.

Weights come from a seed (``init_random_``), a JAX-layout tree
(:meth:`~MiniCPMLayerWiseReranker.load_tree_`: dense, int8 or int4 leaves)
or a checkpoint directory (:meth:`~MiniCPMLayerWiseReranker.from_pretrained`);
``layers.quantize_layers_`` makes them w8a8 on any device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..devices import resolve_device
from ..ops import fused_norm
from ..utils.events import emit, trace
from .layers import (
    DecoderConfig,
    DecoderLayer,
    embed,
    init_random_,
    key_ranges,
    load_tree_,
    rms_norm,
    rope_tables,
)


@contextlib.contextmanager
def counted_chain():
    """Emit one ``fused_chain`` event for the block: ``kernel``, the
    launches of the decoder layers' norm, residual and SiLU * up kernels
    (``ops/fused_norm.py``), and ``plain``, the calls of the same steps that
    took the eager ops. The counts are process-wide: a block counts whatever
    ran while it was open."""
    kernel, plain = fused_norm.launches, fused_norm.plain_calls
    try:
        yield
    finally:
        emit("fused_chain", {"kernel": fused_norm.launches - kernel, "plain": fused_norm.plain_calls - plain})


PROMPT = (
    "Given a query A and a passage B, determine whether the passage "
    "contains an answer to the query by providing a prediction of "
    "either 'Yes' or 'No'."
)


def minicpm_config_from_hf(hf: Dict[str, Any], act_quant: bool = False) -> DecoderConfig:
    """``config.json`` of a MiniCPM checkpoint -> :class:`DecoderConfig`."""
    return DecoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        attention_bias=hf.get("attention_bias", False),
        scale_emb=hf.get("scale_emb", 1.0),
        scale_depth=hf.get("scale_depth", 0.0),
        dim_model_base=hf.get("dim_model_base", 0.0),
        act_quant=act_quant,
    )


def last_real_index(mask: np.ndarray) -> np.ndarray:
    """Per-row index of the last real token (either padding side)."""
    return (mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)).astype(np.int64)


def build_pair_inputs(
    tokenizer, pairs: List[Tuple[str, str]], max_length: int, seq_bucket: int, padding_side: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Pairs -> padded ``(input_ids, attention_mask)`` int32: ``<bos> A:
    query`` (<= 3/4 of max_length) ``\\n B: passage``, cut to
    ``max_length``, then ``\\n`` and the prompt; padded to a multiple of
    ``seq_bucket`` on ``padding_side`` (mirrors ``rerankers.py:251-292``)."""
    tk = tokenizer
    prompt_ids = tk(PROMPT, add_special_tokens=False)["input_ids"]
    sep_ids = tk("\n", add_special_tokens=False)["input_ids"]
    rows = []
    for query, passage in pairs:
        q_ids = tk(f"A: {query}", add_special_tokens=False,
                   max_length=max_length * 3 // 4, truncation=True)["input_ids"]
        p_ids = tk(f"B: {passage}", add_special_tokens=False,
                   max_length=max_length, truncation=True)["input_ids"]
        first = [tk.bos_token_id] + q_ids
        second = (sep_ids + p_ids)[: max(max_length - len(first), 0)]
        rows.append(first + second + sep_ids + prompt_ids)
    max_len = max(-(-max(len(r) for r in rows) // seq_bucket) * seq_bucket, seq_bucket)
    pad_id = tk.pad_token_id if tk.pad_token_id is not None else 0
    ids = np.full((len(rows), max_len), pad_id, dtype=np.int32)
    mask = np.zeros((len(rows), max_len), dtype=np.int32)
    for i, r in enumerate(rows):
        lo = 0 if padding_side == "right" else max_len - len(r)
        ids[i, lo : lo + len(r)] = r
        mask[i, lo : lo + len(r)] = 1
    return ids, mask


def gather_padded_rows(chunks: Sequence[torch.Tensor], idx: torch.Tensor, pad_left: bool) -> torch.Tensor:
    """Each ``[b, S_c, D]`` chunk zero-padded to the widest ``S`` on the
    scorer's padding side, the chunks concatenated, and rows ``idx`` taken
    in one indexing op (JAX's ``minicpm._gather_padded_rows``)."""
    s_max = max(h.shape[1] for h in chunks)
    padded = [F.pad(h, (0, 0, s_max - h.shape[1], 0) if pad_left else (0, 0, 0, s_max - h.shape[1]))
              if h.shape[1] < s_max else h for h in chunks]
    return torch.cat(padded, dim=0)[idx]


class MiniCPMLayerWiseReranker(nn.Module):
    """Scores (query, passage) pairs. ``heads[L]`` is the f32 score head of
    layer ``L`` (rows below ``start_layer`` are unused)."""

    def __init__(
        self,
        cfg: DecoderConfig,
        tokenizer,
        start_layer: int = 8,
        cutoff_layer: int = 28,
        max_length: int = 1024,
        use_efficient: int = 0,
        efficient_t: float = 0.4,
        efficient_layers: Tuple[int, ...] = (12,),
        seq_bucket: int = 64,
        padding_side: str = "",
        device="cuda",
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d, **kw), requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(d, **kw), requires_grad=False)
        self.heads = nn.Parameter(
            torch.zeros(cfg.num_hidden_layers + 1, d, device=kw["device"], dtype=torch.float32),
            requires_grad=False,
        )
        self.tokenizer = tokenizer
        self.start_layer = start_layer
        self.cutoff_layer = cutoff_layer
        self.max_length = max_length
        self.use_efficient = use_efficient
        self.efficient_t = efficient_t
        # judge layers clamped into [start_layer, cutoff_layer]: every judge
        # layer needs a head and must lie inside the run segment
        self.efficient_layers = tuple(max(start_layer, min(j, cutoff_layer)) for j in efficient_layers)
        self.seq_bucket = seq_bucket
        # explicit argument > the checkpoint tokenizer's declaration > left
        self.padding_side = padding_side or getattr(tokenizer, "padding_side", None) or "left"

    def init_random_(self, generator: torch.Generator, std: float = 0.02) -> "MiniCPMLayerWiseReranker":
        """Seeded random weights (``layers.init_random_``; norms stay 1)."""
        return init_random_(self, generator, self.start_layer, std)


    def load_tree_(self, params: Dict[str, Any]) -> "MiniCPMLayerWiseReranker":
        """Copy a JAX-layout tree into the module (``layers.load_tree_``:
        dense, int8 or int4 linears, a dense or int8 embedding table)."""
        return load_tree_(self, params)

    @classmethod
    def from_pretrained(cls, model_dir: str, quant: str = "", device="cuda", dtype: torch.dtype = torch.bfloat16,
                        **scorer_kwargs) -> "MiniCPMLayerWiseReranker":
        """A bge-reranker-v2-minicpm-layerwise checkpoint directory -> the
        scorer on ``device`` (``hf_loader.load_minicpm_reranker``:
        ``start_layer`` from ``config.json``, the layerwise heads, ``quant``
        "", "int8", "w8a8", "int4" or "w4a8"), with the directory's
        tokenizer."""
        from transformers import AutoTokenizer

        from .hf_loader import load_minicpm_reranker

        cfg, params, start_layer = load_minicpm_reranker(model_dir, dtype=dtype, quant=quant, device=device)
        tok = AutoTokenizer.from_pretrained(model_dir, trust_remote_code=True)
        model = cls(cfg, tok, start_layer=start_layer, device=device, dtype=dtype, **scorer_kwargs)
        return model.load_tree_(params)

    # -- tokenization (mirrors rerankers.py:251-292) --------------------------

    def build_inputs(self, pairs: List[Tuple[str, str]]) -> Tuple[np.ndarray, np.ndarray]:
        """Pairs -> padded ``(input_ids, attention_mask)``
        (:func:`build_pair_inputs` at this scorer's settings)."""
        return build_pair_inputs(self.tokenizer, pairs, self.max_length, self.seq_bucket, self.padding_side)

    # -- scoring ---------------------------------------------------------------

    def _judge_quit(self, scores: np.ndarray) -> bool:
        """Early-exit criterion over the batch's scores
        (``efficient_modeling_minicpm_reranker.py:1256-1277``)."""
        s = np.asarray(scores, dtype=np.float64)
        p = np.exp(s - s.max())
        p = p / p.sum()
        if self.use_efficient == 1:  # max-prob criterion
            return bool(p.max() >= self.efficient_t)
        # normalized entropy; quits when it is HIGH (the reference's literal
        # comparison, replicated)
        entropy = -np.sum(p * np.log(np.maximum(p, 1e-30)))
        return bool(entropy / (-np.log(1.0 / len(p))) >= self.efficient_t)

    def _segment(self, hidden, ranges, rope, start: int, end: int) -> torch.Tensor:
        for idx in range(start, end):
            hidden = self.layers[idx](hidden, *ranges, *rope)
        return hidden

    def _layer_score(self, hidden, layer: int, last_idx, scale_head_input: bool = True) -> np.ndarray:
        """Head ``layer`` on ``norm(hidden)`` at each row's last real token,
        f32 ``[B]``."""
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), last_idx]
        normed = rms_norm(pooled, self.final_norm, self.cfg.rms_norm_eps)
        if scale_head_input and self.cfg.dim_model_base:
            normed = normed / (self.cfg.hidden_size / self.cfg.dim_model_base)
        return (normed.float() @ self.heads[layer]).cpu().numpy()

    @torch.inference_mode()
    def score_pairs(self, pairs: List[Tuple[str, str]], judge: bool = False) -> Tuple[np.ndarray, int]:
        """Score one batch: ``(scores[B], layer used)``. ``judge=True`` runs
        the two-segment early-exit protocol. Two spans: ``rerank.prep`` (the
        inputs, their ranges and tables, the upload and the embedding) and
        ``rerank.forward`` (the layers and the scores' host read), and one
        ``fused_chain`` event (:func:`counted_chain`)."""
        with trace("rerank.prep"):
            hidden, ranges, last_idx, rope, _ = self._embed_pairs(pairs)
        cutoff = self.cutoff_layer
        with trace("rerank.forward"), counted_chain():
            if judge and self.efficient_layers:
                j = self.efficient_layers[0]
                hidden = self._segment(hidden, ranges, rope, 0, j)
                scores = self._layer_score(hidden, j, last_idx, scale_head_input=False)
                if self._judge_quit(scores):
                    return scores, j
                hidden = self._segment(hidden, ranges, rope, j, cutoff)
                return self._layer_score(hidden, cutoff, last_idx, scale_head_input=False), cutoff
            hidden = self._segment(hidden, ranges, rope, 0, cutoff)
            scale = not judge and self.use_efficient == 0
            return self._layer_score(hidden, cutoff, last_idx, scale_head_input=scale), cutoff

    def _prepare(self, mask_np: np.ndarray):
        """Key ranges, last real index and RoPE tables of a padded batch."""
        dev = self.final_norm.device
        ranges = tuple(torch.from_numpy(a).to(dev) for a in key_ranges(mask_np))
        last_idx = torch.from_numpy(last_real_index(mask_np)).to(dev)
        rope = rope_tables(mask_np.shape[1], self.cfg.hd, self.cfg.rope_theta, device=dev)
        return ranges, last_idx, rope

    def _embed_pairs(self, pairs: List[Tuple[str, str]]):
        """A batch's inputs on the device: the embedded rows, :meth:`_prepare`'s
        ranges, last real index and RoPE tables, and the host mask."""
        ids_np, mask_np = self.build_inputs(pairs)
        ranges, last_idx, rope = self._prepare(mask_np)
        hidden = embed(self.cfg, self.embed, torch.from_numpy(ids_np).to(self.final_norm.device), self.final_norm.dtype)
        return hidden, ranges, last_idx, rope, mask_np

    @torch.inference_mode()
    def score_pairs_carry(self, pairs: List[Tuple[str, str]]) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Cascade stage 1: ``score_pairs(pairs)`` at ``cutoff_layer`` (the
        judge layer while the cascade runs it) and the carry, ``{"hidden":
        [B, S, D] on the device, after the last layer run, "mask": the host
        mask}``, so stage 2 resumes there."""
        hidden, ranges, last_idx, rope, mask_np = self._embed_pairs(pairs)
        with counted_chain():
            hidden = self._segment(hidden, ranges, rope, 0, self.cutoff_layer)
        scores = self._layer_score(hidden, self.cutoff_layer, last_idx, scale_head_input=self.use_efficient == 0)
        return scores, {"hidden": hidden, "mask": mask_np}

    @torch.inference_mode()
    def score_carried(
        self, chunk_hiddens: List[torch.Tensor], flat_idx: np.ndarray, masks_rows: np.ndarray, from_layer: int
    ) -> np.ndarray:
        """Cascade stage 2 from carried stage-1 hidden states: the rows
        ``flat_idx`` of the chunks re-padded to the widest one and
        concatenated (:func:`gather_padded_rows`), with their re-padded
        masks ``masks_rows`` ``[N, S_max]``, run through layers
        ``[from_layer, cutoff_layer)`` and scored. Key ranges, the last real
        index and the RoPE tables are those of the new width. Positions are
        the batch-shared ``0..S_max-1``, as in JAX: a left-padded row moves
        to new absolute positions, and rotary attention keeps only their
        differences, so scores equal the re-run path's to rounding."""
        hidden = gather_padded_rows(
            chunk_hiddens, torch.as_tensor(np.asarray(flat_idx), dtype=torch.long, device=self.final_norm.device),
            self.padding_side != "right",
        )
        ranges, last_idx, rope = self._prepare(np.asarray(masks_rows))
        with counted_chain():
            hidden = self._segment(hidden, ranges, rope, from_layer, self.cutoff_layer)
        return self._layer_score(hidden, self.cutoff_layer, last_idx, scale_head_input=self.use_efficient == 0)

