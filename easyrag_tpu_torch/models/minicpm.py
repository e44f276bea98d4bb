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
clear ``efficient_t``. The module drives ``easyrag_tpu.rerankers.LLMRerank``
unchanged through ``score_pairs``, ``cutoff_layer`` and ``padding_side``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..devices import resolve_device
from .layers import DecoderConfig, DecoderLayer, embed, init_random_, key_ranges, rms_norm, rope_tables

PROMPT = (
    "Given a query A and a passage B, determine whether the passage "
    "contains an answer to the query by providing a prediction of "
    "either 'Yes' or 'No'."
)


def last_real_index(mask: np.ndarray) -> np.ndarray:
    """Per-row index of the last real token (either padding side)."""
    return (mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)).astype(np.int64)


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

    # -- tokenization (mirrors rerankers.py:251-292) --------------------------

    def build_inputs(self, pairs: List[Tuple[str, str]]) -> Tuple[np.ndarray, np.ndarray]:
        """Pairs -> padded ``(input_ids, attention_mask)``: ``<bos> A: query``
        (<= 3/4 of max_length) ``\\n B: passage``, cut to ``max_length``, then
        ``\\n`` and the prompt; padded to a multiple of ``seq_bucket`` on
        ``padding_side``."""
        tk = self.tokenizer
        prompt_ids = tk(PROMPT, add_special_tokens=False)["input_ids"]
        sep_ids = tk("\n", add_special_tokens=False)["input_ids"]
        rows = []
        for query, passage in pairs:
            q_ids = tk(f"A: {query}", add_special_tokens=False,
                       max_length=self.max_length * 3 // 4, truncation=True)["input_ids"]
            p_ids = tk(f"B: {passage}", add_special_tokens=False,
                       max_length=self.max_length, truncation=True)["input_ids"]
            first = [tk.bos_token_id] + q_ids
            second = (sep_ids + p_ids)[: max(self.max_length - len(first), 0)]
            rows.append(first + second + sep_ids + prompt_ids)
        bucket = self.seq_bucket
        max_len = max(-(-max(len(r) for r in rows) // bucket) * bucket, bucket)
        pad_id = tk.pad_token_id if tk.pad_token_id is not None else 0
        ids = np.full((len(rows), max_len), pad_id, dtype=np.int32)
        mask = np.zeros((len(rows), max_len), dtype=np.int32)
        for i, r in enumerate(rows):
            lo = 0 if self.padding_side == "right" else max_len - len(r)
            ids[i, lo : lo + len(r)] = r
            mask[i, lo : lo + len(r)] = 1
        return ids, mask

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
        the two-segment early-exit protocol."""
        ids_np, mask_np = self.build_inputs(pairs)
        dev = self.embed.device
        ranges = tuple(torch.from_numpy(a).to(dev) for a in key_ranges(mask_np))
        last_idx = torch.from_numpy(last_real_index(mask_np)).to(dev)
        rope = rope_tables(ids_np.shape[1], self.cfg.hd, self.cfg.rope_theta, device=dev)
        hidden = embed(self.cfg, self.embed, torch.from_numpy(ids_np).to(dev))
        cutoff = self.cutoff_layer
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
