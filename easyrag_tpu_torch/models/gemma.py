"""The Gemma2 cost-wise reranker with mid-network token compression (port of
``easyrag_tpu/models/gemma.py``).

bge-reranker-v2.5-gemma2-lightweight: a Gemma2 decoder whose sequence is
compressed at chosen layers — consecutive passage hidden states mean-pooled in
groups of ``compress_ratio`` (ragged tail renormalised) while the query and
prompt segments pass through intact — with one f32 score head per layer from
``start_layer`` (every ``layer_sep`` layers). The score of cutoff ``L`` is head
``L`` on the Gemma-normed hidden at each row's last real position.

Padding is on the right, as token compression needs and K4
(``ops/flash_softcap.py``) takes: the attention of every layer goes through
K4's wrapper with no mask input. The host plans each compressed length from
the token counts (bucketed to 64), so later layers really run at the shorter
length; RoPE positions restart at ``0..S'-1`` in every segment after a
compression, as the JAX package's ``_gemma_segment`` recomputes them. The
module drives ``rerankers.LLMRerank`` through ``score_pairs``,
``cutoff_layer`` and ``padding_side``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..devices import resolve_device
from .layers import (
    DecoderConfig,
    DecoderLayer,
    embed,
    init_random_,
    load_tree_,
    rms_norm,
    rope_tables,
)

PROMPT = "Predict whether passage B contains an answer to query A."


def gemma_config_from_hf(hf: Dict[str, Any], act_quant: bool = False) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        gemma=True,
        attn_logit_softcapping=hf.get("attn_logit_softcapping", 0.0) or 0.0,
        query_pre_attn_scalar=hf.get("query_pre_attn_scalar", 0.0) or 0.0,
        act_quant=act_quant,
    )


def token_compress(
    hidden: torch.Tensor,  # [B, S, D]
    mask: torch.Tensor,  # [B, S], right padded
    query_lengths: torch.Tensor,  # [B]
    prompt_lengths: torch.Tensor,  # [B]
    ratio: int,
    out_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape pooling of the passage segment.

    Each output row is ``[query | pooled passage groups | prompt | zeros]``
    with mask 1 on its first ``qlen + retain + plen`` positions; a group is
    the f32 mean of its (up to ``ratio``) members, cast once. ``out_len`` must
    be at least every row's compressed length."""
    b, s, d = hidden.shape
    dev = hidden.device
    qlen = query_lengths.to(device=dev, dtype=torch.int64)[:, None]  # [B, 1]
    plen = prompt_lengths.to(device=dev, dtype=torch.int64)[:, None]
    seq_len = mask.sum(dim=1, dtype=torch.int64)[:, None]
    passage_len = seq_len - qlen - plen
    retain = (passage_len + ratio - 1) // ratio
    final_len = qlen + plen + retain

    j = torch.arange(out_len, device=dev)[None, :]  # [1, out_len]
    in_query = j < qlen
    in_passage = (j >= qlen) & (j < qlen + retain)
    in_prompt = (j >= qlen + retain) & (j < final_len)

    g = (j - qlen)[:, :, None]  # passage group index where in_passage
    i = torch.arange(ratio, device=dev)[None, None, :]
    passage_src = qlen[:, :, None] + g * ratio + i  # [B, out_len, ratio]
    passage_valid = in_passage[:, :, None] & (g * ratio + i < passage_len[:, :, None])
    count = passage_valid.sum(dim=2, keepdim=True)
    passage_w = torch.where(passage_valid, 1.0 / count.clamp(min=1).float(), 0.0)

    # query and prompt positions copy through slot 0
    prompt_src = qlen + passage_len + (j - qlen - retain)
    copy_src = torch.where(in_query, j, torch.where(in_prompt, prompt_src, 0))
    copy_w = (in_query | in_prompt).float()

    src = torch.where(in_passage[:, :, None], passage_src, copy_src[:, :, None]).clamp(0, s - 1)
    w = torch.where(in_passage[:, :, None], passage_w, 0.0)
    w[:, :, 0] += copy_w
    gathered = torch.gather(hidden, 1, src.reshape(b, out_len * ratio, 1).expand(b, out_len * ratio, d))
    new_hidden = torch.einsum("bjr,bjrd->bjd", w, gathered.reshape(b, out_len, ratio, d).float()).to(hidden.dtype)
    return new_hidden, (j < final_len).to(mask.dtype)


class GemmaCostWiseReranker(nn.Module):
    """(query, passage) scorer with token compression. ``heads[L]`` is the
    f32 score head of layer ``L`` (zero where the checkpoint has none)."""

    def __init__(
        self,
        cfg: DecoderConfig,
        tokenizer,
        cutoff_layer: int = 28,
        compress_layer: Tuple[int, ...] = (24, 40),
        compress_ratio: int = 2,
        max_length: int = 1024,
        device="cuda",
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        super().__init__()
        if not cfg.gemma:
            raise ValueError("GemmaCostWiseReranker needs a Gemma config (cfg.gemma)")
        kw = dict(device=resolve_device(device), dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d, **kw), requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(d, **kw), requires_grad=False)
        self.heads = nn.Parameter(
            torch.zeros(cfg.num_hidden_layers + 1, d, device=kw["device"], dtype=torch.float32), requires_grad=False
        )
        self.tokenizer = tokenizer
        self.cutoff_layer = cutoff_layer
        self.compress_layer = tuple(sorted(compress_layer))
        self.compress_ratio = compress_ratio
        self.max_length = max_length
        self.padding_side = "right"  # compression and K4 need it

    def init_random_(self, generator: torch.Generator, start_layer: int = 8, std: float = 0.02) -> "GemmaCostWiseReranker":
        """Seeded random weights (``layers.init_random_``) with heads for
        layers ``start_layer..num_layers``."""
        return init_random_(self, generator, start_layer, std)


    def load_tree_(self, params: Dict[str, Any]) -> "GemmaCostWiseReranker":
        """Copy a JAX-layout tree into the module (``layers.load_tree_``:
        dense, int8 or int4 linears, a dense or int8 embedding table)."""
        return load_tree_(self, params)

    # -- tokenization (mirrors get_inputs_v2_5, rerankers.py:203-249) ---------

    def build_inputs(self, pairs: List[Tuple[str, str]]):
        """Pairs -> right-padded ``(input_ids, mask, query_lengths,
        prompt_lengths)``: ``<bos> A: query`` (<= 3/4 of max_length)
        ``\\n B: passage`` cut to ``max_length``, then ``\\n`` and the prompt;
        padded to a multiple of 128."""
        tk = self.tokenizer
        prompt_ids = tk(PROMPT, add_special_tokens=False)["input_ids"]
        sep_ids = tk("\n", add_special_tokens=False)["input_ids"]
        rows, qlens, plens = [], [], []
        for query, passage in pairs:
            q_ids = tk(f"A: {query}", add_special_tokens=False,
                       max_length=self.max_length * 3 // 4, truncation=True)["input_ids"]
            p_ids = tk(f"B: {passage}", add_special_tokens=False,
                       max_length=self.max_length, truncation=True)["input_ids"]
            first = [tk.bos_token_id] + q_ids
            second = (sep_ids + p_ids)[: max(self.max_length - len(first), 0)]
            rows.append(first + second + sep_ids + prompt_ids)
            qlens.append(len(first) + len(sep_ids))
            plens.append(len(sep_ids + prompt_ids))
        max_len = max(-(-max(len(r) for r in rows) // 128) * 128, 128)
        pad_id = tk.pad_token_id if tk.pad_token_id is not None else 0
        ids = np.full((len(rows), max_len), pad_id, dtype=np.int32)
        mask = np.zeros((len(rows), max_len), dtype=np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask, np.asarray(qlens, np.int32), np.asarray(plens, np.int32)

    # -- scoring ---------------------------------------------------------------

    def _segment(self, hidden: torch.Tensor, start: int, end: int) -> torch.Tensor:
        """Layers ``[start, end)`` at positions ``0..S-1`` (right padding: no
        key ranges)."""
        cos, sin = rope_tables(hidden.shape[1], self.cfg.hd, self.cfg.rope_theta, device=hidden.device)
        for idx in range(start, end):
            hidden = self.layers[idx](hidden, None, None, cos, sin)
        return hidden

    def _layer_score(self, hidden: torch.Tensor, mask: torch.Tensor, layer: int) -> np.ndarray:
        """Head ``layer`` (f32) on the Gemma-normed hidden at each row's last
        real position, ``sum(mask) - 1``."""
        last = mask.sum(dim=1, dtype=torch.int64) - 1
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
        normed = rms_norm(pooled, self.final_norm, self.cfg.rms_norm_eps, gemma=True)
        return (normed.float() @ self.heads[layer]).cpu().numpy()

    @torch.inference_mode()
    def score_pairs(self, pairs: List[Tuple[str, str]], judge: bool = False) -> Tuple[np.ndarray, int]:
        """Score one batch: ``(scores[B], cutoff_layer)``. ``judge`` is
        accepted for ``LLMRerank`` and ignored: there is no early exit."""
        ids_np, mask_np, qlens_np, plens_np = self.build_inputs(pairs)
        dev = self.final_norm.device
        hidden = embed(self.cfg, self.embed, torch.from_numpy(ids_np).to(dev), self.final_norm.dtype)
        mask = torch.from_numpy(mask_np).to(dev)
        qlens, plens = torch.from_numpy(qlens_np).to(dev), torch.from_numpy(plens_np).to(dev)
        seq_lens = mask_np.sum(axis=1)
        cur = 0
        for comp_at in self.compress_layer:
            if comp_at == 0 or comp_at >= self.cutoff_layer:
                continue
            hidden = self._segment(hidden, cur, comp_at)
            retain = -(-(seq_lens - qlens_np - plens_np) // self.compress_ratio)
            seq_lens = qlens_np + plens_np + retain  # query and prompt pass through
            out_len = -(-int(seq_lens.max()) // 64) * 64
            hidden, mask = token_compress(hidden, mask, qlens, plens, self.compress_ratio, out_len)
            cur = comp_at
        hidden = self._segment(hidden, cur, self.cutoff_layer)
        return self._layer_score(hidden, mask, self.cutoff_layer), self.cutoff_layer


def load_gemma_reranker(model_dir: str, quant: str = "", device="cuda", dtype: torch.dtype = torch.bfloat16,
                        **scorer_kwargs) -> GemmaCostWiseReranker:
    """A bge-reranker-v2.5-gemma2-lightweight checkpoint directory ->
    :class:`GemmaCostWiseReranker` on ``device`` (``start_layer`` and
    ``layer_sep`` from ``config.json``; the tokenizer pads on the right).
    ``quant``: "", "int8", "w8a8", "int4" or "w4a8", as
    ``hf_loader.load_decoder_params`` takes it; JAX's loader sets
    ``act_quant`` for w8a8 only, and so does this one."""
    from transformers import AutoTokenizer

    from .hf_loader import load_decoder_params, load_hf_config

    hf = load_hf_config(model_dir)
    cfg = gemma_config_from_hf(hf, act_quant=quant == "w8a8")
    params = load_decoder_params(
        model_dir, cfg.num_hidden_layers, dtype=dtype, quant=quant, device=resolve_device(device),
        start_layer=hf.get("start_layer", 8), gemma=True, head_layer_sep=hf.get("layer_sep", 1),
    )
    tok = AutoTokenizer.from_pretrained(model_dir, trust_remote_code=True)
    tok.padding_side = "right"
    model = GemmaCostWiseReranker(cfg, tok, device=device, dtype=dtype, **scorer_kwargs)
    return model.load_tree_(params)
