"""Qwen2 configuration and the gte-Qwen2 embedder (port of
``easyrag_tpu/models/qwen2.py``).

The generator (``models/decode.py``) runs Qwen2 causal LMs such as
Qwen2-7B-Instruct. :class:`GTEEmbedder` is the dense route's embedder
(gte-Qwen2-7B-instruct): the "Instruct: ... \\nQuery: " query prefix,
``max_length`` 8192, inputs padded to (batch, sequence) buckets, the decoder
stack over the JAX-layout tree (``layers.forward_hidden``: K3 in every layer
at ``S % 128 == 0``), last-token pooling and L2 normalization in f32. A
tensor-parallel tree (``parallel/tp.py``) runs K3 on every shard at the
shard's head counts and pools on the first ``model`` device
(:func:`load_gte_embedder` with a mesh whose ``model`` axis is wider than 1).

Pooling reads position ``sum(mask) - 1``, the last real token only under
right padding, as JAX's ``GTEEmbedder._embed`` does (it never passes
``left_padded``). A tokenizer that pads on the left would pool a pad token
there; the port refuses it (ROADMAP Queue 3) rather than compute something
else.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..devices import resolve_device
from .layers import DecoderConfig, forward_hidden, tp_devices

QUERY_INSTRUCT = (
    "Instruct: Given a web search query, retrieve relevant passages that "
    "answer the query\nQuery: "
)

SEQ_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def qwen2_config_from_hf(hf: Dict[str, Any], act_quant: bool = False) -> DecoderConfig:
    """``config.json`` of a Qwen2 checkpoint -> :class:`DecoderConfig`
    (``act_quant`` for a w8a8 or w4a8 tree)."""
    return DecoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10000.0),
        attention_bias=True,  # Qwen2 uses QKV bias
        act_quant=act_quant,
    )


@torch.inference_mode()
def embed_step(
    cfg: DecoderConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S]
    left_padded: bool = False,
) -> torch.Tensor:
    """forward -> last-token pool -> L2 normalize; ``[B, D]`` f32."""
    h = forward_hidden(cfg, params, input_ids, attention_mask)
    if left_padded:
        pooled = h[:, -1]
    else:
        last = attention_mask.sum(dim=1).long() - 1
        pooled = h[torch.arange(h.shape[0], device=h.device), last]
    pooled = pooled.float()
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _tree_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


class GTEEmbedder:
    """Query/text embedder with the GTE contract, on ``device``: the card
    unless the caller asks for the CPU (the tree moves there if it is not
    already). A tensor-parallel tree stays where its shards are and the
    embedder runs on its first ``model`` device, the one holding the
    embedding and the norms; ``device`` is not read then. ``stats`` counts
    the batches, real tokens and padded tokens embedded so far."""

    def __init__(
        self,
        cfg: DecoderConfig,
        params: Dict[str, Any],
        tokenizer,
        max_length: int = 8192,
        embed_batch_size: int = 128,
        embed_type: int = 0,
        batch_buckets: Sequence[int] = (1, 8, 32, 128),
        device="cuda",
    ) -> None:
        if getattr(tokenizer, "padding_side", "right") == "left":
            raise ValueError(
                "GTEEmbedder pools at sum(mask) - 1, the last real token only under right padding; "
                "a left-padding tokenizer is ROADMAP Queue 3 (right-padding-only pooling)"
            )
        self.cfg = cfg
        if tp_devices(params) is not None:
            self.device = params["final_norm"].device
            self.params = params
        else:
            self.device = resolve_device(device)
            self.params = _tree_to(params, self.device)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.embed_batch_size = embed_batch_size
        self.embed_type = embed_type
        # a full chunk always has its bucket (JAX drops it when
        # embed_batch_size is not a bucket and then fails, ROADMAP Queue 3)
        self.batch_buckets = tuple(b for b in batch_buckets if b < embed_batch_size) + (embed_batch_size,)
        self.stats = {"batches": 0, "tokens": 0, "padded_tokens": 0}

    # -- core ---------------------------------------------------------------

    def _embed(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.cfg.hidden_size), dtype=np.float32)
        bs = self.embed_batch_size
        seq_buckets = [x for x in SEQ_BUCKETS if x <= self.max_length] or [self.max_length]
        for lo in range(0, len(texts), bs):
            chunk = texts[lo : lo + bs]
            enc = self.tokenizer(chunk, max_length=self.max_length, padding=True, truncation=True, return_tensors="np")
            ids = np.asarray(enc["input_ids"]).astype(np.int32)
            mask = np.asarray(enc["attention_mask"]).astype(np.int32)
            b, s = ids.shape
            sb, bb = _bucket(s, seq_buckets), _bucket(b, self.batch_buckets)
            ids_p = np.zeros((bb, sb), dtype=np.int32)
            mask_p = np.zeros((bb, sb), dtype=np.int32)
            ids_p[:b, :s] = ids
            mask_p[:b, :s] = mask
            # padding rows need >=1 real token for the length-1 gather
            mask_p[b:, 0] = 1
            emb = embed_step(
                self.cfg, self.params, torch.from_numpy(ids_p).to(self.device), torch.from_numpy(mask_p).to(self.device)
            )
            out[lo : lo + b] = emb[:b].cpu().numpy()
            self.stats["batches"] += 1
            self.stats["tokens"] += int(mask.sum())
            self.stats["padded_tokens"] += bb * sb
        return out

    # -- GTE public contract --------------------------------------------------

    def get_detailed_instruct(self, query: str) -> str:
        return f"{QUERY_INSTRUCT}{query}"

    def get_query_embedding(self, query: str) -> np.ndarray:
        return self._embed([self.get_detailed_instruct(query)])[0]

    def get_query_embeddings(self, queries: List[str]) -> np.ndarray:
        return self._embed([self.get_detailed_instruct(q) for q in queries])

    def get_text_embedding(self, text: str) -> np.ndarray:
        return self._embed([text])[0]

    def get_text_embeddings(self, texts: List[str]) -> np.ndarray:
        return self._embed(list(texts))

    def embed_nodes(self, nodes, embed_type: Optional[int] = None) -> np.ndarray:
        from ..corpus.views import get_node_content

        et = self.embed_type if embed_type is None else embed_type
        return self._embed([get_node_content(n, et) for n in nodes])


def load_gte_embedder(model_dir: str, quant: str = "", device="cuda", embed_type: int = 0, mesh=None) -> GTEEmbedder:
    """A local gte-Qwen2 checkpoint directory -> :class:`GTEEmbedder` (the
    gte branch of ``easyrag_tpu/models/registry.py::load_embedder``):
    weights through ``hf_loader.load_qwen2_embedder``, the tokenizer from
    the same directory, 128-row embedding batches. With a ``mesh`` whose
    ``model`` axis is wider than 1 the weights load onto its first
    ``model`` device and shard tensor-parallel over that axis
    (``parallel.tp.shard_decoder_params``) instead of going to ``device``."""
    from transformers import AutoTokenizer

    from .hf_loader import load_qwen2_embedder

    tp = mesh is not None and mesh.shape.get("model", 1) > 1
    cfg, params = load_qwen2_embedder(model_dir, quant=quant, device=mesh.model_devices()[0] if tp else device)
    if tp:
        from ..parallel.tp import shard_decoder_params

        params = shard_decoder_params(mesh, cfg, params, axis="model")
    tokenizer = AutoTokenizer.from_pretrained(model_dir, trust_remote_code=True)
    return GTEEmbedder(cfg, params, tokenizer, embed_type=embed_type, embed_batch_size=128, device=device)
