"""JAX parameter trees -> the port's modules and trees.

The tree is ``easyrag_tpu.models.layers.init_params``'s layout (plus
``heads``, layer -> ``[1, hidden]``, for the reranker), with every leaf a
numpy array. Both packages store linear weights ``[out, in]``, so leaves copy
over unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from .gemma import GemmaCostWiseReranker
from .layers import DecoderConfig
from .minicpm import MiniCPMLayerWiseReranker
from .qwen2 import GTEEmbedder


def minicpm_from_jax(
    cfg: DecoderConfig,
    params_np: Dict[str, Any],
    device,
    dtype: torch.dtype,
    tokenizer,
    **scorer_kwargs,
) -> MiniCPMLayerWiseReranker:
    """A :class:`MiniCPMLayerWiseReranker` holding ``params_np``'s weights
    (dense bf16/f32 trees only; heads stay f32)."""
    model = MiniCPMLayerWiseReranker(cfg, tokenizer, device=device, dtype=dtype, **scorer_kwargs)

    def put(param: torch.Tensor, leaf) -> None:
        if not hasattr(leaf, "__array__"):
            raise NotImplementedError(
                f"quantized or non-dense leaf {type(leaf).__name__}: only dense weights are ported (ROADMAP Queue 1, item 4)"
            )
        arr = np.array(leaf, dtype=np.float32).reshape(param.shape)
        param.copy_(torch.from_numpy(arr))

    def dense(p: Dict[str, Any]):
        if set(p) != {"w"}:
            raise NotImplementedError(
                f"linear with {sorted(p)}: biases and int8/w8a8/int4 weights are not ported (ROADMAP Queue 1, item 4)"
            )
        return p["w"]

    with torch.no_grad():
        put(model.embed, params_np["embed"])
        put(model.final_norm, params_np["final_norm"])
        for layer, p in zip(model.layers, params_np["layers"], strict=True):
            put(layer.input_norm, p["input_norm"])
            put(layer.post_norm, p["post_norm"])
            for name in ("q", "k", "v", "o"):
                put(getattr(layer, name), dense(p["attn"][name]))
            for name in ("gate", "up", "down"):
                put(getattr(layer, name), dense(p["mlp"][name]))
        for layer_idx, w in params_np["heads"].items():
            put(model.heads[int(layer_idx)], w)
    return model


def gemma_from_jax(
    cfg: DecoderConfig,
    params_np: Dict[str, Any],
    device,
    dtype: torch.dtype,
    tokenizer,
    **scorer_kwargs,
) -> GemmaCostWiseReranker:
    """A :class:`GemmaCostWiseReranker` holding a JAX Gemma tree's weights
    (``heads`` keyed by layer; dense weights only; heads stay f32)."""
    model = GemmaCostWiseReranker(cfg, tokenizer, device=device, dtype=dtype, **scorer_kwargs)
    return model.load_tree_(params_np)


_EXACT = ("w_q", "w_p", "scale")  # int8 bytes and f32 scales keep their dtype


def causal_lm_params_from_jax(params_np: Dict[str, Any], device, dtype: torch.dtype) -> Dict[str, Any]:
    """A JAX decoder tree (dense, int8, int4 or fused int4 linears, a dense
    or int8 embedding table, an optional ``lm_head`` as an array or a dict)
    -> the port's tree with the same keys, for ``models/decode.py``.
    Quantized bytes and scales keep their dtypes; every other leaf becomes
    ``dtype``."""

    def leaf(key: str, arr) -> torch.Tensor:
        if key in _EXACT:
            return torch.from_numpy(np.array(arr)).to(device)
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)

    def tree(key: str, node: Union[Dict[str, Any], Any]):
        if isinstance(node, dict):
            return {k: tree(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [tree(key, v) for v in node]
        return leaf(key, node)

    return tree("", params_np)


def gte_from_jax(
    cfg: DecoderConfig,
    params_np: Dict[str, Any],
    device,
    dtype: torch.dtype,
    tokenizer,
    **embedder_kwargs,
) -> GTEEmbedder:
    """A :class:`GTEEmbedder` over a JAX gte-Qwen2 tree (dense, int8 or int4
    linears; no ``lm_head``), converted by :func:`causal_lm_params_from_jax`."""
    return GTEEmbedder(cfg, causal_lm_params_from_jax(params_np, device, dtype), tokenizer, device=device,
                       **embedder_kwargs)
