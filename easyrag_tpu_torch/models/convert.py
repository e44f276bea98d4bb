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
from .layers import _EXACT, DecoderConfig
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
    (dense, int8 or int4 linears, ``MiniCPMLayerWiseReranker.load_tree_``;
    heads stay f32). A w8a8 or w4a8 tree needs ``cfg.act_quant``."""
    model = MiniCPMLayerWiseReranker(cfg, tokenizer, device=device, dtype=dtype, **scorer_kwargs)
    return model.load_tree_(params_np)


def gemma_from_jax(
    cfg: DecoderConfig,
    params_np: Dict[str, Any],
    device,
    dtype: torch.dtype,
    tokenizer,
    **scorer_kwargs,
) -> GemmaCostWiseReranker:
    """A :class:`GemmaCostWiseReranker` holding a JAX Gemma tree's weights
    (``heads`` keyed by layer; dense, int8 or int4 linears; heads stay f32).
    A w8a8 tree needs ``cfg.act_quant``."""
    model = GemmaCostWiseReranker(cfg, tokenizer, device=device, dtype=dtype, **scorer_kwargs)
    return model.load_tree_(params_np)




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
