"""HuggingFace checkpoint -> the port's decoder tree (port of
``easyrag_tpu/models/hf_loader.py``'s loader).

Streams ``*.safetensors`` shard by shard from a local model directory and
maps the llama-family names onto the JAX package's tree layout::

  (model.)embed_tokens.weight                       -> embed
  (model.)layers.{i}.self_attn.{q,k,v,o}_proj.*     -> layers[i].attn.*
  (model.)layers.{i}.mlp.{gate,up,down}_proj.weight -> layers[i].mlp.*
  (model.)layers.{i}.input_layernorm.weight         -> layers[i].input_norm
  (model.)layers.{i}.post_attention_layernorm.*     -> layers[i].post_norm
  (model.)norm.weight                               -> final_norm
  lm_head.weight                                    -> lm_head (absent: tied)
  lm_head.{j}.linear_head.weight                    -> heads[start_layer + j*layer_sep]
  (Gemma2: post_attention / pre_feedforward / post_feedforward norms map to
   post_attn_norm / pre_mlp_norm / post_mlp_norm)

Shards are read with ``framework="pt"``: real checkpoints are bf16, and numpy
knows ``bfloat16`` only once ``ml_dtypes`` has registered it, which importing
JAX does and the port never does. Weights are quantized in f32, tensor by
tensor, on the target device.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

import torch

from ..devices import resolve_device
from .quant import quantize_linear_int4, quantize_linear_int8

QUANTS = ("", "int8", "int4")

_NORM_MAP = {
    "input_layernorm": "input_norm",
    "post_attention_layernorm": "post_norm",
    "pre_feedforward_layernorm": "pre_mlp_norm",
    "post_feedforward_layernorm": "post_mlp_norm",
}

_GEMMA_NORM_MAP = {
    "input_layernorm": "input_norm",
    "post_attention_layernorm": "post_attn_norm",
    "pre_feedforward_layernorm": "pre_mlp_norm",
    "post_feedforward_layernorm": "post_mlp_norm",
}


def load_hf_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        return json.load(f)


def _safetensor_files(model_dir: str):
    """The ``model.safetensors.index.json`` weight map's shards, else a glob."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path, encoding="utf-8") as f:
            index = json.load(f)
        return [os.path.join(model_dir, name) for name in sorted(set(index["weight_map"].values()))]
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    return files


def _iter_safetensors(model_dir: str):
    """One shard open at a time, one tensor at a time."""
    from safetensors import safe_open

    for path in _safetensor_files(model_dir):
        with safe_open(path, framework="pt") as f:
            for name in f.keys():
                yield name, f.get_tensor(name)


def load_decoder_params(
    model_dir: str,
    num_layers: int,
    dtype: torch.dtype = torch.bfloat16,
    quant: str = "",
    device="cuda",
    start_layer: Optional[int] = None,
    gemma: bool = False,
    head_layer_sep: int = 1,
) -> Dict[str, Any]:
    """Stream a checkpoint's safetensors into the decoder tree.

    ``quant="int8"`` or ``"int4"`` stores every attention/MLP projection and
    an untied ``lm_head`` quantized per output channel; ``"int4"`` also
    stores the embedding table int8 (per-row scales). Norms and biases stay
    in ``dtype``; layerwise score heads are f32 ``[1, hidden]`` under
    ``heads``, keyed by layer. The tree lands on ``device``: the card unless
    the caller asks for the CPU."""
    if quant in ("w8a8", "w4a8"):
        raise NotImplementedError(f"quant={quant!r}: activation quantization is ROADMAP Queue 1, item 4")
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    device = resolve_device(device)
    layers = [{"attn": {}, "mlp": {}} for _ in range(num_layers)]
    params: Dict[str, Any] = {"layers": layers}
    heads: Dict[int, torch.Tensor] = {}
    norm_map = _GEMMA_NORM_MAP if gemma else _NORM_MAP

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype)

    def put_linear(t: torch.Tensor) -> Dict[str, torch.Tensor]:
        if quant == "int8":
            return quantize_linear_int8(t.to(device).float())
        if quant == "int4":
            return quantize_linear_int4(t.to(device).float())
        return {"w": put(t)}

    for raw_name, tensor in _iter_safetensors(model_dir):
        name = raw_name[6:] if raw_name.startswith("model.") else raw_name
        parts = name.split(".")
        if name == "embed_tokens.weight":
            params["embed"] = quantize_linear_int8(tensor.to(device).float()) if quant == "int4" else put(tensor)
        elif name == "norm.weight":
            params["final_norm"] = put(tensor)
        elif parts[0] == "lm_head":
            if parts[1].isdigit():
                heads[(start_layer or 0) + int(parts[1]) * head_layer_sep] = tensor.to(device=device, dtype=torch.float32)
            else:
                params["lm_head"] = put_linear(tensor)
        elif parts[0] == "layers":
            i = int(parts[1])
            if i >= num_layers:
                continue
            sub = parts[2]
            if sub == "self_attn":
                proj = parts[3][0]  # q/k/v/o
                if parts[4] == "weight":
                    layers[i]["attn"].setdefault(proj, {}).update(put_linear(tensor))
                else:
                    layers[i]["attn"].setdefault(proj, {})["b"] = put(tensor)
            elif sub == "mlp":
                layers[i]["mlp"][parts[3].split("_")[0]] = put_linear(tensor)
            elif sub in norm_map:
                layers[i][norm_map[sub]] = put(tensor)
    if heads:
        params["heads"] = heads
    return params


def load_qwen2_embedder(model_dir: str, dtype: torch.dtype = torch.bfloat16, quant: str = "", device="cuda"):
    """gte-Qwen2 checkpoint -> ``(DecoderConfig, params)`` on ``device`` (the
    card unless the caller asks for the CPU). ``quant``: "", "int8" or
    "int4" (with an int8 embedding table); "w8a8" and "w4a8" raise
    (activation quantization, ROADMAP Queue 1, item 4)."""
    from .qwen2 import qwen2_config_from_hf

    device = resolve_device(device)
    cfg = qwen2_config_from_hf(load_hf_config(model_dir))
    return cfg, load_decoder_params(model_dir, cfg.num_hidden_layers, dtype=dtype, quant=quant, device=device)
