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
from .layers import QUANTS
from .quant import quantize_linear_int4, quantize_linear_int8

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

    ``quant="int8"`` or ``"w8a8"`` stores every attention/MLP projection and
    an untied ``lm_head`` as int8 per output channel, ``"int4"`` or
    ``"w4a8"`` as nibble-packed int4 with an int8 embedding table (per-row
    scales); w8a8 and w4a8 store the same leaves as int8 and int4, and their
    activations quantize at run time (``DecoderConfig.act_quant``, set by
    the caller). Norms and biases stay in ``dtype``; layerwise score heads
    are f32 ``[1, hidden]`` under ``heads``, keyed by layer. The tree lands
    on ``device``: the card unless the caller asks for the CPU."""
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    return _tree(_iter_safetensors(model_dir), num_layers, dtype, quant, resolve_device(device), start_layer, gemma,
                 head_layer_sep)


def params_from_state_dict(
    state_dict: Dict[str, Any],
    num_layers: int,
    start_layer: Optional[int] = None,
    gemma: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Dict[str, Any]:
    """In-memory form of :func:`load_decoder_params` for tests and
    conversions (JAX's ``hf_loader.params_from_state_dict``): the same names,
    dense leaves in ``dtype`` and a plain ``lm_head`` tensor, on ``device``
    (the card unless the caller asks for the CPU). Leaves may be tensors or
    numpy arrays."""
    items = ((name, torch.as_tensor(t)) for name, t in state_dict.items())
    params = _tree(items, num_layers, dtype, "", resolve_device(device), start_layer, gemma, 1)
    if "lm_head" in params:
        params["lm_head"] = params["lm_head"]["w"]
    return params


def _tree(named, num_layers, dtype, quant, device, start_layer, gemma, head_layer_sep) -> Dict[str, Any]:
    """``(name, tensor)`` pairs in HF names -> the decoder tree (the mapping
    of the module docstring), each tensor quantized or cast as it arrives."""
    layers = [{"attn": {}, "mlp": {}} for _ in range(num_layers)]
    params: Dict[str, Any] = {"layers": layers}
    heads: Dict[int, torch.Tensor] = {}
    norm_map = _GEMMA_NORM_MAP if gemma else _NORM_MAP
    int4 = quant in ("int4", "w4a8")

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype)

    def put_linear(t: torch.Tensor) -> Dict[str, torch.Tensor]:
        if quant in ("int8", "w8a8"):
            return quantize_linear_int8(t.to(device).float())
        if int4:
            return quantize_linear_int4(t.to(device).float())
        return {"w": put(t)}

    for raw_name, tensor in named:
        name = raw_name[6:] if raw_name.startswith("model.") else raw_name
        parts = name.split(".")
        if name == "embed_tokens.weight":
            params["embed"] = quantize_linear_int8(tensor.to(device).float()) if int4 else put(tensor)
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
    card unless the caller asks for the CPU). ``quant``: "", "int8", "w8a8",
    "int4" or "w4a8" (int4 with an int8 embedding table); w8a8 and w4a8 set
    ``cfg.act_quant``."""
    from .qwen2 import qwen2_config_from_hf

    device = resolve_device(device)
    cfg = qwen2_config_from_hf(load_hf_config(model_dir), act_quant=quant in ("w8a8", "w4a8"))
    return cfg, load_decoder_params(model_dir, cfg.num_hidden_layers, dtype=dtype, quant=quant, device=device)


def load_minicpm_reranker(model_dir: str, dtype: torch.dtype = torch.bfloat16, quant: str = "", device="cuda"):
    """bge-reranker-v2-minicpm-layerwise checkpoint -> ``(cfg, params,
    start_layer)`` (JAX's ``hf_loader.load_minicpm_reranker``):
    ``start_layer`` from ``config.json`` (default 8), the layerwise heads
    under ``heads``, ``quant`` as :func:`load_decoder_params` takes it (w8a8
    and w4a8 set ``cfg.act_quant``), on ``device``."""
    from .minicpm import minicpm_config_from_hf

    device = resolve_device(device)
    hf = load_hf_config(model_dir)
    cfg = minicpm_config_from_hf(hf, act_quant=quant in ("w8a8", "w4a8"))
    start_layer = hf.get("start_layer", 8)
    params = load_decoder_params(model_dir, cfg.num_hidden_layers, dtype=dtype, quant=quant, device=device,
                                 start_layer=start_layer)
    return cfg, params, start_layer
