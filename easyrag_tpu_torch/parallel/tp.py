"""Tensor-parallel sharding of a decoder tree over a mesh's ``model`` axis
(port of ``easyrag_tpu/parallel/tp.py``).

The Megatron layout of the JAX package:

* q/k/v and gate/up projections: output rows split (column parallel);
  query-head block ``s`` goes with KV-head block ``s``, so every shard keeps
  whole GQA groups; biases and per-channel scales split with the rows;
* o and down projections: input columns split (row parallel), their scale
  and bias whole on every shard;
* the embedding, the norms and the head: one copy on the first ``model``
  device, which also holds the residual stream. JAX replicates them on
  every device; here one process drives every shard and runs the
  replicated work once.

JAX annotates the arrays and XLA inserts the all-reduces. The port has no
such compiler: the layer code (``models/layers.py::decoder_layer``,
``row_parallel_linear``) copies the row-parallel partial products to the
first device and sums them there in shard order, so the result is the same
on every run. Requires ``num_attention_heads % mp == 0`` and the KV heads
likewise.

The shards sit on the ``model`` devices of data row 0
(``Mesh.model_devices``). On a mesh of distinct devices each shard owns its
tensors, so the input tree may be dropped; a mesh that repeats a device
(``["cuda:0"] * 2``) keeps views of the input tree, so the shards add no
memory there. The replicated leaves are the input's own tensors wherever
they already lie on the first device.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..models.layers import DecoderConfig
from ..models.quant import unfuse_linear, unpack_int4
from .mesh import Mesh


def shard_decoder_params(
    mesh: Mesh, cfg: DecoderConfig, params: Dict[str, Any], axis: str = "model"
) -> Dict[str, Any]:
    """The tree split over ``axis``: each layer's ``attn`` and ``mlp`` become
    lists of per-shard dicts (shard ``s`` on ``mesh.model_devices(axis)[s]``),
    every other leaf lands on the first of those devices. Int4 leaves become
    their nibble values as int8 (``w_q``, the same scales): the packed
    halves layout cannot be split by rows (each byte pairs input columns
    ``i`` and ``i + I/2``), so no K2 runs under TP, as in JAX. Fused ``qkv``
    and ``gateup`` leaves are split back into their parts first. A shard
    computes with ``layers.shard_config(cfg, mp)``."""
    mp = mesh.shape[axis]
    if cfg.num_attention_heads % mp or cfg.num_key_value_heads % mp:
        raise ValueError(
            f"heads ({cfg.num_attention_heads}/{cfg.num_key_value_heads}) "
            f"not divisible by model-parallel size {mp}"
        )
    if cfg.intermediate_size % mp:
        raise ValueError(f"intermediate size {cfg.intermediate_size} not divisible by model-parallel size {mp}")
    devices = mesh.model_devices(axis)
    first = devices[0]
    own = len(set(devices)) == len(devices)

    def put(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        return t.to(dev, copy=own)

    def shard_dense(p: Dict[str, torch.Tensor], col: bool) -> List[Dict[str, torch.Tensor]]:
        if "w_p" in p:
            p = {"w_q": unpack_int4(p["w_p"]), **{k: v for k, v in p.items() if k != "w_p"}}
        key = "w_q" if "w_q" in p else "w"
        n = p[key].shape[0 if col else 1] // mp
        shards = []
        for s, dev in enumerate(devices):
            cut = slice(s * n, (s + 1) * n)
            out = {key: put(p[key][cut] if col else p[key][:, cut], dev)}
            # per-OUTPUT-channel scales and biases: split with the rows in
            # column-parallel layers, whole in row-parallel ones
            for k in ("scale", "b"):
                if k in p:
                    out[k] = put(p[k][cut] if col else p[k], dev)
            shards.append(out)
        return shards

    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd

    def attn_parts(attn):
        if "qkv" in attn:
            # a fused int4 tree (quant.fuse_decode_tree): Megatron column
            # sharding splits q and the KV head groups separately
            return unfuse_linear(attn["qkv"], [nh * hd, nkv * hd, nkv * hd])
        return attn["q"], attn["k"], attn["v"]

    def mlp_parts(mlp):
        if "gateup" in mlp:
            inter = mlp["gateup"]["scale"].shape[0] // 2
            return unfuse_linear(mlp["gateup"], [inter, inter])
        return mlp["gate"], mlp["up"]

    def replicate(node):
        if isinstance(node, dict):
            return {k: replicate(v) for k, v in node.items()}
        return node.to(first)

    out: Dict[str, Any] = {"embed": replicate(params["embed"]), "final_norm": replicate(params["final_norm"]),
                           "layers": []}
    for layer in params["layers"]:
        q, k, v = (shard_dense(p, col=True) for p in attn_parts(layer["attn"]))
        o = shard_dense(layer["attn"]["o"], col=False)
        gate, up = (shard_dense(p, col=True) for p in mlp_parts(layer["mlp"]))
        down = shard_dense(layer["mlp"]["down"], col=False)
        new = {
            "attn": [{"q": q[s], "k": k[s], "v": v[s], "o": o[s]} for s in range(mp)],
            "mlp": [{"gate": gate[s], "up": up[s], "down": down[s]} for s in range(mp)],
        }
        for key in layer:
            if key not in ("attn", "mlp"):
                new[key] = replicate(layer[key])
        out["layers"].append(new)
    for key in params:
        if key not in out:
            out[key] = replicate(params[key])
    return out
