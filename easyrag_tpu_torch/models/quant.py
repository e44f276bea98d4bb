"""Weight quantization of decoder trees (port of the quantizers in
``easyrag_tpu/models/hf_loader.py``).

A decoder tree is the JAX package's layout: nested dicts of tensors, one dict
per linear with ``w`` (dense), ``w_q``/``scale`` (int8) or ``w_p``/``scale``
(int4), each with an optional bias ``b``. Both quantizers are symmetric and
per output channel, work on CPU and CUDA tensors alike, and give the same
bytes as the JAX package's numpy versions on the same f32 input: division,
``round`` (half to even, as ``np.rint``) and the clip are exact in both.

The same holds on the card: every division is tensor by tensor, which
PyTorch's CUDA kernels take as an IEEE division.

Int4 packs two nibbles per byte in the *halves* layout: byte ``w_p[o, i]``
holds column ``i`` in its low nibble and column ``i + I/2`` in its high one.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..ops import int4_matvec


def _scale_and_round(w: torch.Tensor, qmax: int):
    w = w.float()
    # divide by a tensor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds some scales one ulp away from the CPU's
    amax = w.abs().amax(dim=1)
    scale = amax / torch.full_like(amax, float(qmax))
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale[:, None]), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_linear_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``w ≈ w_q * scale[:, None]`` with ``scale = max|row| / 127``."""
    w_q, scale = _scale_and_round(w, 127)
    return {"w_q": w_q, "scale": scale}


def quantize_linear_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``w ≈ unpack_int4(w_p) * scale[:, None]`` with ``scale = max|row| / 7``,
    nibble-packed in the halves layout."""
    if w.shape[1] % 2:
        raise ValueError(f"int4 packing needs an even input width, got {tuple(w.shape)}")
    w4, scale = _scale_and_round(w, 7)
    half = w.shape[1] // 2
    w4 = w4.to(torch.int32)
    packed = (w4[:, :half] & 0xF) | ((w4[:, half:] & 0xF) << 4)
    return {"w_p": packed.to(torch.uint8).view(torch.int8), "scale": scale}


def unpack_int4(w_p: torch.Tensor) -> torch.Tensor:
    """``[O, I/2]`` packed nibbles -> ``[O, I]`` int8, sign-extended: low
    nibbles are columns ``[0, I/2)``, high nibbles ``[I/2, I)``."""
    b = w_p.to(torch.int32)
    lo = (b << 28) >> 28  # arithmetic shifts sign-extend
    hi = b >> 4
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def quantize_decoder_tree(params: Dict[str, Any], quant: str = "int8") -> Dict[str, Any]:
    """Quantize every attn/mlp linear of an in-memory tree (``quant``: int8 or
    int4). Embeddings, norms and biases pass through."""
    quantize = {"int8": quantize_linear_int8, "int4": quantize_linear_int4}[quant]
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new = dict(layer)
        for group in ("attn", "mlp"):
            new[group] = {
                name: {**quantize(p["w"]), **({"b": p["b"]} if "b" in p else {})} if "w" in p else p
                for name, p in layer[group].items()
            }
        out["layers"].append(new)
    return out


def _fusable(parts: List[Dict[str, torch.Tensor]], equal_widths: bool) -> bool:
    """Every part int4 with one input width and biases on all or none (and,
    for gate/up, one output width, since ``mlp`` splits the fused output at
    its midpoint); and K2 takes the fused shape at one row."""
    if not all("w_p" in p for p in parts):
        return False
    half = parts[0]["w_p"].shape[1]
    outs = [p["w_p"].shape[0] for p in parts]
    if any(p["w_p"].shape[1] != half for p in parts):
        return False
    if len({"b" in p for p in parts}) != 1:
        return False
    if equal_widths and len(set(outs)) != 1:
        return False
    return int4_matvec.supported(1, sum(outs), half)


def _concat(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    keys = ("w_p", "scale", "b") if "b" in parts[0] else ("w_p", "scale")
    return {k: torch.cat([p[k] for p in parts], dim=0) for k in keys}


def fuse_decode_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse int4 q+k+v into ``attn.qkv`` and gate+up into ``mlp.gateup``:
    one K2 launch instead of three (two) on the same activations, with the
    same per-channel values (contraction, scale and bias are row-local).
    Each group is checked first (:func:`_fusable`) and concatenated only
    when it fuses; other groups stay as they are."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        new = dict(layer)
        attn = layer.get("attn", {})
        if all(k in attn for k in ("q", "k", "v")):
            parts = [attn["q"], attn["k"], attn["v"]]
            if _fusable(parts, equal_widths=False):
                new["attn"] = {"qkv": _concat(parts), **{k: v for k, v in attn.items() if k not in ("q", "k", "v")}}
        mlp = layer.get("mlp", {})
        if "gate" in mlp and "up" in mlp:
            parts = [mlp["gate"], mlp["up"]]
            if _fusable(parts, equal_widths=True):
                new["mlp"] = {"gateup": _concat(parts), **{k: v for k, v in mlp.items() if k not in ("gate", "up")}}
        out["layers"].append(new)
    return out


def unfuse_linear(fused: Dict[str, torch.Tensor], outs: List[int]) -> List[Dict[str, torch.Tensor]]:
    """Split a fused packed linear (``qkv``, ``gateup``) back into row blocks
    of sizes ``outs`` (views of its ``w_p``, ``scale`` and ``b``)."""
    parts = []
    start = 0
    for n in outs:
        part = {"w_p": fused["w_p"][start : start + n], "scale": fused["scale"][start : start + n]}
        if "b" in fused:
            part["b"] = fused["b"][start : start + n]
        parts.append(part)
        start += n
    return parts
