"""Seeded random weights, made on the device in a few large calls.

The benchmark draws each model's weights here and hands the same draw to the
program (copied into its modules) and, after the measured window, to the
reference (drawn again from the seed). One ``torch.Generator`` on the device
draws every kind of projection for all layers at once, in the type the model
is served in, in a fixed order.
"""

from __future__ import annotations

from typing import Dict

import torch

STD = 0.02
PROJECTIONS = ("q", "k", "v", "o", "gate", "up", "down")


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A device generator for one model of the run: the seed and a stream
    number, so two models of one run draw different values."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (1 << 63))


def projection_shapes(cfg: Dict) -> Dict[str, tuple]:
    """``[out, in]`` of every projection of a decoder layer."""
    d, inter = cfg["hidden_size"], cfg["intermediate_size"]
    hd = cfg.get("head_dim") or d // cfg["num_attention_heads"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return {"q": (nh * hd, d), "k": (nkv * hd, d), "v": (nkv * hd, d), "o": (d, nh * hd),
            "gate": (cfg["intermediate_size"], d), "up": (inter, d), "down": (d, inter)}


def iter_minicpm_weights(cfg: Dict, seed: int, device, dtype=torch.bfloat16):
    """The layerwise reranker's weights, drawn in order: ``embed`` ``[V, d]``,
    each projection stacked over the layers ``[L, out, in]``, then ``heads``
    ``[L+1, d]`` in f32 (rows below ``start_layer`` zero). Norms are 1 and not
    drawn. Yields ``(name, tensor)`` so a caller can copy and free each."""
    gen = generator(seed, 1, device)
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]

    def draw(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(STD)

    yield "embed", draw(cfg["vocab_size"], d)
    for name, shape in projection_shapes(cfg).items():
        yield name, draw(L, *shape)
    heads = torch.zeros(L + 1, d, device=device, dtype=torch.float32)
    heads[cfg["start_layer"]:] = draw(L + 1 - cfg["start_layer"], d, dt=torch.float32)
    yield "heads", heads


def minicpm_weights(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """:func:`iter_minicpm_weights` as a dict."""
    return dict(iter_minicpm_weights(cfg, seed, device, dtype))

