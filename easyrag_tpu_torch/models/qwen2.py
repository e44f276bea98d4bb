"""Qwen2 configuration (port of ``easyrag_tpu/models/qwen2.py::qwen2_config_from_hf``).

The generator (``models/decode.py``) runs Qwen2 causal LMs such as
Qwen2-7B-Instruct; the gte-Qwen2 embedder comes with the dense route.
"""

from __future__ import annotations

from typing import Any, Dict

from .layers import DecoderConfig


def qwen2_config_from_hf(hf: Dict[str, Any]) -> DecoderConfig:
    """``config.json`` of a Qwen2 checkpoint -> :class:`DecoderConfig`."""
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
    )
