"""Generic causal-LM reranker scored by the 'Yes'-token logit (port of
``easyrag_tpu/models/yes_logit.py``).

The reference's third reranker family (``src/easyrag/custom/rerankers.py:
177-184,361``): any causal LM prompted with the Yes/No instruction, scored by
``logits[:, -1, yes_loc]``. Only the "Yes" row of the head is needed, so a
score is the final-normed hidden state at each row's last real token
(``layers.forward_hidden``, K3 in every layer on the card) times that one
row, in f32. The head is tied to ``embed`` when the tree has no
``lm_head``; an int8 head's row is ``w_q[yes] * scale[yes]``.

Prompts are the MiniCPM reranker's (``minicpm.build_pair_inputs``), padded
on the left unless the tokenizer says otherwise. JAX pads them to a multiple
of 64 and runs its einsum attention; the port pads to a multiple of 128 by
default, so that ``layers.attention`` takes K3 (its gate, JAX's, wants
``S % 128 == 0``). Real rows' scores do not change: pad keys are masked and
rotary attention depends on position differences only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..devices import resolve_device
from .layers import DecoderConfig, forward_hidden
from .minicpm import build_pair_inputs, last_real_index
from .qwen2 import _tree_to


def yes_row(params: Dict[str, Any], yes_loc: int) -> torch.Tensor:
    """The head's "Yes" row, f32: ``lm_head``, or the embedding table when
    there is none (tied); dense or int8. An int4 head raises: JAX reads
    ``w_q`` or ``w`` only and fails with a ``KeyError`` there."""
    head = params.get("lm_head", params["embed"])
    if not isinstance(head, dict):
        return head[yes_loc].float()
    if "w_q" in head:
        return head["w_q"][yes_loc].float() * head["scale"][yes_loc]
    if "w" in head:
        return head["w"][yes_loc].float()
    raise ValueError(
        f"YesLogitScorer: the head is {sorted(head)} (int4): only dense and int8 heads give a 'Yes' row "
        "(an untied head stored int4 by quant='int4'/'w4a8')"
    )


class YesLogitScorer:
    """``score_pairs(pairs)`` -> ``(scores[B], num_hidden_layers)`` on
    ``device``: the card unless the caller asks for the CPU (the tree moves
    there if it is not already). It always runs the full stack."""

    def __init__(
        self,
        cfg: DecoderConfig,
        params: Dict[str, Any],
        tokenizer,
        max_length: int = 1024,
        seq_bucket: int = 128,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _tree_to(params, self.device)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.seq_bucket = seq_bucket
        self.padding_side = getattr(tokenizer, "padding_side", None) or "left"
        # the scorer protocol's attribute (LLMRerank saves and restores it)
        self.cutoff_layer = cfg.num_hidden_layers
        self.yes_row = yes_row(self.params, tokenizer("Yes", add_special_tokens=False)["input_ids"][0])

    @classmethod
    def from_pretrained(cls, model_dir: str, quant: str = "", device="cuda", **kwargs) -> "YesLogitScorer":
        """A local Qwen2 causal-LM checkpoint directory -> the scorer
        (``quant``: "", "int8" or "w8a8"; w8a8 sets ``cfg.act_quant``, as
        JAX's does; an int4 untied head raises at construction)."""
        from transformers import AutoTokenizer

        from .hf_loader import load_decoder_params, load_hf_config
        from .qwen2 import qwen2_config_from_hf

        device = resolve_device(device)
        cfg = qwen2_config_from_hf(load_hf_config(model_dir), act_quant=quant == "w8a8")
        params = load_decoder_params(model_dir, cfg.num_hidden_layers, quant=quant, device=device)
        tok = AutoTokenizer.from_pretrained(model_dir, trust_remote_code=True)
        return cls(cfg, params, tok, device=device, **kwargs)

    def build_inputs(self, pairs: List[Tuple[str, str]]) -> Tuple[np.ndarray, np.ndarray]:
        return build_pair_inputs(self.tokenizer, pairs, self.max_length, self.seq_bucket, self.padding_side)

    @torch.inference_mode()
    def score_pairs(self, pairs: List[Tuple[str, str]], judge: bool = False) -> Tuple[np.ndarray, int]:
        """Score one batch; ``judge`` is accepted for ``LLMRerank`` and
        ignored (no early exit)."""
        ids, mask = self.build_inputs(pairs)
        dev = self.device
        h = forward_hidden(self.cfg, self.params, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        last = torch.from_numpy(last_real_index(mask)).to(dev)
        pooled = h[torch.arange(h.shape[0], device=dev), last].float()
        return (pooled @ self.yes_row).cpu().numpy(), self.cfg.num_hidden_layers
