"""Plain PyTorch reference of the bge-reranker-v2-minicpm-layerwise scorer.

Follows the published model: a MiniCPM decoder (RMSNorm, rotate-half RoPE,
multi-head attention, SiLU MLP, residual branches scaled by
``scale_depth / sqrt(num_hidden_layers)``, embeddings by ``scale_emb``), run
to the cutoff layer; the score is that layer's head on the final RMSNorm of
the last real token's hidden state, divided by ``hidden_size /
dim_model_base``. The input is the checkpoint's pair format: ``<bos> "A: "
query`` (at most 3/4 of ``max_length``), ``"\\n" "B: " passage`` cut so the
two fit ``max_length``, then ``"\\n"`` and the yes/no prompt.

Rows are right padded and attention is causal, so padding is never read by
a real token. ``quant="w8a8"`` is the control: every projection with int8
weights (per output channel) and int8 activations (per token), the precision
one step below the configuration's bf16, as the port's own w8a8 path
quantizes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PROMPT = (
    "Given a query A and a passage B, determine whether the passage "
    "contains an answer to the query by providing a prediction of "
    "either 'Yes' or 'No'."
)


def pair_ids(tokenizer, query: str, passage: str, max_length: int) -> List[int]:
    """One pair's token ids in the checkpoint's format."""
    tk = tokenizer
    q_ids = tk(f"A: {query}", max_length=max_length * 3 // 4, truncation=True)["input_ids"]
    p_ids = tk(f"B: {passage}", max_length=max_length, truncation=True)["input_ids"]
    sep = tk("\n")["input_ids"]
    first = [tk.bos_token_id] + q_ids
    second = (sep + p_ids)[: max(max_length - len(first), 0)]
    return first + second + sep + tk(PROMPT)["input_ids"]


def quantize_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per row of the last axis: ``(q int8, scale f32 [..., 1])``."""
    amax = w.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    return torch.round(w.float() / scale).clamp_(-127, 127).to(torch.int8), scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b.T`` of int8 matrices, as f32 (int32 on the card)."""
    if a.device.type == "cuda":
        m = a.shape[0]
        pad = max(17 - m, 0)  # torch._int_mm wants more than 16 rows
        a = F.pad(a, (0, 0, 0, pad)) if pad else a
        return torch._int_mm(a, b.t())[:m].float()
    return (a.double() @ b.double().t()).float()


class MiniCPMReference:
    """The scorer over weights from :func:`weights.minicpm_weights` (drawn
    in bf16). ``precision``: "bf16" computes in bf16 with f32 norms, RoPE
    and softmax, as a plain bf16 deployment would; "tf32" and "f32" compute
    in float32 from the same weights, with TF32 matrix products on or off.
    ``quant="w8a8"`` quantizes every projection as described above."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], quant: str = "", precision: str = "bf16") -> None:
        self.cfg = cfg
        self.precision = precision
        dt = torch.bfloat16 if precision == "bf16" else torch.float32
        self.w = {k: v if k == "heads" else v.to(dt) for k, v in weights.items()}  # the heads are f32
        self.quant = quant
        self._q8: Dict[Tuple[str, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def linear(self, x: torch.Tensor, name: str, layer: int) -> torch.Tensor:
        w = self.w[name][layer]
        if self.quant != "w8a8":
            return x @ w.t()
        key = (name, layer)
        if key not in self._q8:
            self._q8[key] = quantize_rows(w)
        wq, ws = self._q8[key]
        flat = x.reshape(-1, x.shape[-1])
        xq, xs = quantize_rows(flat)
        y = int_matmul(xq, wq) * xs * ws.reshape(1, -1)
        return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[0])

    def rms(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.cfg["rms_norm_eps"])).to(x.dtype)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """Rotate-half RoPE on ``[B, H, S, D]`` at positions ``0..S-1``."""
        S, D = x.shape[2], x.shape[3]
        inv = 1.0 / (self.cfg["rope_theta"] ** (torch.arange(0, D, 2, device=x.device, dtype=torch.float32) / D))
        ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
        ang = torch.cat([ang, ang], dim=-1)
        xf = x.float()
        rot = torch.cat([-xf[..., D // 2:], xf[..., : D // 2]], dim=-1)
        return (xf * ang.cos() + rot * ang.sin()).to(x.dtype)

    def layer(self, h: torch.Tensor, i: int) -> torch.Tensor:
        cfg = self.cfg
        B, S, d = h.shape
        nh = cfg["num_attention_heads"]
        hd = d // nh
        r = cfg["scale_depth"] / cfg["num_hidden_layers"] ** 0.5
        x = self.rms(h)
        q, k, v = (self.linear(x, n, i).reshape(B, S, nh, hd).transpose(1, 2) for n in ("q", "k", "v"))
        a = F.scaled_dot_product_attention(self.rope(q), self.rope(k), v, is_causal=True)
        h = h + self.linear(a.transpose(1, 2).reshape(B, S, d), "o", i) * r
        x = self.rms(h)
        m = F.silu(self.linear(x, "gate", i)) * self.linear(x, "up", i)
        return h + self.linear(m, "down", i) * r

    def score(self, rows: Sequence[Sequence[int]], cutoff: int, batch: int = 16) -> np.ndarray:
        """Scores (float64) of token rows at ``cutoff`` layers, ``batch`` rows
        at a time."""
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.precision == "tf32"
        try:
            return self._score(rows, cutoff, batch)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    @torch.inference_mode()
    def _score(self, rows: Sequence[Sequence[int]], cutoff: int, batch: int) -> np.ndarray:
        cfg, dev = self.cfg, self.w["embed"].device
        out = []
        for lo in range(0, len(rows), batch):
            chunk = rows[lo : lo + batch]
            S = max(len(r) for r in chunk)
            ids = torch.zeros(len(chunk), S, dtype=torch.long)
            for j, r in enumerate(chunk):
                ids[j, : len(r)] = torch.tensor(r)
            last = torch.tensor([len(r) - 1 for r in chunk], device=dev)
            h = self.w["embed"][ids.to(dev)] * cfg["scale_emb"]
            for i in range(cutoff):
                h = self.layer(h, i)
            pooled = self.rms(h[torch.arange(len(chunk), device=dev), last])
            normed = pooled.float() / (cfg["hidden_size"] / cfg["dim_model_base"])
            out.append((normed @ self.w["heads"][cutoff]).double().cpu().numpy())
        return np.concatenate(out) if out else np.zeros(0)
