"""Autoregressive generation: bucketed prefill + KV-cache greedy decode (port
of ``easyrag_tpu/models/decode.py``).

Two phases, as in the JAX package:

* **prefill** -- one causal forward over the prompt padded LEFT to a length
  bucket. Each layer's rotary-encoded K/V land in a preallocated
  ``[B, S + max_new, kv_heads, head_dim]`` cache. Attention runs through the
  K3 port (``ops/flash_attention.py``) where the JAX package runs the stock
  kernel (head_dim and S multiples of 128; the CUDA kernel takes head_dim
  up to 512 and raises past it) and through the einsum
  formulation otherwise; the int4 projections at more than 64 rows unpack
  and take one large ``torch.matmul``.
* **decode** -- single-token steps (or, with speculation, verify blocks of
  ``draft_len + 1`` tokens): projections through K2 for int4 trees, rotary at
  the true per-row position, attention against the cache (two cuBLAS
  products, f32 logits) with a validity mask (``finfo(f32).min`` on invalid slots, never ``-inf``), and a
  greedy argmax over the LM head. A verify block takes the two ops whose
  rounding depends on its row count one block position at a time, with a
  single step's shapes (``tools/torch_probe_verify.py`` found both on the
  H100): the cache attention's cuBLAS products over the same ``S + max_new``
  slots (cuBLAS picks its tiling by the number of query rows) and the
  RMSNorms' f32 mean of squares (torch splits a row's reduction differently
  at ``B * Q`` rows than at ``B``, which flips a bf16 rounding of the output
  now and then). So on the card the tokens equal plain greedy's bit for bit
  wherever the projections are row-invariant too (K2's int4 path; a dense
  cuBLAS projection is not). A decode-pool step (``models/decode_pool.py``,
  :class:`PoolRows`) also takes them one row at a time, each over the row's
  own ``bucket + max_new`` slots, so a pool row's tokens equal its solo run's
  at B=1.

What differs from JAX: the KV cache and the token buffers are updated IN
PLACE (JAX's arrays are immutable); the loops are Python loops that read
one flag back from the device per step to stop as soon as every row is done
(JAX's ``while_loop`` does the same on the device); out-of-range writes of a
verify block go to spare slots past the end instead of being dropped, and
those slots feed no emitted token.

The parameter tree is the JAX package's (nested dicts, ``models/layers.py``
linears), so trees convert leaf by leaf (``models/convert.py``). Every
layer runs through ``layers.decoder_layer`` with its phase's cache-writing
attention. A tensor-parallel tree (``parallel/tp.py``) has one KV cache per
shard on the shard's device, K3 and the cache attention per shard at its
head counts, the row-parallel sums, norms, embedding and head on the first
device. The decode pool's rows (:class:`PoolRows`) take unsharded trees
only, as JAX's pool does.
"""

from __future__ import annotations

import json
import os
import time
from functools import partial
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..devices import resolve_device
from ..ops.flash64 import apply_rope
from ..ops.flash_attention import flash_attention, flash_attention_plain
from .layers import (
    EAGER,
    DecoderConfig,
    decoder_layer,
    embed,
    linear,
    norm_chain,
    rms_norm,
    rope_tables,
    shard_config,
    tp_devices,
)

Cache = List[Dict[str, torch.Tensor]]
MASK_VALUE = float(torch.finfo(torch.float32).min)


def _dtype(params: Dict[str, Any]) -> torch.dtype:
    """The tree's compute dtype (that of its norms)."""
    return params["final_norm"].dtype


def init_cache(cfg: DecoderConfig, batch: int, total_len: int, dtype: torch.dtype, device) -> Cache:
    """Per-layer K/V buffers, rotary already applied at write time. A list
    of devices (a tensor-parallel tree's shards, ``layers.tp_devices``)
    gives each layer one buffer pair per shard, on the shard's device with
    its ``nkv / mp`` heads."""
    if isinstance(device, (list, tuple)):
        scfg = shard_config(cfg, len(device))
        per_shard = [init_cache(scfg, batch, total_len, dtype, d) for d in device]
        return [list(layer) for layer in zip(*per_shard)]
    shape = (batch, total_len, cfg.num_key_value_heads, cfg.hd)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.num_hidden_layers)
    ]


def use_flash(hd: int, s: int) -> bool:
    """The JAX prefill's gate for the stock flash kernel (``hd % 128 == 0 and
    S % 128 == 0``)."""
    return hd % 128 == 0 and s % 128 == 0


def _prefill_layer(
    cfg: DecoderConfig,
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, S, D]
    cos: torch.Tensor,  # [B, S, hd]
    sin: torch.Tensor,
    kv_start: torch.Tensor,  # [B] int32: first real slot (left padding)
    kv_end: torch.Tensor,  # [B] int32
    cache: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """One decoder layer over the full prompt; K/V land in ``cache[:, :S]``
    (a tensor-parallel layer: in each shard's cache, its attention at the
    shard's head counts)."""
    return decoder_layer(cfg, p, x, lambda sh, scfg, q, k, v: _prefill_attend(
        scfg, q, k, v, *_on_shard(q, sh, cache, cos, sin, kv_start, kv_end)))


def _on_shard(q: torch.Tensor, shard: int, cache, *inputs) -> list:
    """``inputs`` on ``q``'s device (ints as they are), then the layer's
    cache on ``shard`` (a tensor-parallel layer's is a list, :func:`init_cache`)."""
    return [t if isinstance(t, int) else t.to(q.device) for t in inputs] + [
        cache[shard] if isinstance(cache, list) else cache]


def _prefill_attend(cfg: DecoderConfig, q, k, v, cos, sin, kv_start, kv_end, cache) -> torch.Tensor:
    """The prefill's attention between the projections: RoPE, the cache
    write, then K3 or its plain version; ``[B, S, nh * hd]``."""
    b, s = q.shape[:2]
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    # K3 wherever the JAX package runs the stock kernel; its einsum path elsewhere.
    # The CUDA kernel takes head_dim up to 512 and raises past it.
    attend = flash_attention if use_flash(hd, s) else flash_attention_plain
    return attend(
        q.reshape(b, s, nh * hd), k.reshape(b, s, nkv * hd), v.reshape(b, s, nkv * hd).contiguous(),
        kv_start, kv_end, hd ** -0.5, nkv,
    )


def _cache_operands(cache: Dict[str, torch.Tensor], t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``t`` cache slots as :func:`_attend_cache`'s operands, made
    once per layer: f32 keys and the values, each ``[B * nkv, t, hd]`` and
    contiguous whatever the cache's length."""
    b, _, nkv, hd = cache["k"].shape
    keys = cache["k"][:, :t].transpose(1, 2).to(torch.float32, memory_format=torch.contiguous_format)
    values = cache["v"][:, :t].transpose(1, 2).contiguous()
    return keys.reshape(b * nkv, t, hd), values.reshape(b * nkv, t, hd)


def _attend_cache(
    cfg: DecoderConfig, q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, allowed: torch.Tensor, dtype
) -> torch.Tensor:
    """Queries ``[B, Q, nh, hd]`` against :func:`_cache_operands`' keys and
    values, ``allowed`` ``[B, Q, T]``; f32 logits and softmax, probabilities
    in ``dtype``; ``[B, Q, nh * hd]``. Both products run one position at a
    time with a single step's shapes (cuBLAS picks its tiling by the number
    of query rows); the scale, mask and softmax round each row on its own
    and run over all positions at once."""
    b, qn = q.shape[:2]
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    g, t = nh // nkv, keys.shape[1]
    qf, kt = q.float(), keys.transpose(1, 2)
    logits = torch.stack([torch.bmm(qf[:, j].reshape(b * nkv, g, hd), kt) for j in range(qn)]) * hd ** -0.5
    logits = torch.where(allowed.transpose(0, 1)[:, :, None, None], logits.view(qn, b, nkv, g, t), MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(dtype).view(qn, b * nkv, g, t)
    out = torch.stack([torch.bmm(probs[j], values) for j in range(qn)])  # [Q, B * nkv, g, hd]
    return out.view(qn, b, nh * hd).transpose(0, 1)


def _position_means(xf: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """``[B, Q, 1]`` f32 means of squares of ``xf`` ``[B, Q, D]``, each
    position's reduced over a ``[B, 1, D]`` slice, as a single step reduces
    its ``[B, 1, D]``: torch splits a row's reduction differently at
    ``B * Q`` rows than at ``B``. ``per_row`` reduces each ``[1, 1, D]``
    slice alone, as a single step at B=1 does (the decode pool's rows)."""
    sq = xf.pow(2)
    if per_row:
        return torch.cat([
            torch.cat([sq[r : r + 1, j : j + 1].mean(dim=-1, keepdim=True) for j in range(xf.shape[1])], dim=1)
            for r in range(xf.shape[0])
        ])
    return torch.cat([sq[:, j : j + 1].mean(dim=-1, keepdim=True) for j in range(xf.shape[1])], dim=1)


def _row_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, per_row: bool = False) -> torch.Tensor:
    """:func:`rms_norm` of a verify block ``[B, Q, D]`` with
    :func:`_position_means`; the rest is elementwise, in :func:`rms_norm`'s
    order."""
    xf = x.float()
    return (xf * torch.rsqrt(_position_means(xf, per_row) + eps) * weight.float()).to(x.dtype)


#: the verify block's chain (:func:`_row_norm`) and the decode pool's, whose
#: norms reduce each row alone
_ROW_CHAIN = norm_chain(_row_norm)
_POOL_CHAIN = norm_chain(partial(_row_norm, per_row=True))


class PoolRows(NamedTuple):
    """The rows of a decode-pool step (``models/decode_pool.py``): row ``r``
    of the step's input is cache row ``spans[r][0]`` and attends over that
    row's first ``spans[r][1]`` cache slots, the length a solo run of the
    row's prompt bucket allocates. ``index`` holds the cache rows on the
    device. Norms and cache attention then run one row at a time with a
    single step's shapes at B=1, so each row rounds as its solo run does."""

    index: torch.Tensor  # [R] int64
    spans: Tuple[Tuple[int, int], ...]


def _attend_rows(cfg: DecoderConfig, q: torch.Tensor, cache: Dict[str, torch.Tensor], allowed: torch.Tensor,
                 rows: PoolRows, dtype) -> torch.Tensor:
    """:func:`_attend_cache` one pool row at a time over its own cache row
    and length; ``q`` ``[R, Q, nh, hd]``, ``allowed`` ``[R, Q, T]``."""
    outs = []
    for r, (c, t) in enumerate(rows.spans):
        one = {"k": cache["k"][c : c + 1], "v": cache["v"][c : c + 1]}
        outs.append(_attend_cache(cfg, q[r : r + 1], *_cache_operands(one, t), allowed[r : r + 1, :, :t], dtype))
    return torch.cat(outs)


def _decode_layer(
    cfg: DecoderConfig,
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, 1, D]
    pos: int | torch.Tensor,  # the cache slot every row writes, or [B] per-row slots
    kv_valid: torch.Tensor,  # [B, T] bool, this slot included
    cos: torch.Tensor,  # [B, 1, hd]
    sin: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    rows: Optional[PoolRows] = None,
) -> torch.Tensor:
    """One decoder layer over a single-token step. ``pos`` an int: every
    row writes that slot (the uniform left-padded layout). ``pos`` a ``[B]``
    tensor: row ``i`` writes its own slot (JAX's ``_cache_write``), in cache
    row ``rows.index[i]`` when ``rows`` is given, and the norms and the cache
    attention then run row by row (:class:`PoolRows`). A tensor-parallel
    layer attends on every shard against its cache; the decode pool's rows
    are not sharded."""
    if rows is not None and isinstance(cache, list):  # a tensor-parallel layer's per-shard caches
        raise ValueError("the decode pool runs unsharded trees: tensor-parallel rows are not supported")
    return decoder_layer(cfg, p, x, lambda sh, scfg, q, k, v: _decode_attend(
        scfg, q, k, v, *_on_shard(q, sh, cache, pos, kv_valid, cos, sin), rows, x.dtype),
        EAGER if rows is None else _POOL_CHAIN)


def _decode_attend(cfg: DecoderConfig, q, k, v, pos, kv_valid, cos, sin, cache, rows, dtype) -> torch.Tensor:
    """A single step's attention between the projections: RoPE, the cache
    write at ``pos``, attention over the cache; ``[B, 1, nh * hd]``."""
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if isinstance(pos, int):
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
    else:
        index = rows.index if rows is not None else torch.arange(q.shape[0], device=q.device)
        cache["k"][index, pos] = k[:, 0]
        cache["v"][index, pos] = v[:, 0]
    if rows is not None:
        return _attend_rows(cfg, q, cache, kv_valid[:, None, :], rows, dtype)
    return _attend_cache(cfg, q, *_cache_operands(cache, kv_valid.shape[1]), kv_valid[:, None, :], dtype)


def _verify_layer(
    cfg: DecoderConfig,
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, Q, D]: the draft block
    slots: torch.Tensor,  # [B, Q] cache slots these tokens occupy
    allowed: torch.Tensor,  # [B, Q, T] visibility: valid cache slots + the block's causal triangle
    cos: torch.Tensor,  # [B, Q, hd]
    sin: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    rows: Optional[PoolRows] = None,
) -> torch.Tensor:
    """One decoder layer over a speculative verify block. K/V of every
    position are written first; rejected slots are never marked valid and
    the next block overwrites them. The cache attention (over the first
    ``T`` cache slots, its operands made once for the block) and the norms'
    reductions run one position at a time with :func:`_decode_layer`'s
    shapes, so each row rounds as a single step does; the projections take
    all ``B*Q`` rows at once. With ``rows`` (a decode pool's step) row ``r``
    is cache row ``rows.index[r]``, and norms and attention also run one row
    at a time (:class:`PoolRows`). A tensor-parallel layer attends on every
    shard against its cache with the same per-position shapes."""
    if rows is not None and isinstance(cache, list):  # a tensor-parallel layer's per-shard caches
        raise ValueError("the decode pool runs unsharded trees: tensor-parallel rows are not supported")
    return decoder_layer(cfg, p, x, lambda sh, scfg, q, k, v: _verify_attend(
        scfg, q, k, v, *_on_shard(q, sh, cache, slots, allowed, cos, sin), rows, x.dtype),
        _ROW_CHAIN if rows is None else _POOL_CHAIN)


def _verify_attend(cfg: DecoderConfig, q, k, v, slots, allowed, cos, sin, cache, rows, dtype) -> torch.Tensor:
    """A verify block's attention between the projections: RoPE, the cache
    writes at ``slots``, attention over the cache one position at a time;
    ``[B, Q, nh * hd]``."""
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    index = rows.index if rows is not None else torch.arange(q.shape[0], device=q.device)
    cache["k"][index[:, None], slots] = k
    cache["v"][index[:, None], slots] = v
    if rows is not None:
        return _attend_rows(cfg, q, cache, allowed, rows, dtype)
    return _attend_cache(cfg, q, *_cache_operands(cache, allowed.shape[-1]), allowed, dtype)


def _lm_logits(cfg: DecoderConfig, params: Dict[str, Any], h: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden ``[..., D]`` -> f32 vocab logits."""
    if cfg.dim_model_base:  # MiniCPM logit scaling
        h = h / (cfg.hidden_size / cfg.dim_model_base)
    head = params.get("lm_head")
    if head is None:  # tied embeddings; an int8 table doubles as an int8 head
        emb = params["embed"]
        head = emb if isinstance(emb, dict) else {"w": emb}
    elif not isinstance(head, dict):
        head = {"w": head}
    return linear(h, head).float()


def _prefill(
    cfg: DecoderConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, S] LEFT-padded
    attention_mask: torch.Tensor,  # [B, S]
    cache: Cache,
) -> torch.Tensor:
    """Prompt forward; returns the final-normed hidden of the last slot
    ``[B, D]`` (left padding: the last real token)."""
    b, s = input_ids.shape
    lengths = attention_mask.sum(dim=1).to(torch.int32)
    pos = torch.arange(s, dtype=torch.int32, device=input_ids.device)
    positions = torch.clamp(pos[None, :] - (s - lengths)[:, None], min=0)
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    kv_start = (s - lengths).to(torch.int32)
    kv_end = torch.full_like(kv_start, s)
    h = embed(cfg, params["embed"], input_ids, _dtype(params))
    for idx in range(cfg.num_hidden_layers):
        h = _prefill_layer(cfg, params["layers"][idx], h, cos, sin, kv_start, kv_end, cache[idx])
    return rms_norm(h[:, -1], params["final_norm"], cfg.rms_norm_eps)


def _is_eos(tok: torch.Tensor, eos_ids: torch.Tensor) -> torch.Tensor:
    return (tok[..., None] == eos_ids).any(dim=-1)


def _sync_ms(t0: float, device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


@torch.inference_mode()
def generate_greedy(
    cfg: DecoderConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, S] LEFT-padded
    attention_mask: torch.Tensor,  # [B, S]
    eos_ids: torch.Tensor,  # [E]
    max_new_tokens: int,
    limit: Optional[int] = None,  # step cap (<= max_new_tokens)
    active: Optional[torch.Tensor] = None,  # [B] bool; False rows emit EOS only
    stats: Optional[Dict[str, float]] = None,
) -> torch.Tensor:
    """Greedy decode: ``[B, max_new_tokens]`` int32; slots after a row's EOS
    hold ``eos_ids[0]`` (the emitted EOS is kept). Stops once every row is
    done. ``stats``, when given, receives ``prefill_ms``, ``steps`` (decode
    forwards) and ``decode_ms`` (each time ends in a device sync)."""
    dev = input_ids.device
    b, s = input_ids.shape
    eos0 = int(eos_ids[0])
    t0 = time.perf_counter()
    cache = init_cache(cfg, b, s + max_new_tokens, _dtype(params), tp_devices(params) or dev)
    lengths = attention_mask.sum(dim=1).to(torch.int32)
    tok = _lm_logits(cfg, params, _prefill(cfg, params, input_ids, attention_mask, cache)).argmax(-1)
    if stats is not None:
        stats["prefill_ms"] = _sync_ms(t0, dev)
        t0 = time.perf_counter()
    kv_valid = torch.cat([attention_mask > 0, torch.zeros(b, max_new_tokens, dtype=torch.bool, device=dev)], dim=1)
    out = torch.full((b, max_new_tokens), eos0, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev) if active is None else ~active.to(dev)
    step_cap = max_new_tokens if limit is None else min(limit, max_new_tokens)
    step = 0
    while step < step_cap and not bool(done.all()):
        out[:, step] = torch.where(done, eos0, tok)
        done = done | _is_eos(tok, eos_ids)
        step += 1
        if step == step_cap or bool(done.all()):
            break  # the token this step would produce is never written
        pos = s + step - 1  # uniform cache slot (left padding)
        kv_valid[:, pos] = ~done
        cos, sin = rope_tables((lengths + step - 1)[:, None], cfg.hd, cfg.rope_theta)
        h = embed(cfg, params["embed"], tok[:, None], _dtype(params))
        for idx in range(cfg.num_hidden_layers):
            h = _decode_layer(cfg, params["layers"][idx], h, pos, kv_valid, cos, sin, cache[idx])
        h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)[:, 0]  # [B, 1, D], as a verify position
        tok = _lm_logits(cfg, params, h).argmax(-1)
    if stats is not None:
        stats["steps"] = max(step - 1, 0)
        stats["decode_ms"] = _sync_ms(t0, dev)
    return out


def _ngram_draft(
    buf: torch.Tensor,  # [B, L] token history (left-padded prompt + emitted)
    start: torch.Tensor,  # [B] first valid index
    end: torch.Tensor,  # [B] one past the last valid index
    ngram: int,
    draft_len: int,
) -> torch.Tensor:
    """Prompt-lookup drafts: the ``draft_len`` tokens that followed the most
    recent earlier occurrence of the row's trailing ``ngram``. Rows without
    a match draft clamped garbage; verification rejects it, so drafts change
    speed, never output."""
    b, l = buf.shape
    dev = buf.device
    rows = torch.arange(b, device=dev)[:, None]
    key = buf[rows, torch.clamp(end[:, None] - ngram + torch.arange(ngram, device=dev), 0, l - 1)]
    pos = torch.arange(l, device=dev)[None, :]  # window END index
    match = torch.ones(b, l, dtype=torch.bool, device=dev)
    for j in range(ngram):
        shifted = torch.cat([torch.zeros(b, j, dtype=buf.dtype, device=dev), buf[:, : l - j]], dim=1)
        match &= shifted == key[:, ngram - 1 - j][:, None]
    match &= pos - (ngram - 1) >= start[:, None]  # window inside the valid range
    match &= pos <= end[:, None] - 1 - draft_len  # and the whole draft too
    best = torch.where(match, pos, -1).max(dim=1).values
    src = torch.clamp(best[:, None] + 1 + torch.arange(draft_len, device=dev), 0, l - 1)
    return buf[rows, src]


@torch.inference_mode()
def generate_greedy_spec(
    cfg: DecoderConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    eos_ids: torch.Tensor,
    max_new_tokens: int,
    draft_len: int = 7,
    ngram: int = 2,
    limit: Optional[int] = None,
    active: Optional[torch.Tensor] = None,
    stats: Optional[Dict[str, float]] = None,
) -> torch.Tensor:
    """Greedy decode with prompt-lookup speculation: each step verifies
    ``draft_len`` drafted tokens in one forward over ``draft_len + 1``
    positions and keeps the leading run equal to the model's own argmax, so
    the tokens equal :func:`generate_greedy`'s (bit for bit where the
    projections are row-invariant, as K2's int4 path is: the block's cache
    attention and norm reductions take the single step's shapes). Rows progress
    independently: cache slots, rope positions and output offsets are per
    row. ``stats`` receives ``prefill_ms``, ``steps`` (verify blocks) and
    ``decode_ms``."""
    dev = input_ids.device
    b, s = input_ids.shape
    k1 = draft_len + 1
    t_total = s + max_new_tokens
    t_cache = t_total + draft_len  # a late block's slots past t_total feed no emitted token
    eos0 = int(eos_ids[0])
    t0 = time.perf_counter()
    cache = init_cache(cfg, b, t_cache, _dtype(params), tp_devices(params) or dev)
    lengths = attention_mask.sum(dim=1).to(torch.int32)
    first = _lm_logits(cfg, params, _prefill(cfg, params, input_ids, attention_mask, cache)).argmax(-1)
    if stats is not None:
        stats["prefill_ms"] = _sync_ms(t0, dev)
        t0 = time.perf_counter()
    done = torch.zeros(b, dtype=torch.bool, device=dev) if active is None else ~active.to(dev)
    first = torch.where(done, eos0, first).to(torch.int32)
    step_cap = max_new_tokens if limit is None else min(limit, max_new_tokens)
    # token history: prompt + emitted; `first` is emitted token 0. The last
    # column takes the writes of tokens that are not emitted.
    buf = torch.cat(
        [input_ids.to(torch.int32), torch.full((b, max_new_tokens + 1), eos0, dtype=torch.int32, device=dev)], dim=1
    )
    buf[:, s] = first
    n = torch.ones(b, dtype=torch.int32, device=dev)
    done = done | _is_eos(first, eos_ids) | (n >= step_cap)
    # kv validity: prompt slots from prefill; an emitted token's K/V are
    # written by the verify block that consumes it. The last column again
    # takes the writes of slots that are not accepted.
    kv_valid = torch.cat([attention_mask > 0, torch.zeros(b, t_cache - s + 1, dtype=torch.bool, device=dev)], dim=1)
    start = s - lengths
    rows = torch.arange(b, device=dev)
    j_idx = torch.arange(k1, device=dev)[None, :]
    # attention sees the first t_total slots, as generate_greedy's cache holds:
    # a slot past them belongs to a position that feeds no emitted token
    t_idx = torch.arange(t_total, device=dev)[None, None, :]
    blocks = 0
    while not bool(done.all()):
        blocks += 1
        last = buf[rows, torch.clamp(s + n - 1, 0, t_total - 1)]
        draft = _ngram_draft(buf[:, :t_total], start, s + n, ngram, draft_len)
        tokens_in = torch.cat([last[:, None], draft], dim=1)
        cur = s + n - 1  # cache slot of `last` = its sequence index
        slots = cur[:, None] + j_idx
        cos, sin = rope_tables((lengths + n - 1)[:, None] + j_idx, cfg.hd, cfg.rope_theta)
        allowed = kv_valid[:, None, :t_total] | ((t_idx >= cur[:, None, None]) & (t_idx <= slots[:, :, None]))
        h = embed(cfg, params["embed"], tokens_in, _dtype(params))
        for idx in range(cfg.num_hidden_layers):
            h = _verify_layer(cfg, params["layers"][idx], h, slots, allowed, cos, sin, cache[idx])
        h = _row_norm(h, params["final_norm"], cfg.rms_norm_eps)
        preds = _lm_logits(cfg, params, h).argmax(-1).to(torch.int32)  # preds[:, j] follows tokens_in[:, :j+1]
        acc = torch.cumprod((draft == preds[:, :-1]).to(torch.int32), dim=1).sum(dim=1)
        first_eos = torch.where(_is_eos(preds, eos_ids), j_idx, k1).min(dim=1).values
        m = torch.minimum(torch.minimum(acc + 1, first_eos + 1), step_cap - n)
        m = torch.where(done, 0, m)
        emit = j_idx < m[:, None]
        buf[rows[:, None], torch.where(emit, (s + n)[:, None] + j_idx, t_total)] = preds
        kv_valid[rows[:, None], torch.where(emit, cur[:, None] + j_idx, t_cache)] = True
        n = n + m
        done = done | ((m > 0) & (first_eos < m)) | (n >= step_cap)
    if stats is not None:
        stats["steps"] = blocks
        stats["decode_ms"] = _sync_ms(t0, dev)
    gen = buf[:, s:t_total]
    return torch.where(torch.arange(max_new_tokens, device=dev)[None, :] < n[:, None], gen, eos0)


def _pad_left(ids: Sequence[int], bucket: int, pad_id: int) -> Tuple[List[int], List[int]]:
    pad = bucket - len(ids)
    return [pad_id] * pad + list(ids), [0] * pad + [1] * len(ids)


def eos_ids_of(model_dir: str, hf: Dict[str, Any], tokenizer) -> List[int]:
    """``config.json``'s EOS ids plus ``generation_config.json``'s, as HF
    ``generate`` honours both (Qwen2-7B-Instruct declares [151643, 151645]
    in the latter, only 151645 in the former)."""
    eos = hf.get("eos_token_id", tokenizer.eos_token_id)
    eos_ids = [eos] if isinstance(eos, int) else list(eos)
    path = os.path.join(model_dir, "generation_config.json")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            g = json.load(f).get("eos_token_id")
        for e in [g] if isinstance(g, int) else (g or []):
            if e not in eos_ids:
                eos_ids.append(e)
    return eos_ids


class TorchCausalLM:
    """The local generation backend of the pipeline's ``local_llm`` option
    (port of ``easyrag_tpu/models/decode.py::JaxCausalLM``): chat template,
    greedy, total length capped at ``MAX_LENGTH``; prompts grouped by length
    bucket, each group one batched dispatch with its batch padded to a power
    of two (padding rows start done)."""

    MAX_LENGTH = 8192

    def __init__(
        self,
        model_dir: str,
        dtype: torch.dtype = torch.bfloat16,
        quant: str = "int8",
        max_new_tokens: Optional[int] = None,
        buckets: Sequence[int] = (256, 512, 1024, 2048, 4096, 7680),
        max_batch: int = 8,
        spec_tokens: int = 0,
        spec_ngram: int = 2,
        device="cuda",
    ) -> None:
        """Load a local Qwen2 checkpoint (``quant``: "", "int8", "w8a8",
        "int4" or "w4a8"; w8a8 and w4a8 set ``cfg.act_quant``; int4 and w4a8
        trees are fused, ``quant.fuse_decode_tree``) onto ``device``: the
        card unless the caller asks for the CPU; without a card it raises."""
        from transformers import AutoTokenizer

        from .hf_loader import load_decoder_params, load_hf_config
        from .quant import fuse_decode_tree
        from .qwen2 import qwen2_config_from_hf

        if not os.path.isdir(model_dir):
            raise FileNotFoundError(f"local LLM: {model_dir!r} is not a local model directory")
        device = resolve_device(device)
        hf = load_hf_config(model_dir)
        cfg = qwen2_config_from_hf(hf, act_quant=quant in ("w8a8", "w4a8"))
        params = load_decoder_params(model_dir, cfg.num_hidden_layers, dtype=dtype, quant=quant, device=device)
        if quant in ("int4", "w4a8"):
            params = fuse_decode_tree(params)
        tokenizer = AutoTokenizer.from_pretrained(model_dir, trust_remote_code=True)
        self._setup(cfg, params, tokenizer, eos_ids_of(model_dir, hf, tokenizer), max_new_tokens, buckets,
                    max_batch, spec_tokens, spec_ngram)

    @classmethod
    def from_params(
        cls,
        cfg: DecoderConfig,
        params: Dict[str, Any],
        tokenizer,
        eos_ids: Sequence[int],
        max_new_tokens: Optional[int] = None,
        buckets: Sequence[int] = (256, 512, 1024, 2048, 4096, 7680),
        max_batch: int = 8,
        spec_tokens: int = 0,
        spec_ngram: int = 2,
    ) -> "TorchCausalLM":
        """A model over an in-memory tree (on the device of its tensors) and
        a tokenizer with ``apply_chat_template``/``decode``/``pad_token_id``."""
        self = cls.__new__(cls)
        self._setup(cfg, params, tokenizer, eos_ids, max_new_tokens, buckets, max_batch, spec_tokens, spec_ngram)
        return self

    def _setup(self, cfg, params, tokenizer, eos_ids, max_new_tokens, buckets, max_batch, spec_tokens, spec_ngram):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.eos_ids = list(eos_ids)
        self.device = params["final_norm"].device
        # None -> generate up to total length MAX_LENGTH; an int caps new tokens
        self.max_new_tokens = max_new_tokens
        self.buckets = tuple(sorted(buckets))
        self.max_batch = max_batch
        self.spec_tokens = spec_tokens  # drafts verified per step, 0 = plain decode
        self.spec_ngram = spec_ngram
        #: per dispatch of the last generate_batch: bucket, batch, prompt and
        #: generated token counts, the real rows' tokens, prefill_ms, steps,
        #: decode_ms
        self.last_stats: List[Dict[str, Any]] = []

    def _encode(self, query: str) -> List[int]:
        ids = self.tokenizer.apply_chat_template([{"role": "user", "content": query}], add_generation_prompt=True)
        # the prompt fits the largest bucket and leaves room for one new token
        cap = min(self.buckets[-1], self.MAX_LENGTH - 1)
        if self.max_new_tokens is not None:
            cap = min(cap, self.MAX_LENGTH - self.max_new_tokens)
        return list(ids[-cap:])

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if n <= b)

    def _bucket_max_new(self, bucket: int) -> int:
        max_new = self.MAX_LENGTH - bucket
        return max_new if self.max_new_tokens is None else min(self.max_new_tokens, max_new)

    def _first_eos(self, toks: List[int]) -> Optional[int]:
        return min((toks.index(e) for e in self.eos_ids if e in toks), default=None)

    def _decode_row(self, toks: List[int]) -> str:
        cut = self._first_eos(toks)
        if cut is not None:
            toks = toks[:cut]
        return self.tokenizer.decode(toks, skip_special_tokens=True)

    def _pad_id(self) -> int:
        return self.tokenizer.pad_token_id or self.eos_ids[0]

    def _run_group(self, rows, masks, max_new: int, n_real: int, limit: Optional[int] = None, stats=None):
        """One batched dispatch; ``[B, max_new]`` int32 on the host."""
        dev = self.device
        b = len(rows)
        ids = torch.tensor(rows, dtype=torch.int32, device=dev)
        mask = torch.tensor(masks, dtype=torch.int32, device=dev)
        eos = torch.tensor(self.eos_ids, dtype=torch.int32, device=dev)
        active = torch.arange(b, device=dev) < n_real
        if self.spec_tokens:
            out = generate_greedy_spec(
                self.cfg, self.params, ids, mask, eos, max_new, draft_len=self.spec_tokens, ngram=self.spec_ngram,
                limit=limit, active=active, stats=stats,
            )
        else:
            out = generate_greedy(self.cfg, self.params, ids, mask, eos, max_new, limit=limit, active=active,
                                  stats=stats)
        return out.cpu()

    def generate(self, query: str) -> str:
        return self.generate_batch([query])[0]

    def generate_batch(self, queries: Sequence[str]) -> List[str]:
        """Batched greedy generation: prompts group by length bucket, each
        group (at most ``max_batch`` rows, padded to a power of two) is one
        dispatch; answers come back in order."""
        encs = [self._encode(q) for q in queries]
        groups: Dict[int, List[int]] = {}
        for i, ids in enumerate(encs):
            groups.setdefault(self._bucket(len(ids)), []).append(i)
        pad_id = self._pad_id()
        out: List[Optional[str]] = [None] * len(queries)
        self.last_stats = []
        for bucket, idxs in groups.items():
            max_new = self._bucket_max_new(bucket)
            dummy = _pad_left([self.eos_ids[0]], bucket, pad_id)
            for lo in range(0, len(idxs), self.max_batch):
                chunk = idxs[lo : lo + self.max_batch]
                b = 1 << (len(chunk) - 1).bit_length()
                rows = [_pad_left(encs[i], bucket, pad_id) for i in chunk] + [dummy] * (b - len(chunk))
                stats: Dict[str, Any] = {"bucket": bucket, "batch": b, "prompt_tokens": [len(encs[i]) for i in chunk]}
                toks = self._run_group([r for r, _ in rows], [m for _, m in rows], max_new, len(chunk), stats=stats)
                stats["tokens"] = [toks[j].tolist() for j in range(len(chunk))]
                stats["new_tokens"] = []
                for i, row in zip(chunk, stats["tokens"]):
                    cut = self._first_eos(row)
                    stats["new_tokens"].append(len(row) if cut is None else cut + 1)  # emitted, the EOS included
                    out[i] = self._decode_row(row)
                self.last_stats.append(stats)
        return out  # type: ignore[return-value]

    def plan_groups(self, queries: Sequence[str]) -> List[Tuple[int, int]]:
        """The ``(bucket, group size)`` plan ``generate_batch`` would use,
        without device work."""
        groups: Dict[int, int] = {}
        for q in queries:
            bucket = self._bucket(len(self._encode(q)))
            groups[bucket] = groups.get(bucket, 0) + 1
        return sorted(groups.items())

    def warmup(
        self,
        buckets: Optional[Sequence[int]] = None,
        batch_sizes: Sequence[int] = (1,),
        pairs: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> None:
        """Run each ``(bucket, B)`` shape once off the request path (prefill
        plus a first step; with speculation, one verify block), so its
        allocations and kernel builds happen here. ``pairs`` gives an
        explicit list; otherwise ``buckets`` x ``batch_sizes``."""
        if pairs is not None:
            work = [(bk, (b,)) for bk, b in pairs]
        else:
            work = [(bk, tuple(batch_sizes)) for bk in (buckets or self.buckets)]
        pad_id = self._pad_id()
        for bucket, sizes in work:
            bucket = self._bucket(bucket)
            dummy = _pad_left([self.eos_ids[0]], bucket, pad_id)
            for b in sizes:
                rows = [dummy] * b
                # the prefill token counts as one emitted: limit 2 reaches a verify block
                self._run_group([r for r, _ in rows], [m for _, m in rows], self._bucket_max_new(bucket), b,
                                limit=2 if self.spec_tokens else 1)
