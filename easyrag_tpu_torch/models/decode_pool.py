"""Continuous batching for on-device generation: the decode pool (port of
``easyrag_tpu/models/decode_pool.py``).

Requests join a running decode at chunk boundaries instead of waiting for a
window to fill (``generation.BatchingLocalLLM``): under serving, the rerank
stage staggers arrivals into the generation stage, so windows rarely
coincide and batched decodes mostly run one row. The pool keeps one state
per slot tier and admits a request into a free slot between chunks:

* **slot tiers** -- slots come in per-bucket size tiers (``tiers=[(2048, 2),
  (7680, 2)]``): a slot holds ``bucket + max_new`` cache slots, so a short
  prompt does not reserve the largest bucket's KV. A request lands in the
  smallest tier that fits its prompt bucket and overflows upward when that
  tier is full. Only tiers with live rows run.
* **admission** -- the prompt is prefilled alone at its own bucket
  (:func:`prefill_only`, K3 where the JAX package takes the stock flash
  kernel) and spliced into a free slot (:func:`pool_insert`).
* **chunks** -- :func:`pool_chunk` runs up to ``chunk_steps`` decode steps
  over a tier's live rows (:func:`pool_chunk_spec` up to ``chunk_steps``
  verify blocks with prompt-lookup drafts when the LLM speculates). Rows
  write their own cache slots (``gen_base + n``) and take RoPE at their true
  positions (``lengths + n``); per-row semantics are JAX's exactly: write
  the pending token at ``out[i, n]``, mark EOS, validate its slot, advance,
  freeze finished rows.

Each row's tokens equal a solo ``generate_greedy`` of its prompt at B=1
(``tests/test_torch_decode_pool.py``, and on the card ``chip_smoke.py``
phase 10): the projections (K2 on int4 trees) give the same bits at every
row count, and a step takes its norms and its cache attention one row at a
time with the solo run's shapes, over the row's own ``bucket + max_new``
slots (``decode.PoolRows``).

What differs from JAX: the state is updated in place (nothing is donated);
a chunk is a Python loop that reads the rows' ``done`` flags back once per
step (JAX's ``while_loop`` exits on the device) and runs only the live rows;
a speculative tier's cache holds ``spec_tokens`` spare slots past its end
for the block writes JAX drops (``mode="drop"``), which feed no emitted
token.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .decode import (
    PoolRows,
    _decode_layer,
    _dtype,
    _is_eos,
    _lm_logits,
    _ngram_draft,
    _pad_left,
    _prefill,
    _row_norm,
    _verify_layer,
    init_cache,
)
from .layers import DecoderConfig, embed, rope_tables

PoolState = Dict[str, Any]


def pool_init(
    cfg: DecoderConfig, pool_size: int, total_len: int, max_new: int, dtype: torch.dtype, device, spare: int = 0
) -> PoolState:
    """A fresh tier state on ``device``: every slot free (``done`` true).
    The caches hold ``total_len + spare`` slots (``spare``: a speculative
    block's writes past the end)."""
    b, t, m = pool_size, total_len, max_new

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "caches": init_cache(cfg, b, t + spare, dtype, device),
        "kv_mask": zeros(b, t, dtype=torch.bool),
        "tok": zeros(b),  # next input token (the last emitted)
        "n": zeros(b),  # tokens recorded in out per row
        "done": torch.ones(b, dtype=torch.bool, device=device),
        "lengths": zeros(b),  # true prompt lengths (RoPE)
        "gen_base": zeros(b),  # the row's prefill bucket
        "buf": zeros(b, t),  # token history (spec drafts)
        "out": zeros(b, m),
    }


@torch.inference_mode()
def prefill_only(
    cfg: DecoderConfig,
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [1, S] LEFT-padded to the length bucket
    attention_mask: torch.Tensor,  # [1, S]
) -> Tuple[torch.Tensor, list]:
    """Prompt forward at the request's own bucket: the first greedy token
    ``[1]`` and an S-slot cache to splice into the pool."""
    b, s = input_ids.shape
    cache = init_cache(cfg, b, s, _dtype(params), input_ids.device)
    first = _lm_logits(cfg, params, _prefill(cfg, params, input_ids, attention_mask, cache)).argmax(-1)
    return first.to(torch.int32), cache


@torch.inference_mode()
def pool_insert(
    state: PoolState,
    slot: int,
    prefill_cache: list,  # per-layer {"k"/"v": [1, S, nkv, hd]}
    prefill_ids: torch.Tensor,  # [1, S] LEFT-padded prompt
    prefill_mask: torch.Tensor,  # [1, S]
    first_tok: torch.Tensor,  # [1]
    length: int,  # true prompt length
    eos0: int,  # out-buffer fill value
) -> None:
    """Splice a prefilled request into free slot ``slot``, in place: its KV
    at ``[slot, :S]``, its validity (the prefill mask, every later slot
    invalid, clearing the previous occupant's), its token history (the
    left-padded prompt sits at ``[S - length, S)``) and an ``eos0``-filled
    out row."""
    s = prefill_mask.shape[1]
    for pool_c, pf_c in zip(state["caches"], prefill_cache):
        pool_c["k"][slot, :s] = pf_c["k"][0]
        pool_c["v"][slot, :s] = pf_c["v"][0]
    state["kv_mask"][slot] = False
    state["kv_mask"][slot, :s] = prefill_mask[0] > 0
    state["buf"][slot] = eos0
    state["buf"][slot, :s] = prefill_ids[0]
    state["out"][slot] = eos0
    state["tok"][slot] = first_tok[0]
    state["n"][slot] = 0
    state["done"][slot] = False
    state["lengths"][slot] = length
    state["gen_base"][slot] = s


def _live_rows(state: PoolState, stats: Dict[str, float]) -> List[int]:
    """The rows not done, read back to the host: the pool's one device sync
    per step, timed into ``stats["sync_ms"]``."""
    t0 = time.perf_counter()
    done = state["done"].tolist()
    stats["sync_ms"] = stats.get("sync_ms", 0.0) + (time.perf_counter() - t0) * 1e3
    return [i for i, d in enumerate(done) if not d]


def _rows(live: List[int], gen_base: List[int], max_new: int, device) -> PoolRows:
    """A step's :class:`PoolRows`: each live row attends over the
    ``bucket + max_new`` slots its solo run allocates."""
    return PoolRows(torch.tensor(live, dtype=torch.long, device=device),
                    tuple((i, gen_base[i] + max_new) for i in live))


def _count(stats: Dict[str, float], live: List[int]) -> None:
    stats["steps"] = stats.get("steps", 0) + 1
    stats["row_steps"] = stats.get("row_steps", 0) + len(live)


@torch.inference_mode()
def pool_chunk(
    cfg: DecoderConfig,
    params: Dict[str, Any],
    state: PoolState,
    eos_ids: torch.Tensor,  # [E] int32
    steps: int,
    stats: Optional[Dict[str, float]] = None,
) -> PoolState:
    """Up to ``steps`` decode steps over the tier's live rows, in place.

    Per row, ``decode.generate_greedy``'s body with the global step replaced
    by the row's ``n``: write the pending token at ``out[i, n]``, mark EOS,
    validate the token's cache slot ``gen_base + n``, then the forward at
    RoPE position ``lengths + n`` over the rows still live, advance. Rows
    whose ``n`` froze keep their emitted suffix. A row that records its
    last token this step is done before the forward (the token that forward
    would give is never written). ``stats`` gains ``steps`` (forwards),
    ``row_steps`` (live rows summed over them) and ``sync_ms``."""
    stats = {} if stats is None else stats
    dev = state["tok"].device
    b, t = state["kv_mask"].shape
    m = state["out"].shape[1]
    idx = torch.arange(b, device=dev)
    gen_base = state["gen_base"].tolist()
    dtype = _dtype(params)
    for _ in range(steps):
        tok, n, done = state["tok"], state["n"], state["done"]
        nw = n.clamp(max=m - 1)
        state["out"][idx, nw] = torch.where(done, state["out"][idx, nw], tok)
        done |= _is_eos(tok, eos_ids)
        pos = (state["gen_base"] + n).clamp(max=t - 1)
        state["kv_mask"][idx, pos] = ~done
        rope_pos = state["lengths"] + n
        n += (~done).to(torch.int32)
        done |= n >= m
        live = _live_rows(state, stats)
        if not live:
            break
        _count(stats, live)
        rows = _rows(live, gen_base, m, dev)
        r = rows.index
        cos, sin = rope_tables(rope_pos[r][:, None], cfg.hd, cfg.rope_theta)
        kv_valid = state["kv_mask"][r]
        h = embed(cfg, params["embed"], tok[r][:, None], dtype)
        for li in range(cfg.num_hidden_layers):
            h = _decode_layer(cfg, params["layers"][li], h, pos[r], kv_valid, cos, sin, state["caches"][li], rows=rows)
        h = _row_norm(h, params["final_norm"], cfg.rms_norm_eps, per_row=True)[:, 0]
        tok[r] = _lm_logits(cfg, params, h).argmax(-1).to(torch.int32)
    return state


@torch.inference_mode()
def pool_chunk_spec(
    cfg: DecoderConfig,
    params: Dict[str, Any],
    state: PoolState,
    eos_ids: torch.Tensor,
    steps: int,
    draft_len: int,
    ngram: int,
    stats: Optional[Dict[str, float]] = None,
) -> PoolState:
    """Speculative chunk: up to ``steps`` verify blocks, in place.

    Each block flushes the pending token as :func:`pool_chunk`'s step does
    (``out[i, n]``, its history entry, EOS, its cache slot), drafts
    ``draft_len`` tokens from the row's history and verifies them in one
    forward over ``draft_len + 1`` positions. A row emits ``1..draft_len +
    1`` tokens by its own greedy acceptance, stopped at an EOS and at its
    room; the last accepted prediction becomes the pending token, so an EOS
    is recorded by the next flush, as :func:`pool_chunk` records it. The
    tokens equal :func:`pool_chunk`'s. ``stats`` as :func:`pool_chunk`'s,
    ``steps`` counting blocks."""
    stats = {} if stats is None else stats
    dev = state["tok"].device
    b, t = state["kv_mask"].shape
    m = state["out"].shape[1]
    k1 = draft_len + 1
    idx = torch.arange(b, device=dev)
    j_idx = torch.arange(k1, device=dev)[None, :]
    t_idx = torch.arange(t, device=dev)[None, :]
    m_idx = torch.arange(m, device=dev)[None, :]
    gen_base = state["gen_base"].tolist()
    dtype = _dtype(params)
    for _ in range(steps):
        tok, n, done = state["tok"], state["n"], state["done"]
        # flush the pending token (pool_chunk's step start)
        nw = n.clamp(max=m - 1)
        state["out"][idx, nw] = torch.where(done, state["out"][idx, nw], tok)
        bpos = (state["gen_base"] + n).clamp(max=t - 1)
        state["buf"][idx, bpos] = torch.where(done, state["buf"][idx, bpos], tok)
        done |= _is_eos(tok, eos_ids)
        state["kv_mask"][idx, bpos] = ~done
        done |= n + 1 >= m  # the flush filled the row's last out slot
        live = _live_rows(state, stats)
        if not live:
            break
        _count(stats, live)
        rows = _rows(live, gen_base, m, dev)
        r = rows.index
        base, length, nr, tk = state["gen_base"][r], state["lengths"][r], n[r], tok[r]
        e = nr + 1  # emitted tokens, the flush included
        # draft and verify block
        draft = _ngram_draft(state["buf"][r], base - length, base + e, ngram, draft_len)
        tokens_in = torch.cat([tk[:, None], draft], dim=1)
        cur = base + nr  # the pending token's cache slot
        slots = cur[:, None] + j_idx
        cos, sin = rope_tables((length + nr)[:, None] + j_idx, cfg.hd, cfg.rope_theta)
        block = (t_idx[:, None, :] >= cur[:, None, None]) & (t_idx[:, None, :] <= slots[:, :, None])
        allowed = state["kv_mask"][r][:, None, :] | block
        h = embed(cfg, params["embed"], tokens_in, dtype)
        for li in range(cfg.num_hidden_layers):
            h = _verify_layer(cfg, params["layers"][li], h, slots, allowed, cos, sin, state["caches"][li], rows=rows)
        h = _row_norm(h, params["final_norm"], cfg.rms_norm_eps, per_row=True)
        preds = _lm_logits(cfg, params, h).argmax(-1).to(torch.int32)  # preds[:, j] follows tokens_in[:, :j+1]
        # greedy acceptance and per-row advance: live rows have room >= 1
        acc = torch.cumprod((draft == preds[:, :-1]).to(torch.int32), dim=1).sum(dim=1)
        first_eos = torch.where(_is_eos(preds, eos_ids), j_idx, k1).min(dim=1).values
        adv = torch.minimum(torch.minimum(acc + 1, first_eos + 1), m - e).to(torch.int32)
        # preds[:, :adv-1] are recorded now (out at e.., history at base+e..,
        # their block slots cur+1.. become valid); preds[adv-1] is pending
        emit_out = (m_idx >= e[:, None]) & (m_idx < (e + adv - 1)[:, None])
        state["out"][r] = torch.where(emit_out, preds.gather(1, (m_idx - e[:, None]).clamp(0, draft_len)),
                                      state["out"][r])
        hist = base + e
        emit_buf = (t_idx >= hist[:, None]) & (t_idx < (hist + adv - 1)[:, None])
        state["buf"][r] = torch.where(emit_buf, preds.gather(1, (t_idx - hist[:, None]).clamp(0, draft_len)),
                                      state["buf"][r])
        state["kv_mask"][r] |= (t_idx > cur[:, None]) & (t_idx < (cur + adv)[:, None])
        tok[r] = preds.gather(1, (adv - 1)[:, None])[:, 0]
        n[r] = nr + adv
    return state


class _Tier:
    """One pool tier: slots sized ``bucket + max_new``."""

    def __init__(self, cfg, bucket: int, slots: int, max_new: int, dtype, device, spare: int) -> None:
        self.bucket = bucket
        self.total_len = bucket + max_new
        self.slots = slots
        self._init = (cfg, slots, self.total_len, max_new, dtype, device, spare)
        self.state = pool_init(*self._init)
        self.free: List[int] = list(range(slots))
        self.live: Dict[int, Any] = {}  # slot -> opaque request handle

    def reset(self) -> None:
        self.state = pool_init(*self._init)
        self.free = list(range(self.slots))
        self.live = {}


class DecodePool:
    """Host-side slot bookkeeping around the pool ops, on the LLM's device
    (``models/decode.py::TorchCausalLM``: the card unless its caller asked
    for the CPU).

    Not thread-safe: the async driver
    (``generation.ContinuousBatchingLocalLLM``) serializes every call, as
    one device runs one dispatch at a time.

    ``tiers`` maps prompt bucket -> slot count (``[(2048, 2), (7680, 2)]``);
    ``None`` keeps one tier of ``pool_size`` slots at the largest bucket.
    Speculation follows the LLM's ``spec_tokens``/``spec_ngram``, as the
    batched path does. ``stats`` sums over every chunk: ``live_rows`` (the
    tier's live rows at each dispatch), ``steps`` (forwards or verify
    blocks), ``row_steps`` (live rows summed over them), ``sync_ms`` (the
    per-step read of the rows' flags) and ``chunk_ms`` (host clock around
    each chunk, which ends in that read)."""

    def __init__(
        self,
        llm,
        pool_size: int = 4,
        chunk_steps: int = 32,
        tiers: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> None:
        if not llm.max_new_tokens:
            raise ValueError(
                "continuous batching needs tpu.local_llm_max_new set: the pool's output buffer is static per row"
            )
        self.llm = llm
        self.cfg: DecoderConfig = llm.cfg
        self.params = llm.params
        self.device = self.params["final_norm"].device
        self.max_new = int(llm.max_new_tokens)
        self.chunk_steps = chunk_steps
        self.spec_tokens = int(getattr(llm, "spec_tokens", 0) or 0)
        self.spec_ngram = int(getattr(llm, "spec_ngram", 2) or 2)
        self.eos_ids = torch.tensor(llm.eos_ids, dtype=torch.int32, device=self.device)
        self.pad_id = llm.tokenizer.pad_token_id or llm.eos_ids[0]
        if tiers is None:
            tiers = [(llm.buckets[-1], pool_size)]
        bad = [b for b, _ in tiers if b not in llm.buckets]
        if bad:
            raise ValueError(f"pool tier buckets {bad} are not prompt buckets {llm.buckets}")
        self.tiers = [
            _Tier(self.cfg, bucket, slots, self.max_new, _dtype(self.params), self.device, self.spec_tokens)
            for bucket, slots in sorted(tiers)
        ]
        self.pool_size = sum(t.slots for t in self.tiers)
        self.chunks = 0  # chunk dispatches (observability/tests)
        self.joins = 0  # inserts that joined an already-live pool
        self.stats: Dict[str, float] = {}

    # -- admission ---------------------------------------------------------

    def fits(self, token_ids: Sequence[int]) -> bool:
        """True when some tier can ever hold this prompt's bucket."""
        bucket = next((b for b in self.llm.buckets if len(token_ids) <= b), None)
        return bucket is not None and bucket <= self.tiers[-1].bucket

    def can_admit(self, token_ids: Sequence[int]) -> bool:
        """True when some tier that fits this prompt has a free slot."""
        bucket = next((b for b in self.llm.buckets if len(token_ids) <= b), None)
        if bucket is None:
            return False
        return any(t.bucket >= bucket and t.free for t in self.tiers)

    def insert(self, token_ids: Sequence[int], handle: Any) -> int:
        """Prefill and splice into a free slot; returns the flat slot index.
        The smallest tier that holds the prompt's bucket takes it, larger
        tiers when it is full."""
        bucket = next(b for b in self.llm.buckets if len(token_ids) <= b)
        tier = next((t for t in self.tiers if t.bucket >= bucket and t.free), None)
        if tier is None:
            raise RuntimeError("decode pool full")
        return self._insert_into(tier, bucket, token_ids, handle)

    def _insert_into(self, tier: _Tier, bucket: int, token_ids, handle) -> int:
        slot = tier.free.pop()
        row, mask = _pad_left(list(token_ids), bucket, self.pad_id)
        ids = torch.tensor([row], dtype=torch.int32, device=self.device)
        mask_t = torch.tensor([mask], dtype=torch.int32, device=self.device)
        first, cache = prefill_only(self.cfg, self.params, ids, mask_t)
        if self.active:
            self.joins += 1
        pool_insert(tier.state, slot, cache, ids, mask_t, first, len(token_ids), self.llm.eos_ids[0])
        tier.live[slot] = handle
        base = sum(t.slots for t in self.tiers[: self.tiers.index(tier)])
        return base + slot

    @property
    def active(self) -> bool:
        return any(t.live for t in self.tiers)

    @property
    def free(self) -> List[int]:
        """Flat free-slot view (slot indices offset by tier)."""
        out, base = [], 0
        for t in self.tiers:
            out.extend(base + s for s in t.free)
            base += t.slots
        return out

    @property
    def live(self) -> Dict[int, Any]:
        """Flat live view (flat slot index -> handle)."""
        out, base = {}, 0
        for t in self.tiers:
            out.update({base + s: h for s, h in t.live.items()})
            base += t.slots
        return out

    # -- decode ------------------------------------------------------------

    def run_chunk(self) -> List[Tuple[Any, List[int]]]:
        """One chunk per tier with live rows; harvest the finished rows as
        ``(handle, tokens)``."""
        finished = []
        for tier in self.tiers:
            if not tier.live:
                continue
            self.stats["live_rows"] = self.stats.get("live_rows", 0) + len(tier.live)
            t0 = time.perf_counter()
            if self.spec_tokens:
                pool_chunk_spec(self.cfg, self.params, tier.state, self.eos_ids, self.chunk_steps, self.spec_tokens,
                                self.spec_ngram, stats=self.stats)
            else:
                pool_chunk(self.cfg, self.params, tier.state, self.eos_ids, self.chunk_steps, stats=self.stats)
            self.chunks += 1
            done = tier.state["done"].tolist()
            self.stats["chunk_ms"] = self.stats.get("chunk_ms", 0.0) + (time.perf_counter() - t0) * 1e3
            for slot in list(tier.live):
                if done[slot]:
                    finished.append((tier.live.pop(slot), tier.state["out"][slot].tolist()))
                    tier.free.append(slot)
        return finished

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        for tier in self.tiers:
            tier.reset()

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """One prefill and insert per (tier, bucket) a request can land in
        and one chunk per tier, off the request path (the kernels' builds
        and the allocator's first blocks), then reset. Inserts target the
        tier directly (``insert``'s routing would send a small bucket's
        dummy to the small tier)."""
        for tier in self.tiers:
            cands = [b for b in (buckets or self.llm.buckets) if b <= tier.bucket]
            for bucket in cands:
                bucket = next(b for b in self.llm.buckets if bucket <= b)
                if not tier.free:
                    # fewer slots than buckets: drain, keep warming
                    self.run_chunk()
                    tier.free, tier.live = list(range(tier.slots)), {}
                # pad_id is always a valid token (an EOS id may be a
                # sentinel that never fires)
                self._insert_into(tier, bucket, [self.pad_id] * bucket, None)
            self.run_chunk()
        self.reset()
