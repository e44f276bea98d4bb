"""The port's continuous-batching decode pool against the JAX package's.

``easyrag_tpu_torch/models/decode_pool.py`` admits requests into a running
decode at chunk boundaries. Each test here is the analogue of one of
``tests/test_decode_pool.py``: the same tiny decoder (one JAX parameter
tree, given to the port through ``causal_lm_params_from_jax``, f32 on the
CPU), the same prompts and the same joins through JAX's ``DecodePool`` and
the port's. Every row's tokens must equal JAX's pool's exactly, and the
port's own solo ``generate_greedy`` at the row's prompt bucket. A bf16 case
holds the port's pool to the port's solo run alone, and a ``cuda`` case does
so on the card with an int4 tree (K2, the card's norms and cache attention).
"""

import asyncio
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from easyrag_tpu.generation import ContinuousBatchingLocalLLM as JaxWrapper
from easyrag_tpu.models.decode_pool import DecodePool as JaxPool
from easyrag_tpu.models.layers import init_params
from easyrag_tpu_torch.generation import ContinuousBatchingLocalLLM
from easyrag_tpu_torch.models import decode as td
from easyrag_tpu_torch.models.convert import causal_lm_params_from_jax
from easyrag_tpu_torch.models.decode_pool import DecodePool
from easyrag_tpu_torch.models.layers import DecoderConfig

sys.path.insert(0, str(Path(__file__).parent))
from test_decode import VOCAB, tiny_cfg  # noqa: E402
from test_decode_pool import StubLLM as JaxStubLLM  # noqa: E402

torch.set_num_threads(1)

EOS = VOCAB - 1


class StubLLM:
    """The ``TorchCausalLM`` surface ``DecodePool`` consumes, over an
    in-memory tree: cfg, params, buckets, EOS, speculation, and the JAX
    test's byte-level encode and decode."""

    def __init__(self, cfg, params, buckets=(4, 8), max_new=6, eos_ids=(EOS,), spec_tokens=0, spec_ngram=2):
        self.cfg = cfg
        self.params = params
        self.buckets = tuple(buckets)
        self.max_new_tokens = max_new
        self.eos_ids = list(eos_ids)
        self.spec_tokens = spec_tokens
        self.spec_ngram = spec_ngram

        class Tok:
            pad_token_id = 0

        self.tokenizer = Tok()

    _encode = JaxStubLLM._encode
    _decode_row = JaxStubLLM._decode_row


def port_cfg(jcfg) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size, intermediate_size=jcfg.intermediate_size,
        num_hidden_layers=jcfg.num_hidden_layers, num_attention_heads=jcfg.num_attention_heads,
        num_key_value_heads=jcfg.num_key_value_heads,
    )


def pair(seed, dtype=torch.float32, **kw):
    """(JAX's stub LLM, the port's) over one tiny tree from ``seed``; ``kw``
    are the stubs' settings, or ``tiny_cfg``'s under ``"cfg"``."""
    jcfg = tiny_cfg(**kw.pop("cfg", {}))
    params = init_params(jcfg, jax.random.key(seed))
    tp = causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", dtype)
    return JaxStubLLM(jcfg, params, **kw), StubLLM(port_cfg(jcfg), tp, **kw)


def solo(llm, prompt):
    """The oracle: the port's ``generate_greedy`` at B=1, at the bucket
    ``insert`` would pick."""
    bucket = next(b for b in llm.buckets if len(prompt) <= b)
    row, mask = td._pad_left(list(prompt), bucket, 0)
    out = td.generate_greedy(llm.cfg, llm.params, torch.tensor([row], dtype=torch.int32),
                             torch.tensor([mask], dtype=torch.int32), torch.tensor(llm.eos_ids, dtype=torch.int32),
                             llm.max_new_tokens)
    return out[0].tolist()


def harvest(pool, results):
    for handle, toks in pool.run_chunk():
        results[handle] = [int(t) for t in toks]


def both(llms, scenario, **pool_kw):
    """Run ``scenario(pool)`` on JAX's pool and the port's; returns the two
    result dicts and the two pools."""
    jax_llm, port_llm = llms
    pools = JaxPool(jax_llm, **pool_kw), DecodePool(port_llm, **pool_kw)
    return [scenario(p) for p in pools], pools


def assert_rows(llms, results, prompts):
    """Every row equal to JAX's pool's row and to the port's solo run."""
    ref, got = results
    for name, prompt in prompts.items():
        assert got[name] == ref[name], name
        assert got[name] == solo(llms[1], prompt), name


def staggered(prompts):
    def scenario(pool):
        results = {}
        names = list(prompts)
        pool.insert(prompts[names[0]], names[0])
        harvest(pool, results)  # the first row is a chunk in when the second joins
        pool.insert(prompts[names[1]], names[1])
        harvest(pool, results)
        pool.insert(prompts[names[2]], names[2])  # two live rows at different progress
        assert pool.joins == 2
        while pool.active:
            harvest(pool, results)
        return results

    return scenario


PROMPTS = {"a": [3, 1, 4], "b": [1, 5, 9, 2, 6, 5], "c": [8, 9]}


@pytest.mark.parametrize("draft_len", [0, 1, 3])
def test_staggered_joins_match_jax_and_solo(draft_len):
    """Three prompts of different lengths and buckets join a running pool at
    different chunk boundaries (plain, and speculative at two draft
    lengths); every row equals JAX's and its solo run."""
    llms = pair(0, buckets=(4, 8), max_new=6, spec_tokens=draft_len)
    results, _ = both(llms, staggered(PROMPTS), pool_size=3, chunk_steps=2)
    assert_rows(llms, results, PROMPTS)


def test_slot_reuse_after_finish():
    """A freed slot's stale cache and mask do not leak into its next tenant."""
    llms = pair(1, cfg={"num_key_value_heads": 2}, buckets=(4, 8), max_new=4)

    def scenario(pool):
        results = {}
        pool.insert([7, 2, 9, 4, 1], "first")
        while pool.active:
            harvest(pool, results)
        reused = pool.insert([2, 2], "second")  # same slot, smaller bucket
        assert reused == 0 and pool.free == []
        while pool.active:
            harvest(pool, results)
        return results

    results, _ = both(llms, scenario, pool_size=1, chunk_steps=8)
    assert_rows(llms, results, {"first": [7, 2, 9, 4, 1], "second": [2, 2]})


@pytest.mark.parametrize("draft_len", [0, 3])
def test_eos_terminates_row_and_suffix_is_eos_filled(draft_len):
    """A row stops at EOS mid-chunk (plain and speculative); the emitted EOS
    is kept and the suffix is eos0-filled, as generate_greedy fills it."""
    probe = pair(2, buckets=(4,), max_new=5)[1]
    free_run = solo(probe, [3, 1, 4])  # no natural EOS
    eos = free_run[1]  # the 2nd emitted token becomes the EOS
    llms = pair(2, buckets=(4,), max_new=5, eos_ids=(eos,), spec_tokens=draft_len)

    def scenario(pool):
        results = {}
        pool.insert([3, 1, 4], "x")
        while pool.active:
            harvest(pool, results)
        return results

    results, _ = both(llms, scenario, pool_size=2 - bool(draft_len), chunk_steps=8)
    assert_rows(llms, results, {"x": [3, 1, 4]})
    assert results[1]["x"] == free_run[:2] + [eos] * 3


def test_finished_row_output_survives_lingering():
    """A done row that stays in the pool while others decode keeps its
    emitted tokens."""
    llms = pair(3, buckets=(4, 8), max_new=3)

    def scenario(pool):
        results = {}
        pool.insert([5, 3], "short")
        pool.insert([1, 2, 3, 4, 5, 6], "long")
        for _ in range(12):
            if not pool.active:
                break
            harvest(pool, results)
        return results

    results, _ = both(llms, scenario, pool_size=2, chunk_steps=1)  # 1-step chunks
    assert_rows(llms, results, {"short": [5, 3], "long": [1, 2, 3, 4, 5, 6]})


def drive(wrapper, prompts):
    async def run():
        async def one(i, p):
            await asyncio.sleep(0.002 * i)
            return await wrapper.acomplete(p)

        return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))

    return [r.text for r in asyncio.run(run())]


ASYNC_PROMPTS = ["ab", "cdef", "g", "hijk", "lm"]


def test_async_wrapper_joins_and_matches():
    """The ``acomplete`` contract end to end: more requests than slots, each
    resolves to JAX's text and its solo run's, and a mid-flight join
    happened."""
    llms = pair(4, buckets=(4, 8), max_new=4)
    ref = drive(JaxWrapper(llms[0], pool_size=2, chunk_steps=2), ASYNC_PROMPTS)
    wrapper = ContinuousBatchingLocalLLM(llms[1], pool_size=2, chunk_steps=2)
    got = drive(wrapper, ASYNC_PROMPTS)
    assert got == ref
    for p, text in zip(ASYNC_PROMPTS, got):
        assert text == llms[1]._decode_row(solo(llms[1], llms[1]._encode(p))), p
    assert wrapper.dispatches == wrapper.pool.chunks > 0
    assert wrapper.pool.joins > 0


def test_pool_warmup_runs_and_resets():
    llms = pair(5, buckets=(4, 8), max_new=3)

    def scenario(pool):
        pool.warmup()
        assert not pool.active and sorted(pool.free) == [0, 1]
        results = {}
        pool.insert([9, 8, 7], "q")  # still right after the warmup and reset
        while pool.active:
            harvest(pool, results)
        return results

    results, (ref, pool) = both(llms, scenario, pool_size=2, chunk_steps=4)
    assert_rows(llms, results, {"q": [9, 8, 7]})
    assert pool.chunks == ref.chunks


@pytest.mark.parametrize("seed", range(4))
def test_spec_pool_matches_across_seeds(seed):
    """Random tiny models fall into greedy cycles, where drafts ACCEPT, so a
    seed sweep takes both the accept and the reject paths."""
    llms = pair(10 + seed, cfg={"num_key_value_heads": 2}, buckets=(8,), max_new=10, spec_tokens=3)
    prompts = {
        "x": [(seed * 7 + j * 3) % (VOCAB - 2) + 1 for j in range(7)],
        "y": [(seed * 5 + j) % (VOCAB - 2) + 1 for j in range(4)],
    }

    def scenario(pool):
        results = {}
        for name, p in prompts.items():
            pool.insert(p, name)
        while pool.active:
            harvest(pool, results)
        return results

    results, (_, pool) = both(llms, scenario, pool_size=2, chunk_steps=3)
    assert_rows(llms, results, prompts)
    assert pool.stats["steps"] > 0 and pool.stats["row_steps"] >= pool.stats["steps"]


def test_tiered_pool_routing_and_parity():
    """Short prompts land in the small tier, long ones in the large tier,
    overflow goes upward when the small tier is full, and every row still
    equals JAX's and its solo run."""
    llms = pair(6, buckets=(4, 8), max_new=4)

    def scenario(pool):
        assert pool.pool_size == 3
        results = {}
        s1 = pool.insert([5, 3], "short1")  # tier 0 (bucket 4)
        s2 = pool.insert([1, 2, 3, 4, 5, 6], "long")  # tier 1 (bucket 8)
        s3 = pool.insert([7, 2], "short2")  # tier 0 full: overflows to tier 1
        assert s1 == 0 and s2 in (1, 2) and s3 in (1, 2) and s2 != s3
        assert not pool.can_admit([9] * 3) and not pool.can_admit([9] * 7)
        while pool.active:
            harvest(pool, results)
        assert pool.can_admit([9] * 7) and len(pool.free) == 3
        return results

    results, _ = both(llms, scenario, chunk_steps=2, tiers=[(4, 1), (8, 2)])
    assert_rows(llms, results, {"short1": [5, 3], "long": [1, 2, 3, 4, 5, 6], "short2": [7, 2]})


def test_tiered_pool_rejects_unknown_bucket():
    llms = pair(6, buckets=(4, 8), max_new=4)
    for pool_cls, llm in zip((JaxPool, DecodePool), llms):
        with pytest.raises(ValueError, match="not prompt buckets"):
            pool_cls(llm, tiers=[(5, 2)])
    with pytest.raises(ValueError, match="local_llm_max_new"):
        DecodePool(pair(6, buckets=(4, 8), max_new=0)[1])


@pytest.mark.parametrize("spec", [0, 2])
def test_tiered_pool_kv_state_is_tier_sized(spec):
    """Small-tier slots do not reserve the largest bucket's KV; a
    speculative tier's caches hold ``spec`` spare slots past its end."""
    llms = pair(6, buckets=(4, 8), max_new=4, spec_tokens=spec)
    ref, pool = JaxPool(llms[0], tiers=[(4, 2), (8, 1)]), DecodePool(llms[1], tiers=[(4, 2), (8, 1)])
    for jt, t in zip(ref.tiers, pool.tiers):
        assert tuple(t.state["kv_mask"].shape) == jt.state["kv_mask"].shape
        assert tuple(t.state["out"].shape) == jt.state["out"].shape
        b, total = jt.state["kv_mask"].shape
        assert t.state["caches"][0]["k"].shape[:2] == (b, total + spec)
    assert [tuple(t.state["kv_mask"].shape) for t in pool.tiers] == [(2, 8), (1, 12)]


def test_tiered_spec_warmup_and_async_driver():
    """Tiers and speculation under the async driver: more requests than
    slots, long prompts wait for a fitting slot instead of failing, all
    resolve to JAX's text and their solo runs'."""
    llms = pair(4, buckets=(4, 8), max_new=4, spec_tokens=2)
    ref_wrapper = JaxWrapper(llms[0], chunk_steps=2, tiers=[(4, 1), (8, 1)])
    ref_wrapper.warmup()
    wrapper = ContinuousBatchingLocalLLM(llms[1], chunk_steps=2, tiers=[(4, 1), (8, 1)])
    wrapper.warmup()
    assert not wrapper.pool.active and len(wrapper.pool.free) == 2
    ref, got = drive(ref_wrapper, ASYNC_PROMPTS), drive(wrapper, ASYNC_PROMPTS)
    assert got == ref
    for p, text in zip(ASYNC_PROMPTS, got):
        assert text == llms[1]._decode_row(solo(llms[1], llms[1]._encode(p))), p


def test_driver_failures_reach_their_waiters():
    """An encode failure fails its own waiter only; a device failure in a
    chunk fails every live row's waiter (never swallowed), the pool resets,
    and later requests are served."""
    llm = pair(7, buckets=(4, 8), max_new=3)[1]
    wrapper = ContinuousBatchingLocalLLM(llm, pool_size=2, chunk_steps=2)
    encode = llm._encode
    llm._encode = lambda q: (_ for _ in ()).throw(ValueError("bad prompt")) if q == "bad" else encode(q)
    run_chunk = wrapper.pool.run_chunk
    calls = []

    def failing_chunk():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return run_chunk()

    wrapper.pool.run_chunk = failing_chunk

    async def run():
        return await asyncio.gather(*(wrapper.acomplete(p) for p in ("ab", "bad", "cd")), return_exceptions=True)

    out = asyncio.run(run())
    assert isinstance(out[1], ValueError)
    assert isinstance(out[0], RuntimeError) and isinstance(out[2], RuntimeError)  # both were live
    assert not wrapper.pool.active and len(wrapper.pool.free) == 2
    assert drive(wrapper, ["ab"]) == [llm._decode_row(solo(llm, encode("ab")))]


def test_prompt_past_every_tier_fails_its_waiter():
    """A prompt whose bucket no tier holds fails its own waiter (JAX's
    driver would wait for it forever without yielding); the others are
    served."""
    llm = pair(7, buckets=(4, 8), max_new=3)[1]
    wrapper = ContinuousBatchingLocalLLM(llm, chunk_steps=2, tiers=[(4, 2)])

    async def run():
        return await asyncio.gather(*(wrapper.acomplete(p) for p in ("ab", "abcdef", "cd")), return_exceptions=True)

    # in a thread of its own: a driver that spins without yielding blocks its
    # event loop, so no timeout inside that loop could fire
    result = {}
    thread = threading.Thread(target=lambda: result.update(out=asyncio.run(run())), daemon=True)
    thread.start()
    thread.join(60)
    assert not thread.is_alive(), "the driver never finished"
    out = result["out"]
    assert isinstance(out[1], ValueError) and "no pool tier" in str(out[1])
    assert [r.text for r in (out[0], out[2])] == [llm._decode_row(solo(llm, llm._encode(p))) for p in ("ab", "cd")]


def test_bf16_pool_equals_the_ports_solo_runs():
    """On a bf16 tree the port's pool gives its own solo runs' tokens
    exactly (plain and speculative): each step takes its norms and cache
    attention row by row with the solo run's shapes."""
    for spec in (0, 3):
        llm = pair(8, dtype=torch.bfloat16, cfg={"num_key_value_heads": 2}, buckets=(4, 8), max_new=6,
                   spec_tokens=spec)[1]
        pool = DecodePool(llm, chunk_steps=2, tiers=[(4, 1), (8, 2)])
        results = staggered(PROMPTS)(pool)
        for name, prompt in PROMPTS.items():
            assert results[name] == solo(llm, prompt), (spec, name)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [0, 7])
def test_pool_equals_solo_on_card(spec):
    """On the card with a fused int4 tree in bf16 (K2 at every row count,
    K3 in the prefill): staggered joins across two tiers, one row
    overflowing into the large tier; every row equals its solo
    ``generate_greedy`` at B=1 bit for bit. No JAX array is made: JAX may
    hold the card."""
    from easyrag_tpu_torch.models.quant import fuse_decode_tree, quantize_linear_int4, quantize_linear_int8

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(spec)
    cfg = DecoderConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=1, head_dim=128, attention_bias=True)
    d, hd = cfg.hidden_size, cfg.hd

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16) * 0.05

    ones = torch.ones(d, device=dev, dtype=torch.bfloat16)
    layers = [{
        "input_norm": ones, "post_norm": ones,
        "attn": {**{n: {**quantize_linear_int4(rnd(w, d)), "b": rnd(w)} for n, w in (("q", 2 * hd), ("k", hd),
                                                                                     ("v", hd))},
                 "o": quantize_linear_int4(rnd(d, 2 * hd))},
        "mlp": {"gate": quantize_linear_int4(rnd(512, d)), "up": quantize_linear_int4(rnd(512, d)),
                "down": quantize_linear_int4(rnd(d, 512))},
    } for _ in range(cfg.num_hidden_layers)]
    tp = fuse_decode_tree({"embed": quantize_linear_int8(rnd(cfg.vocab_size, d)), "layers": layers,
                           "final_norm": ones, "lm_head": quantize_linear_int4(rnd(cfg.vocab_size, d))})
    llm = StubLLM(cfg, tp, buckets=(128, 256), max_new=24, eos_ids=(cfg.vocab_size - 1,), spec_tokens=spec)
    pool = DecodePool(llm, chunk_steps=8, tiers=[(128, 1), (256, 2)])
    rng = np.random.default_rng(spec)
    prompts = {f"p{i}": [int(t) for t in rng.integers(1, cfg.vocab_size - 1, size=n)]
               for i, n in enumerate((100, 200, 60))}  # p2 finds the 128 tier full: it overflows
    results = staggered(prompts)(pool)

    def solo_card(prompt):
        bucket = next(b for b in llm.buckets if len(prompt) <= b)
        row, mask = td._pad_left(prompt, bucket, 0)
        return td.generate_greedy(cfg, tp, torch.tensor([row], dtype=torch.int32, device=dev),
                                  torch.tensor([mask], dtype=torch.int32, device=dev),
                                  torch.tensor(llm.eos_ids, dtype=torch.int32, device=dev), 24)[0].tolist()

    for name, prompt in prompts.items():
        assert results[name] == solo_card(prompt), name
