"""The port's generator against the JAX package's, token for token.

A tiny Qwen2-style decoder (2 layers, hidden 256, 2 query heads of 128 on 1
KV head, QKV bias, vocab 256, untied head) with one JAX parameter tree in
three forms: dense, int8, and fused int4 with an int8 embedding table and an
int4 head (the ``local_llm_quant: int4`` layout). The port gets each tree
through ``causal_lm_params_from_jax``. In f32 on the CPU, ``generate_greedy``
and ``generate_greedy_spec`` must give the same tokens as JAX's on a
left-padded batch with an inactive row, a step limit and EOS fill, and the
speculative tokens must equal the plain ones.

``TorchCausalLM`` runs on a tiny saved Qwen2 checkpoint with a word tokenizer
and a chat template (the recipe of ``tests/test_gen_batch.py``): its text,
``plan_groups`` and ``warmup`` behave as ``JaxCausalLM``'s, and its loader
builds the JAX loader's leaves in every quantization.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from easyrag_tpu.models import decode as jd
from easyrag_tpu.models import hf_loader as jh
from easyrag_tpu.models import layers as jl
from easyrag_tpu_torch.models import decode as td
from easyrag_tpu_torch.models import hf_loader as th
from easyrag_tpu_torch.models.convert import causal_lm_params_from_jax
from easyrag_tpu_torch.models.layers import DecoderConfig
from easyrag_tpu_torch.models.qwen2 import qwen2_config_from_hf

torch.set_num_threads(1)

ARCH = dict(
    vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=1, head_dim=128, attention_bias=True,
)
PROMPTS = [[5, 7, 9, 11, 3, 3, 5, 7, 9, 11, 2], [1, 2, 3, 1, 2], [4]]
BUCKET = 16


def _tree(form):
    cfg = jl.DecoderConfig(dtype=jnp.float32, **ARCH)
    params = jl.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    for layer in params["layers"]:
        for n in "qkv":
            layer["attn"][n]["b"] = jnp.asarray(rng.standard_normal(layer["attn"][n]["b"].shape).astype(np.float32) * 0.1)
    head = rng.standard_normal((ARCH["vocab_size"], ARCH["hidden_size"])).astype(np.float32) * 0.05
    params["lm_head"] = jnp.asarray(head)
    if form == "int8":
        params = jh.quantize_decoder_tree(params, "int8")
        params["lm_head"] = jh.quantize_linear_int8(head)
    elif form == "int4":
        params = jh.fuse_decode_tree(jh.quantize_decoder_tree(params, "int4"))
        params["lm_head"] = jh.quantize_linear_int4(head)
        params["embed"] = jh.quantize_linear_int8(np.asarray(params["embed"]))
        assert "qkv" in params["layers"][0]["attn"] and "gateup" in params["layers"][0]["mlp"]
    return cfg, params


def _batch():
    rows = [[0] * (BUCKET - len(p)) + p for p in PROMPTS]
    masks = [[0] * (BUCKET - len(p)) + [1] * len(p) for p in PROMPTS]
    return np.array(rows, np.int32), np.array(masks, np.int32)


def _run_jax(cfg, params, eos, max_new, spec=0, **kw):
    rows, masks = _batch()
    args = (cfg, params, jnp.asarray(rows), jnp.asarray(masks), jnp.asarray(eos, jnp.int32), max_new)
    if "limit" in kw:
        kw["limit"] = jnp.int32(kw["limit"])
    if "active" in kw:
        kw["active"] = jnp.asarray(kw["active"])
    if spec:
        return np.asarray(jd.generate_greedy_spec(*args, draft_len=spec, **kw))
    return np.asarray(jd.generate_greedy(*args, **kw))


def _run_port(params, eos, max_new, spec=0, **kw):
    rows, masks = _batch()
    args = (DecoderConfig(**ARCH), params, torch.from_numpy(rows), torch.from_numpy(masks),
            torch.tensor(eos, dtype=torch.int32), max_new)
    if "active" in kw:
        kw["active"] = torch.tensor(kw["active"])
    if spec:
        return td.generate_greedy_spec(*args, draft_len=spec, **kw).numpy()
    return td.generate_greedy(*args, **kw).numpy()


@pytest.mark.parametrize("form", ["dense", "int8", "int4"])
def test_greedy_and_spec_tokens_match_jax(form):
    cfg, params = _tree(form)
    tp = causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", torch.float32)
    free = _run_jax(cfg, params, [ARCH["vocab_size"] + 1], 10)  # an EOS that never fires
    np.testing.assert_array_equal(_run_port(tp, [ARCH["vocab_size"] + 1], 10), free)
    eos = [int(free[0, 3]), ARCH["vocab_size"] + 1]  # row 0 stops at step 3 or before
    active = [True, True, False]
    want = _run_jax(cfg, params, eos, 10, active=active)
    assert (want[0, 4:] == eos[0]).all() and (want[2] == eos[0]).all()
    np.testing.assert_array_equal(_run_port(tp, eos, 10, active=active), want)
    np.testing.assert_array_equal(_run_port(tp, eos, 10, limit=3), _run_jax(cfg, params, eos, 10, limit=3))
    spec = _run_port(tp, eos, 10, spec=3, active=active)
    np.testing.assert_array_equal(spec, want)
    np.testing.assert_array_equal(spec, _run_jax(cfg, params, eos, 10, spec=3, active=active))
    np.testing.assert_array_equal(_run_port(tp, eos, 10, spec=3, limit=4), _run_jax(cfg, params, eos, 10, limit=4))


@pytest.mark.parametrize("hd,s,kernel", [(128, 256, True), (256, 128, True), (128, 48, False), (64, 128, False)])
def test_prefill_takes_k3_where_jax_takes_the_stock_kernel(monkeypatch, hd, s, kernel):
    """The prefill calls the K3 wrapper wherever JAX's ``_prefill_layer``
    calls the stock kernel (head_dim and S multiples of 128), head_dim 256
    included: on a CUDA tensor that wrapper launches or raises
    (``test_torch_flash_attention``), so no shape runs the plain version on
    the card unseen."""
    arch = dict(ARCH, head_dim=hd, vocab_size=32)
    params = jl.init_params(jl.DecoderConfig(dtype=jnp.float32, **arch), jax.random.key(1))
    tp = causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", torch.float32)
    calls = []
    real = td.flash_attention
    monkeypatch.setattr(td, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    cfg = DecoderConfig(**arch)
    ids = torch.zeros(1, s, dtype=torch.int32)
    mask = (torch.arange(s) >= s - 5).to(torch.int32)[None]
    h = td._prefill(cfg, tp, ids, mask, td.init_cache(cfg, 1, s + 1, torch.float32, "cpu"))
    assert torch.isfinite(h).all()
    assert calls == ([(1, s, 2 * hd)] * arch["num_hidden_layers"] if kernel else [])


def test_ngram_draft_matches_jax():
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 4, size=(3, 24)).astype(np.int32)
    start, end = np.array([0, 5, 20], np.int32), np.array([24, 17, 22], np.int32)
    ref = np.asarray(jd._ngram_draft(jnp.asarray(buf), jnp.asarray(start), jnp.asarray(end), 2, 3))
    got = td._ngram_draft(torch.from_numpy(buf), torch.from_numpy(start), torch.from_numpy(end), 2, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def _verify_inputs(tp, q):
    """The prefill of ``_batch()`` into a speculative cache, and one verify
    block of ``q`` seeded tokens right after it (slots ``S..S+q-1``)."""
    tcfg = DecoderConfig(**ARCH)
    rows, masks = _batch()
    b, s = rows.shape
    t_total = s + 6  # max_new 6
    ids, mask = torch.from_numpy(rows), torch.from_numpy(masks)
    cache = td.init_cache(tcfg, b, t_total + q - 1, torch.float32, "cpu")
    td._prefill(tcfg, tp, ids, mask, cache)
    lengths = mask.sum(dim=1).to(torch.int32)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, ARCH["vocab_size"], (b, q)).astype(np.int32))
    j_idx = torch.arange(q)[None, :]
    slots = s + j_idx.expand(b, q)
    kv_valid = torch.cat([mask > 0, torch.zeros(b, t_total - s, dtype=torch.bool)], dim=1)
    t_idx = torch.arange(t_total)[None, None, :]
    allowed = kv_valid[:, None, :] | ((t_idx >= s) & (t_idx <= slots[:, :, None]))
    return tcfg, cache, tokens, lengths, slots, kv_valid, allowed


@pytest.mark.parametrize("form", ["dense", "int4"])
@torch.inference_mode()
def test_verify_block_matches_jax_and_single_steps(form):
    """One verify block of 4 positions through every layer and the head: the
    port's ``_verify_layer`` (norms and cache attention one position at a
    time over the first ``S + max_new`` slots) against JAX's in f32, and its
    row j against the j-th single step (``_decode_layer``) from the same
    cache state."""
    from easyrag_tpu_torch.models.layers import rms_norm, rope_tables

    cfg, params = _tree(form)
    tp = causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", torch.float32)
    q = 4
    tcfg, cache, tokens, lengths, slots, kv_valid, allowed = _verify_inputs(tp, q)
    s, t_total, eps = _batch()[0].shape[1], allowed.shape[-1], tcfg.rms_norm_eps
    cos, sin = rope_tables(lengths[:, None] + torch.arange(q)[None, :], tcfg.hd, tcfg.rope_theta)
    x = td.embed(tcfg, tp["embed"], tokens, torch.float32)
    jcache = [{n: jnp.asarray(c[n][:, :t_total].numpy()) for n in ("k", "v")} for c in cache]
    jx = jnp.asarray(x.numpy())
    h = x
    block_cache = [{n: c[n].clone() for n in ("k", "v")} for c in cache]
    for idx in range(ARCH["num_hidden_layers"]):
        h = td._verify_layer(tcfg, tp["layers"][idx], h, slots, allowed, cos, sin, block_cache[idx])
        jx, _ = jd._verify_layer(cfg, params["layers"][idx], jx, *(jnp.asarray(t.numpy()) for t in (slots, allowed, cos, sin)),
                                 jcache[idx])
    got = td._lm_logits(tcfg, tp, rms_norm(h, tp["final_norm"], eps))
    want = np.asarray(jd._lm_logits(cfg, params, jl.rms_norm(jx, params["final_norm"], cfg.rms_norm_eps)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    step_cache = [{n: c[n][:, :t_total].clone() for n in ("k", "v")} for c in cache]
    valid = kv_valid.clone()
    for j in range(q):
        valid[:, s + j] = True
        cj, sj = rope_tables((lengths + j)[:, None], tcfg.hd, tcfg.rope_theta)
        hj = td.embed(tcfg, tp["embed"], tokens[:, j : j + 1], torch.float32)
        for idx in range(ARCH["num_hidden_layers"]):
            hj = td._decode_layer(tcfg, tp["layers"][idx], hj, s + j, valid, cj, sj, step_cache[idx])
        step = td._lm_logits(tcfg, tp, rms_norm(hj[:, 0], tp["final_norm"], eps))
        np.testing.assert_allclose(got[:, j].numpy(), step.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("draft_len", [7, 3])
def test_spec_tokens_equal_greedy_bit_for_bit_on_card(draft_len):
    """On the card in bf16, with a fused int4 tree quantized by the port
    (K2 sums every output in an order that does not depend on the row
    count), speculative decoding gives plain greedy's tokens bit for bit on
    every active row of a B=4 batch with one inactive row, as the smoke's
    batched dispatch runs it. No JAX array is made: JAX may hold the card."""
    from easyrag_tpu_torch.models.quant import fuse_decode_tree, quantize_linear_int4, quantize_linear_int8

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(draft_len)
    d, inter, hd, nh, nkv = (ARCH[k] for k in ("hidden_size", "intermediate_size", "head_dim", "num_attention_heads",
                                                "num_key_value_heads"))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16) * 0.05

    ones = torch.ones(d, device=dev, dtype=torch.bfloat16)
    layers = [{
        "input_norm": ones, "post_norm": ones,
        "attn": {**{n: {**quantize_linear_int4(rnd(w, d)), "b": rnd(w)} for n, w in (("q", nh * hd), ("k", nkv * hd),
                                                                                     ("v", nkv * hd))},
                 "o": quantize_linear_int4(rnd(d, nh * hd))},
        "mlp": {"gate": quantize_linear_int4(rnd(inter, d)), "up": quantize_linear_int4(rnd(inter, d)),
                "down": quantize_linear_int4(rnd(d, inter))},
    } for _ in range(ARCH["num_hidden_layers"])]
    tp = fuse_decode_tree({"embed": quantize_linear_int8(rnd(ARCH["vocab_size"], d)), "layers": layers,
                           "final_norm": ones, "lm_head": quantize_linear_int4(rnd(ARCH["vocab_size"], d))})
    assert "qkv" in tp["layers"][0]["attn"]
    rows, masks = _batch()
    rows = np.concatenate([rows, np.full((1, BUCKET), 4, np.int32)])
    masks = np.concatenate([masks, np.ones((1, BUCKET), np.int32)])
    args = (DecoderConfig(**ARCH), tp, torch.from_numpy(rows).to(dev), torch.from_numpy(masks).to(dev),
            torch.tensor([ARCH["vocab_size"] - 1], dtype=torch.int32, device=dev), 48)
    active = torch.tensor([True, True, True, False], device=dev)
    plain = td.generate_greedy(*args, active=active).cpu()
    spec = td.generate_greedy_spec(*args, draft_len=draft_len, active=active).cpu()
    assert torch.equal(spec[:3], plain[:3])


@pytest.fixture(scope="module")
def tiny_causal_checkpoint(tmp_path_factory):
    """Tiny Qwen2 causal checkpoint + word tokenizer with a chat template
    (``tests/test_gen_batch.py::tiny_causal_checkpoint``), plus a
    generation_config.json with a second EOS id."""
    import json

    from transformers import Qwen2Config, Qwen2ForCausalLM

    from test_checkpoint_boot import _word_tokenizer

    out = tmp_path_factory.mktemp("models") / "qwen2-tiny-gen"
    torch.manual_seed(11)
    hf_cfg = Qwen2Config(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256, attn_implementation="eager",
        tie_word_embeddings=False, eos_token_id=61,
    )
    Qwen2ForCausalLM(hf_cfg).eval().float().save_pretrained(str(out), safe_serialization=True)
    tok = _word_tokenizer()
    tok.chat_template = (
        "{% for m in messages %}{{ m['content'] }} {% endfor %}"
        "{% if add_generation_prompt %}w0 {% endif %}"
    )
    tok.save_pretrained(str(out))
    with open(out / "generation_config.json", "w") as f:
        json.dump({"eos_token_id": [61, 59]}, f)
    return str(out)


QUERIES = ["w3 w1 w4", "w9 w8 w7 w6 w5 w4 w3 w2 w1 w10", "w2 w7 w1", "w5 w5 w5"]


@pytest.mark.parametrize("spec", [0, 3])
def test_causal_lm_matches_jax(tiny_causal_checkpoint, spec):
    kw = dict(quant="", max_new_tokens=6, buckets=(8, 16), max_batch=2, spec_tokens=spec)
    ref = jd.JaxCausalLM(tiny_causal_checkpoint, dtype=jnp.float32, **kw)
    got = td.TorchCausalLM(tiny_causal_checkpoint, dtype=torch.float32, device="cpu", **kw)
    assert got.eos_ids == ref.eos_ids == [61, 59]
    assert got.plan_groups(QUERIES) == ref.plan_groups(QUERIES) == [(8, 3), (16, 1)]
    want = ref.generate_batch(QUERIES)
    assert got.generate_batch(QUERIES) == want
    assert [s["batch"] for s in got.last_stats] == [2, 1, 1]  # bucket 8 in two chunks, then bucket 16
    got.warmup(buckets=(5, 16), batch_sizes=(1, 2))
    assert got.generate(QUERIES[0]) == want[0]


@pytest.mark.parametrize("quant", ["", "int8", "int4", "w8a8", "w4a8"])
def test_loader_matches_jax(tiny_causal_checkpoint, quant):
    ref = jh.load_decoder_params(tiny_causal_checkpoint, 2, dtype=jnp.float32, quant=quant)
    got = th.load_decoder_params(tiny_causal_checkpoint, 2, dtype=torch.float32, quant=quant, device="cpu")
    ref_np = jax.tree.map(np.asarray, ref)
    assert sorted(got) == sorted(ref_np) == ["embed", "final_norm", "layers", "lm_head"]

    def same(a, b):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, list):
            for x, y in zip(a, b, strict=True):
                same(x, y)
        else:
            np.testing.assert_array_equal(a.numpy(), b)

    same(got, ref_np)
    hf = th.load_hf_config(tiny_causal_checkpoint)
    assert qwen2_config_from_hf(hf) == DecoderConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=hf["rms_norm_eps"], rope_theta=hf["rope_theta"], attention_bias=True,
    )
    with pytest.raises(ValueError):
        th.load_decoder_params(tiny_causal_checkpoint, 2, quant="fp8", device="cpu")
