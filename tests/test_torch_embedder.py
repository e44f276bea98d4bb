"""The port's gte-Qwen2 embedder against the JAX package's.

A tiny Qwen2 (2 layers, 2 query heads of 128 on 1 KV head, QKV bias, vocab
512) in f32 with one JAX parameter tree, given to the port through
``gte_from_jax``. JAX runs with ``use_flash`` under
``pltpu.force_tpu_interpret_mode()``, so at the 128 and 256 buckets its
``layers.attention`` calls the stock Pallas kernel (``layers.py:351``) and
at the 64 bucket the einsum path; the port runs the same gate, K3's plain
version at the larger buckets. Texts land in all three buckets, with
batch-padding rows; the normalized embeddings of the real rows agree within
atol 2e-5 (f32 sums in another order, the kernel's online softmax against a
materialised one). The left-padding tokenizer is refused; the loader gives
JAX's leaves on a tiny saved checkpoint in every quantization, and
``load_gte_embedder`` embeds as JAX's registry does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from easyrag_tpu.models import hf_loader as jh
from easyrag_tpu.models import layers as jl
from easyrag_tpu.models import qwen2 as jq
from easyrag_tpu_torch.models import hf_loader as th
from easyrag_tpu_torch.models import layers as tl
from easyrag_tpu_torch.models import qwen2 as tq
from easyrag_tpu_torch.models.convert import gte_from_jax
from easyrag_tpu_torch.models.layers import DecoderConfig

torch.set_num_threads(1)

ARCH = dict(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=1, head_dim=128, attention_bias=True,
)
ATOL = 2e-5
# one text per bucket: 40 characters (64), 100 (128), 200 (256)
TEXTS = ["运维扩容指南" * 6 + "abcd", "backup and restore " * 5 + "tail!", "鉴权日志 log rotation " * 11 + "xyz"]


class BatchCharTok:
    """One token per character, the HF batch call ``_embed`` makes (padding
    to the longest row, truncation, numpy tensors), on either side."""

    def __init__(self, vocab=512, padding_side="right"):
        self.vocab = vocab
        self.padding_side = padding_side

    def __call__(self, texts, max_length=None, padding=True, truncation=True, return_tensors="np"):
        rows = [[ord(c) % (self.vocab - 2) + 2 for c in t][:max_length] for t in texts]
        s = max(len(r) for r in rows)
        ids = np.zeros((len(rows), s), np.int64)
        mask = np.zeros((len(rows), s), np.int64)
        for i, r in enumerate(rows):
            cols = slice(0, len(r)) if self.padding_side == "right" else slice(s - len(r), s)
            ids[i, cols], mask[i, cols] = r, 1
        return {"input_ids": ids, "attention_mask": mask}


def jax_tree(arch=ARCH, seed=0):
    cfg = jl.DecoderConfig(dtype=jnp.float32, **arch)
    params = jl.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for n in "qkv":
            layer["attn"][n]["b"] = jnp.asarray(rng.standard_normal(layer["attn"][n]["b"].shape).astype(np.float32) * 0.1)
    return cfg, params, jax.tree.map(np.asarray, params)


def embedders(**kw):
    """(JAX's embedder with ``use_flash``, the port's) over one tree."""
    jcfg, params, params_np = jax_tree()
    ref = jq.GTEEmbedder(dataclasses.replace(jcfg, use_flash=True), params, BatchCharTok(), **kw)
    got = gte_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, BatchCharTok(), **kw)
    return ref, got


def test_text_embeddings_match_jax_in_every_bucket(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    ref, got = embedders()
    calls = []
    real = tl.flash_attention
    monkeypatch.setattr(tl, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    for text in TEXTS:  # batch bucket 1 at sequence buckets 64, 128, 256
        with pltpu.force_tpu_interpret_mode():
            want = ref.get_text_embedding(text)
        np.testing.assert_allclose(got.get_text_embedding(text), want, atol=ATOL, rtol=0)
    # K3 (here its plain version) at the 128 and 256 buckets, every layer; the einsum path at 64
    assert calls == [(1, 128, 256)] * 2 + [(1, 256, 256)] * 2
    assert got.stats == {"batches": 3, "tokens": sum(len(t) for t in TEXTS), "padded_tokens": 64 + 128 + 256}
    out = got.get_text_embeddings(TEXTS)
    assert out.dtype == np.float32 and out.shape == (3, 256)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-6)


def test_batched_embeddings_with_padding_rows_match_jax():
    """Three texts fill batch bucket 8 with five padding rows, right-padded
    to the 256 bucket; nine texts in batches of 8 take buckets 8, then 1."""
    from jax.experimental.pallas import tpu as pltpu

    ref, got = embedders()
    with pltpu.force_tpu_interpret_mode():
        want = ref.get_text_embeddings(TEXTS)
        want_q = ref.get_query_embeddings(TEXTS[:2])
    np.testing.assert_allclose(got.get_text_embeddings(TEXTS), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.get_query_embeddings(TEXTS[:2]), want_q, atol=ATOL, rtol=0)
    assert got.stats["padded_tokens"] == 8 * 256 + 8 * 256
    small_ref, small = embedders(embed_batch_size=8)
    with pltpu.force_tpu_interpret_mode():
        want_small = small_ref.get_text_embeddings(TEXTS * 3)
    np.testing.assert_allclose(small.get_text_embeddings(TEXTS * 3), want_small, atol=ATOL, rtol=0)
    assert small.batch_buckets == (1, 8) and small.stats["batches"] == 2


def test_query_instruct_and_embed_nodes():
    from jax.experimental.pallas import tpu as pltpu

    from easyrag_tpu_torch.schema import TextNode

    ref, got = embedders(embed_type=1)
    assert got.get_detailed_instruct("q") == ref.get_detailed_instruct("q") == tq.QUERY_INSTRUCT + "q"
    assert tq.SEQ_BUCKETS == jq.SEQ_BUCKETS
    with pltpu.force_tpu_interpret_mode():  # the instruct prefix puts the query in the 128 bucket
        want = ref.get_query_embedding("扩容步长")
    np.testing.assert_allclose(got.get_query_embedding("扩容步长"), want, atol=ATOL)
    nodes = [TextNode(text=t, metadata={"file_path": f"d/{i}.txt"}) for i, t in enumerate(TEXTS[:2])]
    views = ["###\nd/0.txt\n\n" + TEXTS[0], "###\nd/1.txt\n\n" + TEXTS[1]]
    np.testing.assert_allclose(got.embed_nodes(nodes), got.get_text_embeddings(views), atol=1e-6)


def test_left_padding_tokenizer_is_refused():
    _, _, params_np = jax_tree()
    with pytest.raises(ValueError, match="Queue 3"):
        gte_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, BatchCharTok(padding_side="left"))


@pytest.mark.parametrize("left", [False, True])
def test_embed_step_pools_like_jax(left):
    """``embed_step`` on its own: right padding pools at ``sum(mask) - 1``,
    ``left_padded`` the last slot."""
    jcfg, params, params_np = jax_tree()
    tree = gte_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, BatchCharTok()).params
    tok = BatchCharTok(padding_side="left" if left else "right")
    enc = tok(["short text", "a longer piece of text here"])
    ids, mask = enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)
    want = np.asarray(jq.embed_step(jcfg, params, jnp.asarray(ids), jnp.asarray(mask), left_padded=left))
    got = tq.embed_step(DecoderConfig(**ARCH), tree, torch.from_numpy(ids), torch.from_numpy(mask), left_padded=left)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,k3_calls", [(72, 0), (128, 2)])
def test_forward_hidden_head_dim_64_gate(monkeypatch, s, k3_calls):
    """At head_dim 64 the gate hands ``S % 128 == 0`` to K3 (on the card it
    raises there, naming ROADMAP Queue 2) and runs the einsum path
    otherwise; on the CPU both equal JAX's einsum path on real rows."""
    arch = dict(ARCH, num_attention_heads=4, num_key_value_heads=2, head_dim=64)
    jcfg, params, params_np = jax_tree(arch, seed=1)
    tree = gte_from_jax(DecoderConfig(**arch), params_np, "cpu", torch.float32, BatchCharTok()).params
    calls = []
    real = tl.flash_attention
    monkeypatch.setattr(tl, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    ids, mask = np.zeros((2, s), np.int32), np.zeros((2, s), np.int32)
    rng = np.random.default_rng(2)
    for b, n in enumerate([s, 30]):
        ids[b, :n], mask[b, :n] = rng.integers(2, 512, size=n), 1
    want = np.asarray(jl.forward_hidden(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)))
    got = tl.forward_hidden(DecoderConfig(**arch), tree, torch.from_numpy(ids), torch.from_numpy(mask))
    real_rows = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real_rows], want[real_rows], atol=3e-5, rtol=3e-4)
    assert len(calls) == k3_calls


@pytest.fixture(scope="module")
def tiny_gte_checkpoint(tmp_path_factory):
    """Tiny gte-Qwen2 checkpoint (a ``Qwen2Model``, no LM head) with a word
    tokenizer that pads on the right."""
    from transformers import Qwen2Config, Qwen2Model

    from test_checkpoint_boot import _word_tokenizer

    out = tmp_path_factory.mktemp("ckpt") / "gte-qwen2-tiny"
    torch.manual_seed(3)
    hf_cfg = Qwen2Config(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=128, attn_implementation="eager",
    )
    Qwen2Model(hf_cfg).eval().float().save_pretrained(str(out), safe_serialization=True)
    _word_tokenizer().save_pretrained(str(out))
    return str(out)


@pytest.mark.parametrize("quant", ["", "int8", "int4", "w8a8", "w4a8"])
def test_loader_matches_jax(tiny_gte_checkpoint, quant):
    jcfg, ref = jh.load_qwen2_embedder(tiny_gte_checkpoint, dtype=jnp.float32, quant=quant)
    cfg, got = th.load_qwen2_embedder(tiny_gte_checkpoint, dtype=torch.float32, quant=quant, device="cpu")
    assert cfg.hidden_size == jcfg.hidden_size and cfg.num_key_value_heads == jcfg.num_key_value_heads
    assert cfg.act_quant == jcfg.act_quant == (quant in ("w8a8", "w4a8"))
    ref_np = jax.tree.map(np.asarray, ref)
    assert sorted(got) == sorted(ref_np) == ["embed", "final_norm", "layers"]
    if quant in ("int4", "w4a8"):
        assert sorted(got["embed"]) == ["scale", "w_q"]

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
    with pytest.raises(ValueError):
        th.load_qwen2_embedder(tiny_gte_checkpoint, quant="fp8", device="cpu")


def test_load_gte_embedder_matches_jax_registry(monkeypatch, tiny_gte_checkpoint):
    """Both load bf16 weights (the registry's dtype) and compute in bf16,
    which each framework rounds at other places: atol 1e-2 on unit vectors."""
    from easyrag_tpu.models.registry import load_embedder

    ref = load_embedder(tiny_gte_checkpoint, embed_type=1)
    got = tq.load_gte_embedder(tiny_gte_checkpoint, device="cpu", embed_type=1)
    calls = []
    real = tl.flash_attention
    monkeypatch.setattr(tl, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    assert got.embed_batch_size == 128 and got.batch_buckets == (1, 8, 32, 128) and got.embed_type == 1
    texts = ["w1 w2 w3", "w5 w9 w9 w12 w4 w30 w2"]
    np.testing.assert_allclose(got.get_text_embeddings(texts), np.asarray(ref.get_text_embeddings(texts)), atol=1e-2)
    assert not calls  # head_dim 8: the einsum path, where the registry's gate keeps the kernels off


def test_embedder_defaults_to_the_card(tiny_gte_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, _, params_np = jax_tree()
    no_card = pytest.raises(RuntimeError, match="no CUDA device")
    with no_card:
        tq.load_gte_embedder(tiny_gte_checkpoint)
    with no_card:
        th.load_qwen2_embedder(tiny_gte_checkpoint)
    tree = gte_from_jax(DecoderConfig(**ARCH), params_np, "cpu", torch.float32, BatchCharTok()).params
    with no_card:
        tq.GTEEmbedder(DecoderConfig(**ARCH), tree, BatchCharTok())


def test_decoder_loader_defaults_to_the_card(tiny_gte_checkpoint):
    """``load_decoder_params`` resolves its default device like every other
    loader: without a card it raises instead of loading onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.load_decoder_params(tiny_gte_checkpoint, 2)
    assert th.load_decoder_params(tiny_gte_checkpoint, 2, device="cpu")["final_norm"].device.type == "cpu"
