"""The port's tensor parallelism (``easyrag_tpu_torch/parallel/tp.py`` and the
layer code's TP forms) against the JAX package's on the CPU.

JAX shards over its 8 virtual CPU devices (``tests/conftest.py``); the port
over ``["cpu"] * mp``, one process driving every shard. Trees come from
``easyrag_tpu.models.layers.init_params`` and cross with
``causal_lm_params_from_jax``. Each port shard's leaves must equal JAX's
addressable shard of the same leaf (dense, int8, int4 and fused-int4 trees,
biases included), and the analogues of JAX's six TP tests must hold against
JAX's TP run and against the port's unsharded run: greedy tokens in f32
(mp 4), int8, int4 and a fused int4 tree (mp 2), w8a8's hidden states on a
data 4 x model 2 mesh (within 2e-5 of JAX's TP, bit for bit the port's
unsharded w8a8: the cross-shard amax is exact and the s32 partials sum
exactly), the TP embedder (rtol 1e-5). Further: TP speculative decode
equals TP greedy, a row-parallel bias is added once, the registry and the
pipeline load the embedder tensor-parallel from a ``model`` axis as JAX's
do (the same embeddings, the same contexts), and the dry run passes.

CUDA (marked ``cuda``, skipped without a card): K3 at a shard's head counts
of gte-Qwen2-7B (14 on 2 and 7 on 1, head_dim 128) against its plain
version, and w8a8's TP hidden states on the card against the unsharded run.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from easyrag_tpu.models import decode as jd
from easyrag_tpu.models import hf_loader as jh
from easyrag_tpu.models import layers as jl
from easyrag_tpu.models import qwen2 as jq
from easyrag_tpu.models import registry as jreg
from easyrag_tpu.parallel import mesh as jmesh
from easyrag_tpu.parallel import tp as jtp
from easyrag_tpu.pipeline import EasyRAGPipeline as JaxPipeline
from easyrag_tpu_torch.dryrun import dryrun_multichip
from easyrag_tpu_torch.models import decode as td
from easyrag_tpu_torch.models import layers as tl
from easyrag_tpu_torch.models import registry as reg
from easyrag_tpu_torch.models.convert import causal_lm_params_from_jax
from easyrag_tpu_torch.models.qwen2 import embed_step
from easyrag_tpu_torch.models.quant import quantize_decoder_tree, unfuse_linear
from easyrag_tpu_torch.parallel import data_model_mesh, make_mesh, shard_decoder_params
from easyrag_tpu_torch.pipeline import EasyRAGPipeline
from test_torch_embedder import tiny_gte_checkpoint  # noqa: F401  (a fixture)
from test_torch_pipeline import configs, offline_counter  # noqa: F401  (a fixture)

torch.set_num_threads(1)

VOCAB = 97  # tests/test_decode.py's tiny decoder
TINY = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4)


def jax_cfg(**kw):
    return jl.DecoderConfig(dtype=jnp.float32, **{**TINY, **kw})


def port_cfg(**kw):
    return tl.DecoderConfig(**{**TINY, **kw})


def to_port(params):
    return causal_lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu", torch.float32)


def port_mesh(mp):
    return make_mesh([mp], ("model",), devices=["cpu"] * mp)


def jax_mesh(mp):
    return JaxMesh(np.array(jax.devices()[:mp]).reshape(mp), ("model",))


def with_biases(params, names=("q", "k", "v", "o"), seed=7, scale=0.1):
    """Nonzero biases on the named attention projections."""
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:
        for n in names:
            lin = layer["attn"][n]
            lin["b"] = jnp.asarray(rng.standard_normal(lin["w"].shape[0]).astype(np.float32) * scale)
    return params


def tree(form, cfg, key):
    """A JAX tree in one of the layouts: dense, int8, int4 or fused int4."""
    params = with_biases(jl.init_params(cfg, jax.random.key(key)), names=("q", "k", "v"))
    if form == "int8":
        return jh.quantize_decoder_tree(params, "int8")
    if form in ("int4", "fused"):
        params = jh.quantize_decoder_tree(params, "int4")
        return jh.fuse_decode_tree(params) if form == "fused" else params
    return params


# -- layout -----------------------------------------------------------------------


def jax_blocks(arr, dim):
    """JAX's addressable shards of ``arr``, one per block along ``dim``, in
    block order (a data axis repeats them)."""
    blocks = {}
    for sh in arr.addressable_shards:
        blocks.setdefault(sh.index[dim].start or 0, np.asarray(sh.data))
    return [blocks[k] for k in sorted(blocks)]


def jax_replicated(arr):
    full = np.asarray(arr)
    for sh in arr.addressable_shards:
        np.testing.assert_array_equal(np.asarray(sh.data), full)
    return full


@pytest.mark.parametrize("form", ["dense", "int8", "int4", "fused"])
@pytest.mark.parametrize("mp", [2, 4])
def test_shards_equal_jax_addressable_shards(form, mp):
    cfg = jax_cfg(num_key_value_heads=4 if mp == 4 else 2)
    params = tree(form, cfg, 0)
    if form == "fused":
        assert "qkv" in params["layers"][0]["attn"] and "gateup" in params["layers"][0]["mlp"]
    params["layers"][0]["attn"]["o"]["b"] = jnp.full((cfg.hidden_size,), 0.25, jnp.float32)
    ref = jtp.shard_decoder_params(jmesh.data_model_mesh(8, model_parallel=mp), cfg, params, axis="model")
    got = shard_decoder_params(data_model_mesh(8, mp, devices=["cpu"] * 8), port_cfg(num_key_value_heads=cfg.num_key_value_heads),
                               to_port(params), axis="model")
    assert sorted(got) == sorted(ref)
    for key in ("embed", "final_norm"):
        np.testing.assert_array_equal(got[key].numpy(), jax_replicated(ref[key]))
    for glayer, rlayer in zip(got["layers"], ref["layers"], strict=True):
        for key in ("input_norm", "post_norm"):
            np.testing.assert_array_equal(glayer[key].numpy(), jax_replicated(rlayer[key]))
        for group, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
            assert len(glayer[group]) == mp
            for name in names:
                col = name not in ("o", "down")
                rleaf = rlayer[group][name]
                for s in range(mp):
                    gleaf = glayer[group][s][name]
                    assert sorted(gleaf) == sorted(rleaf)
                    if form in ("int4", "fused"):
                        assert "w_q" in gleaf and gleaf["w_q"].dtype == torch.int8
                    for k, arr in rleaf.items():
                        if k in ("w", "w_q"):
                            want = jax_blocks(arr, 0 if col else 1)[s]
                        elif col:
                            want = jax_blocks(arr, 0)[s]
                        else:
                            want = jax_replicated(arr)
                        np.testing.assert_array_equal(gleaf[k].numpy(), want)


def test_indivisible_heads_raise_like_jax():
    cfg = jax_cfg(num_attention_heads=4, num_key_value_heads=2)
    params = jl.init_params(cfg, jax.random.key(0))
    with pytest.raises(ValueError) as want:
        jtp.shard_decoder_params(jax_mesh(3), cfg, params, axis="model")
    with pytest.raises(ValueError) as got:
        shard_decoder_params(port_mesh(3), port_cfg(num_key_value_heads=2), to_port(params), axis="model")
    assert str(got.value) == str(want.value) and "not divisible by model-parallel size 3" in str(got.value)


def test_unfuse_linear_matches_jax():
    cfg = jax_cfg(num_key_value_heads=2)
    fused = tree("fused", cfg, 1)["layers"][0]["attn"]["qkv"]
    outs = [32, 16, 16]
    for g, r in zip(unfuse_linear(to_port({"x": fused})["x"], outs), jh.unfuse_linear(fused, outs), strict=True):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))


# -- the analogues of JAX's TP tests ---------------------------------------------------


def jax_tokens(cfg, params, prompt, max_new, eos, mesh=None, spec=0):
    args = (cfg, params, jnp.asarray([prompt], jnp.int32), jnp.ones((1, len(prompt)), jnp.int32),
            jnp.asarray(eos, jnp.int32), max_new)
    fn = (lambda: jd.generate_greedy_spec(*args, draft_len=spec)) if spec else (lambda: jd.generate_greedy(*args))
    if mesh is None:
        return list(np.asarray(fn()[0]))
    with mesh:
        return list(np.asarray(fn()[0]))


def port_tokens(cfg, params, prompt, max_new, eos, spec=0):
    args = (cfg, params, torch.tensor([prompt], dtype=torch.int32), torch.ones(1, len(prompt), dtype=torch.int32),
            torch.tensor(eos, dtype=torch.int32), max_new)
    out = td.generate_greedy_spec(*args, draft_len=spec) if spec else td.generate_greedy(*args)
    return out[0].tolist()


@pytest.mark.parametrize("form,mp,key,prompt,max_new", [
    ("dense", 4, 9, [3, 1, 4, 1, 5, 9, 2, 6], 6),  # tests/test_decode.py:195
    ("int8", 2, 10, [8, 2, 7, 5], 5),  # :225
    ("int4", 2, 12, [8, 2, 7, 5, 1, 3], 5),  # :272
    ("fused", 2, 3, [8, 2, 7, 5, 1, 3], 5),  # tests/test_int4_fused.py:122
])
def test_tp_decode_matches_jax_tp_and_unsharded(form, mp, key, prompt, max_new):
    cfg = jax_cfg()
    params = jl.init_params(cfg, jax.random.key(key))
    if form == "int8":
        params = jh.quantize_decoder_tree(params)
    elif form in ("int4", "fused"):
        params = jh.quantize_decoder_tree(params, quant="int4")
        if form == "fused":
            params = jh.fuse_decode_tree(params)
            assert "qkv" in params["layers"][0]["attn"]
    eos = [VOCAB - 1]
    ref = jax_tokens(cfg, jtp.shard_decoder_params(jax_mesh(mp), cfg, params, axis="model"), prompt, max_new, eos,
                     mesh=jax_mesh(mp))
    assert ref == jax_tokens(cfg, params, prompt, max_new, eos)
    one = to_port(params)
    sharded = shard_decoder_params(port_mesh(mp), port_cfg(), one, axis="model")
    if form in ("int4", "fused"):
        assert "w_q" in sharded["layers"][0]["attn"][0]["q"]  # unfused and unpacked
    got = port_tokens(port_cfg(), sharded, prompt, max_new, eos)
    assert got == ref == port_tokens(port_cfg(), one, prompt, max_new, eos)
    # speculation over the TP tree keeps the greedy tokens
    assert port_tokens(port_cfg(), sharded, prompt, max_new, eos, spec=3) == got


def test_tp_spec_matches_tp_greedy_and_jax():
    """A prompt that repeats itself, so drafts are accepted: the TP verify
    blocks give TP greedy's tokens and JAX's TP spec tokens."""
    cfg = jax_cfg(num_key_value_heads=2)
    params = with_biases(jl.init_params(cfg, jax.random.key(4)))
    prompt, eos = [5, 2, 8, 2, 8, 2, 8, 2], [VOCAB - 1]
    sharded = shard_decoder_params(port_mesh(2), port_cfg(num_key_value_heads=2), to_port(params), axis="model")
    greedy = port_tokens(port_cfg(num_key_value_heads=2), sharded, prompt, 10, eos)
    assert port_tokens(port_cfg(num_key_value_heads=2), sharded, prompt, 10, eos, spec=3) == greedy
    jtree = jtp.shard_decoder_params(jax_mesh(2), cfg, params, axis="model")
    assert greedy == jax_tokens(cfg, jtree, prompt, 10, eos, mesh=jax_mesh(2), spec=3)


W8A8 = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2)


def test_w8a8_tp_matches_jax_and_unsharded_bits():
    """tests/test_w8a8.py:94 on a data 4 x model 2 mesh."""
    cfg = jl.DecoderConfig(dtype=jnp.float32, act_quant=True, **W8A8)
    params = jh.quantize_decoder_tree(jl.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, size=(3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    m = jmesh.data_model_mesh(8, model_parallel=2)
    with m:
        ref = np.asarray(jl.forward_hidden(cfg, jtp.shard_decoder_params(m, cfg, params, axis="model"),
                                           jnp.asarray(ids), jnp.asarray(mask)))
    pcfg = tl.DecoderConfig(act_quant=True, **W8A8)
    one = to_port(params)
    sharded = shard_decoder_params(data_model_mesh(8, 2, devices=["cpu"] * 8), pcfg, one, axis="model")
    got = tl.forward_hidden(pcfg, sharded, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, tl.forward_hidden(pcfg, one, torch.from_numpy(ids), torch.from_numpy(mask)))


def test_tp_embedder_matches_jax():
    """tests/test_sharded.py:31."""
    cfg = jl.DecoderConfig(dtype=jnp.float32, attention_bias=True, **W8A8)
    params = jl.init_params(cfg, jax.random.key(0))
    ids = (np.arange(3 * 12).reshape(3, 12) % 64).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    m = jmesh.data_model_mesh(8, model_parallel=2)
    with m:
        ref = np.asarray(jq.embed_step(cfg, jtp.shard_decoder_params(m, cfg, params, axis="model"),
                                       jnp.asarray(ids), jnp.asarray(mask)))
    pcfg = tl.DecoderConfig(attention_bias=True, **W8A8)
    one = to_port(params)
    sharded = shard_decoder_params(data_model_mesh(8, 2, devices=["cpu"] * 8), pcfg, one, axis="model")
    got = embed_step(pcfg, sharded, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, embed_step(pcfg, one, torch.from_numpy(ids), torch.from_numpy(mask)).numpy(),
                               rtol=1e-5, atol=1e-6)


# -- further cases ---------------------------------------------------------------


@pytest.mark.parametrize("form", ["dense", "int8", "w8a8"])
def test_row_parallel_bias_is_added_once(form):
    """A row-parallel linear with a large bias equals the unsharded linear
    (w8a8 bit for bit): a bias added on every shard would count it mp times."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((24, 32)).astype(np.float32))
    b = torch.full((24,), 3.0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    leaf = {"w": w, "b": b} if form == "dense" else {**tl.quantize_linear_int8(w), "b": b}
    a8 = form == "w8a8"
    want = tl.linear(x, leaf, a8)
    for mp in (2, 4):
        n = 32 // mp
        ps = [{k: (v[:, s * n : (s + 1) * n] if k in ("w", "w_q") else v) for k, v in leaf.items()} for s in range(mp)]
        got = tl.row_parallel_linear([x[..., s * n : (s + 1) * n] for s in range(mp)], ps, a8)
        if a8:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_tp_forward_with_o_bias_matches_jax_and_unsharded():
    cfg = jax_cfg(num_key_value_heads=2, attention_bias=True)
    params = with_biases(jl.init_params(cfg, jax.random.key(6)), scale=1.0)
    ids = (np.arange(2 * 9).reshape(2, 9) % VOCAB).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    with jax_mesh(2):
        ref = np.asarray(jl.forward_hidden(cfg, jtp.shard_decoder_params(jax_mesh(2), cfg, params, axis="model"),
                                           jnp.asarray(ids), jnp.asarray(mask)))
    pcfg = port_cfg(num_key_value_heads=2, attention_bias=True)
    one = to_port(params)
    sharded = shard_decoder_params(port_mesh(2), pcfg, one, axis="model")
    got = tl.forward_hidden(pcfg, sharded, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, tl.forward_hidden(pcfg, one, torch.from_numpy(ids), torch.from_numpy(mask)).numpy(),
                               rtol=2e-5, atol=2e-5)


TEXTS = ["w1 w2 w3", "w4 w5 w6 w7", "w30 w2"]


@pytest.mark.parametrize("quant", ["", "w8a8"])
def test_load_embedder_over_a_model_axis_matches_jax(tiny_gte_checkpoint, quant):  # noqa: F811
    ref = jreg.load_embedder(tiny_gte_checkpoint, embed_type=1, quant=quant,
                             mesh=jmesh.data_model_mesh(8, model_parallel=2))
    mesh = data_model_mesh(4, 2, devices=["cpu"] * 4)
    got = reg.load_embedder(tiny_gte_checkpoint, embed_type=1, quant=quant, mesh=mesh, device="cpu")
    assert tl.tp_devices(got.params) == mesh.model_devices() and len(got.params["layers"][0]["attn"]) == 2
    a, b = got.get_text_embeddings(TEXTS), np.asarray(ref.get_text_embeddings(TEXTS))
    assert ((a * b).sum(axis=1) > 0.999).all()  # unit vectors, bf16 apart
    one = reg.load_embedder(tiny_gte_checkpoint, embed_type=1, quant=quant, device="cpu")
    assert tl.tp_devices(one.params) is None
    if quant == "w8a8":  # exact integer products, the same bf16 elementwise work
        np.testing.assert_array_equal(a, one.get_text_embeddings(TEXTS))
    else:
        assert ((a * one.get_text_embeddings(TEXTS)).sum(axis=1) > 0.999).all()


def test_tp_pipeline_matches_jax(tmp_path, offline_counter, tiny_gte_checkpoint):  # noqa: F811
    """``tpu.mesh_shape: [2, 2]`` over ``[data, model]`` with
    ``tpu.shard_index``: the embedder named by the config loads
    tensor-parallel, the indexes shard over ``data``; the contexts equal
    JAX's pipeline's under the same config."""
    root = tmp_path / "corpus"
    (root / "director").mkdir(parents=True)
    docs = {"a": "w1 w2 w3\nw1 w2 w3 w4 w5。\n", "b": "w6 w7\nw6 w7 w8 w9。\n", "c": "w10 w11\nw3 w12 w13。\n",
            "d": "w14 w15\nw14 w16 w2 w17。\n", "e": "w18 w19\nw20 w9 w21。\n", "f": "w22 w23\nw24 w5 w25 w12。\n"}
    for name, text in docs.items():
        (root / "director" / f"{name}.txt").write_text(text, encoding="utf-8")
    (root / "pathmap.json").write_text(json.dumps({f"director/{n}.txt": ["k", n] for n in docs}), encoding="utf-8")
    # JAX's sharded merge needs every k within D times a shard's docs
    kw = dict(re_only=True, retrieval_type=1, rerank_fusion_type=1, use_reranker=0, embedding_name=tiny_gte_checkpoint,
              vector_size=32, chunk_size=64, chunk_overlap=10, data_path=str(root), f_topk_1=4, f_topk_2=4,
              f_topk_3=2, r_topk=2)
    tpu = dict(embedder_quant="w8a8", mesh_shape=[2, 2], mesh_axis_names=["data", "model"], shard_index=True)
    cfg, _ = configs(cache_path=str(tmp_path / "jax_cache"), tpu=dict(use_pallas=False, **tpu), **kw)
    _, port_cfg_ = configs(cache_path=str(tmp_path / "port_cache"), tpu=tpu, **kw)
    mesh = data_model_mesh(4, 2, devices=["cpu"] * 4)
    ref, got = JaxPipeline(cfg), EasyRAGPipeline(port_cfg_, device="cpu", mesh=mesh)
    assert got.mesh.shape == {"data": 2, "model": 2}
    assert tl.tp_devices(got.embed_model.params) == mesh.model_devices()
    for q in ("w1 w2 w3", "w6 w9", "w3 w12"):
        a = asyncio.run(ref.run({"query": q}))
        b = asyncio.run(got.run({"query": q}))
        assert b["contexts"] and b["contexts"] == a["contexts"]
        assert [n.node.idx for n in b["nodes"]] == [n.node.idx for n in a["nodes"]]


def test_dryrun_multichip_on_cpu(capsys):
    out = dryrun_multichip(8, ["cpu"] * 8)
    assert out["mesh"] == {"data": 4, "model": 2} and out["embed"] == (4, 128)
    assert "dryrun_multichip OK" in capsys.readouterr().out


# -- the card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(14, 2), (7, 1)])
def test_k3_at_shard_head_counts_on_card(cuda, nh, nkv):
    """K3 at gte-Qwen2-7B's per-shard heads (mp 2 and 4), right padded as
    the embedder pads, against its plain version (the K3 tests' row rule)."""
    from easyrag_tpu_torch.ops import flash_attention as k3

    B, S, hd = 4, 256, 128
    gen = torch.Generator(device=cuda).manual_seed(nh)
    q = torch.randn(B, S, nh * hd, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, S, nkv * hd, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(B, S, nkv * hd, generator=gen, device=cuda).to(torch.bfloat16)
    kv_s = torch.zeros(B, dtype=torch.int32, device=cuda)
    kv_e = torch.tensor([256, 200, 17, 1], dtype=torch.int32, device=cuda)
    before = k3.launches
    got = k3.flash_attention(q, k, v, kv_s, kv_e, hd ** -0.5, nkv)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ref = k3.flash_attention_plain(q, k, v, kv_s, kv_e, hd ** -0.5, nkv)
    real = torch.arange(S, device=cuda)[None, :] < kv_e[:, None]
    g, r = got[real].float().reshape(-1, hd), ref[real].float().reshape(-1, hd)
    assert ((g - r).abs() <= 1.6e-2 * r.abs().amax(dim=1, keepdim=True)).all()


@pytest.mark.cuda
def test_w8a8_tp_bits_on_card(cuda):
    """w8a8's TP hidden states on the card (two shards on one card) equal
    the unsharded run's bit for bit, at head_dim 128 and S 128 (K3)."""
    cfg = tl.DecoderConfig(vocab_size=64, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2, attention_bias=True, act_quant=True)
    from easyrag_tpu_torch.dryrun import random_tree

    def bf16(node, key=""):  # int8 bytes and f32 scales keep their dtypes
        if isinstance(node, dict):
            return {k: bf16(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [bf16(v) for v in node]
        return node if key in ("w_q", "scale") else node.to(torch.bfloat16)

    one = bf16(quantize_decoder_tree(random_tree(cfg, 3, cuda)))
    ids = torch.randint(0, 64, (2, 128), generator=torch.Generator().manual_seed(0)).to(cuda, torch.int32)
    mask = torch.ones_like(ids)
    mask[1, 90:] = 0
    sharded = shard_decoder_params(data_model_mesh(2, 2, devices=[cuda] * 2), cfg, one, axis="model")
    assert torch.equal(tl.forward_hidden(cfg, sharded, ids, mask), tl.forward_hidden(cfg, one, ids, mask))


@pytest.mark.cuda
def test_f32_product_keeps_f32_sums_on_card(cuda):
    """A bf16 row-parallel partial on the card comes back in f32 (cuBLAS's
    sums, not rounded to bf16), also for a shard's column view of ``w``."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 64, 1792, generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn(512, 3584, generator=gen, device=cuda).to(torch.bfloat16)[:, 1792:]
    got = tl.f32_product(x, w)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 512)
    torch.testing.assert_close(got, x.float() @ w.float().t(), rtol=1e-5, atol=1e-3)
