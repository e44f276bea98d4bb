"""The multi-device dry run (port of ``__graft_entry__.py::dryrun_multichip``).

One call drives every sharded surface of the port over a ``(data, model)``
mesh at a tiny size: the tensor-parallel embedder (``parallel/tp.py``) and
the data-sharded dense and resident indexes (``parallel/sharded.py``) in one
query step, the indexes' stream forms and compressed dtypes, the rows/CSR
parity of the resident index, w8a8 under TP, TP greedy and TP speculative
decode against the unsharded greedy tokens, and int4 under TP from a fused
tree. It raises on the first mismatch.

The caller passes the devices: ``["cpu"] * 8`` on the CPU, ``["cuda:0"] *
4`` on one card, or none for distinct cards (``parallel.mesh.make_mesh``,
which raises without a card). Nothing here picks a platform.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .index.dense import l2_normalize
from .index.sparse import build_sparse_index
from .models.decode import generate_greedy, generate_greedy_spec
from .models.layers import DecoderConfig
from .models.qwen2 import embed_step
from .models.quant import fuse_decode_tree, quantize_decoder_tree, unpack_int4
from .parallel.mesh import data_model_mesh
from .parallel.sharded import ShardedDenseIndex, ShardedResidentSparseIndex
from .parallel.tp import shard_decoder_params


def tiny_config(heads: int = 4, kv_heads: int = 2, layers: int = 2, hidden: int = 128) -> DecoderConfig:
    """JAX's dry-run config at hidden 128 (JAX's is 64): the fused int4 tree
    needs ``I/2`` a multiple of K2's 64-byte step, or ``fuse_decode_tree``
    leaves the groups unfused."""
    return DecoderConfig(
        vocab_size=512, hidden_size=hidden, intermediate_size=hidden * 2, num_hidden_layers=layers,
        num_attention_heads=heads, num_key_value_heads=kv_heads, attention_bias=True,
    )


def random_tree(cfg: DecoderConfig, seed: int, device) -> dict:
    """A seeded f32 decoder tree on ``device``: every weight, the QKV biases
    and the embedding ``N(0, 0.02)``, norms 1, the head tied to the
    embedding (``easyrag_tpu.models.layers.init_params``'s layout)."""
    gen = torch.Generator().manual_seed(seed)
    d, inter, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hd
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def rnd(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(device)

    layers = []
    for _ in range(cfg.num_hidden_layers):
        attn = {n: {"w": rnd(out, d), "b": rnd(out)} for n, out in (("q", nh * hd), ("k", nkv * hd), ("v", nkv * hd))}
        attn["o"] = {"w": rnd(d, nh * hd)}
        mlp = {"gate": {"w": rnd(inter, d)}, "up": {"w": rnd(inter, d)}, "down": {"w": rnd(d, inter)}}
        layers.append({"input_norm": torch.ones(d, device=device), "attn": attn, "mlp": mlp,
                       "post_norm": torch.ones(d, device=device)})
    return {"embed": rnd(cfg.vocab_size, d), "layers": layers, "final_norm": torch.ones(d, device=device)}


def unpacked_layers(params: dict) -> dict:
    """An int4 tree (fused or not) with every packed leaf of its layers as
    its nibble values in int8 (``w_q``, the same scales), the embedding and
    the head as they are: the unsharded counterpart of what
    ``shard_decoder_params`` computes with."""

    def unpack(node):
        if isinstance(node, dict):
            if "w_p" in node:
                return {"w_q": unpack_int4(node["w_p"]), **{k: v for k, v in node.items() if k != "w_p"}}
            return {k: unpack(v) for k, v in node.items()}
        return node

    return {**params, "layers": [unpack(layer) for layer in params["layers"]]}


def _equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"dryrun_multichip: {what}: {got.tolist()} != {want.tolist()}")


@torch.inference_mode()
def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the dry run over ``n_devices`` devices (a ``model`` axis of 2 when
    ``n_devices`` is even, else 1); returns the mesh's shape and the query
    step's output shapes, and prints one summary line."""
    mp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = data_model_mesh(n_devices, model_parallel=mp, devices=devices)
    first = mesh.model_devices()[0]

    # -- TP-sharded embedder ----------------------------------------------------
    cfg = tiny_config()
    params = random_tree(cfg, 0, first)
    params_tp = shard_decoder_params(mesh, cfg, params, axis="model")
    b, s, d = 4, 16, cfg.hidden_size
    ids = torch.from_numpy(np.arange(b * s).reshape(b, s) % 512).to(first, torch.int32)
    mask = torch.ones(b, s, dtype=torch.int32, device=first)

    # -- data-sharded dense index -------------------------------------------------
    rng = np.random.default_rng(0)
    n_docs = 64 * n_devices + 7
    matrix = l2_normalize(rng.normal(size=(n_docs, d)).astype(np.float32))
    dense = ShardedDenseIndex(mesh, matrix, dtype="float32")

    # -- data-sharded device-resident sparse index --------------------------------
    corpus = [[f"w{rng.integers(0, 50)}" for _ in range(12)] for _ in range(n_docs)]
    sparse = build_sparse_index(corpus, bm25_type=0)
    resident = ShardedResidentSparseIndex(mesh, sparse, light_cap=64, max_query_terms=8)
    tid, cnt = resident.query_terms(["w1", "w2", "w3"])
    tids_b = torch.from_numpy(np.broadcast_to(tid, (b, len(tid))).copy())
    cnts_b = torch.from_numpy(np.broadcast_to(cnt, (b, len(cnt))).copy())

    # -- the query step: TP embedding, then both indexes --------------------------
    k = 8
    q = embed_step(cfg, params_tp, ids, mask)
    dv, di = dense._batch([q.to(sh.matrix.device) for sh in dense.shards], [None] * len(dense.shards), k)
    sv, si = resident._score_topk(tids_b, cnts_b, k)
    if not (q.shape == (b, d) and dv.shape == di.shape == sv.shape == si.shape == (b, k)):
        raise AssertionError(f"dryrun_multichip: shapes {q.shape} {dv.shape} {di.shape} {sv.shape} {si.shape}")
    np.testing.assert_allclose(q.norm(dim=1).cpu().numpy(), 1.0, rtol=1e-4)
    if not ((di >= 0) & (di < n_docs)).all():
        raise AssertionError("dryrun_multichip: dense indices out of range")

    # -- stream forms and the compressed index dtypes (what tpu.shard_index
    # wires into the pipeline) ------------------------------------------------------
    qs = q.cpu().numpy()
    sv2, _ = dense.query_stream(np.repeat(qs, 2, axis=0), k, batch=4)
    queries = [["w1", "w2"], ["w3"], ["w4", "w5", "w6"]]
    tv3, _ = resident.stream_score_topk(queries, k, batch=2)
    v8, _ = ShardedDenseIndex.build(mesh, matrix, dtype="int8").query(qs[:2], k)
    res8 = ShardedResidentSparseIndex(mesh, sparse, light_cap=8, max_query_terms=8, heavy_dtype="int8")
    v8s, _ = res8.score_topk(queries[:1], k)
    if not (sv2.shape == (2 * b, k) and tv3.shape == (len(queries), k) and v8.shape == (2, k)
            and v8s.shape == (1, k)):
        raise AssertionError(f"dryrun_multichip: stream shapes {sv2.shape} {tv3.shape} {v8.shape} {v8s.shape}")
    # both light layouts of the sharded index agree bit for bit (light_cap 8:
    # light terms exist at this corpus)
    vr, ir = ShardedResidentSparseIndex(mesh, sparse, light_cap=8, max_query_terms=8,
                                        light_rows=True).stream_score_topk(queries, k, batch=2)
    vc, ic = ShardedResidentSparseIndex(mesh, sparse, light_cap=8, max_query_terms=8,
                                        light_rows=False).stream_score_topk(queries, k, batch=2)
    np.testing.assert_array_equal(vr, vc)
    np.testing.assert_array_equal(ir, ic)

    # -- w8a8 under TP: the row-parallel projections quantize with the
    # cross-shard amax -------------------------------------------------------------
    cfg_a8 = dataclasses.replace(cfg, act_quant=True)
    params_a8 = shard_decoder_params(mesh, cfg_a8, quantize_decoder_tree(random_tree(cfg, 1, first)), axis="model")
    q8 = embed_step(cfg_a8, params_a8, ids, mask)
    if q8.shape != (b, d):
        raise AssertionError(f"dryrun_multichip: w8a8 embedding shape {q8.shape}")
    np.testing.assert_allclose(q8.norm(dim=1).cpu().numpy(), 1.0, rtol=1e-4)

    # -- TP generation: greedy, then speculative, against one device ---------------
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]], dtype=torch.int32, device=first)
    pmask = torch.ones_like(prompt)
    eos = torch.tensor([511], dtype=torch.int32, device=first)
    toks_1chip = generate_greedy(cfg, params, prompt, pmask, eos, 4)
    toks_tp = generate_greedy(cfg, params_tp, prompt, pmask, eos, 4)
    if toks_tp.shape != (1, 4):
        raise AssertionError(f"dryrun_multichip: TP tokens shape {toks_tp.shape}")
    _equal(toks_tp, toks_1chip, "TP greedy vs one device")
    _equal(generate_greedy_spec(cfg, params_tp, prompt, pmask, eos, 4, draft_len=3), toks_1chip,
           "TP speculative vs one device")

    # -- int4 under TP from the fused production layout: the shards carry the
    # nibble values as int8, so the tokens equal the unsharded run of the
    # same values (K2 on the card takes bf16 only; this config is f32) ------------
    params_i4 = fuse_decode_tree(quantize_decoder_tree(params, "int4"))
    if "qkv" not in params_i4["layers"][0]["attn"] or "gateup" not in params_i4["layers"][0]["mlp"]:
        raise AssertionError("dryrun_multichip: the int4 tree did not fuse")
    toks_i4_1chip = generate_greedy(cfg, unpacked_layers(params_i4), prompt, pmask, eos, 4)
    toks_i4_tp = generate_greedy(cfg, shard_decoder_params(mesh, cfg, params_i4, axis="model"), prompt, pmask, eos, 4)
    _equal(toks_i4_tp, toks_i4_1chip, "int4 TP vs one device")
    print(
        f"dryrun_multichip OK: mesh={mesh.shape} embed {tuple(q.shape)} dense topk {tuple(di.shape)} "
        f"sparse topk {tuple(si.shape)} streams+int8+rows/csr-parity+w8a8-tp+tp-decode+tp-spec+int4-tp OK"
    )
    return {"mesh": mesh.shape, "embed": tuple(q.shape), "dense": tuple(di.shape), "sparse": tuple(si.shape)}
