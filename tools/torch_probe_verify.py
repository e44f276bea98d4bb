#!/usr/bin/env python3
"""Where does a speculative verify block round differently from single steps?

Run on a machine with an NVIDIA GPU, from the root of a checkout:

    python3 tools/torch_probe_verify.py [--bucket 1024] [--batch 4]

Builds Qwen2-7B-Instruct at full width and depth with random int4 weights
(``chip_smoke.build_generator``, the smoke's phase-5 tree), prefills a
left-padded batch (attention through K3's plain version, so the probe does
not depend on the kernel), then feeds the same 8 tokens (the last emitted
token and 7 drafts) two ways from the same cache state:

* one verify block of Q=8 positions, in four variants: ``block`` (the norms
  over all ``B*Q`` rows and the cache attention over ``[B, Q]`` and the
  ``S + max_new + 7`` slots of the speculative cache, as the verify path ran
  before its repair), ``row_attention`` (the attention one position at a
  time over the greedy cache's ``S + max_new`` slots), ``row_norms`` (the
  norms' means of squares one position at a time, ``decode._row_norm``) and
  ``rows`` (both, what ``models/decode.py::_verify_layer`` does);
* 8 single steps, each the ops of ``models/decode.py::_decode_layer``.

With ``--generate N`` it instead runs ``generate_greedy`` twice and
``generate_greedy_spec`` with 0 and 7 drafts for N new tokens on that batch
(the last row inactive) and fingerprints the logits behind every emitted
token: per run and row, against the first greedy run, the first token whose
logits differ in bits, the block position that produced it, the first layer
whose output there differs, greedy's top-2 margin, and the equal tokens.

For each variant it prints one JSON line: the first (layer, op) where row j
of the block differs in bits from step j for some j, how many of the
(layer, op) outputs differ, whether the final logits and argmax agree, and
finally whether ``_verify_layer`` itself gives the single steps' layer
outputs. Also written to ``chiprun_out/probe_verify.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = 7
MAX_NEW = 128
# the norms' f32 means of squares are compared too: a different reduction
# order shows there every time, in the bf16 outputs only now and then
OPS = ("input_norm_mean", "input_norm", "qkv", "rope", "attention", "o_proj_residual", "post_norm_mean", "post_norm",
       "mlp_residual")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_probe_verify: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from easyrag_tpu_torch.models import decode as td
    from easyrag_tpu_torch.models.layers import EAGER, apply_rope, linear, mlp_act, qkv_proj, rms_norm, rope_tables
    from easyrag_tpu_torch.ops.flash_attention import flash_attention_plain

    ap = argparse.ArgumentParser()
    ap.add_argument("--bucket", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--generate", type=int, default=0)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, params = chip_smoke.build_generator(torch, chip_smoke.SEED + 3)
    B, S, Q = args.batch, args.bucket, SPEC + 1
    gen = torch.Generator(device=dev).manual_seed(1)
    lengths = torch.tensor([S - 37 * i for i in range(B)], dtype=torch.int32, device=dev)
    ids = torch.randint(0, 151_643, (B, S), generator=gen, device=dev, dtype=torch.int32)
    mask = (torch.arange(S, device=dev)[None, :] >= (S - lengths)[:, None]).to(torch.int32)
    t_total, t_cache = S + MAX_NEW, S + MAX_NEW + SPEC
    if args.generate:
        return generate(torch, td, cfg, params, ids, mask, args.generate, chip_smoke)
    td.flash_attention = flash_attention_plain  # the probe is about the decode ops, not K3
    with torch.inference_mode():
        cache = td.init_cache(cfg, B, t_cache, torch.bfloat16, dev)
        td._prefill(cfg, params, ids, mask, cache)
        tokens = torch.randint(0, 151_643, (B, Q), generator=gen, device=dev, dtype=torch.int32)
        kv_valid = torch.cat([mask > 0, torch.zeros(B, t_cache - S, dtype=torch.bool, device=dev)], dim=1)
        eps, r = cfg.rms_norm_eps, cfg.residual_scale
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd

        def mean_sq(x, by_row):  # a single step's rms_norm reduces x.float().pow(2) over [B, 1, D]
            return td._position_means(x.float()) if by_row else x.float().pow(2).mean(-1, keepdim=True)

        def layer(p, x, cos, sin, c, write, attend, norm, by_row=False):
            rec = {"input_norm_mean": mean_sq(x, by_row)}
            h = rec["input_norm"] = norm(x, p["input_norm"])
            q, k, v = qkv_proj(cfg, p["attn"], h)
            rec["qkv"] = torch.cat([q.flatten(2), k.flatten(2), v.flatten(2)], -1)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            rec["rope"] = torch.cat([q.flatten(2), k.flatten(2)], -1)
            write(c, k, v)
            out = rec["attention"] = attend(q, c)
            x = rec["o_proj_residual"] = x + linear(out, p["attn"]["o"]) * r
            rec["post_norm_mean"] = mean_sq(x, by_row)
            n2 = rec["post_norm"] = norm(x, p["post_norm"])
            x = rec["mlp_residual"] = x + linear(mlp_act(cfg, p["mlp"], n2, EAGER.act), p["mlp"]["down"]) * r
            return x, rec

        def head(h, norm):
            hn = norm(h, params["final_norm"])
            return hn, td._lm_logits(cfg, params, hn)

        # 8 single steps over a copy of the greedy-sized cache
        steps = []
        scache = [{n: c[n][:, :t_total].clone() for n in ("k", "v")} for c in cache]
        svalid = kv_valid[:, :t_total].clone()
        for j in range(Q):
            svalid[:, S + j] = True
            cos, sin = rope_tables((lengths + j)[:, None], hd, cfg.rope_theta)
            h = td.embed(cfg, params["embed"], tokens[:, j : j + 1], torch.bfloat16)
            recs = []

            def write(c, k, v, pos=S + j):
                c["k"][:, pos] = k[:, 0]
                c["v"][:, pos] = v[:, 0]

            def attend(q, c):
                return td._attend_cache(cfg, q, *td._cache_operands(c, t_total), svalid[:, None, :], torch.bfloat16)

            for idx in range(cfg.num_hidden_layers):
                h, rec = layer(params["layers"][idx], h, cos, sin, scache[idx], write, attend,
                               lambda t, w: rms_norm(t, w, eps))
                recs.append(rec)
            hn, logits = head(h, lambda t, w: rms_norm(t, w, eps))  # generate_greedy's [B, 1, D] form
            steps.append((recs, hn[:, 0], logits[:, 0]))

        j_idx = torch.arange(Q, device=dev)[None, :]
        slots = S + j_idx.expand(B, Q)
        rows = torch.arange(B, device=dev)[:, None]
        cos, sin = rope_tables(lengths[:, None] + j_idx, hd, cfg.rope_theta)

        def block_attend(q, c, t):
            t_idx = torch.arange(t, device=dev)[None, None, :]
            allowed = kv_valid[:, None, :t] | ((t_idx >= S) & (t_idx <= slots[:, :, None]))
            if t == t_cache:  # the verify attention before its repair: all Q rows in one einsum
                qg = q.reshape(B, Q, nkv, nh // nkv, hd)
                logits = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), c["k"].float()) * hd ** -0.5
                logits = torch.where(allowed[:, None, None], logits, td.MASK_VALUE)
                probs = torch.softmax(logits, dim=-1).to(torch.bfloat16)
                return torch.einsum("bkgqt,btkd->bqkgd", probs, c["v"]).reshape(B, Q, nh * hd)
            return td._attend_cache(cfg, q, *td._cache_operands(c, t), allowed, torch.bfloat16)

        def write_block(c, k, v):
            c["k"][rows, slots] = k
            c["v"][rows, slots] = v

        results = []
        variants = {"block": (t_cache, False), "row_attention": (t_total, False), "row_norms": (t_cache, True),
                    "rows": (t_total, True)}
        for name, (t, row_norms) in variants.items():
            norm = (lambda x, w: td._row_norm(x, w, eps)) if row_norms else (lambda x, w: rms_norm(x, w, eps))
            bcache = [{n: c[n].clone() for n in ("k", "v")} for c in cache]
            h = td.embed(cfg, params["embed"], tokens, torch.bfloat16)
            first, n_diff = None, 0
            for idx in range(cfg.num_hidden_layers):
                h, rec = layer(params["layers"][idx], h, cos, sin, bcache[idx], write_block,
                               lambda q, c: block_attend(q, c, t), norm, row_norms)
                for op in OPS:
                    differs = [j for j in range(Q) if not torch.equal(rec[op][:, j], steps[j][0][idx][op][:, 0])]
                    if differs:
                        n_diff += 1
                        if first is None:
                            first = {"layer": idx, "op": op, "rows": differs}
            hn, logits = head(h, norm)
            same_norm = all(torch.equal(hn[:, j], steps[j][1]) for j in range(Q))
            same_logits = all(torch.equal(logits[:, j], steps[j][2]) for j in range(Q))
            same_argmax = all(torch.equal(logits[:, j].argmax(-1), steps[j][2].argmax(-1)) for j in range(Q))
            results.append({"variant": name, "first_difference": first, "differing_layer_ops": n_diff,
                            "of": cfg.num_hidden_layers * len(OPS), "final_norm_equal": same_norm,
                            "logits_equal": same_logits, "argmax_equal": same_argmax})
            print(json.dumps(results[-1]), flush=True)
            del bcache

        # the repaired verify layer itself, layer outputs against the steps'
        bcache = [{n: c[n].clone() for n in ("k", "v")} for c in cache]
        t_idx = torch.arange(t_total, device=dev)[None, None, :]
        allowed = kv_valid[:, None, :t_total] | ((t_idx >= S) & (t_idx <= slots[:, :, None]))
        h = td.embed(cfg, params["embed"], tokens, torch.bfloat16)
        bad = []
        for idx in range(cfg.num_hidden_layers):
            h = td._verify_layer(cfg, params["layers"][idx], h, slots, allowed, cos, sin, bcache[idx])
            if not all(torch.equal(h[:, j], steps[j][0][idx]["mlp_residual"][:, 0]) for j in range(Q)):
                bad.append(idx)
        results.append({"variant": "decode._verify_layer", "layers_differing": bad})
        print(json.dumps(results[-1]), flush=True)
    smi = chip_smoke.run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "probe_verify.json"), "w") as f:
        json.dump({"device": smi, "bucket": S, "batch": B, "results": results}, f, indent=1)
    return 0


def generate(torch, td, cfg, params, ids, mask, max_new, chip_smoke) -> int:
    """Plain greedy (twice: is it deterministic?), spec 0 and spec 7 on one
    batch: the logits behind every emitted token, fingerprinted (two float64
    sums of their bit patterns), and each layer's output at the position
    that emitted it."""
    dev = ids.device
    B, S = ids.shape
    eos = torch.tensor(chip_smoke.QWEN2_EOS, dtype=torch.int32, device=dev)
    active = torch.arange(B, device=dev) < B - 1
    real = {n: getattr(td, n) for n in ("_lm_logits", "_ngram_draft", "_decode_layer", "_verify_layer")}
    rec, ends, layers = [], [], []

    def fingerprint(v):
        # integer sums of the f32 bit patterns: exact in any order (a float
        # sum over the vocabulary would itself round by the row count)
        bits = v.view(torch.int32).long()
        w = torch.arange(v.shape[-1], device=v.device, dtype=torch.int64)
        top = v.topk(2, dim=-1).values
        return torch.stack([bits.sum(-1), (bits * w).sum(-1), ((top[..., 0] - top[..., 1]) * 2**20).long(),
                            v.argmax(-1)], -1).cpu()

    def logits_hook(*a):
        out = real["_lm_logits"](*a)
        rec.append(fingerprint(out.float()))
        return out

    def draft_hook(buf, start, end, *a):
        ends.append((end - S).cpu())
        return real["_ngram_draft"](buf, start, end, *a)

    def layer_hook(name):
        def hook(*a):
            out = real[name](*a)
            layers.append(out[:, 0].clone())  # position 0 of the block, or the step
            return out
        return hook

    td._lm_logits, td._ngram_draft = logits_hook, draft_hook
    td._decode_layer, td._verify_layer = layer_hook("_decode_layer"), layer_hook("_verify_layer")
    runs = {}
    with torch.inference_mode():
        for name, spec in (("greedy", None), ("greedy_again", None), ("spec0", 0), ("spec", SPEC)):
            rec, ends, layers, stats = [], [], [], {}
            if spec is None:
                toks = td.generate_greedy(cfg, params, ids, mask, eos, max_new, active=active, stats=stats)
            else:
                toks = td.generate_greedy_spec(cfg, params, ids, mask, eos, max_new, draft_len=spec, active=active,
                                               stats=stats)
            runs[name] = (toks.cpu(), rec, ends, layers)
            print(json.dumps({"run": name, "steps": stats["steps"],
                              "ms_per_step": stats["decode_ms"] / max(stats["steps"], 1)}), flush=True)
    for n, f in real.items():
        setattr(td, n, f)

    def tokens_map(name):
        """(row, token) -> (fingerprint, block position, forward index)."""
        _, r, e, _ = runs[name]
        out = {(b, 0): (r[0][b], None, None) for b in range(B)}
        if not e:  # greedy: call t gives token t
            for t in range(1, len(r)):
                for b in range(B):
                    out[(b, t)] = (r[t][b], 0, t - 1)
            return out
        for k in range(1, len(r)):  # block k's position j < n_(k+1) - n_k gives token n_k + j
            n = e[k - 1]
            n_next = e[k] if k < len(e) else torch.full_like(n, max_new)
            for b in range(B):
                for j in range(min(int(n_next[b] - n[b]), r[k].shape[1])):
                    out[(b, int(n[b]) + j)] = (r[k][b, j], j, k - 1)
        return out

    nl = cfg.num_hidden_layers
    ref = tokens_map("greedy")
    ref_layers = runs["greedy"][3]
    results = []
    for name in ("greedy_again", "spec0", "spec"):
        got = tokens_map(name)
        got_layers = runs[name][3]
        for b in range(B - 1):
            first = None
            for t in range(max_new):
                if (b, t) not in got or (b, t) not in ref:
                    break
                if not torch.equal(got[(b, t)][0][:2], ref[(b, t)][0][:2]):
                    g_idx, r_idx = got[(b, t)][2], ref[(b, t)][2]
                    layer = None
                    if got[(b, t)][1] == 0 and g_idx is not None and r_idx is not None:
                        diff = [L for L in range(nl)
                                if not torch.equal(got_layers[g_idx * nl + L][b], ref_layers[r_idx * nl + L][b])]
                        layer = diff[0] if diff else "none (final norm or head)"
                    first = {"token": t, "block_position": got[(b, t)][1], "first_layer": layer,
                             "greedy_margin": float(ref[(b, t)][0][2]) / 2**20,
                             "argmax_equal": bool(got[(b, t)][0][3] == ref[(b, t)][0][3])}
                    break
            toks_equal = int((runs[name][0][b] == runs["greedy"][0][b]).sum())
            results.append({"run": name, "row": b, "first_logits_difference": first, "tokens_equal": toks_equal})
            print(json.dumps(results[-1]), flush=True)
    print(json.dumps({"spec_blocks": len(runs["spec"][2]), "greedy_steps": len(runs["greedy"][1]) - 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
