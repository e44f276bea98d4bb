#!/usr/bin/env python3
"""H100 probe for K2's unpack (``easyrag_tpu_torch/csrc/probe_int4.cu``).

Run from the root of a checkout, on a machine with an NVIDIA GPU:
``python3 tools/torch_probe_int4.py [--rows 1 32] [--against DIR]``. It
builds the probe library with the port's ``_build`` (``nvcc`` for sm_90a)
and asks the two questions ``tools/exp_int4_unpack.py`` asked of the TPU:

* WHERE: per decode shape (that probe's q 3584x3584, kv 512x3584, gate
  18944x3584 and down 3584x18944, plus the fused qkv and gateup the port
  runs), how many GB/s of packed weights does the matvec stream, at 1 and 32
  rows of activations?
* WHY: does the unpack cost time beside the loads? The same production loop
  (``csrc/int4_matvec.cuh``: the same plan, ring, products and reduction)
  runs with each unpack variant: the first port's shift-and-convert
  (``shift_f32``), the TPU probe's ``i8shift`` and ``xormask``, and Hopper's
  ``prmt``/``lop3`` + ``__hsub2`` (``magic``, production). Every variant's
  bf16 output must equal the first variant's bit for bit (the nibbles are
  exact, and no variant changes the order of any sum), and the first must
  agree with the plain version within ``chip_smoke.K2_RTOL`` /
  ``K2_ROW_ATOL``. ``loads_only`` runs the same copies and waits with no
  unpack and no products: the time the loop costs beside the bytes is the
  difference (its output is not compared).

``--plan NAME=KS,NBLK ...`` also times ``magic`` at another plan (K slices,
blocks per slice) for the named shape, in turns with the wrapper's plan
(``ops/int4_matvec.py::plan``), each checked against the plain version.

Times are ``chip_smoke.graph_ms``: CUDA events around a CUDA graph of at
least 50 launches that cycle through copies of the weights four times the
size of the L2 (``chip_smoke.cold_weights``), as a decode step reads every
layer's weights from HBM. With ``--against DIR`` the probe also times the
``int4_matvec`` of another checkout at ``DIR`` (for example the parent
commit, unpacked with ``git archive``) on the same inputs, in the same
process, in turns with this one. Each line is JSON with the card's
``nvidia-smi`` name and power limit; the lines also go to
``build/probe_int4.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {  # [O, I/2]
    "q": (3584, 1792), "kv": (512, 1792), "gate": (18_944, 1792), "down": (3584, 9472),
    "qkv": (4608, 1792), "gateup": (37_888, 1792),
}
# variant: csrc/int4_matvec.cuh's Unpack; "magic" is production (csrc/int4_matvec.cu)
VARIANTS = {"shift_f32": 0, "i8shift": 1, "xormask": 2, "magic": 3, "loads_only": 4}
UNCHECKED = ("loads_only",)  # no products: its output is not compared


def load_checkout(path: str, alias: str):
    """``ops.int4_matvec`` of the port in another checkout, imported as the
    package ``alias`` (its kernels build under that checkout's ``build/``)."""
    pkg = os.path.join(os.path.abspath(path), "easyrag_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.int4_matvec")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 32])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--against", default="", help="another checkout whose int4_matvec is timed beside this one")
    ap.add_argument("--plan", nargs="+", default=[], metavar="NAME=KS,NBLK",
                    help="another plan timed beside the wrapper's for shape NAME")
    args = ap.parse_args()
    alt_plans = {}
    for item in args.plan:
        name, ks_nblk = item.split("=")
        alt_plans.setdefault(name, []).append(tuple(int(v) for v in ks_nblk.split(",")))

    import torch

    if not torch.cuda.is_available():
        print("torch_probe_int4: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from easyrag_tpu_torch import _build
    from easyrag_tpu_torch.ops import int4_matvec as k2

    _build.build(["probe_int4", "int4_matvec"])
    lib = _build.load("probe_int4")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_int4_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
    lib.probe_int4_launch.restype = ctypes.c_int
    for line in _build.build_logs.get("probe_int4", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.split("info    :")[-1].strip())
    other = load_checkout(args.against, "against_port") if args.against else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 7)
    rows_out = []

    def record(row):
        row["card"] = smi
        rows_out.append(row)
        print(json.dumps(row), flush=True)

    for name in args.shapes:
        n_out, half = SHAPES[name]
        ks, nblk = k2.plan(n_out, half, sms)
        x_all, w, scale = smoke.k2_case(torch, gen, n_out, half, max(args.rows))
        cold, n_copies = smoke.cold_weights(w, scale)
        reps = max(50, n_copies)
        for rows in args.rows:
            x = x_all[:rows].contiguous()
            out = torch.empty((rows, n_out), dtype=torch.bfloat16, device="cuda")
            wss = {}  # a workspace per plan

            def run(v, wt, st, plan=(ks, nblk), out=out, x=x, rows=rows, wss=wss):
                if plan not in wss:
                    wss[plan] = torch.empty((plan[0], rows, n_out), dtype=torch.float32, device="cuda") if plan[0] > 1 else None
                ws = wss[plan]
                _build.check(lib.probe_int4_launch(v, x.data_ptr(), wt.data_ptr(), st.data_ptr(), out.data_ptr(),
                                                   ws.data_ptr() if ws is not None else None, rows, n_out, half,
                                                   *plan, torch.cuda.current_stream().cuda_stream),
                             "probe_int4_launch")

            ref = k2.int4_matvec_plain(x, w, scale).float()
            bound = smoke.K2_RTOL * ref.abs() + smoke.K2_ROW_ATOL * ref.abs().amax(dim=1, keepdim=True)

            def plain_ratio(plan, vname):
                run(VARIANTS["magic"], w, scale, plan)
                torch.cuda.synchronize()
                ratio = float(((out.float() - ref).abs() / bound).max())
                if ratio > 1.0:
                    raise RuntimeError(f"{name} R={rows}: {vname} disagrees with the plain version ({ratio:.3f} of the bound)")
                return ratio

            first = None
            for vname, v in VARIANTS.items():
                run(v, w, scale)
                torch.cuda.synchronize()
                got = out.clone()
                if first is None:
                    first = got
                    ratio = float(((got.float() - ref).abs() / bound).max())
                    if ratio > 1.0:
                        raise RuntimeError(f"{name} R={rows}: {vname} disagrees with the plain version ({ratio:.3f} of the bound)")
                same = torch.equal(got, first)
                if not same and vname not in UNCHECKED:
                    raise RuntimeError(f"{name} R={rows}: {vname}'s output differs from shift_f32's")
                ms = smoke.graph_ms(torch, lambda v=v: run(v, *next(cold)), n=reps)
                record({"shape": name, "O": n_out, "half": half, "rows": rows, "ks": ks, "nblk": nblk,
                        "variant": vname, "ms": ms, "gb_s": n_out * half / ms / 1e6,
                        "bound_share": n_out * half / smoke.PEAK_BYTES * 1e3 / ms, "bits_equal_first": same,
                        "plain_bound_ratio": ratio})
            for alt in alt_plans.get(name, []):  # the wrapper's plan, then the other, in turns
                for plan in ((ks, nblk), alt, alt, (ks, nblk)):
                    vname = "magic_plan" if plan == (ks, nblk) else "magic_alt_plan"
                    ratio = plain_ratio(plan, vname)
                    ms = smoke.graph_ms(torch, lambda plan=plan: run(VARIANTS["magic"], *next(cold), plan), n=reps)
                    record({"shape": name, "O": n_out, "half": half, "rows": rows, "ks": plan[0], "nblk": plan[1],
                            "variant": vname, "ms": ms, "gb_s": n_out * half / ms / 1e6,
                            "bound_share": n_out * half / smoke.PEAK_BYTES * 1e3 / ms, "plain_bound_ratio": ratio})
            if other is not None:  # the other checkout, then this one's wrapper, in turns
                for label, mod in (("against", other), ("wrapper", k2), ("wrapper", k2), ("against", other)):
                    ms = smoke.graph_ms(torch, lambda mod=mod: mod.int4_matvec(x, *next(cold)), n=reps)
                    record({"shape": name, "O": n_out, "half": half, "rows": rows, "variant": label, "ms": ms,
                            "gb_s": n_out * half / ms / 1e6, "bound_share": n_out * half / smoke.PEAK_BYTES * 1e3 / ms})
        del cold, x_all, w, scale
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "probe_int4.json"), "w") as fh:
        json.dump(rows_out, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
