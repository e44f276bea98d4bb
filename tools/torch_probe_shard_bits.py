#!/usr/bin/env python3
"""H100 probe: does a column range of a product or a reduction give the
whole row's bits? The question behind ``easyrag_tpu_torch/parallel/
sharded.py``'s shard widths.

Run from the root of a checkout, on a machine with an NVIDIA GPU:
``python3 tools/torch_probe_shard_bits.py`` (about 15 s). A sharded index
scores each doc range on its own; it returns the single-chip index's scores
bit for bit only if each range's arithmetic adds in the single-chip order.
On seeded inputs at phase 3's and phase 7's shapes of ``chip_smoke.py``, for
shard widths 5000 (20,000 docs over 4), 6667 (over 3, JAX's ``ceil(N/D)``),
6668 and 6672:

1. the resident BM25 heavy part's gather form
   (``ops/bm25_resident.py::heavy_part``): ``(w[:, :, None] *
   heavy[rows]).sum(1)`` over 64 rows of 64 term slots, each shard's
   columns against the whole row's;
2. the dense index's product (``index/dense.py::dense_scores``): 64 bf16
   queries against the bf16 rows, ``torch.mm(..., out_dtype=float32)``, and
   the f32 form ``q @ m.T``, each row range against the whole matrix's.

Prints one JSON line per (form, width, shard): equal bits or not, and the
largest difference; the last line holds the card's name and ``nvidia-smi``
power limit. Each line also goes to ``build/probe_shard_bits.json``.
"""

from __future__ import annotations

import json
import os
import subprocess

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (5000, 6667, 6668, 6672)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_probe_shard_bits: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    H, N, B, T = 4192, 20000, 64, 64  # phase 3's f32 heavy matrix, a stream batch, the term budget
    lines = []

    def emit(**rec):
        lines.append(rec)
        print(json.dumps(rec))

    heavy = torch.rand(H, N, generator=g, device=dev)
    hrow = torch.randint(0, H, (B, T), generator=g, device=dev)
    w = torch.randint(1, 4, (B, T), generator=g, device=dev).float()

    def part(h):
        return (w[:, :, None] * h[hrow].float()).sum(1)

    full = part(heavy)
    for S in WIDTHS:
        for s in range(-(-N // S)):
            lo = s * S
            cols = heavy[:, lo : lo + S].contiguous()
            got = part(cols)
            ref = full[:, lo : lo + got.shape[1]]
            emit(form="heavy gather sum", width=S, shard=s, equal=torch.equal(got.view(torch.int32), ref.contiguous().view(torch.int32)),
                 max_abs=float((got - ref).abs().max()))
    for dt in (torch.bfloat16, torch.float32):
        m = torch.randn(N, 3584, generator=g, device=dev).to(dt)
        q = torch.randn(B, 3584, generator=g, device=dev).to(dt)

        def mm(a, b):
            return torch.mm(a, b.t(), out_dtype=torch.float32) if dt == torch.bfloat16 else a @ b.t()

        whole = mm(q, m)
        for S in (5000, 6667, 6672):
            for s in range(-(-N // S)):
                lo = s * S
                got = mm(q, m[lo : lo + S].contiguous())
                ref = whole[:, lo : lo + got.shape[1]].contiguous()
                emit(form=f"dense {str(dt).split('.')[-1]} product", width=S, shard=s,
                     equal=torch.equal(got.view(torch.int32), ref.view(torch.int32)), max_abs=float((got - ref).abs().max()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "probe_shard_bits.json"), "w") as f:
        f.write("\n".join(json.dumps(rec) for rec in lines) + "\n")


if __name__ == "__main__":
    main()
