#!/bin/bash
# Mutation check of the K4 kernel (easyrag_tpu_torch/csrc/flash_softcap.cu):
# plants one fault at a time in a throwaway copy of the checkout under the
# git-ignored build/, then runs chip_smoke.py's K4 comparison at the Gemma2
# reranker's three shapes and the `cuda` tests of
# tests/test_torch_flash_softcap.py on that copy. The first copy is
# unmodified and must pass; every faulty copy should fail. Needs one CUDA
# card and nvcc.
#
#   bash tools/torch_mutate_k4.sh
set -u
cd "$(dirname "$0")/.."
SRC=easyrag_tpu_torch/csrc/flash_softcap.cu
names=(control softcap_dropped diagonal_masked no_rescale gqa_map tail_rows)
exprs=(
  's/^$//'
  's/if (softcap > 0.0f) x = tanhf(x \/ softcap) \* softcap;//'
  's/k0 + quarter \* 16 + c > qrow/k0 + quarter * 16 + c >= qrow/'
  's/o\[c\] \*= alpha;/;/'
  's/const int kvh = h \/ (NH \/ NKV);/const int kvh = h % NKV;/'
  's/if (row < S) val/if (row < S - 8) val/'
)
for i in "${!names[@]}"; do
  name=${names[$i]}
  d=build/mut_$name
  rm -rf "$d"; mkdir -p "$d"
  tar --exclude=./build --exclude=./chiprun_out --exclude=./.git -cf - . | tar -xf - -C "$d"
  sed -i "${exprs[$i]}" "$d/$SRC"
  if [ "$name" != control ] && cmp -s "$SRC" "$d/$SRC"; then echo "== $name: NOT APPLIED"; continue; fi
  echo "== $name: $(diff "$SRC" "$d/$SRC" | grep '^>' | head -1)"
  (cd "$d" && python3 - <<'PY'
import numpy as np, torch
import chip_smoke as cs
from easyrag_tpu_torch.ops import flash_softcap as k4
for B, S, lengths, args, real in cs.k4_cases(torch, np, cs.SEED + 6):
    try:
        err, rel = cs.k4_compare(torch, k4, args, real)
        print(f"smoke K4 B={B} S={S}: passes ({rel:.3e} of the row)")
    except cs.SmokeFailure as exc:
        print(f"smoke K4 B={B} S={S}: FAILS: {exc}")
PY
  )
  (cd "$d" && python3 -m pytest tests/test_torch_flash_softcap.py -m cuda -q -rA -p no:cacheprovider 2>&1 | grep -E "^(PASSED|FAILED)|passed|failed")
done
