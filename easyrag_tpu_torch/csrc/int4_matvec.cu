// Matvec over nibble-packed int4 weights, for R <= 64 rows of activations.
//
// Replaces easyrag_tpu/ops/int4_matvec.py::int4_matvec (K2), every int4
// projection of a decode step and of a verify block (q/k/v or the fused qkv,
// o, gate/up or the fused gateup, down) and the int4 LM head. The kernel
// body, its design and the bound it works against are in int4_matvec.cuh.
//
// The shape gate (ops/int4_matvec.py::supported): I/2 % 64 == 0,
// O % 16 == 0, 1 <= R <= 64. The plan (K slices, blocks per slice) comes from
// ops/int4_matvec.py::plan, a function of (O, I/2) only.

#include "int4_matvec.cuh"

// The unpack tools/torch_probe_int4.py found fastest on the H100.
constexpr int UNPACK = int4mv::UNPACK_MAGIC;

// x [R, 2*half] bf16, w [O, half] int8, scale [O] f32, y [R, O] bf16; ws
// [ks, R, O] f32 when ks > 1 (null otherwise); all 16-byte aligned. Returns
// the cudaError_t of the launches.
extern "C" int int4_matvec_launch(const void* x, const void* w, const void* scale, void* y, void* ws, int R, int O,
                                  int half, int ks, int nblk, void* stream) {
  return int4mv::launch<UNPACK>(x, w, scale, y, ws, R, O, half, ks, nblk, (cudaStream_t)stream);
}
