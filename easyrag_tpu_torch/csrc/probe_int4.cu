// H100 probe for K2's unpack; on no path of the system and not in the smoke.
//
// Asks on Hopper what tools/exp_int4_unpack.py:109 asked of the TPU: at each
// decode shape, how many GB/s of packed weights the matvec streams, and
// whether the nibble unpack costs time beside the loads. Every variant runs
// the production loop of int4_matvec.cuh (the same ring, products and
// reduction, at the plan (ks, nblk) it is given) and differs only in how a
// pair of nibbles becomes a bf16x2:
//   0  the first port's unpack: 32-bit shifts sign-extend, int -> f32 -> bf16;
//   1  the TPU probe's i8shift: sign extension in the 8-bit domain, then
//      int -> bf16 directly;
//   2  the TPU probe's xormask: ((n & 15) ^ 8) - 8, then int -> f32 -> bf16;
//   3  Hopper's (production): prmt and lop3 put the nibble (xor 8) under the
//      bf16 exponent of 128, one bf16x2 subtraction of 136;
//   4  loads only: the same copies and waits, no unpack and no products (its
//      outputs are meaningless): what the loop costs beside the bytes.
// Variants 0-3 give exactly -8..7, so all give the same output bits;
// tools/torch_probe_int4.py checks that and times them.

#include "int4_matvec.cuh"

extern "C" int probe_int4_launch(int variant, const void* x, const void* w, const void* scale, void* y, void* ws,
                                 int R, int O, int half, int ks, int nblk, void* stream) {
  using namespace int4mv;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case UNPACK_SHIFT_F32:
      return launch<UNPACK_SHIFT_F32>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
    case UNPACK_I8SHIFT:
      return launch<UNPACK_I8SHIFT>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
    case UNPACK_XORMASK:
      return launch<UNPACK_XORMASK>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
    case UNPACK_MAGIC:
      return launch<UNPACK_MAGIC>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
    case UNPACK_NONE:
      return launch<UNPACK_NONE>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
