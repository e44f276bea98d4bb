// Matvec over nibble-packed int4 weights, for R <= 64 rows of activations.
//
// Replaces easyrag_tpu/ops/int4_matvec.py::int4_matvec (K2), every int4
// projection of a decode step (q/k/v or the fused qkv, o, gate/up or the
// fused gateup, down) and the int4 LM head. Same contract: x [R, I] bf16,
// w_p [O, I/2] int8 in the halves layout (byte w_p[o, i] holds column i in
// its low nibble and column i + I/2 in its high nibble), scale [O] f32, and
//   y[r, o] = bf16((sum_i x[r, i] * nib[o, i]) * scale[o]),  f32 sums.
//
// Bound on the H100: the packed bytes. At Qwen2-7B a decode step reads
// ~3.5 GB of them (~1.05 ms at 3.35 TB/s), so the design is about reading
// each byte once, 16 bytes a load, and keeping the unpack out of memory:
//
//   * one block of 8 warps owns 16 output channels (one m16n8k16 M tile);
//     its warps split I/2 in 64-byte steps (warp w takes steps w, w+8, ...),
//     so blocks are many enough to keep the card's memory busy even at
//     O = 3584;
//   * in each step a lane loads 16 bytes of row g and 16 of row g+8
//     (g = lane/4) with two 16-byte loads, unpacks both nibbles in
//     registers into bf16 pairs (the values -7..7 are exact) and feeds them
//     to mma.sync.m16n8k16 as the A operand: 8 tensor-core products per step
//     (4 over low nibbles, 4 over high). The k order inside each product is
//     permuted so that every lane's 16 bytes form its own fragments; x is
//     read in the same permuted order, so the sum is the same;
//   * x does not fit in shared memory whole (64 x 18944 bf16 is 2.4 MB), so
//     the block stages it in chunks of 512 packed columns, both halves of
//     each chunk (x[:, c0:c0+512] and x[:, I/2+c0 : I/2+c0+512]), rows past
//     R as zeros; the next step's weights are loaded before the chunk is
//     staged, so their latency overlaps the staging;
//   * the 8 warps' partial sums are added in warp order through shared
//     memory, then scaled in f32 and rounded once to bf16.
//
// Each output's sum is taken in one order whatever R is: the same products
// over the same k slices, the same warp split and the same final additions;
// a product's result for one row of x does not depend on the other rows.
// So a row's result has the same bits at R = 1 and at R = 32.
//
// The shape gate (ops/int4_matvec.py::supported): I/2 % 64 == 0,
// O % 16 == 0, 1 <= R <= 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;    // threads per block
constexpr int BM = 16;            // output channels per block
constexpr int STEP = 64;          // packed bytes of a row per warp step
constexpr int CW = WARPS * STEP;  // packed columns per staged chunk
constexpr int LDX = 2 * CW + 8;   // bf16 per staged x row: lo chunk, hi chunk, pad against bank conflicts

__device__ __forceinline__ int lo_nib(uint32_t word, int i) {  // low nibble of byte i, sign-extended
  return ((int)(word << (28 - 8 * i))) >> 28;
}

__device__ __forceinline__ int hi_nib(uint32_t word, int i) {  // high nibble of byte i, sign-extended
  return ((int)(word << (24 - 8 * i))) >> 28;
}

__device__ __forceinline__ uint32_t pack2(int a, int b) {  // two small ints -> bf16x2 (a in the low half)
  __nv_bfloat162 v = __floats2bfloat162_rn((float)a, (float)b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t nib_pair(uint32_t word, int i, bool high) {
  return high ? pack2(hi_nib(word, i), hi_nib(word, i + 1)) : pack2(lo_nib(word, i), lo_nib(word, i + 1));
}

// NTILES 8-row tiles of x rows (R <= 8 * NTILES).
template <int NTILES>
__global__ void __launch_bounds__(NT)
int4_matvec_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                   int R, int O, int half) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [8*NTILES][LDX]
  float* red = reinterpret_cast<float*>(smem);                  // [WARPS][8*NTILES][BM], after the loop
  constexpr int RP = 8 * NTILES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma group: output rows g and g+8, x row g of each tile
  const int t = lane & 3;   // thread in group: this lane's 16 bytes of each step
  const int o0 = blockIdx.x * BM;
  const int8_t* wrow = w + (size_t)(o0 + g) * half + t * 16;
  const size_t row8 = (size_t)8 * half;

  float acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int nchunks = (half + CW - 1) / CW;
  uint4 wa = make_uint4(0, 0, 0, 0), wb = wa;
  if (warp * STEP < half) {
    wa = *reinterpret_cast<const uint4*>(wrow + warp * STEP);
    wb = *reinterpret_cast<const uint4*>(wrow + row8 + warp * STEP);
  }
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * CW;
    const int k0 = c0 + warp * STEP;  // this warp's packed columns [k0, k0 + 64)
    // the next chunk's weights, in flight while this chunk is staged and used
    uint4 na = make_uint4(0, 0, 0, 0), nb = na;
    if (k0 + CW < half) {
      na = *reinterpret_cast<const uint4*>(wrow + k0 + CW);
      nb = *reinterpret_cast<const uint4*>(wrow + row8 + k0 + CW);
    }
    __syncthreads();  // every warp is done with the previous chunk
    for (int u = threadIdx.x; u < RP * (2 * CW / 8); u += NT) {
      const int r = u / (2 * CW / 8);
      const int j = (u % (2 * CW / 8)) * 8;  // column in [0, 2*CW)
      const int hh = j >= CW;                // 0: low half of x, 1: high half
      const int col = c0 + j - hh * CW;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < R && col < half)
        val = *reinterpret_cast<const uint4*>(x + (size_t)r * 2 * half + (size_t)hh * half + col);
      *reinterpret_cast<uint4*>(xs + r * LDX + j) = val;
    }
    __syncthreads();
    if (k0 < half) {
      const uint32_t aw[4] = {wa.x, wa.y, wa.z, wa.w};  // row g: bytes 4s..4s+3 in word s
      const uint32_t bw[4] = {wb.x, wb.y, wb.z, wb.w};  // row g+8
      const int xc = warp * STEP + t * 16;               // this lane's x columns in the chunk
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // low nibbles, then high nibbles
        // A fragments of the 4 products: logical k 2t, 2t+1 <- bytes 4s,
        // 4s+1 of word s; k 2t+8, 2t+9 <- bytes 4s+2, 4s+3
        uint32_t a[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          a[s][0] = nib_pair(aw[s], 0, hh);
          a[s][1] = nib_pair(bw[s], 0, hh);
          a[s][2] = nib_pair(aw[s], 2, hh);
          a[s][3] = nib_pair(bw[s], 2, hh);
        }
#pragma unroll
        for (int n = 0; n < NTILES; ++n) {
          // x row n*8+g, the same 16 columns in the same permuted order
          const __nv_bfloat16* xr = xs + (n * 8 + g) * LDX + hh * CW + xc;
          const uint4 x0 = *reinterpret_cast<const uint4*>(xr);
          const uint4 x1 = *reinterpret_cast<const uint4*>(xr + 8);
          const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int s = 0; s < 4; ++s) mma(acc[n], a[s][0], a[s][1], a[s][2], a[s][3], xw[2 * s], xw[2 * s + 1]);
        }
      }
    }
    wa = na;
    wb = nb;
  }

  __syncthreads();  // the staging buffer becomes the reduction buffer
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const int r = n * 8 + 2 * t;
    red[(warp * RP + r) * BM + g] = acc[n][0];
    red[(warp * RP + r + 1) * BM + g] = acc[n][1];
    red[(warp * RP + r) * BM + g + 8] = acc[n][2];
    red[(warp * RP + r + 1) * BM + g + 8] = acc[n][3];
  }
  __syncthreads();
  for (int u = threadIdx.x; u < RP * BM; u += NT) {
    const int r = u / BM;
    const int m = u % BM;
    if (r >= R) continue;
    float s = red[r * BM + m];
#pragma unroll
    for (int wi = 1; wi < WARPS; ++wi) s = __fadd_rn(s, red[(wi * RP + r) * BM + m]);
    y[(size_t)r * O + o0 + m] = __float2bfloat16_rn(__fmul_rn(s, scale[o0 + m]));
  }
}

template <int NTILES>
int launch(const void* x, const void* w, const void* scale, void* y, int R, int O, int half,
           cudaStream_t stream) {
  constexpr int RP = 8 * NTILES;
  const int stage = RP * LDX * (int)sizeof(__nv_bfloat16);
  const int reduce = WARPS * RP * BM * (int)sizeof(float);
  const int smem = stage > reduce ? stage : reduce;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int4_matvec_kernel<NTILES>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int4_matvec_kernel<NTILES><<<O / BM, NT, smem, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, (__nv_bfloat16*)y, R, O, half);
  return (int)cudaGetLastError();
}

}  // namespace

// x [R, 2*half] bf16, w [O, half] int8, scale [O] f32, y [R, O] bf16.
// The caller checks the shape gate. Returns the cudaError_t of the launch.
extern "C" int int4_matvec_launch(const void* x, const void* w, const void* scale, void* y,
                                  int R, int O, int half, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0 || R > 64 || O % BM || half % STEP) return (int)cudaErrorInvalidValue;
  if (R <= 8) return launch<1>(x, w, scale, y, R, O, half, s);
  if (R <= 16) return launch<2>(x, w, scale, y, R, O, half, s);
  if (R <= 32) return launch<4>(x, w, scale, y, R, O, half, s);
  return launch<8>(x, w, scale, y, R, O, half, s);
}
