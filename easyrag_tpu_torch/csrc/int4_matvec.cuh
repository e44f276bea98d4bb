// The int4 matvec's kernel body (K2), shared by csrc/int4_matvec.cu (the
// production entry point) and csrc/probe_int4.cu (the unpack probe, which
// runs the same loop with every unpack variant).
//
// Contract: x [R, I] bf16 with 1 <= R <= 64, w_p [O, I/2] int8 in the halves
// layout (byte w_p[o, i] holds column i in its low nibble and column i + I/2
// in its high nibble), scale [O] f32, and
//   y[r, o] = bf16((sum_i x[r, i] * nib[o, i]) * scale[o]),  f32 sums.
//
// Bound on the H100: the packed bytes (O * I/2 at 3.35 TB/s). The products
// (2 R O I) stay under them up to R = 32 at mma.sync's rate (gateup at R = 32:
// 8.7 GFLOP, ~14 us at the ~620 TFLOP/s tools/torch_probe_k1.py measured for
// mma.sync, against 20.3 us of bytes); at R = 64 they take longer. The
// design, limit by limit:
//
//   * x staged once per many outputs. I/2 is cut into `ks` K slices of at most
//     MAX_SLICE_STEPS 64-byte steps; block (j, s) stages x's columns of slice s
//     (both halves, ceil(R/8) row tiles; only the rows of the last tile past R
//     are zeros) into shared memory once, and its NW warps (8; 4 past R = 32)
//     then walk many 16-output tiles of that slice: warp w of block j takes
//     tiles j*NW + w, j*NW + w + NW*nblk, ... So x crosses from L2 once per block,
//     not once per 16 outputs. `ks` and `nblk` are the host's plan
//     (ops/int4_matvec.py::plan), a function of (O, I/2) only.
//   * the memory kept busy. Each row's slice is contiguous, so a tile's slice
//     is 16 bulk copies (cp.async.bulk, up to 512 bytes each, issued by lanes
//     0..15, marked evict-first in L2 so x and the partials stay) into the
//     warp's own two-stage ring, completing on the stage's mbarrier: 8 warps
//     x 2 stages x 7-9 KB, up to ~140 KB in flight per SM in runs of whole
//     slices, where 16-byte loads into registers (tried first) kept ~35% of
//     the bound at R=1. A warp refills a stage as soon as its lanes have read
//     it; no block barrier between weight steps, and every wait traps rather
//     than hangs. (A third stage, 16-byte cp.async copies by every lane, L2's
//     normal policy and 4 warps of 32 outputs were measured and were not
//     faster: PERF.md §6.)
//   * a fixed-order reduction across slices. With ks == 1 the warp scales and
//     rounds its own sums; otherwise it writes f32 partials to the workspace
//     ws[ks, R, O] and reduce_kernel, launched as a programmatic dependent so
//     that its launch overlaps the matvec's tail, adds them in slice order
//     (s = 0, 1, ...), scales in f32 and rounds once. No float atomics. (The
//     last block of each output group reducing in the matvec's own launch was
//     tried: its reads sat on the tail, 3-7x slower at R=32.)
//   * the unpack (template UNPACK): the variants the probe compares; the
//     production entry point takes the one the probe found fastest.
//   * the products: mma.sync m16n8k16 with the weights as A (16 outputs) and
//     x as B (8 rows); k is permuted so that every lane's 16 bytes form its own
//     fragments, and x is read from shared memory in the same permuted order.
//
// Each output's sum is taken in one order whatever R is: the same slices
// (fixed by O and I/2), inside a slice the same products in the same step
// order, the same cross-slice order; one x row's column of a product does not
// depend on the other rows. So a row's result has the same bits at R = 1 and
// R = 32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int4mv {
// Internal linkage: the production library and the probe library both
// instantiate these templates, and one process may load both; shared
// function-local statics (the shared-memory attribute flag) would otherwise
// be unified across them.
namespace {

constexpr int STEP = 64;             // packed bytes of a row per step
constexpr int MAX_SLICE_STEPS = 8;   // a K slice is at most 512 packed columns
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block may use
constexpr int CH = 4;                // accumulator chains per product tile
constexpr int STAGES = 2;            // ring stages per warp

// UNPACK_NONE (the probe's "loads only"): no unpack and no products, the
// weights only touched; its outputs are meaningless.
enum Unpack { UNPACK_SHIFT_F32 = 0, UNPACK_I8SHIFT = 1, UNPACK_XORMASK = 2, UNPACK_MAGIC = 3, UNPACK_NONE = 4 };

__host__ __device__ constexpr int ldx(int kc) { return 2 * kc + 8; }  // bf16 per staged x row, padded against bank conflicts

// two nibbles -> bf16x2 through f32 (a in the low half)
__device__ __forceinline__ uint32_t pack2_f32(int a, int b) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)a, (float)b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16x2 of the low (high == false) or high nibbles of bytes i and i + 1 of
// `word`, sign-extended, byte i in the low half. Every variant gives exactly
// -8..7.
template <int UNPACK>
__device__ __forceinline__ uint32_t nib_pair(uint32_t word, int i, bool high) {
  if constexpr (UNPACK == UNPACK_SHIFT_F32) {
    // the first port's unpack: shifts sign-extend each nibble in 32 bits, then int -> f32 -> bf16
    const int sh = high ? 24 : 28;
    return pack2_f32(((int)(word << (sh - 8 * i))) >> 28, ((int)(word << (sh - 8 * i - 8))) >> 28);
  } else if constexpr (UNPACK == UNPACK_I8SHIFT) {
    // the TPU probe's i8shift: sign extension in the 8-bit domain, then int -> bf16 directly
    const int8_t b0 = (int8_t)(word >> (8 * i)), b1 = (int8_t)(word >> (8 * i + 8));
    const int n0 = high ? (b0 >> 4) : ((int8_t)(b0 << 4) >> 4);
    const int n1 = high ? (b1 >> 4) : ((int8_t)(b1 << 4) >> 4);
    __nv_bfloat162 v;
    v.x = __int2bfloat16_rn(n0);
    v.y = __int2bfloat16_rn(n1);
    return *reinterpret_cast<uint32_t*>(&v);
  } else if constexpr (UNPACK == UNPACK_XORMASK) {
    // the TPU probe's xormask: ((n & 15) ^ 8) - 8, no sign-extending shifts
    const uint32_t w = high ? word >> 4 : word;
    return pack2_f32((int)(((w >> (8 * i)) & 15u) ^ 8u) - 8, (int)(((w >> (8 * i + 8)) & 15u) ^ 8u) - 8);
  } else {
    // Hopper: prmt puts byte i and i + 1 into the two halves, lop3 puts each
    // nibble (xor 8) under the bf16 exponent of 128 (0x4300 | m is 128 + m),
    // and one bf16x2 subtraction of 136 leaves the signed nibble, exactly
    uint32_t p = __byte_perm(word, 0u, i == 0 ? 0x4140 : 0x4342);
    if (high) p >>= 4;
    const uint32_t v = (p & 0x000F000Fu) ^ 0x43084308u;
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               __halves2bfloat162(__ushort_as_bfloat16(0x4308), __ushort_as_bfloat16(0x4308)));
    return *reinterpret_cast<uint32_t*>(&r);
  }
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spin == (1u << 26)) __trap();  // a wait that never ends is a fault, not a hang
  }
}
// `bytes` contiguous bytes from global to shared memory, completing on `bar`,
// with the L2 cache policy `policy` (evict first: weights are read once)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// Warps of a block for NTILES 8-row tiles of x, each warp one 16-output
// tile at a time: 8, or 4 at R > 32, where x's slice takes 132 KB.
__host__ __device__ constexpr int warps_for(int ntiles) { return ntiles == 8 ? 4 : 8; }
// Bytes between two weight rows of a ring stage: the slice's width padded to
// 64 mod 128, so the two rows a quarter-warp reads fall in different banks.
__host__ __device__ constexpr int row_pitch(int kc) { return kc % 128 == 0 ? kc + 64 : kc; }
// A ring stage: one warp tile's slice at the widest slice's pitch (no
// narrower slice has a wider pitch).
__host__ __device__ constexpr int stage_bytes(int kc_max) { return 16 * row_pitch(kc_max); }

// The shared memory a launch needs: x's widest slice for 8 * ntiles rows, then
// each warp's ring, then its barriers.
__host__ __device__ constexpr int x_bytes(int ntiles, int kc_max) { return 8 * ntiles * ldx(kc_max) * 2; }
__host__ __device__ constexpr int smem_bytes(int ntiles, int kc_max) {
  return x_bytes(ntiles, kc_max) + warps_for(ntiles) * STAGES * (stage_bytes(kc_max) + 8);
}

// NTILES 8-row tiles of x rows (R <= 8 * NTILES). Grid (nblk, ks). With ks >
// 1, the f32 partials go to ws [ks, R, O] for reduce_kernel.
template <int NTILES, int UNPACK>
__global__ void __launch_bounds__(32 * warps_for(NTILES), 1)
matvec_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int R, int O, int half) {
  constexpr int NW = warps_for(NTILES);
  constexpr int RP = 8 * NTILES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = gridDim.y, s = blockIdx.y;
  const int steps = half / STEP;
  const int st0 = s * steps / ks, nst = (s + 1) * steps / ks - st0;  // this slice's steps
  const int c0 = st0 * STEP, kc = nst * STEP;                        // its packed columns [c0, c0 + kc)
  const int kc_max = ((steps + ks - 1) / ks) * STEP;
  const int LDX = ldx(kc);
  const int pitch = row_pitch(kc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma group: outputs g and g + 8 of each 16-output tile, x row g of each 8-row tile
  const int t = lane & 3;   // thread in group: this lane's 16 bytes of each step
  const int sb = stage_bytes(kc_max);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ring = smem + x_bytes(NTILES, kc_max) + warp * STAGES * sb;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + x_bytes(NTILES, kc_max) + NW * STAGES * sb) + warp * STAGES;
  uint64_t policy;  // the weights are read once: evict them first, so x and the partials stay in L2
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  const int n_tiles = O / 16;
  const int wi = blockIdx.x * NW + warp, nw = gridDim.x * NW;
  const int my_tiles = wi < n_tiles ? (n_tiles - 1 - wi) / nw + 1 : 0;

  // this warp's tile i (outputs [16 (wi + i nw), + 16)) into stage i % STAGES:
  // one bulk copy of the slice per row, one row per lane
  auto fill = [&](int i) {
    uint64_t* bar = &full[i % STAGES];
    uint8_t* stage = ring + (i % STAGES) * sb;
    const int o0 = (wi + i * nw) * 16;
    if (lane == 0) mbar_expect_tx(bar, 16 * kc);
    __syncwarp();
    if (lane < 16) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the warp's reads of the stage come first
      bulk_copy(stage + lane * pitch, w + (size_t)(o0 + lane) * half + c0, kc, bar, policy);
    }
  };
  if (lane == 0) {
    for (int j = 0; j < STAGES; ++j) mbar_init(&full[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int i = 0; i < STAGES && i < my_tiles; ++i) fill(i);

  // x's slice columns, both halves, rows [0, 8 * NTILES); rows past R are zeros
  for (int u = threadIdx.x; u < RP * (2 * kc / 8); u += 32 * NW) {
    const int r = u / (2 * kc / 8);
    const int j = (u % (2 * kc / 8)) * 8;  // column in [0, 2 kc)
    const int hh = j >= kc;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < R) val = *reinterpret_cast<const uint4*>(x + (size_t)r * 2 * half + (size_t)hh * half + c0 + j - hh * kc);
    *reinterpret_cast<uint4*>(xs + r * LDX + j) = val;
  }
  __syncthreads();  // x is staged: the block's only barrier
  // the reduction's grid may start its launch now; it waits for this grid's end before reading ws
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  for (int i = 0; i < my_tiles; ++i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    const uint8_t* wt = ring + (i % STAGES) * sb + g * pitch + t * 16;
    // CH independent accumulators per product tile (chain c = 2 hh + q % 2), so
    // that at R = 1 the tensor cores are not waiting on one chain of eight
    // dependent products a step; added in chain order at the tile's end. The
    // structure is the same at every R.
    float acc[CH][NTILES][4];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int n = 0; n < NTILES; ++n) acc[c][n][0] = acc[c][n][1] = acc[c][n][2] = acc[c][n][3] = 0.0f;
    for (int k = 0; k < nst; ++k) {
      uint32_t aw[2][4];  // row g, row g + 8
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const uint4 v = *reinterpret_cast<const uint4*>(wt + 8 * h8 * pitch + k * STEP);
        aw[h8][0] = v.x, aw[h8][1] = v.y, aw[h8][2] = v.z, aw[h8][3] = v.w;
      }
      const int xc = k * STEP + t * 16;  // this lane's x columns in the slice
      if constexpr (UNPACK == UNPACK_NONE) {
        acc[0][0][0] += __uint_as_float((aw[0][0] ^ aw[1][3]) & 0x3f7fffffu);
        continue;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // low nibbles (x[:, :I/2]), then high nibbles (x[:, I/2:])
        // A fragments: logical k 2t, 2t+1 <- bytes 4q, 4q+1 of word q; k 2t+8, 2t+9 <- bytes 4q+2, 4q+3
        uint32_t a[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q][0] = nib_pair<UNPACK>(aw[0][q], 0, hh);
          a[q][1] = nib_pair<UNPACK>(aw[1][q], 0, hh);
          a[q][2] = nib_pair<UNPACK>(aw[0][q], 2, hh);
          a[q][3] = nib_pair<UNPACK>(aw[1][q], 2, hh);
        }
#pragma unroll
        for (int n = 0; n < NTILES; ++n) {
          // x row n*8+g, the same 16 columns in the same permuted order
          const __nv_bfloat16* xr = xs + (n * 8 + g) * LDX + hh * kc + xc;
          const uint4 x0 = *reinterpret_cast<const uint4*>(xr);
          const uint4 x1 = *reinterpret_cast<const uint4*>(xr + 8);
          const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma(acc[2 * hh + (q & 1)][n], a[q][0], a[q][1], a[q][2], a[q][3], xw[2 * q], xw[2 * q + 1]);
        }
      }
    }
    __syncwarp();  // every lane is done reading the stage: refill it with the tile STAGES ahead
    if (i + STAGES < my_tiles) fill(i + STAGES);
    const int o0 = (wi + i * nw) * 16;
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = n * 8 + 2 * t + (e & 1);
        const int o = o0 + g + (e >> 1) * 8;
        if (r < R) {
          float v = acc[0][n][e];
#pragma unroll
          for (int c = 1; c < CH; ++c) v = __fadd_rn(v, acc[c][n][e]);
          if (ks == 1)
            y[(size_t)r * O + o] = __float2bfloat16_rn(__fmul_rn(v, scale[o]));
          else
            ws[((size_t)s * R + r) * O + o] = v;
        }
      }
  }
}

// y[r, o] = bf16((ws[0, r, o] + ws[1, r, o] + ... + ws[ks-1, r, o]) * scale[o]),
// the slices added in order; four outputs a thread (O % 16 == 0). Launched as a
// programmatic dependent of matvec_kernel: its blocks may start
// while the matvec's last blocks run, and wait for the matvec's grid to finish
// (and its writes to be visible) before reading ws.
__global__ void reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                              __nv_bfloat16* __restrict__ y, int R, int O, int ks) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t n4 = (size_t)R * O / 4;
  for (size_t u = blockIdx.x * (size_t)blockDim.x + threadIdx.x; u < n4; u += (size_t)gridDim.x * blockDim.x) {
    const size_t idx = 4 * u;
    float4 v = __ldcg(reinterpret_cast<const float4*>(ws + idx));
    for (int s = 1; s < ks; ++s) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)s * R * O + idx));
      v.x = __fadd_rn(v.x, p.x);
      v.y = __fadd_rn(v.y, p.y);
      v.z = __fadd_rn(v.z, p.z);
      v.w = __fadd_rn(v.w, p.w);
    }
    const int o = (int)(idx % O);
    const float4 sc = *reinterpret_cast<const float4*>(scale + o);
    __nv_bfloat162 lo = __floats2bfloat162_rn(__fmul_rn(v.x, sc.x), __fmul_rn(v.y, sc.y));
    __nv_bfloat162 hi = __floats2bfloat162_rn(__fmul_rn(v.z, sc.z), __fmul_rn(v.w, sc.w));
    uint2 out;
    out.x = *reinterpret_cast<uint32_t*>(&lo);
    out.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(y + idx) = out;
  }
}

template <int NTILES, int UNPACK>
int launch_rows(const void* x, const void* w, const void* scale, void* y, void* ws, int R, int O, int half, int ks,
                int nblk, cudaStream_t stream) {
  const int kc_max = ((half / STEP + ks - 1) / ks) * STEP;
  const int smem = smem_bytes(NTILES, kc_max);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static int configured = 0;  // the dynamic shared memory allowed so far (internal linkage: per library)
  if (smem > configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(matvec_kernel<NTILES, UNPACK>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = MAX_SMEM;
  }
  cudaGetLastError();  // an error left by an earlier runtime call is not this launch's
  matvec_kernel<NTILES, UNPACK><<<dim3(nblk, ks), 32 * warps_for(NTILES), smem, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, (__nv_bfloat16*)y, (float*)ws, R, O, half);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return (int)err;
  // the reduction as a programmatic dependent launch (0.5-0.7 us less than a plain one: PERF.md §6)
  const int n4 = R * O / 4;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, reduce_kernel, (const float*)ws, (const float*)scale, (__nv_bfloat16*)y, R, O,
                                 ks);
}

// x [R, 2*half] bf16, w [O, half] int8, scale [O] f32, y [R, O] bf16; with
// ks > 1, ws [ks, R, O] f32. The plan (ks, nblk) comes from the host. Returns
// the cudaError_t of the launches.
template <int UNPACK>
int launch(const void* x, const void* w, const void* scale, void* y, void* ws, int R, int O, int half, int ks,
           int nblk, cudaStream_t s) {
  if (R <= 0 || R > 64 || O <= 0 || O % 16 || half <= 0 || half % STEP || nblk <= 0 || ks <= 0 ||
      ks > half / STEP || (half / STEP + ks - 1) / ks > MAX_SLICE_STEPS || (ks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R <= 8) return launch_rows<1, UNPACK>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
  if (R <= 16) return launch_rows<2, UNPACK>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
  if (R <= 32) return launch_rows<4, UNPACK>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
  return launch_rows<8, UNPACK>(x, w, scale, y, ws, R, O, half, ks, nblk, s);
}

}  // namespace
}  // namespace int4mv
