// Causal head_dim-64 attention with a per-row key range and optional RoPE.
//
// Replaces easyrag_tpu/ops/flash64.py::flash64_attention (K1), the attention
// of every MiniCPM reranker layer. Same layout ([B, S, H*64] bf16 for q, k, v
// and the output), f32 logits and softmax, masked logits set to
// finfo(f32).min. What differs from the TPU kernel:
//
//   * padding: keys outside [kv_start[b], kv_end[b]) are masked, so left AND
//     right padding are both right (the TPU kernel assumes a left-pad prefix);
//   * one block per (128-row q tile, head, batch row), two resident on an SM
//     (96 registers a thread, 66 KB of shared memory), the longest causal
//     prefixes launched first (the q tile is the slowest grid dimension,
//     reversed), in three roles: one producer warp keeps a ring of NSTAGE
//     K/V tile pairs (64 keys x 64 dims each) full with TMA loads (3-D
//     tensor maps over [B, S, H*64], 128-byte swizzle, rows past S
//     zero-filled) that complete on mbarriers; two consumer warpgroups each
//     own 64 q rows, one 64-row causal group, and walk the k tiles from the
//     row range's first tile up to their group's diagonal tile with an
//     online softmax, so nothing of size S*S exists anywhere. Head-pair lane
//     packing and the rotate-half matmul were TPU layout devices and are
//     gone;
//   * both products on wgmma m64n64k16 (bf16 in, f32 accumulate): S = Q K^T
//     with Q and K read from 128-byte-swizzled shared memory, the logits
//     left in registers; the softmax runs on them there (ex2.approx with
//     log2(e) folded into the scale); the unnormalised probabilities,
//     rounded to bf16, are repacked in registers as the A operand of
//     O += P V, V's tile read MN-major through the descriptor's transpose
//     bit; O stays in registers and the row sum divides at the end (the TPU
//     kernel rounds the normalised probabilities), a difference of about one
//     bf16 rounding of the output;
//   * the softmax overlaps the products across the two consumer
//     warpgroups: each waits for its own products, so one's softmax runs
//     while the other's wgmma runs (a software pipeline inside a warpgroup,
//     QK^T of tile i+1 issued with PV of tile i, measured slower on the H100:
//     ptxas serialises its wgmmas). The causal and range compares run only on
//     tiles that straddle the diagonal or a range edge;
//   * rows whose every visited key is masked stay finite: masked logits are
//     finfo.min, never -inf, so exp(min - min) = 1 gives a uniform average
//     over the visited keys, and a row that visits no tile at all (its 64-row
//     group's causal prefix lies before kv_start) writes zeros. The visited
//     tiles are those of 64-row groups, as in the first version, so pad rows
//     keep their output;
//   * RoPE (rotate-half, f32 math without fma, rounded to bf16 like the host
//     version) from [S, 64] f32 tables: a prologue kernel rotates K once into
//     a scratch tensor the wrapper allocates (instead of once per q tile, with
//     32 KB of tables per 8 KB K tile), and each consumer rotates its Q rows
//     as it loads them.
//
// Bound on the H100: at the reranker's shape (B=32, S=1216, H=36, right
// padded) the real rows need ~0.15 TFLOP of QK^T + PV and ~0.72 GB of q, k, v
// and output, 0.21 ms at 3.35 TB/s. The H100 probes of csrc/probe_k1.cu
// (tools/torch_probe_k1.py) put wgmma at its full 4,094 FLOP a clock per SM
// already at contraction depth 64, mma.sync fed by ldmatrix at 65% of that,
// and ex2 at 16 a clock per SM: a 64x64 tile's QK^T and PV take 256 clocks
// of the tensor cores and its 4,096 exponentials 256 clocks of the SFU, so
// the softmax has to overlap the products or it sets the pace. The RoPE
// prologue moves K twice more (~0.1 ms at full bandwidth).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int BQ = 128;
constexpr int BK = 64;
constexpr int NSTAGE = 3;
constexpr int NCW = 2;                   // consumer warpgroups, 64 q rows each
constexpr int NT = NCW * 128 + 32;       // + one producer warp
constexpr int TILE_BYTES = BK * HD * 2;  // 8 KB
constexpr int SMEM_BYTES = 1024 + (NCW + 2 * NSTAGE) * TILE_BYTES + 2 * NSTAGE * 8;
constexpr float MASK_VALUE = -3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;

union Pack8 {
  uint4 u;
  __nv_bfloat16 x[8];
};

__device__ __forceinline__ int swz(int r, int chunk) { return r * HD + ((chunk ^ (r & 7)) << 3); }
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 128-byte-swizzled tile of 128-byte rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

#define WG_D32(d)                                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),    \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),     \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS32                                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64 f32) (+)= A (64x16, smem, K-major) * B (16x64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64x64 f32) += A (64x16, registers) * B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rotate columns [8c, 8c+8) (lo) and [32+8c, 32+8c+8) (hi) of one 64-wide
// row by its cos/sin rows: x*cos + rotate_half(x)*sin, rotate_half(x) =
// [-x2, x1]; no fma, so the rounding is the host version's.
__device__ __forceinline__ void rope8(Pack8& lo, Pack8& hi, const float* __restrict__ cr, const float* __restrict__ sr,
                                      int c) {
  float cl[8], ch[8], sl[8], sh[8];
  *reinterpret_cast<float4*>(cl) = *reinterpret_cast<const float4*>(cr + 8 * c);
  *reinterpret_cast<float4*>(cl + 4) = *reinterpret_cast<const float4*>(cr + 8 * c + 4);
  *reinterpret_cast<float4*>(ch) = *reinterpret_cast<const float4*>(cr + 32 + 8 * c);
  *reinterpret_cast<float4*>(ch + 4) = *reinterpret_cast<const float4*>(cr + 32 + 8 * c + 4);
  *reinterpret_cast<float4*>(sl) = *reinterpret_cast<const float4*>(sr + 8 * c);
  *reinterpret_cast<float4*>(sl + 4) = *reinterpret_cast<const float4*>(sr + 8 * c + 4);
  *reinterpret_cast<float4*>(sh) = *reinterpret_cast<const float4*>(sr + 32 + 8 * c);
  *reinterpret_cast<float4*>(sh + 4) = *reinterpret_cast<const float4*>(sr + 32 + 8 * c + 4);
  Pack8 ol, oh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = __bfloat162float(lo.x[i]);
    const float z = __bfloat162float(hi.x[i]);
    ol.x[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(a, cl[i]), __fmul_rn(-z, sl[i])));
    oh.x[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(z, ch[i]), __fmul_rn(a, sh[i])));
  }
  lo = ol;
  hi = oh;
}

// K rotated once: one thread per (row, head, chunk pair c = 0..3).
__global__ void __launch_bounds__(256)
rope_k_kernel(const __nv_bfloat16* __restrict__ k, const float* __restrict__ cos, const float* __restrict__ sin,
              __nv_bfloat16* __restrict__ out, int S, int H, size_t units) {
  const size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const int c = (int)(u & 3);
  const size_t hu = u >> 2;
  const int s = (int)((hu / H) % S);
  const size_t off = hu * HD;
  Pack8 lo, hi;
  lo.u = *reinterpret_cast<const uint4*>(k + off + 8 * c);
  hi.u = *reinterpret_cast<const uint4*>(k + off + 32 + 8 * c);
  rope8(lo, hi, cos + (size_t)s * HD, sin + (size_t)s * HD, c);
  *reinterpret_cast<uint4*>(out + off + 8 * c) = lo.u;
  *reinterpret_cast<uint4*>(out + off + 32 + 8 * c) = hi.u;
}

__global__ void __launch_bounds__(NT, 2)
flash64_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
               const __nv_bfloat16* __restrict__ q, const int32_t* __restrict__ kv_start,
               const int32_t* __restrict__ kv_end, const float* __restrict__ cos, const float* __restrict__ sin,
               __nv_bfloat16* __restrict__ out, int S, int H, float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  __nv_bfloat16* sq = (__nv_bfloat16*)base;                                   // NCW tiles
  __nv_bfloat16* sk = (__nv_bfloat16*)(base + NCW * TILE_BYTES);              // NSTAGE tiles
  __nv_bfloat16* sv = (__nv_bfloat16*)(base + (NCW + NSTAGE) * TILE_BYTES);   // NSTAGE tiles
  uint64_t* full = (uint64_t*)(base + (NCW + 2 * NSTAGE) * TILE_BYTES);
  uint64_t* empty = full + NSTAGE;

  const int nqt = (S + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int F = H * HD;
  const int q0 = qt * BQ;
  const int start = max(kv_start[b], 0);
  const int end = min(kv_end[b], S);
  const int kt_lo = start / BK;
  const int kt_hi = end > start ? min(2 * qt + 1, (end - 1) / BK) : -1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == NCW) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == NCW * 128) {
      for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
        const int s = i % NSTAGE;
        if (i >= NSTAGE) mbar_wait(&empty[s], ((i / NSTAGE) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE_BYTES);
        tma_load(sk + s * BK * HD, &kmap, &full[s], h * HD, kt * BK, b);
        tma_load(sv + s * BK * HD, &vmap, &full[s], h * HD, kt * BK, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64), one 64-row group
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0q = q0 + 64 * wg;
  __nv_bfloat16* my_q = sq + wg * BK * HD;
  for (int u = tid; u < 64 * 4; u += 128) {
    const int r = u >> 2;
    const int c = u & 3;
    const int row = r0q + r;
    Pack8 lo, hi;
    lo.u = make_uint4(0, 0, 0, 0);
    hi.u = lo.u;
    if (row < S) {
      const __nv_bfloat16* src = q + ((size_t)b * S + row) * F + h * HD;
      lo.u = *reinterpret_cast<const uint4*>(src + 8 * c);
      hi.u = *reinterpret_cast<const uint4*>(src + 32 + 8 * c);
      if (cos != nullptr) rope8(lo, hi, cos + (size_t)row * HD, sin + (size_t)row * HD, c);
    }
    *reinterpret_cast<uint4*>(my_q + swz(r, c)) = lo.u;
    *reinterpret_cast<uint4*>(my_q + swz(r, c + 4)) = hi.u;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  const int grp = r0q / BK;
  const int my_hi = (end > start && r0q < S) ? min(grp, (end - 1) / BK) : -1;
  const float scale = sm_scale * LOG2E;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int wrow = r0q + warp * 16;
  const int row0 = wrow + g;
  const int row1 = row0 + 8;
  const uint64_t dq = sw128_desc(my_q);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.0f, l1 = 0.0f;

  for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
    const int s = i % NSTAGE;
    mbar_wait(&full[s], (i / NSTAGE) & 1);
    if (kt <= my_hi) {
      const int k0 = kt * BK;
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
      const uint64_t dk = sw128_desc(sk + s * BK * HD);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_ss(sc, dq + 2 * ks, dk + 2 * ks, ks);
      wg_commit();
      wg_wait0();

      const bool edge = k0 + BK - 1 > wrow || k0 < start || k0 + BK > end;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * nt + e] * scale;
          if (edge) {
            const int j = k0 + 8 * nt + c2 + (e & 1);
            const int ii = e < 2 ? row0 : row1;
            x = (j <= ii && j >= start && j < end) ? x : MASK_VALUE;
          }
          sc[4 * nt + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = ex2(m0 - mx0);
      const float a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      uint32_t pa[4][4];
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p00 = ex2(sc[4 * nt] - mx0);
        const float p01 = ex2(sc[4 * nt + 1] - mx0);
        const float p10 = ex2(sc[4 * nt + 2] - mx1);
        const float p11 = ex2(sc[4 * nt + 3] - mx1);
        ps0 += p00 + p01;
        ps1 += p10 + p11;
        pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p00, p01);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o[4 * nt] *= a0;
        o[4 * nt + 1] *= a0;
        o[4 * nt + 2] *= a1;
        o[4 * nt + 3] *= a1;
      }
      const uint64_t dv = sw128_desc(sv + s * BK * HD);
      wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs(o, pa[j], dv + (uint64_t)((2048 * j) >> 4));
      wg_commit();
      wg_wait0();
    }
    mbar_arrive(&empty[s]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  // stage the warp's own 16 rows in its Q tile (the warpgroup's wgmma reads of
  // Q are complete: every product waited), then write 16-byte row chunks
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const int r = warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<uint32_t*>(my_q + swz(r, nt) + c2) = pack_bf16(o[4 * nt] * inv0, o[4 * nt + 1] * inv0);
    *reinterpret_cast<uint32_t*>(my_q + swz(r + 8, nt) + c2) = pack_bf16(o[4 * nt + 2] * inv1, o[4 * nt + 3] * inv1);
  }
  __syncwarp();
#pragma unroll
  for (int u = lane; u < 16 * 8; u += 32) {
    const int rr = warp * 16 + (u >> 3);
    const int c = u & 7;
    if (r0q + rr < S)
      *reinterpret_cast<uint4*>(out + ((size_t)b * S + r0q + rr) * F + h * HD + 8 * c) =
          *reinterpret_cast<const uint4*>(my_q + swz(rr, c));
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// [B, S, H*64] bf16 as a 3-D map, 64x64 boxes of one head, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* x, int B, int S, int H) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * HD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * HD * 2, (cuuint64_t)S * H * HD * 2};
  const cuuint32_t box[3] = {HD, BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v, out: [B, S, H*64] bf16, 16-byte aligned; kv_start, kv_end: [B]
// int32; cos, sin: [S, 64] f32 or both null; k_rot: [B, S, H*64] bf16 scratch
// for the rotated K (unused without cos). Returns the first cudaError_t of
// the launches, or cudaErrorInvalidValue when a tensor map cannot be made.
extern "C" int flash64_launch(const void* q, const void* k, const void* v, const void* kv_start, const void* kv_end,
                              const void* cos, const void* sin, void* k_rot, void* out, int B, int S, int H,
                              float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const void* keys = k;
  if (cos != nullptr) {
    const size_t units = (size_t)B * S * H * 4;
    rope_k_kernel<<<(unsigned)((units + 255) / 256), 256, 0, st>>>(
        (const __nv_bfloat16*)k, (const float*)cos, (const float*)sin, (__nv_bfloat16*)k_rot, S, H, units);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    keys = k_rot;
  }
  CUtensorMap kmap, vmap;
  if (!make_map(&kmap, keys, B, S, H) || !make_map(&vmap, v, B, S, H)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(flash64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash64_kernel<<<grid, NT, SMEM_BYTES, st>>>(kmap, vmap, (const __nv_bfloat16*)q, (const int32_t*)kv_start,
                                                (const int32_t*)kv_end, (const float*)cos, (const float*)sin,
                                                (__nv_bfloat16*)out, S, H, sm_scale);
  return (int)cudaGetLastError();
}
