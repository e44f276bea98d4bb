// Causal grouped-query attention on Hopper (sm_90a): wgmma + TMA, shared by
// K3 (csrc/flash_attention.cu: per-row key ranges, every head_dim that is a
// multiple of 64 up to 512) and K4 (csrc/flash_softcap.cu: the Gemma2 logit
// softcap, head_dim 128/256, no key range). Each .cu keeps its own extern "C"
// entry point and launch count.
//
// Layout: q and out are [B, S, NH*HD] bf16, k and v [B, S, NKV*HD] bf16 (the
// projections' own layout); query head h reads KV head h / (NH/NKV) in place.
// Keys outside [kv_start[b], kv_end[b]) (K4: [0, S)) and above the diagonal
// get the logit finfo(f32).min, never -inf.
//
// One block per (query head, V column group, batch row, q tile of 64 NCW
// rows), heads fastest, so the NH/NKV heads of one KV group run side by side
// and share their K/V tiles in L2; the q tiles with the longest causal
// prefixes launch first (the q tile fastest instead measured within 3% either
// way on the H100). NCW warpgroups of 128 threads (two up to HD 256) and no
// producer warp: a ninth warp would put three warps on one of the SM's four
// register-file quarters and cap every thread at 168 registers, where the
// HD-256 O accumulator alone is 128 (ptxas then spills and serialises the
// wgmmas; setmaxnreg did not lift the cap).
//
// Past HD 256 (Shape<HD>): the O accumulator of all of V's columns would not
// fit the 255 registers a thread may hold, so V's columns are split into NG
// groups of at most 256 (4 panels), one block per group, each recomputing
// QK^T over the whole head dim; and Q, K and V tiles of 64 x HD no longer fit
// 227 KB at two warpgroups and two stages, so Shape picks the first of (two
// warpgroups, 3 stages), (2, 2), (1, 3), (1, 2), (2, 1), (1, 1) that fits.
//
//   * a ring of NSTAGE K/V tile pairs (64 keys x HD) is kept full by TMA
//     loads: 3-D tensor maps over [B, S, NKV*HD], boxes of 64 keys x 64 dims
//     with a 128-byte swizzle (a 64-dim panel is one swizzle atom row),
//     HD/64 panels per tile, rows past S zero-filled; each load completes on
//     the stage's "full" mbarrier. Thread 0 fills the ring first; after
//     that the warpgroup that is second to finish with a stage (a shared
//     counter per stage, odd on the second arrival) refills it with the
//     tile NSTAGE ahead, so no thread ever waits for a stage to drain;
//   * each warpgroup owns 64 q rows, one 64-row causal group, and walks the
//     key tiles from the range's first tile up to min(its group's diagonal
//     tile, the tile of kv_end - 1) with an online softmax in f32
//     registers, so nothing of size S*S exists;
//   * S = Q K^T is wgmma m64n64k16 over HD/16 steps, Q (loaded by the
//     warpgroup's threads into swizzled shared memory) and K both K-major in
//     shared memory, the logits left in registers; the scale (and the
//     softcap, tanhf on the f32 logit, then times the cap) and log2(e) are
//     applied there, and the mask compares run only on tiles that straddle
//     the diagonal or a range edge; the unnormalised probabilities
//     (ex2.approx), rounded to bf16, are repacked in registers as the A
//     operand of O += P V, one m64n64k16 chain per 64-dim panel of V
//     (MN-major through the descriptor's transpose bit), so the f32 O
//     accumulator is HD/2 registers a thread (128 at HD 256); the row sum
//     divides at the end (the TPU kernels round the normalised
//     probabilities): about one bf16 rounding of the output apart;
//   * the softmax of one warpgroup overlaps the other's products (each
//     waits for its own wgmma).
//
// A row whose visited keys are all masked averages them (exp(min - min) =
// 1), and a row that visits no tile (its group's causal prefix lies before
// kv_start) writes zeros: the semantics of the WMMA kernels this replaces.
// Every mbarrier wait has a bound and traps rather than hang the card.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_sm90 {

constexpr int BK = 64;                  // keys per tile
constexpr int PANEL = 64;               // dims per 128-byte swizzle row
constexpr int PANEL_BYTES = BK * PANEL * 2;  // 8 KB: one 64 x 64 bf16 panel
constexpr int MAX_SMEM = 232448;        // dynamic shared memory a block may use
constexpr float MASK_VALUE = -3.4028234663852886e38f;  // finfo(f32).min
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Shape {
  static_assert(HD % 64 == 0 && HD >= 64 && HD <= 512, "head_dim a multiple of 64 up to 512");
  static constexpr int NP = HD / PANEL;                    // panels per row of Q and K
  static constexpr int NG = NP <= 4 ? 1 : (NP + 3) / 4;    // V column groups, one block each
  static constexpr int NPV = (NP + NG - 1) / NG;           // V panels per group (at most 4)
  static constexpr int TILE_BYTES = NP * PANEL_BYTES;      // a 64-row tile of HD: Q or K
  static constexpr int VTILE_BYTES = NPV * PANEL_BYTES;    // a 64-row tile of one V group
  static constexpr int bytes(int ncw, int nstage) {
    return 1024 + ncw * TILE_BYTES + nstage * (TILE_BYTES + VTILE_BYTES) + nstage * 12;
  }
  static constexpr int pick() {  // 10 * warpgroups + stages: the first that fits
    constexpr int opts[6] = {23, 22, 13, 12, 21, 11};
    for (int i = 0; i < 6; ++i)
      if (bytes(opts[i] / 10, opts[i] % 10) <= MAX_SMEM) return opts[i];
    return 0;
  }
  static constexpr int NCW = pick() / 10;                  // warpgroups, 64 q rows each
  static constexpr int NSTAGE = pick() % 10;               // K/V ring depth
  static constexpr int NT = NCW * 128;
  static constexpr int BQ = 64 * NCW;                      // q rows per block
  static constexpr int SMEM_BYTES = bytes(NCW, NSTAGE);
  static_assert(NCW > 0, "no ring fits shared memory");
};

// element offset of (row r, 16-byte chunk c) in a 128-byte-swizzled 64 x 64 panel
__device__ __forceinline__ int swz(int r, int chunk) { return r * PANEL + ((chunk ^ (r & 7)) << 3); }
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
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 128-byte-swizzled panel of 128-byte rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

#define ATTN_WG_D32(d)                                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),    \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),     \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define ATTN_WG_REGS32                                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64 f32) (+)= A (64x16, smem, K-major) * B (16x64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ATTN_WG_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ATTN_WG_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64x64 f32) += A (64x16, registers) * B (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ATTN_WG_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ATTN_WG_D32(d)
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

// One key tile of the online softmax, for the two rows (row0, row1 = row0 + 8)
// a thread holds of a 64-row group: the logits sc of wgmma m64n64 are scaled
// (and softcapped), masked on tiles that straddle the diagonal or a range
// edge (keys k0 + 8 nt + c2 + {0, 1}), the running maxima m and sums l are
// updated, a0/a1 are the factors O must be rescaled by, and pa holds the
// unnormalised probabilities (ex2.approx, rounded to bf16) as the A
// fragments of O += P V.
template <bool SOFTCAP>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], uint32_t (&pa)[4][4], float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1, bool edge, int k0, int row0, int row1,
                                             int c2, int start, int end, float scale, float cap2) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = SOFTCAP ? cap2 * tanhf(sc[4 * nt + e] * scale) : sc[4 * nt + e] * scale;
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
  a0 = ex2(m0 - mx0);
  a1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
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
}

// The end of a 64-row group: the row sums reduced over the quad, O divided
// by them (a row that visited no key gets zeros), each warp's own 16 rows
// staged in `stage` (64-dim swizzled panels, free to overwrite), then written
// as 16-byte row chunks of npv panels: row r of the group to out[(r0q + r) *
// F ...] (out already offset to the batch row and the first column), rows at
// or past S skipped.
template <int NPV>
__device__ __forceinline__ void store_rows(const float (&o)[NPV][32], float l0, float l1, uint8_t* stage, int npv,
                                           int r0q, int S, __nv_bfloat16* out, int F) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  const int r = warp * 16 + g;
#pragma unroll
  for (int p = 0; p < NPV; ++p) {
    __nv_bfloat16* panel = (__nv_bfloat16*)(stage + p * PANEL_BYTES);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(panel + swz(r, nt) + c2) = pack_bf16(o[p][4 * nt] * inv0, o[p][4 * nt + 1] * inv0);
      *reinterpret_cast<uint32_t*>(panel + swz(r + 8, nt) + c2) =
          pack_bf16(o[p][4 * nt + 2] * inv1, o[p][4 * nt + 3] * inv1);
    }
  }
  __syncwarp();
  for (int u = lane; u < 16 * (npv * 8); u += 32) {
    const int rr = warp * 16 + u / (npv * 8);
    const int c = u % (npv * 8);  // 16-byte chunk of the group's columns
    const __nv_bfloat16* panel = (const __nv_bfloat16*)(stage + (c >> 3) * PANEL_BYTES);
    if (r0q + rr < S)
      *reinterpret_cast<uint4*>(out + (size_t)(r0q + rr) * F + 8 * c) = *reinterpret_cast<const uint4*>(panel + swz(rr, c & 7));
  }
}

// kv_start/kv_end null: the whole range [0, S). softcap only with SOFTCAP.
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(Shape<HD>::NT, 1)
attention_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __nv_bfloat16* __restrict__ q, const int32_t* __restrict__ kv_start,
                 const int32_t* __restrict__ kv_end, __nv_bfloat16* __restrict__ out, int S, int NH, int NKV,
                 float sm_scale, float softcap) {
  using Sh = Shape<HD>;
  constexpr int NP = Sh::NP;
  constexpr int NG = Sh::NG;
  constexpr int NPV = Sh::NPV;
  constexpr int NCW = Sh::NCW;
  constexpr int BQ = Sh::BQ;
  constexpr int NSTAGE = Sh::NSTAGE;
  constexpr int TILE = Sh::TILE_BYTES;
  constexpr int VTILE = Sh::VTILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sq = base;                               // NCW tiles of 64 q rows
  uint8_t* sk = base + NCW * TILE;                  // NSTAGE K tiles
  uint8_t* sv = base + (NCW + NSTAGE) * TILE;       // NSTAGE V tiles (this block's column group)
  uint64_t* full = (uint64_t*)(sv + NSTAGE * VTILE);
  int* finished = (int*)(full + NSTAGE);  // per stage: warpgroups done with it, over all its uses

  const int nqt = (S + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.z;
  const int h = blockIdx.x / NG;
  const int vg = blockIdx.x % NG;                   // V column group: panels [vg * NPV, vg * NPV + npv)
  const int npv = NG == 1 ? NPV : min(NPV, NP - vg * NPV);
  const int b = blockIdx.y;
  const int kvh = h / (NH / NKV);
  const int F = NH * HD;
  const int q0 = qt * BQ;
  const int start = kv_start != nullptr ? max(kv_start[b], 0) : 0;
  const int end = kv_end != nullptr ? min(kv_end[b], S) : S;
  const int kt_lo = start / BK;
  const int kt_hi = end > start ? min((q0 + BQ - 1) / BK, (end - 1) / BK) : -1;

  // key tile kt_lo + i into stage i % NSTAGE
  auto load = [&](int i) {
    const int s = i % NSTAGE;
    const int kt = kt_lo + i;
    mbar_expect_tx(&full[s], TILE + npv * PANEL_BYTES);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load(sk + s * TILE + p * PANEL_BYTES, &kmap, &full[s], kvh * HD + p * PANEL, kt * BK, b);
      if (p < npv)
        tma_load(sv + s * VTILE + p * PANEL_BYTES, &vmap, &full[s], kvh * HD + (vg * NPV + p) * PANEL, kt * BK, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      finished[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < NSTAGE && kt_lo + i <= kt_hi; ++i) load(i);
  }
  __syncthreads();

  // warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64), one 64-row group
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0q = q0 + 64 * wg;
  uint8_t* my_q = sq + wg * TILE;
  for (int u = tid; u < 64 * (HD / 8); u += 128) {
    const int r = u / (HD / 8);
    const int c = u % (HD / 8);  // 16-byte chunk of the row
    const int row = r0q + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < S) val = *reinterpret_cast<const uint4*>(q + ((size_t)b * S + row) * F + h * HD + 8 * c);
    __nv_bfloat16* panel = (__nv_bfloat16*)(my_q + (c >> 3) * PANEL_BYTES);
    *reinterpret_cast<uint4*>(panel + swz(r, c & 7)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  const int grp = r0q / BK;
  const int my_hi = (end > start && r0q < S) ? min(grp, (end - 1) / BK) : -1;
  const float scale = SOFTCAP ? sm_scale / softcap : sm_scale * LOG2E;
  const float cap2 = softcap * LOG2E;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int wrow = r0q + warp * 16;
  const int row0 = wrow + g;
  const int row1 = row0 + 8;
  const uint64_t dq = sw128_desc(my_q);
  float o[NPV][32];
#pragma unroll
  for (int p = 0; p < NPV; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.0f, l1 = 0.0f;

  for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
    const int s = i % NSTAGE;
    mbar_wait(&full[s], (i / NSTAGE) & 1);
    if (kt <= my_hi) {
      const int k0 = kt * BK;
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
      const uint64_t dk = sw128_desc(sk + s * TILE);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        // panel ks / 4, 32 bytes (16 dims) per step inside it
        const uint64_t off = (uint64_t)(((ks >> 2) * PANEL_BYTES) >> 4) + 2 * (ks & 3);
        wgmma_ss(sc, dq + off, dk + off, ks);
      }
      wg_commit();
      wg_wait0();

      const bool edge = k0 + BK - 1 > wrow || k0 < start || k0 + BK > end;
      float a0, a1;
      uint32_t pa[4][4];
      softmax_tile<SOFTCAP>(sc, pa, m0, m1, l0, l1, a0, a1, edge, k0, row0, row1, c2, start, end, scale, cap2);
#pragma unroll
      for (int p = 0; p < NPV; ++p)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          o[p][4 * nt] *= a0;
          o[p][4 * nt + 1] *= a0;
          o[p][4 * nt + 2] *= a1;
          o[p][4 * nt + 3] *= a1;
        }
      const uint64_t dv = sw128_desc(sv + s * VTILE);
      wg_fence();
#pragma unroll
      for (int p = 0; p < NPV; ++p)
        if (NG == 1 || p < npv)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_rs(o[p], pa[j], dv + (uint64_t)((p * PANEL_BYTES + 2048 * j) >> 4));
      wg_commit();
      wg_wait0();
    }
    // every warp of the warpgroup is done reading stage s; the last
    // warpgroup to get here refills it
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0 && atomicAdd(&finished[s], 1) % NCW == NCW - 1 && kt + NSTAGE <= kt_hi) load(i + NSTAGE);
  }

  // the warpgroup's wgmma reads of Q are complete (every product waited):
  // its Q tile stages the output
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  store_rows<NPV>(o, l0, l1, my_q, npv, r0q, S, out + (size_t)b * S * F + h * HD + vg * NPV * PANEL, F);
}

// Head dims past 512 (K3 only): Q and K no longer fit shared memory as whole
// 64-row tiles, so they are streamed through it in chunks of at most
// STREAM_PANELS 64-dim panels, and the logits of a key tile accumulate in
// registers over the chunks; V keeps the column groups of HD 320-512 (at most
// 4 panels, one block each). One warpgroup of 64 q rows a block; its threads
// load every tile themselves (16-byte loads into the 128-byte-swizzled
// layout TMA would give), with a block barrier around each chunk. No model of
// the repository has such a head dim: this path is for correctness, not speed.
constexpr int STREAM_PANELS = 4;
constexpr int STREAM_SMEM = 1024 + 3 * STREAM_PANELS * PANEL_BYTES;  // Q chunk, K chunk, V group

// rows [r0, r0 + 64) of x ([B, S, W] bf16; rows of batch row b), dims [c0, c0 + 64 np), into np swizzled
// panels at dst; rows at or past S are zero
__device__ __forceinline__ void load_panels(uint8_t* dst, const __nv_bfloat16* __restrict__ x, int b, int S, int W,
                                            int r0, int c0, int np, int tid) {
  for (int u = tid; u < 64 * np * 8; u += 128) {
    const int r = u / (np * 8);
    const int c = u % (np * 8);  // 16-byte chunk of the row
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(x + ((size_t)b * S + r0 + r) * W + c0 + 8 * c);
    *reinterpret_cast<uint4*>((__nv_bfloat16*)(dst + (c >> 3) * PANEL_BYTES) + swz(r, c & 7)) = val;
  }
}

__global__ void __launch_bounds__(128, 1)
attention_stream_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ kv_start,
                        const int32_t* __restrict__ kv_end, __nv_bfloat16* __restrict__ out, int S, int NH, int NKV,
                        int HD, float sm_scale) {
  constexpr int NPV = STREAM_PANELS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sk = sq + STREAM_PANELS * PANEL_BYTES;
  uint8_t* sv = sk + STREAM_PANELS * PANEL_BYTES;

  const int np = HD / PANEL;
  const int ng = (np + NPV - 1) / NPV;
  const int nqt = (S + 63) / 64;
  const int q0 = (nqt - 1 - (int)blockIdx.z) * 64;
  const int h = blockIdx.x / ng;
  const int vg = blockIdx.x % ng;
  const int npv = min(NPV, np - vg * NPV);
  const int b = blockIdx.y;
  const int kvh = h / (NH / NKV);
  const int F = NH * HD, W = NKV * HD;
  const int start = max(kv_start[b], 0);
  const int end = min(kv_end[b], S);
  const int kt_lo = start / BK;
  const int kt_hi = end > start ? min(q0 / BK, (end - 1) / BK) : -1;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int wrow = q0 + warp * 16;
  const int row0 = wrow + g;
  const int row1 = row0 + 8;
  const float scale = sm_scale * LOG2E;
  const uint64_t dq = sw128_desc(sq), dk = sw128_desc(sk), dv = sw128_desc(sv);
  float o[NPV][32];
#pragma unroll
  for (int p = 0; p < NPV; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.0f, l1 = 0.0f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
    for (int c0 = 0; c0 < np; c0 += STREAM_PANELS) {
      const int npc = min(STREAM_PANELS, np - c0);
      __syncthreads();  // the last products that read sq, sk (and sv) have waited
      load_panels(sq, q, b, S, F, q0, h * HD + c0 * PANEL, npc, tid);
      load_panels(sk, k, b, S, W, k0, kvh * HD + c0 * PANEL, npc, tid);
      if (c0 == 0) load_panels(sv, v, b, S, W, k0, kvh * HD + vg * NPV * PANEL, npv, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      wg_fence();
      for (int ks = 0; ks < 4 * npc; ++ks) {
        const uint64_t off = (uint64_t)(((ks >> 2) * PANEL_BYTES) >> 4) + 2 * (ks & 3);
        wgmma_ss(sc, dq + off, dk + off, 1);
      }
      wg_commit();
      wg_wait0();
    }
    const bool edge = k0 + BK - 1 > wrow || k0 < start || k0 + BK > end;
    float a0, a1;
    uint32_t pa[4][4];
    softmax_tile<false>(sc, pa, m0, m1, l0, l1, a0, a1, edge, k0, row0, row1, c2, start, end, scale, 0.0f);
#pragma unroll
    for (int p = 0; p < NPV; ++p)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o[p][4 * nt] *= a0;
        o[p][4 * nt + 1] *= a0;
        o[p][4 * nt + 2] *= a1;
        o[p][4 * nt + 3] *= a1;
      }
    wg_fence();
#pragma unroll
    for (int p = 0; p < NPV; ++p)
      if (p < npv)
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_rs(o[p], pa[j], dv + (uint64_t)((p * PANEL_BYTES + 2048 * j) >> 4));
    wg_commit();
    wg_wait0();
  }
  __syncthreads();  // every product that read sq has waited: it stages the output
  store_rows<NPV>(o, l0, l1, sq, npv, q0, S, out + (size_t)b * S * F + h * HD + vg * NPV * PANEL, F);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
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

// [B, S, W] bf16 as a 3-D map, boxes of 64 dims x 64 rows, 128-byte swizzle
inline bool make_map(CUtensorMap* map, const void* x, int B, int S, int W) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 2, (cuuint64_t)S * W * 2};
  const cuuint32_t box[3] = {PANEL, BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Returns the cudaError_t of the launch, or cudaErrorInvalidValue when a
// tensor map cannot be made.
template <int HD, bool SOFTCAP>
int launch(const void* q, const void* k, const void* v, const void* kv_start, const void* kv_end, void* out, int B,
           int S, int NH, int NKV, float sm_scale, float softcap, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!make_map(&kmap, k, B, S, NKV * HD) || !make_map(&vmap, v, B, S, NKV * HD)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(attention_kernel<HD, SOFTCAP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<HD>::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  using Sh = Shape<HD>;
  dim3 grid(NH * Sh::NG, B, (S + Sh::BQ - 1) / Sh::BQ);
  attention_kernel<HD, SOFTCAP><<<grid, Sh::NT, Sh::SMEM_BYTES, stream>>>(
      kmap, vmap, (const __nv_bfloat16*)q, (const int32_t*)kv_start, (const int32_t*)kv_end, (__nv_bfloat16*)out, S,
      NH, NKV, sm_scale, softcap);
  return (int)cudaGetLastError();
}

// Head dims past 512 (attention_stream_kernel). Returns the cudaError_t of the
// launch.
inline int launch_stream(const void* q, const void* k, const void* v, const void* kv_start, const void* kv_end,
                         void* out, int B, int S, int NH, int NKV, int HD, float sm_scale, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(attention_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STREAM_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int ng = (HD / PANEL + STREAM_PANELS - 1) / STREAM_PANELS;
  dim3 grid(NH * ng, B, (S + 63) / 64);
  attention_stream_kernel<<<grid, 128, STREAM_SMEM, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const int32_t*)kv_start,
      (const int32_t*)kv_end, (__nv_bfloat16*)out, S, NH, NKV, HD, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace attn_sm90
