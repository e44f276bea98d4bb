// Causal head_dim-64 attention with a per-row key range and optional RoPE.
//
// Replaces easyrag_tpu/ops/flash64.py::flash64_attention (K1), the attention
// of every MiniCPM reranker layer. Same layout ([B, S, H*64] bf16 for q, k, v
// and the output), f32 logits and softmax, masked logits set to
// finfo(f32).min. What differs from the TPU kernel: keys outside
// [kv_start[b], kv_end[b]) are masked, so left AND right padding are both
// right (the TPU kernel assumes a left-pad prefix); the unnormalised
// probabilities are rounded to bf16 for PV and the row sum divides at the end
// (the TPU kernel rounds the normalised ones), about one bf16 rounding of the
// output apart; head-pair lane packing and the rotate-half matmul were TPU
// layout devices and are gone.
//
// What bounds it on the H100: at the reranker's shape (B=32, S=1216, H=36,
// right padded) the real rows need ~0.2 TFLOP of QK^T + PV and ~0.72 GB of
// q, k, v and output, 0.21 ms at 3.35 TB/s, at the ridge. At head dim 64 a
// 64 x 128 tile's two products take 512 clocks of an SM's tensor cores and
// its 8,192 exponentials 512 clocks of its SFUs (16 ex2 a clock,
// csrc/probe_k1.cu), so the tensor cores stay busy only while one
// warpgroup's softmax runs under another's products; the softmax's chain
// (the row maxima, then the exponentials, then the sums) is what a
// warpgroup waits on.
//
// The design, FlashAttention-3's shape with K1's per-row key ranges:
//   * persistent: one CTA of 384 threads per SM (the grid is the SM count,
//     or the number of units when smaller) walks work items in an order fixed
//     by B, S and H alone. An item is 128 q rows of one (batch row, head); a
//     unit pairs q tile nqt-1-p with q tile p of one (batch row, head), so
//     the units walk about the same number of key tiles, the long one first;
//     units run (batch row, head) by (batch row, head), so the CTAs that
//     share a head's K and V read them while they are in L2 (a grid that
//     walks the q tiles slowest reads every head's K and V from HBM once per
//     q tile). CTA c takes units c, c + grid, ...;
//   * a producer warpgroup, whose first thread keeps a pair of Q tiles and a
//     ring of NSTAGE K/V tile pairs (128 keys x 64 dims each) full with TMA
//     loads (3-D tensor maps over [B, S, H*64], 128-byte swizzle, rows past
//     S zero-filled) that complete on mbarriers, the next item's Q and first
//     K/V tiles while the consumers finish the current item. Each item's
//     tile range is read from kv_start / kv_end on the device: no host sync,
//     memset or copy. setmaxnreg moves registers from the producer to the
//     consumers;
//   * two consumer warpgroups own 64 q rows each and walk the item's key
//     tiles, from the range's first tile up to min(the item's diagonal tile,
//     the tile of kv_end - 1), with an online softmax, so nothing of size
//     S*S exists. QK^T is wgmma m64n128k16 (Q and K from shared memory, the
//     logits in registers); PV is wgmma m64n64k16 with the probabilities,
//     rounded to bf16, repacked in registers as its A operand and V read
//     MN-major through the descriptor's transpose bit; O stays in registers;
//   * the softmax runs under the other warpgroup's products: a warpgroup
//     issues QK^T of tile j with PV of tile j-1 in one turn (named barriers
//     give the two warpgroups turns at issuing), then takes the softmax of
//     tile j while the other warpgroup's products run. The registers of an
//     asynchronous product are fenced (fence_regs), and ptxas reports no
//     wgmma serialisation (C7510-C7520) for this kernel;
//   * the softmax's chain is short: after an item's first tile the
//     exponentials are taken against the running row maxima as they stand
//     (softmax_lazy), and only a tile whose logits pass them by enough to
//     make a sum exceed LAZY_SUM computes its maxima, rescales and redoes
//     its exponentials; the rest never wait for a row maximum and never
//     rescale O. (Issuing QK^T of tile j+1 before the softmax of tile j, so
//     that the softmax also runs under the warpgroup's own PV, needs the
//     probabilities twice in registers with this scheme; at the 168
//     registers a thread that 384 threads leave, ptxas then serialises the
//     products. Measured, the short chain gained more than that overlap.);
//   * each warpgroup's 64 output rows of an item go through a staging tile
//     to one TMA store, which overlaps the next item's work; rows past S are
//     clipped;
//   * the exponentials are ex2.approx of fma(s, scale * log2 e, -max *
//     scale * log2 e), max a row's running maximum; masked logits are
//     finfo.min, so every value stays finite; a row whose visited keys are
//     all masked (a pad row before kv_start) gets probabilities of 0 and
//     writes zeros, as does a row that visits no tile (an empty range).
//     Compares run only on tiles that straddle the diagonal or a range edge;
//   * RoPE (rotate-half, f32 math without fma, rounded to bf16 like the host
//     version) from [S, 64] f32 tables: a prologue kernel rotates Q and K
//     once into a scratch tensor the wrapper allocates, and the attention
//     kernel loads both by TMA, so no consumer rotates on its load path.
//
// PERF.md section 6 has this kernel's time on the H100 beside the design it
// replaced. Measured there and dropped: three consumer warpgroups of 192
// rows (128 registers a thread: spills and serialised products), a stream of
// tiles across items (its loop cost more than the item boundaries), q and
// key tiles shifted to put the ragged half tile first (one more masked tile
// an item), Q rotated in shared memory by the producer warps (the tables'
// reads cost what the prologue saved), and the softmax of tile j under the
// warpgroup's own PV of tile j-1 (see above).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int NCW = 2;                   // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * NCW;             // q rows of a work item
constexpr int BK = 128;                  // keys per K/V tile
constexpr int NSTAGE = 4;                // K/V tile pairs in the ring
constexpr int NT = (NCW + 1) * 128;      // the producer warpgroup, then the consumer warpgroups
constexpr int Q_BYTES = BQ * HD * 2;     // 16 KB
constexpr int KV_BYTES = BK * HD * 2;    // 16 KB: one K or V tile
constexpr int O_ROWS = 64;               // output rows a consumer warpgroup stores
constexpr int SMEM_BYTES = 1024 + 2 * Q_BYTES + 2 * NSTAGE * KV_BYTES + NCW * O_ROWS * HD * 2 + 128;
constexpr int SCHED = 1;                 // named barriers 1, 2: the consumers' turns at the tensor cores
constexpr int OBAR = 1 + NCW;            // named barriers 3, 4: one consumer warpgroup's epilogue
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
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void store_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 128-byte-swizzled tile of 128-byte rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the registers of an asynchronous product are live and changed here: no
// read is hoisted above the wait before it, and none is reused while it runs
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WG_D32(d, o)                                                                                              \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]),  \
      "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]),          \
      "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15]), "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]),       \
      "+f"(d[o + 19]), "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), "+f"(d[o + 24]),       \
      "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]), "+f"(d[o + 30]),       \
      "+f"(d[o + 31])
#define WG_R32                                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// s (64x128 f32) (+)= Q (64x16, smem, K-major) * K^T (16x128, smem, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d, 0), WG_D32(d, 32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// o (64x64 f32) += P (64x16, registers) * V (16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d, 0)
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

// Q (blockIdx.y 0) and K (1) rotated once: one thread per (row, head, chunk
// pair c = 0..3).
__global__ void __launch_bounds__(256)
rope_k_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const float* __restrict__ cos,
              const float* __restrict__ sin, __nv_bfloat16* __restrict__ q_out, __nv_bfloat16* __restrict__ k_out,
              int S, int H, size_t units) {
  const size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const __nv_bfloat16* __restrict__ x = blockIdx.y ? k : q;
  __nv_bfloat16* __restrict__ out = blockIdx.y ? k_out : q_out;
  const int c = (int)(u & 3);
  const size_t hu = u >> 2;
  const int s = (int)((hu / H) % S);
  const size_t off = hu * HD;
  Pack8 lo, hi;
  lo.u = *reinterpret_cast<const uint4*>(x + off + 8 * c);
  hi.u = *reinterpret_cast<const uint4*>(x + off + 32 + 8 * c);
  rope8(lo, hi, cos + (size_t)s * HD, sin + (size_t)s * HD, c);
  *reinterpret_cast<uint4*>(out + off + 8 * c) = lo.u;
  *reinterpret_cast<uint4*>(out + off + 32 + 8 * c) = hi.u;
}

// One work item: the BQ q rows of q tile qt of one (batch row, head) and the
// key tiles [lo, hi] they visit (none when lo > hi).
struct Item {
  int b, h, qt, lo, hi;
};

// Item `which` (0 or 1) of unit u, if it has one: the unit pairs q tile
// nqt-1-p with q tile p of (batch row, head) u / npu, so every unit walks
// about nqt+1 key tiles, and an odd count's middle tile stands alone.
__device__ __forceinline__ bool unit_item(int u, int npu, int nqt, int H, int which,
                                          const int32_t* __restrict__ kv_start, const int32_t* __restrict__ kv_end,
                                          int S, Item& it) {
  const int bh = u / npu;
  const int p = u - bh * npu;
  if (which == 1 && 2 * p + 1 == nqt) return false;
  it.b = bh / H;
  it.h = bh - it.b * H;
  it.qt = which == 0 ? nqt - 1 - p : p;
  const int start = max(kv_start[it.b], 0);
  const int end = min(kv_end[it.b], S);
  it.lo = start / BK;
  it.hi = end > start ? min(it.qt, (end - 1) / BK) : -1;
  return true;
}

// One online-softmax step over a 64 x 128 tile of raw logits held in the
// wgmma accumulator layout (row g and g + 8 of the warp's 16, columns
// 8 nt + c2 + {0, 1}): masks keys outside the causal prefix and [start,
// end) on tiles that reach them, moves the running row maxima, returns the
// rescale factors of the rows' sums and outputs, and leaves the unnormalised
// probabilities ex2((s - max) * scale * log2 e) in s. A row with no valid key
// so far keeps probabilities of 0.
__device__ __forceinline__ void softmax_step(float (&s)[64], float& m0, float& m1, float& l0, float& l1, float& a0,
                                             float& a1, int k0, int wrow, int row0, int start, int end, int c2,
                                             float sl2) {
  if (k0 + BK - 1 > wrow || k0 < start || k0 + BK > end) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + 8 * nt + c2 + (e & 1);
        const int i = e < 2 ? row0 : row0 + 8;
        s[4 * nt + e] = (j <= i && j >= start && j < end) ? s[4 * nt + e] : MASK_VALUE;
      }
  }
  float x0 = m0, x1 = m1, y0 = MASK_VALUE, y1 = MASK_VALUE;
#pragma unroll
  for (int nt = 0; nt < 16; nt += 2) {
    x0 = fmaxf(x0, fmaxf(s[4 * nt], s[4 * nt + 1]));
    x1 = fmaxf(x1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    y0 = fmaxf(y0, fmaxf(s[4 * nt + 4], s[4 * nt + 5]));
    y1 = fmaxf(y1, fmaxf(s[4 * nt + 6], s[4 * nt + 7]));
  }
  x0 = fmaxf(x0, y0);
  x1 = fmaxf(x1, y1);
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  a0 = ex2((m0 - x0) * sl2);
  a1 = ex2((m1 - x1) * sl2);
  m0 = x0;
  m1 = x1;
  const float b0 = x0 == MASK_VALUE ? 0.0f : x0 * sl2;
  const float b1 = x1 == MASK_VALUE ? 0.0f : x1 * sl2;
  float p0 = 0.0f, p1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 16; nt += 2) {
    s[4 * nt] = ex2(fmaf(s[4 * nt], sl2, -b0));
    s[4 * nt + 1] = ex2(fmaf(s[4 * nt + 1], sl2, -b0));
    s[4 * nt + 2] = ex2(fmaf(s[4 * nt + 2], sl2, -b1));
    s[4 * nt + 3] = ex2(fmaf(s[4 * nt + 3], sl2, -b1));
    s[4 * nt + 4] = ex2(fmaf(s[4 * nt + 4], sl2, -b0));
    s[4 * nt + 5] = ex2(fmaf(s[4 * nt + 5], sl2, -b0));
    s[4 * nt + 6] = ex2(fmaf(s[4 * nt + 6], sl2, -b1));
    s[4 * nt + 7] = ex2(fmaf(s[4 * nt + 7], sl2, -b1));
    p0 += s[4 * nt] + s[4 * nt + 1];
    p1 += s[4 * nt + 2] + s[4 * nt + 3];
    q0 += s[4 * nt + 4] + s[4 * nt + 5];
    q1 += s[4 * nt + 6] + s[4 * nt + 7];
  }
  l0 = l0 * a0 + (p0 + q0);
  l1 = l1 * a1 + (p1 + q1);
}

// The probabilities, rounded to bf16, as the A operand of 8 k-steps of 16 keys.
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// How large a row's sum over one thread's 32 exponentials of a tile may grow
// against a reference maximum that the tile's logits have passed: up to it,
// every exponential is at most LAZY_SUM, and the reference is kept.
constexpr float LAZY_SUM = 4096.0f;

// The exponentials ex2(s * scale * log2 e - b), rounded to bf16 and packed as
// the A operand of 8 k-steps of 16 keys, and the rows' f32 sums r0, r1.
__device__ __forceinline__ void exps_packed(const float (&s)[64], uint32_t (&p)[8][4], float b0, float b1, float sl2,
                                            float& r0, float& r1) {
  float p0 = 0.0f, p1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float e0 = ex2(fmaf(s[8 * kk], sl2, -b0)), e1 = ex2(fmaf(s[8 * kk + 1], sl2, -b0));
    const float e2 = ex2(fmaf(s[8 * kk + 2], sl2, -b1)), e3 = ex2(fmaf(s[8 * kk + 3], sl2, -b1));
    const float e4 = ex2(fmaf(s[8 * kk + 4], sl2, -b0)), e5 = ex2(fmaf(s[8 * kk + 5], sl2, -b0));
    const float e6 = ex2(fmaf(s[8 * kk + 6], sl2, -b1)), e7 = ex2(fmaf(s[8 * kk + 7], sl2, -b1));
    p0 += e0 + e1;
    p1 += e2 + e3;
    q0 += e4 + e5;
    q1 += e6 + e7;
    p[kk][0] = pack_bf16(e0, e1);
    p[kk][1] = pack_bf16(e2, e3);
    p[kk][2] = pack_bf16(e4, e5);
    p[kk][3] = pack_bf16(e6, e7);
  }
  r0 = p0 + q0;
  r1 = p1 + q1;
}

// The online-softmax step of a tile after an item's first: the exponentials
// are taken against the rows' running maxima m0, m1 as they stand, with no
// wait for the tile's own maxima. While the sums show that no exponential
// passed LAZY_SUM, the maxima, the sums' scale and O stay as they are (so
// neither the tile's maxima nor O's rescale is computed); else the warp finds
// the new maxima and redoes the step exactly, and returns true with the
// rescale factors a0, a1. Masking as in softmax_step.
__device__ __forceinline__ bool softmax_lazy(float (&s)[64], uint32_t (&p)[8][4], float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1, int k0, int wrow, int row0, int start,
                                             int end, int c2, float sl2) {
  if (k0 + BK - 1 > wrow || k0 < start || k0 + BK > end) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + 8 * nt + c2 + (e & 1);
        const int i = e < 2 ? row0 : row0 + 8;
        s[4 * nt + e] = (j <= i && j >= start && j < end) ? s[4 * nt + e] : MASK_VALUE;
      }
  }
  float r0, r1;
  exps_packed(s, p, m0 == MASK_VALUE ? 0.0f : m0 * sl2, m1 == MASK_VALUE ? 0.0f : m1 * sl2, sl2, r0, r1);
  if (!__any_sync(0xffffffffu, !(r0 <= LAZY_SUM && r1 <= LAZY_SUM))) {
    l0 += r0;
    l1 += r1;
    return false;
  }
  float x0 = MASK_VALUE, x1 = MASK_VALUE, y0 = MASK_VALUE, y1 = MASK_VALUE;
#pragma unroll
  for (int nt = 0; nt < 16; nt += 2) {
    x0 = fmaxf(x0, fmaxf(s[4 * nt], s[4 * nt + 1]));
    x1 = fmaxf(x1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    y0 = fmaxf(y0, fmaxf(s[4 * nt + 4], s[4 * nt + 5]));
    y1 = fmaxf(y1, fmaxf(s[4 * nt + 6], s[4 * nt + 7]));
  }
  x0 = fmaxf(x0, y0);
  x1 = fmaxf(x1, y1);
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  x0 = fmaxf(m0, x0);
  x1 = fmaxf(m1, x1);
  a0 = ex2((m0 - x0) * sl2);
  a1 = ex2((m1 - x1) * sl2);
  m0 = x0;
  m1 = x1;
  exps_packed(s, p, x0 == MASK_VALUE ? 0.0f : x0 * sl2, x1 == MASK_VALUE ? 0.0f : x1 * sl2, sl2, r0, r1);
  l0 = l0 * a0 + r0;
  l1 = l1 * a1 + r1;
  return true;
}

__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq, const __nv_bfloat16* k_tile) {
  const uint64_t dk = sw128_desc(k_tile);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_qk(s, dq + 2 * ks, dk + 2 * ks, ks);
  wg_commit();
}

__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[8][4], const __nv_bfloat16* v_tile) {
  const uint64_t dv = sw128_desc(v_tile);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_pv(o, p[kk], dv + (uint64_t)((2048 * kk) >> 4));
  wg_commit();
}

__global__ void __launch_bounds__(NT, 1)
flash64_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
               const int32_t* __restrict__ kv_start, const int32_t* __restrict__ kv_end, int S, int H, int n_units,
               float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  __nv_bfloat16* sq = (__nv_bfloat16*)base;                                          // 2 Q tiles
  __nv_bfloat16* sk = (__nv_bfloat16*)(base + 2 * Q_BYTES);                          // NSTAGE K tiles
  __nv_bfloat16* sv = (__nv_bfloat16*)(base + 2 * Q_BYTES + NSTAGE * KV_BYTES);      // NSTAGE V tiles
  __nv_bfloat16* so = (__nv_bfloat16*)(base + 2 * Q_BYTES + 2 * NSTAGE * KV_BYTES);  // NCW x 64 output rows
  uint64_t* full = (uint64_t*)(base + 2 * Q_BYTES + 2 * NSTAGE * KV_BYTES + NCW * O_ROWS * HD * 2);
  uint64_t* empty = full + NSTAGE;
  uint64_t* q_full = empty + NSTAGE;
  uint64_t* q_empty = q_full + 2;
  const int nqt = (S + BQ - 1) / BQ;
  const int npu = (nqt + 1) / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NCW);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 4 * NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {  // the producer: one thread keeps the Q pair and the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0, iq = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        for (int which = 0; which < 2; ++which) {
          Item item;
          if (!unit_item(u, npu, nqt, H, which, kv_start, kv_end, S, item)) break;
          const int qb = iq & 1;
          if (iq >= 2) mbar_wait(&q_empty[qb], ((iq >> 1) - 1) & 1);
          mbar_expect_tx(&q_full[qb], Q_BYTES);
          tma_load(sq + qb * BQ * HD, &qmap, &q_full[qb], item.h * HD, item.qt * BQ, item.b);
          ++iq;
          for (int kt = item.lo; kt <= item.hi; ++kt, ++it) {
            const int st = it % NSTAGE;
            if (it >= NSTAGE) mbar_wait(&empty[st], ((it / NSTAGE) - 1) & 1);
            mbar_expect_tx(&full[st], 2 * KV_BYTES);
            tma_load(sk + st * BK * HD, &kmap, &full[st], item.h * HD, kt * BK, item.b);
            tma_load(sv + st * BK * HD, &vmap, &full[st], item.h * HD, kt * BK, item.b);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup cw: q rows [64 cw, 64 cw + 64) of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const float sl2 = sm_scale * LOG2E;
  __nv_bfloat16* my_o = so + cw * O_ROWS * HD;
  if (cw == 0) bar_arrive(SCHED, 256);  // the first turn at the tensor cores is warpgroup 0's
  int it = 0, iq = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    for (int which = 0; which < 2; ++which) {
      Item item;
      if (!unit_item(u, npu, nqt, H, which, kv_start, kv_end, S, item)) break;
      const int start = max(kv_start[item.b], 0);
      const int end = min(kv_end[item.b], S);
      const int qb = iq & 1;
      mbar_wait(&q_full[qb], (iq >> 1) & 1);
      ++iq;
      const int r0 = item.qt * BQ + 64 * cw;  // the warpgroup's first q row
      const int wrow = r0 + 16 * warp;
      const int row0 = wrow + g;
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.0f;
      float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.0f, l1 = 0.0f;
      const int n = item.hi - item.lo + 1;
      if (n > 0) {
        const uint64_t dq = sw128_desc(sq + qb * BQ * HD + cw * 64 * HD);
        float s[64], a0, a1;
        uint32_t p[8][4];
        int st = it % NSTAGE;
        mbar_wait(&full[st], (it / NSTAGE) & 1);
        bar_sync(SCHED + cw, 256);
        wg_fence();
        issue_qk(s, dq, sk + st * BK * HD);
        bar_arrive(SCHED + (cw ^ 1), 256);
        wg_wait<0>();
        fence_regs(s);
        softmax_step(s, m0, m1, l0, l1, a0, a1, item.lo * BK, wrow, row0, start, end, c2, sl2);
        pack_p(p, s);
        for (int j = 1; j < n; ++j) {
          // QK^T of tile j and PV of tile j - 1 in one turn; the softmax of
          // tile j then runs under the other warpgroup's products
          const int st1 = (it + j) % NSTAGE;
          mbar_wait(&full[st1], ((it + j) / NSTAGE) & 1);
          bar_sync(SCHED + cw, 256);
          wg_fence();
          issue_qk(s, dq, sk + st1 * BK * HD);
          issue_pv(o, p, sv + st * BK * HD);
          bar_arrive(SCHED + (cw ^ 1), 256);
          wg_wait<0>();
          fence_regs(s);
          fence_regs(o);
          fence_regs(p);
          if (lane == 0) mbar_arrive(&empty[st]);
          if (softmax_lazy(s, p, m0, m1, l0, l1, a0, a1, (item.lo + j) * BK, wrow, row0, start, end, c2, sl2)) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              o[4 * nt] *= a0;
              o[4 * nt + 1] *= a0;
              o[4 * nt + 2] *= a1;
              o[4 * nt + 3] *= a1;
            }
          }
          st = st1;
        }
        bar_sync(SCHED + cw, 256);
        wg_fence();
        issue_pv(o, p, sv + st * BK * HD);
        bar_arrive(SCHED + (cw ^ 1), 256);
        wg_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(&empty[st]);
        it += n;
      }
      if (lane == 0) mbar_arrive(&q_empty[qb]);

      // epilogue: the rows' sums divide, the warpgroup's 64 rows go through
      // its staging tile to one TMA store (rows past S are clipped)
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
      const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
      if (tid == 0) store_wait_read();  // the previous item's store has read the staging tile
      bar_sync(OBAR + cw, 128);
      const int r = warp * 16 + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<uint32_t*>(my_o + swz(r, nt) + c2) = pack_bf16(o[4 * nt] * inv0, o[4 * nt + 1] * inv0);
        *reinterpret_cast<uint32_t*>(my_o + swz(r + 8, nt) + c2) =
            pack_bf16(o[4 * nt + 2] * inv1, o[4 * nt + 3] * inv1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(OBAR + cw, 128);
      if (tid == 0 && r0 < S) tma_store(&omap, my_o, item.h * HD, r0, item.b);
    }
  }
  if (tid == 0) store_wait();
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

// [B, S, H*64] bf16 as a 3-D map, boxes of `rows` rows of one head, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* x, int B, int S, int H, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * HD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * HD * 2, (cuuint64_t)S * H * HD * 2};
  const cuuint32_t box[3] = {HD, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// streaming multiprocessors of the current device (0 on an error)
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess ? n : 0;
}

}  // namespace

// q, k, v, out: [B, S, H*64] bf16, 16-byte aligned; kv_start, kv_end: [B]
// int32; cos, sin: [S, 64] f32 or both null; qk_rot: [2, B, S, H*64] bf16
// scratch for the rotated Q and K (unused without cos). Returns the first
// cudaError_t of the launches, or cudaErrorInvalidValue when a tensor map
// cannot be made.
extern "C" int flash64_launch(const void* q, const void* k, const void* v, const void* kv_start, const void* kv_end,
                              const void* cos, const void* sin, void* qk_rot, void* out, int B, int S, int H,
                              float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const void* queries = q;
  const void* keys = k;
  if (cos != nullptr) {
    const size_t units = (size_t)B * S * H * 4;
    __nv_bfloat16* q_rot = (__nv_bfloat16*)qk_rot;
    __nv_bfloat16* k_rot = q_rot + (size_t)B * S * H * HD;
    rope_k_kernel<<<dim3((unsigned)((units + 255) / 256), 2), 256, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const float*)cos, (const float*)sin, q_rot, k_rot, S, H,
        units);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    queries = q_rot;
    keys = k_rot;
  }
  CUtensorMap qmap, kmap, vmap, omap;
  if (!make_map(&qmap, queries, B, S, H, BQ) || !make_map(&kmap, keys, B, S, H, BK) ||
      !make_map(&vmap, v, B, S, H, BK) || !make_map(&omap, out, B, S, H, O_ROWS))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(flash64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (S + BQ - 1) / BQ;
  const long long units = (long long)B * H * ((nqt + 1) / 2);
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(units < sms ? units : sms);
  flash64_kernel<<<grid, NT, SMEM_BYTES, st>>>(qmap, kmap, vmap, omap, (const int32_t*)kv_start,
                                               (const int32_t*)kv_end, S, H, (int)units, sm_scale);
  return (int)cudaGetLastError();
}
