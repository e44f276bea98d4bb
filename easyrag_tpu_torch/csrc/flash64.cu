// Causal head_dim-64 attention with a per-row key range and optional RoPE.
//
// Replaces easyrag_tpu/ops/flash64.py::flash64_attention (K1), the attention
// of every MiniCPM reranker layer. Same layout ([B, S, H*64] bf16 for q, k, v
// and the output), f32 logits and softmax, masked logits set to
// finfo(f32).min. What differs from the TPU kernel:
//
//   * padding: keys outside [kv_start[b], kv_end[b]) are masked, so left AND
//     right padding are both right (the TPU kernel assumes a left-pad prefix);
//   * one block per (64-row q tile, head, batch row), 4 warps of 16 q rows;
//     the block walks the k tiles from the row range's first tile up to the
//     causal diagonal with an online softmax (running max and sum in f32),
//     so nothing of size S*S exists anywhere. Head-pair lane packing and the
//     rotate-half matmul were TPU layout devices and are gone;
//   * QK^T and PV run on the tensor cores through WMMA 16x16x16 bf16
//     fragments with f32 accumulation; the unnormalised probabilities are
//     rounded to bf16 for PV and the row sum divides at the end (the TPU
//     kernel rounds the normalised probabilities), a difference of about one
//     bf16 rounding of the output;
//   * rows whose every visited key is masked stay finite: masked logits are
//     finfo.min, never -inf, so exp(min - min) = 1 gives a uniform average
//     over the visited keys, and a row that visits no tile at all (its whole
//     causal prefix lies before kv_start) writes zeros.
//   * RoPE (rotate-half, f32 math, rounded to bf16 like the host version) is
//     applied to Q and K as their tiles are loaded, from [S, 64] f32 tables.
//
// Bound on the H100: at the reranker's shape (B=32, S~1.1k, H=36) the work
// is ~170 GFLOP of causal QK^T + PV per layer, so the kernel is tensor-core
// bound in principle; this first version stages every product through
// shared memory with WMMA and synchronous loads, so it runs far below the
// wgmma/TMA rate (about 41 TFLOP/s at that shape on an H100 80GB HBM3 at
// 700 W, 4% of the bf16 peak). Later versions: wgmma with the accumulators
// in registers, TMA loads double-buffered, 128-row q tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HD = 64;   // head dim
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per k tile
constexpr int NT = 128;  // threads per block: 4 warps x 16 q rows
constexpr int LDB = 72;  // bf16 shared row stride (padded against bank conflicts)
constexpr int LDS = 68;  // f32 shared row stride
constexpr float MASK_VALUE = -3.4028234663852886e38f;  // finfo(f32).min

struct Smem {
  __nv_bfloat16 k[BK][LDB];
  __nv_bfloat16 v[BK][LDB];
  __nv_bfloat16 p[BQ][LDB];  // Q staging first, then each warp's probabilities
  float s[BQ][LDS];          // logits, then the P@V partial product
};

union Pack8 {
  uint4 u;
  __nv_bfloat16 x[8];
};

// Rows [r0, r0 + 64) of head h, batch row b, of x [B, S, H*64] into dst,
// rotated by the [S, 64] cos/sin tables when cos is given; rows >= S are 0.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[LDB],
                                          const __nv_bfloat16* __restrict__ x,
                                          const float* __restrict__ cos,
                                          const float* __restrict__ sin,
                                          int b, int h, int r0, int S, int F) {
  for (int u = threadIdx.x; u < BQ * 4; u += NT) {
    const int r = u >> 2;
    const int c = (u & 3) * 8;  // this unit's columns: [c, c+8) and [c+32, c+40)
    const int row = r0 + r;
    Pack8 lo, hi;
    lo.u = make_uint4(0, 0, 0, 0);
    hi.u = lo.u;
    if (row < S) {
      const __nv_bfloat16* src = x + ((size_t)b * S + row) * F + h * HD;
      lo.u = *reinterpret_cast<const uint4*>(src + c);
      hi.u = *reinterpret_cast<const uint4*>(src + c + 32);
      if (cos != nullptr) {
        const float* cr = cos + (size_t)row * HD;
        const float* sr = sin + (size_t)row * HD;
        Pack8 ol, oh;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = __bfloat162float(lo.x[i]);
          const float z = __bfloat162float(hi.x[i]);
          // x*cos + rotate_half(x)*sin, rotate_half(x) = [-x2, x1]; no fma,
          // so the rounding is the host version's
          ol.x[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(a, cr[c + i]), __fmul_rn(-z, sr[c + i])));
          oh.x[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(z, cr[c + 32 + i]), __fmul_rn(a, sr[c + 32 + i])));
        }
        lo = ol;
        hi = oh;
      }
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = lo.u;
    *reinterpret_cast<uint4*>(&dst[r][c + 32]) = hi.u;
  }
}

__global__ void __launch_bounds__(NT)
flash64_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int32_t* __restrict__ kv_start,
               const int32_t* __restrict__ kv_end,
               const float* __restrict__ cos, const float* __restrict__ sin,
               __nv_bfloat16* __restrict__ out, int S, int H, float sm_scale) {
  __shared__ __align__(128) Smem sm;
  const int nqt = (S + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.x;  // longest causal prefixes first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int F = H * HD;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = max(kv_start[b], 0);
  const int end = min(kv_end[b], S);

  load_tile(sm.p, q, cos, sin, b, h, q0, S, F);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(qf[kk], &sm.p[warp * 16][kk * 16], LDB);
  // from here on every warp touches only its own 16 rows of sm.p and sm.s

  const int r = warp * 16 + (lane >> 1);  // this thread's row in the tile
  const int half = lane & 1;              // and which 32 of its 64 columns
  const int qrow = q0 + r;
  float m = MASK_VALUE;
  float l = 0.0f;
  float o[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) o[c] = 0.0f;

  const int kt_lo = start / BK;
  const int kt_hi = end > start ? min(qt, (end - 1) / BK) : -1;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sm.k, k, cos, sin, b, h, k0, S, F);
    load_tile(sm.v, v, nullptr, nullptr, b, h, k0, S, F);
    __syncthreads();

#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, &sm.k[n * 16][kk * 16], LDB);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(&sm.s[warp * 16][n * 16], acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    float sv[32];
    float tmax = MASK_VALUE;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      const bool keep = j <= qrow && j >= start && j < end;
      sv[c] = keep ? sm.s[r][half * 32 + c] * sm_scale : MASK_VALUE;
      tmax = fmaxf(tmax, sv[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      psum += p;
      sm.p[r][half * 32 + c] = __float2bfloat16_rn(p);
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < 32; ++c) o[c] *= alpha;
    __syncwarp();

#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, &sm.p[warp * 16][kk * 16], LDB);
        wmma::load_matrix_sync(vf, &sm.v[kk * 16][n * 16], LDB);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(&sm.s[warp * 16][n * 16], acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) o[c] += sm.s[r][half * 32 + c];
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  if (qrow < S) {
    __nv_bfloat16* dst = out + ((size_t)b * S + qrow) * F + h * HD + half * 32;
#pragma unroll
    for (int c8 = 0; c8 < 4; ++c8) {
      Pack8 pk;
#pragma unroll
      for (int i = 0; i < 8; ++i) pk.x[i] = __float2bfloat16_rn(o[c8 * 8 + i] * inv);
      *reinterpret_cast<uint4*>(dst + c8 * 8) = pk.u;
    }
  }
}

}  // namespace

// q, k, v, out: [B, S, H*64] bf16; kv_start, kv_end: [B] int32; cos, sin:
// [S, 64] f32 or both null. Returns the cudaError_t of the launch.
extern "C" int flash64_launch(const void* q, const void* k, const void* v,
                              const void* kv_start, const void* kv_end,
                              const void* cos, const void* sin, void* out,
                              int B, int S, int H, float sm_scale,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash64_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int32_t*)kv_start,
      (const int32_t*)kv_end, (const float*)cos, (const float*)sin,
      (__nv_bfloat16*)out, S, H, sm_scale);
  return (int)cudaGetLastError();
}
