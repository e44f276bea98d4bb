// Causal grouped-query attention with the Gemma2 logit softcap, head_dim 256
// (and 128), right padding, no mask input.
//
// Replaces easyrag_tpu/ops/flash_softcap.py::flash_softcap_attention (K4),
// the attention of every layer of the Gemma2 cost-wise reranker
// (bge-reranker-v2.5-gemma2-lightweight: 16 query heads of 256 on 8 KV heads,
// attn_logit_softcapping 50, scale query_pre_attn_scalar**-0.5 = 1/16). It
// computes, per query head h and KV head h / (NH/NKV):
//
//   l = (q . k) * sm_scale;  l = tanh(l / c) * c  (c = softcap, 0 = no cap);
//   l = -FLT_MAX above the diagonal;  o = softmax(l) @ v
//
// with f32 logits and softmax. Right padding is the caller's contract: pad
// keys lie after every real query, so causality alone keeps them out of the
// real rows, and pad rows get a finite average of earlier keys.
//
// What differs from the TPU kernel:
//
//   * online softmax. The TPU kernel softmaxes a whole [bq, S] f32 tile in
//     VMEM; at S = 1152 and 64 rows that is 295 KB, more than a block's
//     227 KB of shared memory. Here a block walks the key tiles up to the
//     diagonal with a running max and sum in f32; the softcap is applied to
//     each f32 logit tile before the running max; tiles above the diagonal
//     are skipped and only the diagonal tile carries the triangle mask;
//   * layout. q is [B, S, NH*D] and k, v are [B, S, NKV*D], the projections'
//     own layout: query head h reads KV head h / (NH/NKV) in place, nothing
//     is repeated or transposed;
//   * head_dim 256. One block per (64-row q tile, query head, batch row),
//     8 warps. A 64 x 256 f32 output accumulator is 64 KB: split over 8 warps
//     (4 row groups of 16 x 2 column halves of D/2) it is 64 registers a
//     thread, the load of K3's head_dim-128 kernel. The Q, K and V tiles
//     (3 x 33 KB in bf16), the logits, the probabilities and the warps' PV
//     staging take ~160 KB of dynamic shared memory, opted in with
//     cudaFuncSetAttribute;
//   * products. QK^T and PV run on the tensor cores through WMMA 16x16x16
//     bf16 fragments with f32 accumulation; the unnormalised probabilities
//     are rounded to bf16 for PV and the row sum divides at the end (the TPU
//     kernel rounds the normalised probabilities): about one bf16 rounding
//     of the output apart;
//   * tanhf is the full-precision f32 tanh, not tanh.approx.f32.
//
// Bound on the H100: at B = 32, S = 1152 (the reranker's first 24 layers)
// causal QK^T + PV is ~0.35 TFLOP per layer, 0.35 ms at the bf16 tensor-core
// peak, against 0.27 ms to move q, k, v and o once: compute-bound. This
// first version loads tiles synchronously and stages every product through
// shared memory (WMMA), like csrc/flash_attention.cu, so it runs far below
// that; wgmma with register accumulators and TMA double buffering are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per k tile
constexpr int NW = 8;    // warps: 4 row groups of 16 x 2 column halves
constexpr int NT = NW * 32;
constexpr int LDS = BK + 4;  // f32 row stride of the logits and staging tiles
constexpr int LDP = BK + 8;  // bf16 row stride of the probability tile
constexpr float MASK_VALUE = -3.4028234663852886e38f;  // finfo(f32).min

template <int HD>
struct Smem {
  static constexpr int LDB = HD + 8;  // bf16 row stride of the Q/K/V tiles (against bank conflicts)
  __nv_bfloat16 q[BQ][LDB];
  __nv_bfloat16 k[BK][LDB];
  __nv_bfloat16 v[BK][LDB];
  float s[BQ][LDS];            // logits of the current k tile
  __nv_bfloat16 p[BQ][LDP];    // unnormalised probabilities
  float stage[NW][16][LDS];    // each warp's 16 x 64 slice of P@V
  float alpha[BQ];             // per row: exp(m_old - m_new) of the current tile
  float l[BQ];                 // per row: running sum
};

// Rows [r0, r0 + 64) of head h of x (row stride F elements) into dst; rows
// >= S are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[HD + 8], const __nv_bfloat16* __restrict__ x,
                                          int b, int h, int r0, int S, int F) {
  for (int u = threadIdx.x; u < BQ * (HD / 8); u += NT) {
    const int r = u / (HD / 8);
    const int c = (u % (HD / 8)) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < S) val = *reinterpret_cast<const uint4*>(x + ((size_t)b * S + row) * F + h * HD + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_softcap_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int NH,
                     int NKV, float sm_scale, float softcap) {
  constexpr int HALF = HD / 2;       // output columns per warp
  constexpr int CHUNKS = HALF / 64;  // 64-column chunks per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int nqt = (S + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.x;  // longest causal prefixes first
  const int h = blockIdx.y;
  const int kvh = h / (NH / NKV);
  const int b = blockIdx.z;
  const int F = NH * HD;
  const int FKV = NKV * HD;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rw = warp & 3;   // this warp's 16 rows: rw*16 ...
  const int cg = warp >> 2;  // ... and its output columns cg*HALF ...

  load_tile<HD>(sm.q, q, b, h, q0, S, F);

  // softmax mapping: 4 threads a row, 16 columns each
  const int srow = warp * 8 + (lane >> 2);
  const int quarter = lane & 3;
  float m = MASK_VALUE;
  float l = 0.0f;

  // output mapping: row orow of the tile, columns cg*HALF + c*64 + ohalf*32 + [0, 32)
  const int orow = rw * 16 + (lane >> 1);
  const int ohalf = lane & 1;
  float o[CHUNKS * 32];
#pragma unroll
  for (int c = 0; c < CHUNKS * 32; ++c) o[c] = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile (and sm.q is written)
    load_tile<HD>(sm.k, k, b, kvh, k0, S, FKV);
    load_tile<HD>(sm.v, v, b, kvh, k0, S, FKV);
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 32 keys
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = cg * 32 + n * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(qf, &sm.q[rw * 16][kk * 16], Smem<HD>::LDB);
        wmma::load_matrix_sync(kf, &sm.k[col][kk * 16], Smem<HD>::LDB);
        wmma::mma_sync(acc, qf, kf, acc);
      }
      wmma::store_matrix_sync(&sm.s[rw * 16][col], acc, LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // scale, softcap, causal mask (diagonal tile only), online softmax
    {
      const int qrow = q0 + srow;
      float sv[16];
      float tmax = MASK_VALUE;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float x = sm.s[srow][quarter * 16 + c] * sm_scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        if (kt == qt && k0 + quarter * 16 + c > qrow) x = MASK_VALUE;
        sv[c] = x;
        tmax = fmaxf(tmax, x);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m, tmax);
      const float alpha = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(sv[c] - m_new);
        psum += p;
        sm.p[srow][quarter * 16 + c] = __float2bfloat16_rn(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l = l * alpha + psum;
      m = m_new;
      if (quarter == 0) {
        sm.alpha[srow] = alpha;
        sm.l[srow] = l;
      }
    }
    __syncthreads();

    // O = alpha * O + P V: this warp's 16 rows x HALF columns, 64 at a time
    const float alpha = sm.alpha[orow];
#pragma unroll
    for (int c = 0; c < CHUNKS * 32; ++c) o[c] *= alpha;
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
          wmma::load_matrix_sync(pf, &sm.p[rw * 16][kk * 16], LDP);
          wmma::load_matrix_sync(vf, &sm.v[kk * 16][cg * HALF + ch * 64 + n * 16], Smem<HD>::LDB);
          wmma::mma_sync(acc, pf, vf, acc);
        }
        wmma::store_matrix_sync(&sm.stage[warp][0][n * 16], acc, LDS, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 32; ++c) o[ch * 32 + c] += sm.stage[warp][lane >> 1][ohalf * 32 + c];
      __syncwarp();  // the stage is overwritten by the next chunk
    }
  }

  // every row sees key 0, so l > 0
  const float inv = 1.0f / sm.l[orow];
  const int qrow = q0 + orow;
  if (qrow < S) {
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) {
      __nv_bfloat16* dst = out + ((size_t)b * S + qrow) * F + h * HD + cg * HALF + ch * 64 + ohalf * 32;
#pragma unroll
      for (int c8 = 0; c8 < 4; ++c8) {
        union {
          uint4 u;
          __nv_bfloat16 x[8];
        } pk;
#pragma unroll
        for (int i = 0; i < 8; ++i) pk.x[i] = __float2bfloat16_rn(o[ch * 32 + c8 * 8 + i] * inv);
        *reinterpret_cast<uint4*>(dst + c8 * 8) = pk.u;
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int NH, int NKV, float sm_scale,
           float softcap, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_softcap_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sizeof(Smem<HD>));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  flash_softcap_kernel<HD><<<grid, NT, sizeof(Smem<HD>), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, NH, NKV,
      sm_scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, S, NH*HD] bf16; k, v: [B, S, NKV*HD] bf16; HD 128 or 256;
// NH % NKV == 0; softcap 0 means no cap. Returns the cudaError_t of the launch.
extern "C" int flash_softcap_launch(const void* q, const void* k, const void* v, void* out, int B, int S, int NH,
                                    int NKV, int HD, float sm_scale, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0) return 0;
  if (NKV <= 0 || NH % NKV) return (int)cudaErrorInvalidValue;
  if (HD == 256) return launch<256>(q, k, v, out, B, S, NH, NKV, sm_scale, softcap, (cudaStream_t)stream);
  if (HD == 128) return launch<128>(q, k, v, out, B, S, NH, NKV, sm_scale, softcap, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
