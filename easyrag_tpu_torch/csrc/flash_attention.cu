// Causal grouped-query attention at head_dim 128 with a per-row key range.
//
// Replaces the stock Pallas TPU flash_attention
// (jax.experimental.pallas.ops.tpu.flash_attention, K3) at both of its
// call sites: easyrag_tpu/models/decode.py::_prefill_layer (the prompt
// prefill of the Qwen2 generator, left padding) and
// easyrag_tpu/models/layers.py:351 (every layer of the gte-Qwen2 embedder,
// right padding), causal, with the padding given as segment ids (pad 0,
// real 1). What differs from those calls:
//
//   * layout: q is [B, S, NH*128] and k, v are [B, S, NKV*128], the
//     projections' own layout, so nothing is transposed; query head h reads
//     KV head h / (NH/NKV) directly, so K/V are never repeated;
//   * padding: keys outside [kv_start[b], kv_end[b]) are masked (left
//     padding is kv_start = S - length, kv_end = S; right padding
//     kv_start = 0, kv_end = length); RoPE is applied on the host first;
//   * masked logits are finfo(f32).min, never -inf, so every output is
//     finite: a query row whose visited keys are all masked averages them,
//     and a row that visits no key tile at all (a pad row whose causal
//     prefix lies before kv_start) writes zeros. Pad rows' K/V go to the
//     KV cache, and a NaN there would reach the decode as 0 * NaN;
//   * one block per (64-row q tile, query head, batch row), 4 warps of 16 q
//     rows; the block walks the k tiles from the row range's first tile up
//     to the causal diagonal with an online softmax (running max and sum in
//     f32), so nothing of size S*S exists. QK^T and PV run on the tensor
//     cores through WMMA 16x16x16 bf16 fragments with f32 accumulation; the
//     unnormalised probabilities are rounded to bf16 for PV and the row sum
//     divides at the end (the TPU kernel rounds normalised probabilities),
//     a difference of about one bf16 rounding of the output.
//
// Bound on the H100: at the flagship's largest prompt bucket (B=1,
// S=7680, 28 query heads) causal QK^T + PV is ~0.42 TFLOP per layer,
// 11.8 TFLOP over 28 layers, so the kernel is tensor-core bound in
// principle. This first version stages every product through shared memory
// (WMMA, synchronous loads), like csrc/flash64.cu, and runs far below the
// wgmma/TMA rate; wgmma with register accumulators, TMA double buffering
// and 128-row q tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HD = 128;  // head dim
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per k tile
constexpr int NT = 128;  // threads per block: 4 warps x 16 q rows
constexpr int LDB = HD + 8;  // bf16 row stride of the Q/K/V tiles (padded against bank conflicts)
constexpr int LDP = BK + 8;  // bf16 row stride of the probability tile
constexpr int LDS = BK + 4;  // f32 row stride of the logits / PV staging tile
constexpr float MASK_VALUE = -3.4028234663852886e38f;  // finfo(f32).min

struct Smem {
  __nv_bfloat16 q[BQ][LDB];
  __nv_bfloat16 k[BK][LDB];
  __nv_bfloat16 v[BK][LDB];
  __nv_bfloat16 p[BQ][LDP];  // each warp's probabilities
  float s[BQ][LDS];          // logits, then each 64-column half of P@V
};

// Rows [r0, r0 + 64) of head h of x (row stride F elements) into dst; rows
// >= S are zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[LDB], const __nv_bfloat16* __restrict__ x,
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

__global__ void __launch_bounds__(NT)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ kv_start,
                       const int32_t* __restrict__ kv_end, __nv_bfloat16* __restrict__ out,
                       int S, int NH, int NKV, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
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
  const int start = max(kv_start[b], 0);
  const int end = min(kv_end[b], S);

  load_tile(sm.q, q, b, h, q0, S, F);
  // from here on every warp touches only its own 16 rows of sm.q, sm.p, sm.s

  const int r = warp * 16 + (lane >> 1);  // this thread's row in the tile
  const int half = lane & 1;              // which 32 columns of each 64-wide slice
  const int qrow = q0 + r;
  float m = MASK_VALUE;
  float l = 0.0f;
  float o[64];  // output columns hh*64 + half*32 + c, hh = c / 32
#pragma unroll
  for (int c = 0; c < 64; ++c) o[c] = 0.0f;

  const int kt_lo = start / BK;
  const int kt_hi = end > start ? min(qt, (end - 1) / BK) : -1;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile (and sm.q is written)
    load_tile(sm.k, k, b, kvh, k0, S, FKV);
    load_tile(sm.v, v, b, kvh, k0, S, FKV);
    __syncthreads();

#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(qf, &sm.q[warp * 16][kk * 16], LDB);
        wmma::load_matrix_sync(kf, &sm.k[n * 16][kk * 16], LDB);
        wmma::mma_sync(acc, qf, kf, acc);
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
    for (int c = 0; c < 64; ++c) o[c] *= alpha;
    __syncwarp();

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
          wmma::load_matrix_sync(pf, &sm.p[warp * 16][kk * 16], LDP);
          wmma::load_matrix_sync(vf, &sm.v[kk * 16][hh * 64 + n * 16], LDB);
          wmma::mma_sync(acc, pf, vf, acc);
        }
        wmma::store_matrix_sync(&sm.s[warp * 16][n * 16], acc, LDS, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 32; ++c) o[hh * 32 + c] += sm.s[r][half * 32 + c];
      __syncwarp();  // sm.s is overwritten by the next half
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  if (qrow < S) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      __nv_bfloat16* dst = out + ((size_t)b * S + qrow) * F + h * HD + hh * 64 + half * 32;
#pragma unroll
      for (int c8 = 0; c8 < 4; ++c8) {
        union {
          uint4 u;
          __nv_bfloat16 x[8];
        } pk;
#pragma unroll
        for (int i = 0; i < 8; ++i) pk.x[i] = __float2bfloat16_rn(o[hh * 32 + c8 * 8 + i] * inv);
        *reinterpret_cast<uint4*>(dst + c8 * 8) = pk.u;
      }
    }
  }
}

}  // namespace

// q, out: [B, S, NH*128] bf16; k, v: [B, S, NKV*128] bf16; kv_start, kv_end:
// [B] int32; NH % NKV == 0. Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, const void* kv_start,
                                      const void* kv_end, void* out, int B, int S, int NH, int NKV,
                                      float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0) return 0;
  if (NKV <= 0 || NH % NKV) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  flash_attention_kernel<<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const int32_t*)kv_start,
      (const int32_t*)kv_end, (__nv_bfloat16*)out, S, NH, NKV, sm_scale);
  return (int)cudaGetLastError();
}
