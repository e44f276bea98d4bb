// The MiniCPM decoder layer's elementwise chain in three memory-bound passes:
// residual add + RMSNorm, the residual add alone, and SiLU times up.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it, while PyTorch's eager ops make six passes over [T, D] for one
// RMSNorm (a cast to f32, the square, the mean, two broadcast products, a
// cast back) and two for each residual `x + h * r`. Every value here is
// rounded where the eager ops round it (models/layers.py::rms_norm and the
// eager chain of layers.decoder_layer):
//
//   residual:  hr = bf16(f32(h) * r); x' = bf16(f32(x) + f32(hr))
//   norm:      normed = bf16((f32(x') * rsqrt(sum(f32(x')^2) * (1/D) + eps)) * f32(w))
//   SiLU * up: act = bf16(f32(bf16(g / (1 + expf(-g)))) * f32(u))
//
// so x' and act equal the eager ops' bit for bit, and normed differs only
// where the f32 sum of squares, taken here in another order than PyTorch's
// reduce kernel, rounds to another f32: at most one bf16 ulp. Products and
// sums are the _rn intrinsics, so nvcc never contracts them into an fma that
// would round once where the eager ops round twice (the squares are exact:
// a bf16 value has 8 significant bits).
//
// Bound on the H100: bytes. At the reranker's shape (T = 32 x 1216 rows,
// D = 2304, intermediate 5760) a layer reads and writes 33 bytes per element
// of [T, D]: the input norm 4 (x in, normed out), the mid-layer add + norm 8
// (x and h in, x' and normed out), the layer-end add 6, SiLU * up 6 per
// element of [T, 5760]. Design: the norm gives one warp a row, the row's
// 16-byte vectors strided over its lanes (D = 2304: 288 vectors, 9 a lane),
// x' kept in registers as packed bf16 between the sum and the normalisation,
// so x and h are read once and the weight row comes from L1/L2; the two
// elementwise passes give one 16-byte vector of each input to a thread. The
// norm is built once, for rows of up to 2304 (VPL vectors a lane); a
// narrower row leaves its lanes' last vectors unused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;        // warps, so rows, per block of the norm kernel
constexpr int VPL = 9;         // 16-byte vectors a lane holds: D <= 32 * 8 * 9 = 2304
constexpr int THREADS = 256;   // threads per block of the elementwise kernels

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// two f32 -> two bf16 (round to nearest even), a in the low half
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// x + h * r on two packed bf16 pairs, rounded as the eager ops round
__device__ __forceinline__ uint32_t add_scaled(uint32_t x, uint32_t h, float r) {
  const uint32_t hr = pack(__fmul_rn(lo(h), r), __fmul_rn(hi(h), r));
  return pack(__fadd_rn(lo(x), lo(hr)), __fadd_rn(hi(x), hi(hr)));
}

// PyTorch's silu on CUDA: x / (1 + exp(-x)) in f32 with expf
__device__ __forceinline__ float silu(float x) { return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x))); }

__device__ __forceinline__ uint32_t silu_mul2(uint32_t g, uint32_t u) {
  const uint32_t s = pack(silu(lo(g)), silu(hi(g)));
  return pack(__fmul_rn(lo(s), lo(u)), __fmul_rn(hi(s), hi(u)));
}

__device__ __forceinline__ float sum_sq(uint32_t v, float acc) {
  return __fmaf_rn(hi(v), hi(v), __fmaf_rn(lo(v), lo(v), acc));
}

__device__ __forceinline__ uint32_t scale2(uint32_t x, uint32_t w, float inv) {
  return pack(__fmul_rn(__fmul_rn(lo(x), inv), lo(w)), __fmul_rn(__fmul_rn(hi(x), inv), hi(w)));
}

// One warp per row of `vecs` (at most 32 * VPL) 16-byte vectors. RESIDUAL:
// x' = x + h * r is written to x_out and normalised; else x itself is.
template <bool RESIDUAL>
__global__ void __launch_bounds__(ROWS * 32)
    residual_rms_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ h,
                             const uint4* __restrict__ w, float r, float eps, uint4* __restrict__ x_out,
                             uint4* __restrict__ normed, long long rows, int vecs) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: its row is past the end
  const long long base = row * vecs;
  uint4 v[VPL];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < vecs) {
      uint4 a = x[base + c];
      if (RESIDUAL) {
        const uint4 b = h[base + c];
        a = make_uint4(add_scaled(a.x, b.x, r), add_scaled(a.y, b.y, r), add_scaled(a.z, b.z, r),
                       add_scaled(a.w, b.w, r));
        x_out[base + c] = a;
      }
      v[i] = a;
      ss = sum_sq(a.w, sum_sq(a.z, sum_sq(a.y, sum_sq(a.x, ss))));
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);  // every lane ends with the same sum
  // PyTorch's mean is the sum times the f32 factor 1/D, then + eps, rsqrt
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / (float)(vecs * 8)), eps));
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < vecs) {
      const uint4 g = __ldg(w + c);
      normed[base + c] = make_uint4(scale2(v[i].x, g.x, inv), scale2(v[i].y, g.y, inv), scale2(v[i].z, g.z, inv),
                                    scale2(v[i].w, g.w, inv));
    }
  }
}

struct ScaleAdd {
  float r;
  __device__ __forceinline__ uint32_t operator()(uint32_t x, uint32_t h) const { return add_scaled(x, h, r); }
};

struct SiluMul {
  __device__ __forceinline__ uint32_t operator()(uint32_t g, uint32_t u) const { return silu_mul2(g, u); }
};

// out = op(a, b) over n 16-byte vectors, one a thread
template <class Op>
__global__ void __launch_bounds__(THREADS)
    pair_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ out, long long n, Op op) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint4 p = a[i], q = b[i];
  out[i] = make_uint4(op(p.x, q.x), op(p.y, q.y), op(p.z, q.z), op(p.w, q.w));
}

template <class Op>
int launch_pair(const void* a, const void* b, void* out, long long n_vec, Op op, void* stream) {
  if (n_vec <= 0) return 0;
  const long long blocks = (n_vec + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pair_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>((const uint4*)a, (const uint4*)b, (uint4*)out,
                                                                     n_vec, op);
  return (int)cudaGetLastError();
}

}  // namespace

// x, h (or null), x_out (or null with h), normed: rows * d contiguous bf16;
// w: d bf16; d a multiple of 8, at most 2304; every pointer 16-byte aligned.
extern "C" int residual_rms_norm_launch(const void* x, const void* h, const void* w, float r, float eps, void* x_out,
                                        void* normed, long long rows, int d, void* stream) {
  if (rows <= 0) return 0;
  const int vecs = d / 8;
  if (d <= 0 || d % 8 || vecs > 32 * VPL || (h != nullptr && x_out == nullptr)) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto grid = (unsigned)blocks;
  const auto s = (cudaStream_t)stream;
  if (h != nullptr)
    residual_rms_norm_kernel<true><<<grid, ROWS * 32, 0, s>>>((const uint4*)x, (const uint4*)h, (const uint4*)w, r,
                                                              eps, (uint4*)x_out, (uint4*)normed, rows, vecs);
  else
    residual_rms_norm_kernel<false><<<grid, ROWS * 32, 0, s>>>((const uint4*)x, nullptr, (const uint4*)w, r, eps,
                                                               nullptr, (uint4*)normed, rows, vecs);
  return (int)cudaGetLastError();
}

// x' = x + h * r over n bf16 (a multiple of 8), 16-byte aligned.
extern "C" int scale_add_launch(const void* x, const void* h, float r, void* out, long long n, void* stream) {
  return launch_pair(x, h, out, n / 8, ScaleAdd{r}, stream);
}

// act = silu(gate) * up over n bf16 (a multiple of 8), 16-byte aligned.
extern "C" int silu_mul_launch(const void* gate, const void* up, void* out, long long n, void* stream) {
  return launch_pair(gate, up, out, n / 8, SiluMul{}, stream);
}
