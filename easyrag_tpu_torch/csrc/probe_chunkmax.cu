// H100 probe of the strided chunk-max (the port of tools/exp_chunkmax.py:151
// ``pallas_sublane``; on no path of the port).
//
// The f32 buffer is read as rows of 128 floats; out[g, l] = max over the 8
// rows 8g .. 8g+7 at lane l: [G * 8, 128] -> [G, 128]. Each chunk is 8
// elements 128 apart, not contiguous, so a top-k built on it needs a two-key
// chunk select for exact ties (tools/exp_chunkmax.py:196-200). Each thread
// takes 4 lanes: 8 float4 loads 512 bytes apart (a warp reads 8 whole rows,
// coalesced) and one float4 store. tools/torch_probe_chunkmax.py times it
// beside K6 (csrc/chunkmax.cu) and PyTorch's amax over both layouts.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES4 = 32;  // float4 columns of a 128-float row

__global__ void __launch_bounds__(THREADS) strided_max_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                                              long long n_out4) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;  // (g, lane4)
  if (i >= n_out4) return;
  const long long g = i / LANES4, c = i % LANES4;
  const float4* p = x + g * 8 * LANES4 + c;
  float4 m = __ldcs(p);
#pragma unroll
  for (int r = 1; r < 8; ++r) {
    const float4 v = __ldcs(p + r * LANES4);
    m.x = fmaxf(m.x, v.x);
    m.y = fmaxf(m.y, v.y);
    m.z = fmaxf(m.z, v.z);
    m.w = fmaxf(m.w, v.w);
  }
  __stcs(out + i, m);
}

}  // namespace

// x: n_groups * 1024 contiguous floats, 16-byte aligned; out: n_groups * 128.
extern "C" int strided_max_launch(const void* x, void* out, long long n_groups, void* stream) {
  if (n_groups <= 0) return 0;
  const long long n_out4 = n_groups * LANES4;
  const long long blocks = (n_out4 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  strided_max_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>((const float4*)x, (float4*)out, n_out4);
  return (int)cudaGetLastError();
}
