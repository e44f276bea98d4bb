// K6: the max of each contiguous 8-element chunk of an f32 [B, N] tensor
// (the port of easyrag_tpu's chunk-max stage, tools/exp_chunkmax.py:131
// ``pallas_roll``, the first step of ops/topk.py::_chunkmax_pruned_topk).
//
// out[b, c] = max(x[b, 8c : 8c + 8]). N is a multiple of 8, so the rows'
// chunks tile the flat buffer and out is the flat [B * N / 8] array of chunk
// maxima. Each thread reads its chunk as two float4 (one 32-byte sector,
// streamed: the scores are read once) and writes one float. The work is
// bound by memory; the TPU kernel's lane rolls and one-hot compaction have no
// counterpart here. Max is exact, so the result equals any other order of
// the same maxima bit for bit (0.0 and -0.0 compare equal and may trade).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) chunk_max_kernel(const float4* __restrict__ x, float* __restrict__ out,
                                                            long long n_chunks) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_chunks) return;
  const float4 a = __ldcs(x + 2 * i);
  const float4 b = __ldcs(x + 2 * i + 1);
  const float m = fmaxf(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)), fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w)));
  __stcs(out + i, m);
}

}  // namespace

// x: n_chunks * 8 contiguous floats, 16-byte aligned; out: n_chunks floats.
extern "C" int chunk_max_launch(const void* x, void* out, long long n_chunks, void* stream) {
  if (n_chunks <= 0) return 0;
  const long long blocks = (n_chunks + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  chunk_max_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float*)out, n_chunks);
  return (int)cudaGetLastError();
}
