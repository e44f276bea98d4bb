// BM25 postings scatter: dense scores from gathered postings, deterministic.
//
// Replaces easyrag_tpu/ops/bm25_pallas.py::bm25_scores_pallas (K5), which
// sums vals[p] into scores[doc_ids[p]] as a one-hot matmul per doc tile on
// the TPU's matrix unit. On Hopper the one-hot matmul is the wrong form (it
// pays 2*P*N flops for P useful adds), and a float-atomic scatter is cheap but
// adds in a different order on every run, so near-tied scores flip between
// runs. This kernel keeps the sum order fixed instead:
//
//   * one block per tile of TILE docs (grid.x) and per query row (grid.y);
//     each thread owns one doc of the tile and keeps its running sum in a
//     register;
//   * the row's postings stream through shared memory in chunks of CHUNK, in
//     posting order; every thread scans each chunk (same address for the whole
//     warp, so the shared-memory reads are broadcasts) and adds the postings
//     whose id equals its doc, in posting order. No atomics: each sum is
//     written once, by its owner.
//   * ids outside [0, N) match no thread and are skipped, never written; the
//     sentinel id N with value 0 therefore adds nothing.
//
// Bound on the H100: each thread's scan is a chain of P compare-and-add
// steps, and at N = 20000 the grid is only 79 blocks of 8 warps, fewer than
// the card's 132 SMs, so the kernel is latency-bound, not bandwidth-bound
// (memory traffic is P * 8 bytes per block, served from L2). On an H100 80GB
// HBM3 at 700 W it took 0.3 ms at P = 32768 and 2.1 ms at P = 262144, slower
// than the atomic scatter it replaces. A later version splits the postings
// over blocks as well, or buckets them by doc tile first, and adds the
// partial sums in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;   // docs per block (one per thread)
constexpr int CHUNK = 2048; // postings per shared-memory chunk (16 KB)

__global__ void __launch_bounds__(TILE)
bm25_scores_kernel(const int32_t* __restrict__ doc_ids,
                   const float* __restrict__ vals,
                   float* __restrict__ out, int P, int N) {
  __shared__ int32_t s_ids[CHUNK];
  __shared__ float s_vals[CHUNK];
  const int row = blockIdx.y;
  const int doc = blockIdx.x * TILE + threadIdx.x;
  const int32_t* ids_row = doc_ids + (size_t)row * P;
  const float* vals_row = vals + (size_t)row * P;
  float acc = 0.0f;
  for (int p0 = 0; p0 < P; p0 += CHUNK) {
    const int n = min(CHUNK, P - p0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < n; i += TILE) {
      s_ids[i] = ids_row[p0 + i];
      s_vals[i] = vals_row[p0 + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (s_ids[i] == doc) acc += s_vals[i];
    }
  }
  if (doc < N) out[(size_t)row * N + doc] = acc;
}

}  // namespace

// doc_ids, vals: [B, P] (int32, float32); out: [B, N] float32. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bm25_scores_launch(const void* doc_ids, const void* vals,
                                  void* out, int B, int P, int N,
                                  void* stream) {
  if (B <= 0 || N <= 0) return 0;
  dim3 grid((N + TILE - 1) / TILE, B);
  bm25_scores_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
      (const int32_t*)doc_ids, (const float*)vals, (float*)out, P, N);
  return (int)cudaGetLastError();
}
