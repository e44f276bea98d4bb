// BM25 postings scatter: dense scores from gathered postings, deterministic.
//
// Replaces easyrag_tpu/ops/bm25_pallas.py::bm25_scores_pallas (K5), which
// sums vals[p] into scores[doc_ids[p]] as a one-hot matmul per doc tile on
// the TPU's matrix unit. On Hopper the one-hot matmul is the wrong form (it
// pays 2*P*N flops for P useful adds), and a float-atomic scatter is cheap but
// adds in a different order on every run, so near-tied scores flip between
// runs. This version keeps every doc's sum in posting order, with no float
// atomics, and lets each doc scan only the postings of its own doc tile: a
// stable counting sort of the postings by doc tile, then a sum per tile.
//
//   1. count: one warp per sub-chunk of SUB postings (WARPS warps a block,
//      grid.y over rows) counts its in-range postings per doc tile in shared
//      memory (integer atomics: counts do not depend on order) and writes
//      cnt[row][tile][sub];
//   2. scan: one block per (tile, row) turns the tile's counts into
//      exclusive offsets over its sub-chunks, in place, and writes the
//      tile's total; place and sum add the totals of the earlier tiles (at
//      most MAX_TILES) themselves, so no pass scans all T * nsub counts;
//   3. place: each warp walks its sub-chunk again, 32 postings at a time in
//      posting order, and writes each posting to its tile's bucket at its
//      sub-chunk's offset plus its stable rank (__match_any_sync groups the
//      lanes of one tile, a popcount of the lower lanes ranks them, the
//      group's lowest lane advances the tile's cursor). Each bucket holds
//      its tile's postings in posting order;
//   4. sum: one block per (tile, row); each thread owns one doc, streams the
//      tile's bucket through shared memory and adds the postings whose id is
//      its doc, in bucket order, then writes its sum once.
//
// Ids outside [0, N) are dropped at the count, so the sentinel id N (value 0)
// adds nothing. A tile holds TILE_DOCS docs, or a multiple of it when N needs
// more than MAX_TILES tiles (the sum then walks the tile's docs TILE_DOCS at
// a time); ops/bm25_scatter.py::scatter_layout computes the tile width, the
// tile and sub-chunk counts and the scratch the wrapper allocates.
//
// Bound on the H100: the work is P adds; the bytes are the postings read
// once and the scores written once (~2 MB at P = 262144, ~0.6 us at 3.35
// TB/s), so the floor is the four launches' latency. The passes read the
// postings three times (count, place, sum) from L2. A skewed row (every
// posting in one tile) stays exact but its one sum block scans all P
// postings; a query's postings cannot do that, since a term lists each doc
// once and a tile then gets at most (terms x TILE_DOCS) of them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 512;         // postings per warp sub-chunk
constexpr int WARPS = 4;         // sub-chunks per count/place block
constexpr int MAX_TILES = 1024;  // per-warp tile counters in shared memory
constexpr int TILE_DOCS = 128;   // docs per sum pass, one per thread
constexpr int CHUNK = 2048;      // bucket postings per shared-memory chunk of the sum
constexpr int SCAN_THREADS = 512;  // sub-chunks a tile scan takes at once

__global__ void __launch_bounds__(WARPS * 32)
count_kernel(const int32_t* __restrict__ ids, int P, int N, int tile, int T,
             int nsub, int32_t* __restrict__ cnt) {
  __shared__ int32_t hist[WARPS][MAX_TILES];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y;
  const int sub = blockIdx.x * WARPS + warp;
  if (sub >= nsub) return;  // whole warps; no block barrier below
  for (int t = lane; t < T; t += 32) hist[warp][t] = 0;
  __syncwarp();
  const int32_t* ids_row = ids + (size_t)row * P;
  const int p0 = sub * SUB;
  const int n = min(SUB, P - p0);
  int id[SUB / 32];  // all of the sub-chunk's loads in flight at once
#pragma unroll
  for (int r = 0; r < SUB / 32; ++r) id[r] = r * 32 + lane < n ? ids_row[p0 + r * 32 + lane] : -1;
#pragma unroll
  for (int r = 0; r < SUB / 32; ++r)
    if (id[r] >= 0 && id[r] < N) atomicAdd(&hist[warp][id[r] / tile], 1);
  __syncwarp();
  int32_t* dst = cnt + (size_t)row * T * nsub + sub;
  for (int t = lane; t < T; t += 32) dst[(size_t)t * nsub] = hist[warp][t];
}

// One block per (tile, row): the exclusive scan of the tile's counts over
// its sub-chunks, in place (cnt[row][tile] is contiguous), and the tile's
// total in tot[row][tile]. Tile bases, the scan over tiles, are T <= 1024
// totals that place and sum add up themselves.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_scan_kernel(int32_t* __restrict__ cnt, int32_t* __restrict__ tot, int T, int nsub) {
  __shared__ int32_t warp_sums[SCAN_THREADS / 32];
  const int t = blockIdx.x;
  const int row = blockIdx.y;
  int32_t* c = cnt + ((size_t)row * T + t) * nsub;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < nsub; base += SCAN_THREADS) {  // block-uniform
    const int i = base + threadIdx.x;
    const int x = i < nsub ? c[i] : 0;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < SCAN_THREADS / 32; ++w) {
      const int ws = warp_sums[w];
      before += w < warp ? ws : 0;
      total += ws;
    }
    if (i < nsub) c[i] = carry + before + incl - x;
    carry += total;
    __syncthreads();  // warp_sums is reused
  }
  if (threadIdx.x == 0) tot[(size_t)row * T + t] = carry;
}

__global__ void __launch_bounds__(WARPS * 32)
place_kernel(const int32_t* __restrict__ ids, const float* __restrict__ vals,
             int P, int N, int tile, int T, int nsub,
             const int32_t* __restrict__ off, const int32_t* __restrict__ tot,
             int32_t* __restrict__ b_ids, float* __restrict__ b_vals) {
  __shared__ int32_t cursor[WARPS][MAX_TILES];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y;
  const int sub = blockIdx.x * WARPS + warp;
  if (sub >= nsub) return;  // whole warps; no block barrier below
  // cursor[t] = (postings of tiles before t) + (postings of tile t in
  // earlier sub-chunks): a warp scan over the tile totals
  const int32_t* src = off + (size_t)row * T * nsub + sub;
  const int32_t* tot_row = tot + (size_t)row * T;
  int carry = 0;
  for (int t0 = 0; t0 < T; t0 += 32) {  // warp-uniform
    const int t = t0 + lane;
    const int x = t < T ? tot_row[t] : 0;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (t < T) cursor[warp][t] = carry + incl - x + src[(size_t)t * nsub];
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();
  const int32_t* ids_row = ids + (size_t)row * P;
  const float* vals_row = vals + (size_t)row * P;
  int32_t* bi = b_ids + (size_t)row * P;
  float* bv = b_vals + (size_t)row * P;
  const int p0 = sub * SUB;
  const int n = min(SUB, P - p0);
  const unsigned lower = (1u << lane) - 1u;
  int ids_r[SUB / 32];  // all of the sub-chunk's loads in flight at once
  float vals_r[SUB / 32];
#pragma unroll
  for (int r = 0; r < SUB / 32; ++r) {
    const bool in = r * 32 + lane < n;
    ids_r[r] = in ? ids_row[p0 + r * 32 + lane] : -1;
    vals_r[r] = in ? vals_row[p0 + r * 32 + lane] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < SUB / 32; ++r) {  // in posting order
    const int id = ids_r[r];
    const float v = vals_r[r];
    const bool valid = id >= 0 && id < N;
    const int key = valid ? id / tile : -1;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    const int rank = __popc(same & lower);
    const int base = valid ? cursor[warp][key] : 0;
    __syncwarp();
    if (valid) {
      bi[base + rank] = id;
      bv[base + rank] = v;
      if (rank == 0) cursor[warp][key] = base + __popc(same);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(TILE_DOCS)
sum_kernel(const int32_t* __restrict__ tot, const int32_t* __restrict__ b_ids,
           const float* __restrict__ b_vals, int P, int N, int tile, int T,
           float* __restrict__ out) {
  __shared__ int4 s_ids[CHUNK / 4];  // 16-byte broadcasts: four postings a read
  __shared__ float4 s_vals[CHUNK / 4];
  __shared__ int32_t part[TILE_DOCS / 32];
  const int row = blockIdx.y;
  const int t = blockIdx.x;
  // the bucket starts after the postings of every earlier tile
  const int32_t* tot_row = tot + (size_t)row * T;
  int before = 0;
  for (int u = threadIdx.x; u < t; u += TILE_DOCS) before += tot_row[u];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) before += __shfl_xor_sync(0xffffffffu, before, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = before;
  __syncthreads();
  int beg = 0;
#pragma unroll
  for (int w = 0; w < TILE_DOCS / 32; ++w) beg += part[w];
  const int end = beg + tot_row[t];
  const int32_t* bi = b_ids + (size_t)row * P;
  const float* bv = b_vals + (size_t)row * P;
  const int d_end = min(N, (t + 1) * tile);
  for (int d0 = t * tile; d0 < d_end; d0 += TILE_DOCS) {  // block-uniform
    const int doc = d0 + threadIdx.x;
    float acc = 0.0f;
    for (int c0 = beg; c0 < end; c0 += CHUNK) {
      const int n = min(CHUNK, end - c0);
      const int n4 = (n + 3) / 4;
      __syncthreads();  // the previous chunk is consumed
      int32_t* si = reinterpret_cast<int32_t*>(s_ids);
      float* sv = reinterpret_cast<float*>(s_vals);
      for (int i = threadIdx.x; i < 4 * n4; i += TILE_DOCS) {
        si[i] = i < n ? bi[c0 + i] : -1;  // -1 matches no doc
        sv[i] = i < n ? bv[c0 + i] : 0.0f;
      }
      __syncthreads();
      for (int i = 0; i < n4; ++i) {  // in bucket order
        const int4 d = s_ids[i];
        const float4 w = s_vals[i];
        if (d.x == doc) acc += w.x;
        if (d.y == doc) acc += w.y;
        if (d.z == doc) acc += w.z;
        if (d.w == doc) acc += w.w;
      }
    }
    if (doc < d_end) out[(size_t)row * N + doc] = acc;
  }
}

}  // namespace

// doc_ids, vals: [B, P] (int32, float32); out: [B, N] float32. tile, T, nsub
// and the scratch come from ops/bm25_scatter.py::scatter_layout: scratch
// holds B * (T * nsub + T + 2 * P) 4-byte words (counts, then in-tile
// offsets; tile totals; bucketed ids; bucketed values). Returns the first
// cudaError_t of the four launches (0 on success).
extern "C" int bm25_scores_launch(const void* doc_ids, const void* vals,
                                  void* out, void* scratch, int B, int P, int N,
                                  int tile, int T, int nsub, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (T <= 0 || T > MAX_TILES || tile % TILE_DOCS || (long long)tile * T < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* cnt = (int32_t*)scratch;
  int32_t* tot = cnt + (size_t)B * T * nsub;
  int32_t* b_ids = tot + (size_t)B * T;
  float* b_vals = (float*)(b_ids + (size_t)B * P);
  const int32_t* ids = (const int32_t*)doc_ids;
  const dim3 chunks((nsub + WARPS - 1) / WARPS, B);
  cudaError_t err;
  if (nsub > 0) {
    count_kernel<<<chunks, WARPS * 32, 0, s>>>(ids, P, N, tile, T, nsub, cnt);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  tile_scan_kernel<<<dim3(T, B), SCAN_THREADS, 0, s>>>(cnt, tot, T, nsub);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nsub > 0) {
    place_kernel<<<chunks, WARPS * 32, 0, s>>>(ids, (const float*)vals, P, N,
                                               tile, T, nsub, cnt, tot, b_ids, b_vals);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  sum_kernel<<<dim3(T, B), TILE_DOCS, 0, s>>>(tot, b_ids, b_vals, P, N, tile, T,
                                              (float*)out);
  return (int)cudaGetLastError();
}
