// H100 probe of s8 x s8 -> s32 against bf16 -> f32 tensor-core products; on
// no path of the system and not in the smoke.
//
// It asks on Hopper what tools/exp_attn_int8.py:50 asked of the TPU: does an
// s8 product run at twice the bf16 rate at contraction depth 64 (K1's QK^T,
// [384, 64] @ [64, 1152] per head pair), or only at a deep contraction (PV,
// [384, 1152] @ [1152, 128]), with [512, 512] @ [512, 512] as the peak's
// sanity check? Each SM runs one block that computes the whole product again
// and again (`reps` times), its operands resident in shared memory, and the
// accumulators carried from one product to the next (the loop-carried
// dependence of the TPU probe's fori_loop). Per output tile it runs the
// product's full contraction as one chain and waits for it, as an attention
// kernel waits for its logits:
//
//   * wgma_probe_kernel<INT8>: two warpgroups, 64 x 128 output tiles,
//     wgmma.mma_async m64n128k16 .f32.bf16.bf16 or m64n128k32 .s32.s8.s8,
//     A and B K-major from 128-byte-swizzled shared memory;
//   * mma_probe_kernel<INT8>: eight warps, 16 x 64 output tiles, mma.sync
//     m16n8k16 .f32.bf16 or m16n8k32 .s32.s8, both operands by ldmatrix from
//     XOR-swizzled shared memory (as K1's first kernel read them).
//
// The resident operands are 512 bytes of contraction a row (the TPU probe's
// [K, N] operands do not fit one SM's 227 KB at depth 1152), so a chain
// deeper than that cycles over them: the tensor cores read the same number
// of bytes per product as they would from distinct tiles. The values are
// pseudo-random (integers in [-127, 127], bf16 in [-1, 1)), not zeros, so
// the card's power draw is that of real data. tools/torch_probe_int8.py
// launches them and prints TOP/s and microseconds per product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROW_BYTES = 512;        // resident contraction bytes of a row
constexpr int PANEL_BYTES = 128;      // one 128-byte swizzle row
constexpr int A_ROWS = 64, B_ROWS = 128;  // wgmma tile: 64 x 128
constexpr int WG_SMEM = 1024 + (A_ROWS + B_ROWS) * ROW_BYTES;
constexpr int MMA_A_ROWS = 128, MMA_B_ROWS = 64;  // mma.sync: 8 warps x 16 rows, 64 columns
constexpr int MMA_SMEM = (MMA_A_ROWS + MMA_B_ROWS) * ROW_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  return x ^ (x >> 16);
}

// pseudo-random operand bytes: int8 in [-127, 127], or bf16 in [-1, 1)
template <bool INT8>
__device__ void fill(uint8_t* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 2; i += blockDim.x) {
    const uint32_t h = mix(i * 2654435761U + 12345U);
    if (INT8) {
      p[2 * i] = (uint8_t)(int8_t)((int)(h & 0xff) % 255 - 127);
      p[2 * i + 1] = (uint8_t)(int8_t)((int)((h >> 8) & 0xff) % 255 - 127);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(p + 2 * i) = __float2bfloat16(((int)(h & 0xffff) - 32768) / 32768.0f);
    }
  }
}

// 128-byte-swizzled panel of 128-byte rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define PROBE_DF \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PROBE_DR \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
  "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
  "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
  "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
  "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
  "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
  "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
  "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
#define PROBE_REGS64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PROBE_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PROBE_DF
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PROBE_REGS64 ", %64, %65, p;\n}\n"
      : PROBE_DR
      : "l"(da), "l"(db), "r"(1));
}

template <bool INT8>
__global__ void __launch_bounds__(256, 1)
wgmma_probe_kernel(int M, int K, int N, int reps, long long* cycles, float* sink) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);  // 4 panels of 64 x 128 bytes
  uint8_t* b = a + A_ROWS * ROW_BYTES;                                          // 4 panels of 128 x 128 bytes
  fill<INT8>(a, (A_ROWS + B_ROWS) * ROW_BYTES);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  using Acc = typename std::conditional<INT8, int32_t, float>::type;
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  const int wg = threadIdx.x >> 7;
  const int tiles = (M / 64) * (N / 128);
  const int steps = K * (INT8 ? 1 : 2) / 32;  // 32-byte k steps of the contraction
  const long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    for (int t = wg; t < tiles; t += 2) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int ks = 0; ks < steps; ++ks) {
        const int panel = (ks >> 2) & 3;  // cycle over the 512 resident bytes of a row
        const uint64_t da = sw128_desc(a + panel * A_ROWS * PANEL_BYTES) + 2 * (ks & 3);
        const uint64_t db = sw128_desc(b + panel * B_ROWS * PANEL_BYTES) + 2 * (ks & 3);
        if constexpr (INT8)
          wgmma_s8(acc, da, db);
        else
          wgmma_bf16(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += (float)acc[i];
  sink[blockIdx.x * 256 + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of (row r, 16-byte chunk c) in rows of ROW_BYTES, chunks XOR-swizzled by the row
__device__ __forceinline__ int xsw(int r, int c) { return r * ROW_BYTES + ((c ^ (r & 7)) << 4); }

template <bool INT8>
__global__ void __launch_bounds__(256, 1)
mma_probe_kernel(int M, int K, int N, int reps, long long* cycles, float* sink) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a = smem_raw;                          // 128 rows (16 a warp)
  uint8_t* b = smem_raw + MMA_A_ROWS * ROW_BYTES;  // 64 rows of B^T (columns of the 16 x 64 tile)
  fill<INT8>(smem_raw, MMA_SMEM);
  __syncthreads();
  using Acc = typename std::conditional<INT8, int32_t, float>::type;
  Acc acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (M / 16) * (N / 64);
  const int steps = K * (INT8 ? 1 : 2) / 32;  // 32-byte k steps
  const uint32_t sa = smem_u32(a), sb = smem_u32(b);
  const int ra = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const long long t0 = clock64();
  for (int rep = 0; rep < reps; ++rep) {
    for (int t = warp; t < tiles; t += 8) {
      for (int ks = 0; ks < steps; ++ks) {
        const int c0 = 2 * (ks % (ROW_BYTES / 32));  // cycle over the resident row bytes
        uint32_t af[4];
        ldsm_x4(af, sa + xsw(ra, c0 + (lane >> 4)));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int rb = 16 * np + (lane >> 4) * 8 + (lane & 7);
          uint32_t bf[4];
          ldsm_x4(bf, sb + xsw(rb, c0 + ((lane >> 3) & 1)));
          if constexpr (INT8) {
            mma_s8(acc[2 * np], af, bf[0], bf[1]);
            mma_s8(acc[2 * np + 1], af, bf[2], bf[3]);
          } else {
            mma_bf16(acc[2 * np], af, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) s += (float)acc[n][0] + (float)acc[n][1] + (float)acc[n][2] + (float)acc[n][3];
  sink[blockIdx.x * 256 + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <typename Kernel>
int run(Kernel kernel, int smem, int M, int K, int N, int reps, int blocks, void* cycles, void* sink,
        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, 256, smem, stream>>>(M, K, N, reps, (long long*)cycles, (float*)sink);
  return (int)cudaGetLastError();
}

}  // namespace

// One probe launch: `blocks` blocks of 256 threads, each computing the
// [M, K] @ [K, N] product `reps` times. wgmma: 1, mma.sync: 0; int8: 1,
// bf16: 0. M must be a multiple of 64, N of 128, K of 64 (32-byte steps of
// both types). cycles: [blocks] int64, sink: [blocks * 256] f32. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a shape it does not take).
extern "C" int probe_int8(int wgmma, int int8, int M, int K, int N, int reps, int blocks, void* cycles, void* sink,
                          void* stream) {
  if (M % 64 || N % 128 || K % 64 || M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (wgmma)
    return int8 ? run(wgmma_probe_kernel<true>, WG_SMEM, M, K, N, reps, blocks, cycles, sink, s)
                : run(wgmma_probe_kernel<false>, WG_SMEM, M, K, N, reps, blocks, cycles, sink, s);
  return int8 ? run(mma_probe_kernel<true>, MMA_SMEM, M, K, N, reps, blocks, cycles, sink, s)
              : run(mma_probe_kernel<false>, MMA_SMEM, M, K, N, reps, blocks, cycles, sink, s);
}
