// H100 probes for K1's design; on no path of the system and not in the smoke.
//
// They ask on Hopper what two TPU probes asked on the TPU:
//   * tools/bench_mxu_k64.py:33 (the matrix unit's rate at contraction
//     depth 64 against 128): mma_probe_kernel<DEPTH> runs QK^T as K1's warps
//     do (A fragments held in registers, B read from a swizzled shared tile
//     with ldmatrix, mma.sync m16n8k16), and wgmma_probe_kernel<N, DEPTH> runs
//     wgmma.mma_async m64nNk16 from shared-memory descriptors, waiting after
//     each product as an attention kernel waits for its logits;
//   * tools/bench_vpu.py:26 (the exp, max and select rates of K1's softmax):
//     sfu_probe_kernel<OP> runs ex2.approx, max.f32 or a compare and select,
//     eight independent chains a thread.
// Every block writes its elapsed clock64 cycles; tools/torch_probe_k1.py
// launches them, times them with CUDA events and prints rates per second and
// per clock per SM. The operands' values do not matter (zero tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// no-swizzle K-major descriptor: 8x8 core matrices of 128 contiguous bytes,
// the two of a 16-deep k step 128 bytes apart (LBO), 8-row groups 256 bytes
// apart (SBO)
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

template <int DEPTH>
__global__ void __launch_bounds__(NT, 2)
mma_probe_kernel(int iters, long long* cycles, float* sink) {
  __shared__ __align__(128) __nv_bfloat16 a[128 * DEPTH];
  __shared__ __align__(128) __nv_bfloat16 bt[64 * DEPTH];
  for (int i = threadIdx.x; i < 128 * DEPTH; i += NT) a[i] = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < 64 * DEPTH; i += NT) bt[i] = __float2bfloat16(0.0f);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t af[DEPTH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DEPTH / 16; ++kk) {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4(af[kk], smem_u32(a + r * DEPTH + (((2 * kk + (lane >> 4)) ^ (r & 7)) << 3)));
  }
  float acc[8][4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kk = 0; kk < DEPTH / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int r = 16 * np + (lane >> 4) * 8 + (lane & 7);
        uint32_t b[4];
        ldsm_x4(b, smem_u32(bt + r * DEPTH + (((2 * kk + ((lane >> 3) & 1)) ^ (r & 7)) << 3)));
        mma16816(acc[2 * np], af[kk], b[0], b[1]);
        mma16816(acc[2 * np + 1], af[kk], b[2], b[3]);
      }
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  sink[blockIdx.x * NT + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int N, int DEPTH>
__global__ void __launch_bounds__(NT, 1)
wgmma_probe_kernel(int iters, long long* cycles, float* sink) {
  __shared__ __align__(1024) __nv_bfloat16 a[64 * DEPTH];
  __shared__ __align__(1024) __nv_bfloat16 bt[N * DEPTH];
  for (int i = threadIdx.x; i < 64 * DEPTH; i += NT) a[i] = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < N * DEPTH; i += NT) bt[i] = __float2bfloat16(0.0f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[N / 2] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < DEPTH / 16; ++ks) {
      if constexpr (N == 64)
        wgmma_m64n64k16(acc, desc(a + ks * 64 * 16), desc(bt + ks * N * 16), 1);
      else
        wgmma_m64n128k16(acc, desc(a + ks * 64 * 16), desc(bt + ks * N * 16), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  const long long t1 = clock64();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  sink[blockIdx.x * NT + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// OP 0: ex2.approx; 1: max.f32; 2: compare (setp) and select (selp), the
// causal mask of one logit
template <int OP>
__global__ void __launch_bounds__(NT)
sfu_probe_kernel(int iters, long long* cycles, float* sink) {
  float x[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] = -0.001f * (threadIdx.x + r);
  const int i = threadIdx.x;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if constexpr (OP == 0) {
        // x <- 2^-x stays near its fixed point 0.64; the neg runs on the FMA pipe
        asm volatile("{\n.reg .f32 t;\nneg.f32 t, %0;\nex2.approx.ftz.f32 %0, t;\n}\n" : "+f"(x[r]));
      } else if constexpr (OP == 1) {
        asm volatile("max.f32 %0, %0, %1;\n" : "+f"(x[r]) : "f"(x[(r + 1) & 7]));
      } else {
        asm volatile("{\n.reg .pred p;\nsetp.le.s32 p, %1, %2;\nselp.f32 %0, %0, %3, p;\n}\n"
                     : "+f"(x[r])
                     : "r"(it + r), "r"(i), "f"(-3.4028234663852886e38f));
      }
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) s += x[r];
  sink[blockIdx.x * NT + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// Each entry point launches `blocks` blocks of 256 threads on `stream`;
// cycles: [blocks] int64, sink: [blocks * 256] f32. Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for a shape it does not have.
extern "C" int probe_mma(int depth, int iters, int blocks, void* cycles, void* sink, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (depth == 64)
    mma_probe_kernel<64><<<blocks, NT, 0, s>>>(iters, (long long*)cycles, (float*)sink);
  else if (depth == 128)
    mma_probe_kernel<128><<<blocks, NT, 0, s>>>(iters, (long long*)cycles, (float*)sink);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int probe_wgmma(int n, int depth, int iters, int blocks, void* cycles, void* sink, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long* c = (long long*)cycles;
  float* k = (float*)sink;
  if (n == 64 && depth == 64)
    wgmma_probe_kernel<64, 64><<<blocks, NT, 0, s>>>(iters, c, k);
  else if (n == 64 && depth == 128)
    wgmma_probe_kernel<64, 128><<<blocks, NT, 0, s>>>(iters, c, k);
  else if (n == 128 && depth == 64)
    wgmma_probe_kernel<128, 64><<<blocks, NT, 0, s>>>(iters, c, k);
  else if (n == 128 && depth == 128)
    wgmma_probe_kernel<128, 128><<<blocks, NT, 0, s>>>(iters, c, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int probe_sfu(int op, int iters, int blocks, void* cycles, void* sink, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long* c = (long long*)cycles;
  float* k = (float*)sink;
  if (op == 0)
    sfu_probe_kernel<0><<<blocks, NT, 0, s>>>(iters, c, k);
  else if (op == 1)
    sfu_probe_kernel<1><<<blocks, NT, 0, s>>>(iters, c, k);
  else if (op == 2)
    sfu_probe_kernel<2><<<blocks, NT, 0, s>>>(iters, c, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
