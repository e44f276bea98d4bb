// Causal grouped-query attention with a per-row key range, every head_dim
// that is a multiple of 64, on Hopper (wgmma + TMA up to 512, Q and K
// streamed in head-dim panels past it; the kernel bodies are in
// csrc/attention_sm90.cuh).
//
// Replaces the stock Pallas TPU flash_attention
// (jax.experimental.pallas.ops.tpu.flash_attention, K3) at both of its
// call sites: easyrag_tpu/models/decode.py::_prefill_layer (the prompt
// prefill of the Qwen2 generator, left padding) and
// easyrag_tpu/models/layers.py:351 (every layer of the gte-Qwen2 embedder,
// right padding), causal, with the padding given as segment ids (pad 0,
// real 1). JAX sends every head dim that is a multiple of 64 to the stock
// kernel, and so does the wrapper here: past 256 V's columns are split in
// groups of at most 256, one block each, and past 512 Q and K stream through
// shared memory in chunks of 4 panels (attention_stream_kernel).
// What differs from those calls:
//
//   * layout: q is [B, S, NH*HD] and k, v are [B, S, NKV*HD], the
//     projections' own layout, so nothing is transposed; query head h reads
//     KV head h / (NH/NKV) directly, so K/V are never repeated;
//   * padding: keys outside [kv_start[b], kv_end[b]) are masked (left
//     padding is kv_start = S - length, kv_end = S; right padding
//     kv_start = 0, kv_end = length); RoPE is applied on the host first;
//   * masked logits are finfo(f32).min, never -inf, so every output is
//     finite: a query row whose visited keys are all masked averages them,
//     and a row that visits no key tile at all (a pad row whose causal
//     prefix lies before kv_start) writes zeros. Pad rows' K/V go to the
//     KV cache, and a NaN there would reach the decode as 0 * NaN. A 64-row
//     group walks the key tiles from its range's first tile up to
//     min(its diagonal tile, the tile of kv_end - 1): the tiles past kv_end
//     hold only masked keys, so no output changes by skipping them;
//   * online softmax in f32 registers over wgmma products (see the header).
//
// Bound on the H100: at the flagship's largest prompt bucket (B=1, S=7680,
// 28 query heads of 128) causal QK^T + PV is ~0.42 TFLOP per layer, 0.43 ms
// at the bf16 tensor-core peak against ~0.05 ms of bytes: tensor-core
// bound, and so is the embedder's index build (B=128, S=2048, right padded).
// At head_dim 128 a 64 x 64 tile's products take 512 tensor-core clocks of an
// SM against 256 clocks of the SFU for its 4,096 exponentials (the rates of
// csrc/probe_k1.cu), so the softmax hides behind the other warpgroup's
// products more easily than in K1 at head_dim 64.

#include "attention_sm90.cuh"

// q, out: [B, S, NH*HD] bf16; k, v: [B, S, NKV*HD] bf16, 16-byte aligned;
// kv_start, kv_end: [B] int32; NH % NKV == 0; HD a multiple of 64.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for another
// HD or a tensor map that cannot be made).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, const void* kv_start,
                                      const void* kv_end, void* out, int B, int S, int NH, int NKV, int HD,
                                      float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0) return 0;
  if (NKV <= 0 || NH % NKV) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define K3_HD(D) \
  if (HD == D) return attn_sm90::launch<D, false>(q, k, v, kv_start, kv_end, out, B, S, NH, NKV, sm_scale, 0.0f, st);
  K3_HD(64) K3_HD(128) K3_HD(192) K3_HD(256) K3_HD(320) K3_HD(384) K3_HD(448) K3_HD(512)
#undef K3_HD
  if (HD > 512 && HD % 64 == 0)
    return attn_sm90::launch_stream(q, k, v, kv_start, kv_end, out, B, S, NH, NKV, HD, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
