// Causal grouped-query attention with the Gemma2 logit softcap, head_dim 256
// (and 128), right padding, no mask input, on Hopper (wgmma + TMA; the
// kernel body is csrc/attention_sm90.cuh, shared with K3).
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
//     227 KB of shared memory. Here each 64-row group walks the key tiles up
//     to its diagonal with a running max and sum in f32 registers; the
//     softcap is applied to each f32 logit before the running max; only the
//     tiles on the diagonal carry the triangle mask;
//   * layout. q is [B, S, NH*D] and k, v are [B, S, NKV*D], the projections'
//     own layout: query head h reads KV head h / (NH/NKV) in place, nothing
//     is repeated or transposed;
//   * head_dim 256: a 64-row f32 output accumulator is 128 registers a
//     thread of a consumer warpgroup, run as four 64-dim panels of PV; the
//     K/V ring holds two stages of 64 keys x 256 dims (64 KB each);
//   * the tanh is tanhf, the full-precision f32 tanh, not tanh.approx.f32:
//     tanh.approx's ~2^-11 relative error, times the cap of 50, moves a
//     logit by up to ~0.025, a 2.5% change of its probability, against the
//     1.6e-2 per-row bound the kernel is held to.
//
// Bound on the H100: at B = 32, S = 1152 (the reranker's first 24 layers)
// causal QK^T + PV of the real rows is ~0.2 TFLOP per layer, ~0.2 ms at the
// bf16 tensor-core peak, against 0.27 ms to move q, k, v and o once. At
// head_dim 256 a 64 x 64 tile's products take 1,024 tensor-core clocks of an
// SM; its 4,096 exponentials 256 SFU clocks and its 4,096 tanhf a few
// hundred ALU clocks more, which the other warpgroup's products cover.

#include "attention_sm90.cuh"

// q, out: [B, S, NH*HD] bf16; k, v: [B, S, NKV*HD] bf16, 16-byte aligned; HD
// 128 or 256; NH % NKV == 0; softcap 0 means no cap. Returns the cudaError_t
// of the launch.
extern "C" int flash_softcap_launch(const void* q, const void* k, const void* v, void* out, int B, int S, int NH,
                                    int NKV, int HD, float sm_scale, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0) return 0;
  if (NKV <= 0 || NH % NKV) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool cap = softcap > 0.0f;
  if (HD == 256)
    return cap ? attn_sm90::launch<256, true>(q, k, v, nullptr, nullptr, out, B, S, NH, NKV, sm_scale, softcap, st)
               : attn_sm90::launch<256, false>(q, k, v, nullptr, nullptr, out, B, S, NH, NKV, sm_scale, 0.0f, st);
  if (HD == 128)
    return cap ? attn_sm90::launch<128, true>(q, k, v, nullptr, nullptr, out, B, S, NH, NKV, sm_scale, softcap, st)
               : attn_sm90::launch<128, false>(q, k, v, nullptr, nullptr, out, B, S, NH, NKV, sm_scale, 0.0f, st);
  return (int)cudaErrorInvalidValue;
}
