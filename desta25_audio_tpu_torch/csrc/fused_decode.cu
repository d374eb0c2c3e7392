// One LLM decode step (Kd = 1 token per row) or speculative-verify step
// (Kd = 2..8 tokens per row) as a fixed set of kernels per layer: RMSNorm,
// skinny weight-streaming GEMMs with fused epilogues (bf16 or int8
// weights), and an attention kernel that also writes the new K/V rows into
// the cache.
//
// Replaces: desta25_audio_tpu/ops/fused_decode.py::_make_kernel (no ORCA
//   injection) -- the single-launch Pallas TPU kernel behind
//   fused_decode_layers (K8: bf16 stream w_int8=False and int8 stream
//   w_int8=True, Kd=1) and fused_verify_layers (K8v: Kd=2..8, draft block
//   ops/fused_decode.py:581-660).
// What bounds it on the H100: device-memory bandwidth.  Every step streams
//   every weight once (Llama-3.1-8B: 13.96 GB of bf16 or 6.98 GB of int8
//   layer weights, ~4.2 / ~2.1 ms at 3.35 TB/s) against 2*B*Kd FLOP per
//   weight, far below the 295 FLOP/byte ridge; the KV cache adds
//   B*S*Hkv*Dh*4 bytes per layer (Kd times for the verify step, whose
//   draft tokens each read it).
// Design:
//   * skinny_gemm (csrc/skinny_gemm.cuh, entry point desta_skinny_gemm in
//     csrc/skinny_gemm.cu): the weight-streaming GEMM on the tensor cores
//     with weights and activations swapped (64 weight rows a CTA, the R <=
//     16 token rows as mma's N side), weight tiles and the rows' k-ranges
//     streamed through a 4-stage TMA / bulk-copy ring, K split across a
//     thread-block cluster and the partials summed through distributed
//     shared memory in rank order; the int8 scale applied to the f32 sum,
//     epilogues store / residual / SwiGLU at the TPU kernel's rounding
//     points.  R = B*Kd rows go 16 per pass; above 16 rows each pass
//     re-streams the weights.  Its plan reads N, K and the SM count, not R,
//     so the verify step's token 0 is summed as the decode step's.
//   * decode_attention (csrc/decode_attention.cuh, shared with K9): the
//     step's attention with its cache write, one launch a layer.  The keys
//     of each (batch row b, kv head, draft token j) are split across a
//     thread-block cluster of up to 8 CTAs (ops/fused_decode.
//     plan_decode_splits: 128 CTAs at the b2 decode instead of 16 blocks),
//     each CTA streams its range's K and V tiles through a 4-stage TMA ring,
//     and the softmax's maximum and denominator and the partial outputs are
//     combined through distributed shared memory in rank order, P normalised
//     before its bf16 rounding as on the TPU.  It is bound by bytes (the
//     cached K/V rows below ci), not by operations.
//   * rms_norm: one block per row, f32 statistics, bf16 output.
//   A step costs 7 launches per layer (norm, qkv, attention, o+residual,
//   norm, gate/up+SwiGLU, down+residual).  One persistent kernel or a CUDA
//   graph over them is a later PR.

#include "decode_attention.cuh"

namespace {

using namespace desta;

// ---------------------------------------------------------------------------
// RMSNorm: out[r, :] = bf16(x * rsqrt(mean(x^2) + eps) * w), f32 math
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ out, int D, float eps) {
  __shared__ float red[32];
  const bf16* xr = x + (size_t)blockIdx.x * D;
  bf16* orow = out + (size_t)blockIdx.x * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = __bfloat162float(xr[i]);
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float inv = rsqrtf(ss / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    orow[i] = __float2bfloat16(__bfloat162float(xr[i]) * inv
                               * __bfloat162float(w[i]));
}

}  // namespace

extern "C" int desta_rms_norm(const void* x, const void* w, void* out,
                              int rows, int D, float eps, void* stream) {
  rms_norm_kernel<<<rows, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)out, D, eps);
  return (int)cudaGetLastError();
}

// out[3] = the decode attention's plan on the current device: key ranges,
// keys per range, dynamic shared bytes (ops/fused_decode.plan_decode_splits
// and decode_attention_smem are the same rules)
extern "C" int desta_decode_attention_plan(int B, int Hkv, int kd, int S,
                                           int H, void* out) {
  return (int)decode_attention_plan(B, Hkv, kd, S, H, (int*)out);
}

// the layouts of decode_attention (csrc/decode_attention.cuh)
extern "C" int desta_decode_attention(
    const void* qkv, void* k_cache, void* v_cache, const void* cosb,
    const void* sinb, const void* mask, int mask_stride, const void* ci,
    const void* q_norm, const void* k_norm, void* out, int B, int kd, int S,
    int H, int Hkv, int Dh, float eps, float scale, void* stream) {
  return (int)decode_attention(qkv, k_cache, v_cache, cosb, sinb, mask,
                               mask_stride, ci, q_norm, k_norm, out, B, kd, S,
                               H, Hkv, Dh, eps, scale, (cudaStream_t)stream);
}
