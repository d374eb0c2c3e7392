// K9: one decoder layer of an int8 decode step as two halves, each ending
// in an f32 partial sum of the residual update (the per-layer decode pair).
//
// Replaces: desta25_audio_tpu/ops/fused_decode_tp.py::_make_attn_kernel
//   (attention half: ln1, int8 q/k/v, qk-norm and RoPE, the in-place cache
//   write, the scores over the cache plus the current token, P.V, wo as an
//   f32 partial sum) and ::_make_mlp_kernel (ln2, gate/up, SwiGLU, down as
//   an f32 partial sum), driven layer by layer by fused_decode_layers_tp
//   (psum of the partials over the "model" axis) and
//   fused_decode_layers_perlayer (p = 1, ORCA's injection between layers).
//   The residual h stays f32 between the halves; each half reads bf16(h).
// What bounds it on the H100: device-memory bandwidth.  Each half streams
//   its layer's int8 weight shard once (Llama-3.1-8B at p = 1: 41.9 MB for
//   the attention half, 176.2 MB for the MLP half; 6.98 GB a 32-layer step,
//   ~2.1 ms at 3.35 TB/s) against 2*B FLOP per weight; the attention half
//   also reads B*S*Hkv*Dh*4 bytes of cache.
// Design: 7 launches a layer, K8's (the residual f32), each with
// programmatic dependent launch (common.cuh pdl_*: it reads h, the cache
// and its scratch only after its wait, and lets the next launch start
// early), so a layer chains on the stream and inside a CUDA graph alike:
//   * ln1 / ln2: the decode step's norm kernel (csrc/fused_decode.cu,
//     desta_rms_norm_f32: one block a row, the f32 row rounded to bf16 as
//     it is read, the TPU kernels' input cast).  A fold of the norm into
//     the GEMM's x staging (the norm of the whole row staged once a CTA
//     after its wait, the ranks' sums of squares exchanged through
//     distributed shared memory) ran the 32-layer step 0.35 ms slower on
//     the H100: every CTA read its rows' whole k-range of f32 h before its
//     first product, so the weight stream stalled (PERF.md, K9).
//   * q/k/v and gate/up: the skinny GEMM (csrc/skinny_gemm.cuh, entry
//     desta_skinny_gemm) with its STORE and SWIGLU epilogues.
//   * attention: csrc/decode_attention.cuh at Kd = 1 (keys split across a
//     thread-block cluster, TMA tile loads), on the shard's heads
//     (the q rows of its H/p heads, then its k and v rows) and its slice of
//     the packed cache [B, S, Hkv/p*Dh].
//   * wo and down: skinny_gemm with the STORE_F32 epilogue (the partial
//     sum) or, at p = 1, ADD_F32 (the same f32 add h + partial, in place).

#include "decode_attention.cuh"
#include "skinny_gemm.cuh"

using namespace desta;

// the layouts of decode_attention (csrc/decode_attention.cuh) at Kd = 1
extern "C" int desta_tp_attention(
    const void* qkv, void* k_cache, void* v_cache, const void* cosb,
    const void* sinb, const void* mask, int mask_stride, const void* ci,
    const void* q_norm, const void* k_norm, void* out, int B, int S, int H,
    int Hkv, int Dh, float eps, float scale, void* stream) {
  return (int)decode_attention(qkv, k_cache, v_cache, cosb, sinb, mask,
                               mask_stride, ci, q_norm, k_norm, out, B, 1, S,
                               H, Hkv, Dh, eps, scale, (cudaStream_t)stream);
}

// x [M, K] bf16, w int8 [N, K], scale [N] -> out [M, N] f32: the partial
// sum (accumulate = 0) or out += it (accumulate = 1); K % 16 == 0
extern "C" int desta_tp_gemm(const void* x, const void* w, const void* scale,
                             void* out, int M, int N, int K, int accumulate,
                             void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      accumulate
          ? launch_skinny<int8_t, EPI_ADD_F32>((const bf16*)x, (const int8_t*)w,
                                               (const float*)scale, out, M, N,
                                               K, st)
          : launch_skinny<int8_t, EPI_STORE_F32>((const bf16*)x,
                                                 (const int8_t*)w,
                                                 (const float*)scale, out, M,
                                                 N, K, st);
  return (int)e;
}
