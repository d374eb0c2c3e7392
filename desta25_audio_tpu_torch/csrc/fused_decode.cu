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
//   * rms_norm: one block per row, each thread 16-byte loads of 8 bf16
//     (D = 4096: 512 threads x 8), the row kept in registers between the
//     f32 sum of squares and the scaling, so the residual is read once; the
//     weight loads before the programmatic-launch wait.  Its f32-input form
//     (each value rounded to bf16 as it is read) is K9's ln1 / ln2.
//   A step costs 7 launches per layer (norm, qkv, attention, o+residual,
//   norm, gate/up+SwiGLU, down+residual).  The decode step is captured as
//   one CUDA graph (desta25_audio_tpu_torch/generate/graph.py), and the
//   norm, the GEMMs and the attention are launched with programmatic
//   dependent launch (common.cuh pdl_*): each may start while the kernel
//   before it drains, doing only what depends on no predecessor until its
//   wait.

#include "decode_attention.cuh"

namespace {

using namespace desta;

// ---------------------------------------------------------------------------
// RMSNorm: out[r, :] = bf16(x * rsqrt(mean(x^2) + eps) * w), f32 math
// ---------------------------------------------------------------------------

constexpr int RMS_VEC = 8;            // bf16 a 16-byte load

// Vector v (8 values) of a row as 8 bf16: a 16-byte load, or two of f32
// rounded to bf16 (the f32 residual of the per-layer pair K9).
__device__ __forceinline__ uint4 rms_load8(const bf16* row, int v) {
  return reinterpret_cast<const uint4*>(row)[v];
}
__device__ __forceinline__ uint4 rms_load8(const float* row, int v) {
  const float4* p = reinterpret_cast<const float4*>(row) + 2 * v;
  const float4 a = p[0], b = p[1];
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// One block a row; thread t holds vectors t, t + blockDim.x, ... (NV of
// them, the last ones predicated off past D / 8) in registers.  XT: the
// input's type (bf16; f32, rounded to bf16 as it is read).
template <int NV, typename XT>
__global__ void __launch_bounds__(RMS_THREADS_MAX)
rms_norm_kernel(const XT* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ out, int D, float eps) {
  __shared__ float red[RMS_THREADS_MAX / 32];
  const int nvec = D / RMS_VEC;
  const XT* xr = x + (size_t)blockIdx.x * D;
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4 wr[NV], xv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {  // the weight: no kernel writes it
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) wr[i] = __ldg(wv + v);
  }
  pdl_wait();
  pdl_launch_dependents();
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      xv[i] = rms_load8(xr, v);
      float f[8];
      rms_unpack8(xv[i], f);
      ss = rms_sumsq8(f, ss);
    }
  }
  ss = block_sum(ss, red);
  const float inv = rms_inv(ss, D, eps);
  uint4* orow = reinterpret_cast<uint4*>(out) + (size_t)blockIdx.x * nvec;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      float f[8];
      rms_unpack8(xv[i], f);
      orow[v] = rms_scale8(f, wr[i], inv);
    }
  }
}

template <int NV, typename XT>
cudaError_t launch_rms_norm(const XT* x, const bf16* w, bf16* out,
                            int rows, int D, int threads, float eps,
                            cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {pdl_attribute()};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, rms_norm_kernel<NV, XT>, x, w, out, D, eps);
  return e == cudaSuccess ? cudaGetLastError() : refuse(e);
}

template <typename XT>
int rms_norm(const void* x, const void* w, void* out, int rows, int D,
             float eps, void* stream) {
  const int nvec = D / RMS_VEC;
  if (rows < 1 || D < RMS_VEC || D % RMS_VEC
      || nvec > RMS_THREADS_MAX * RMS_NV_MAX
      || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)
          | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  const int threads = rms_threads(D);
  const int nv = (nvec + threads - 1) / threads;
  const XT* xt = (const XT*)x;
  const bf16* wb = (const bf16*)w;
  bf16* ob = (bf16*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(nv == 1 ? launch_rms_norm<1>(xt, wb, ob, rows, D, threads, eps, st)
               : nv == 2 ? launch_rms_norm<2>(xt, wb, ob, rows, D, threads, eps, st)
               : nv <= 4 ? launch_rms_norm<4>(xt, wb, ob, rows, D, threads, eps, st)
                         : launch_rms_norm<8>(xt, wb, ob, rows, D, threads, eps, st));
}

}  // namespace

// rows x D bf16, D a multiple of 8 up to 32768, 16-byte aligned rows
extern "C" int desta_rms_norm(const void* x, const void* w, void* out,
                              int rows, int D, float eps, void* stream) {
  return rms_norm<bf16>(x, w, out, rows, D, eps, stream);
}

// the same norm of f32 rows, each value rounded to bf16 as it is read (the
// bits of desta_rms_norm on the rows cast to bf16): ln1 / ln2 of the
// per-layer pair K9 (csrc/fused_decode_tp.cu)
extern "C" int desta_rms_norm_f32(const void* x, const void* w, void* out,
                                  int rows, int D, float eps, void* stream) {
  return rms_norm<float>(x, w, out, rows, D, eps, stream);
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
