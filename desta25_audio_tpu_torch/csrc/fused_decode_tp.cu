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
// Design: 5 launches a layer (K8 takes 7):
//   * norm_gemv (here): RMSNorm folded into the prologue of the weight-
//     streaming GEMV.  Every block reads the f32 rows of h, rounds them to
//     bf16 (the TPU kernel's input cast), computes each row's mean square
//     and writes the normalised bf16 rows to shared memory; its warps then
//     stream one int8 weight row (or a gate/up row pair) each with 16-byte
//     loads (WeightVec of csrc/skinny_gemm.cuh), the x operand from shared
//     memory.  The epilogues are skinny_gemm's: STORE for q/k/v (bf16 of
//     the scaled f32 sum) and SWIGLU for the interleaved gate/up rows.  The
//     grid is capped at 4 blocks an SM with a grid-stride loop over
//     columns, so the redundant prologue (B*D*4 bytes a block, from L2)
//     stays small against the weight stream.
//   * attention: csrc/decode_attention.cuh at Kd = 1 (keys split across a
//     thread-block cluster, TMA tile loads), on the shard's heads
//     (the q rows of its H/p heads, then its k and v rows) and its slice of
//     the packed cache [B, S, Hkv/p*Dh].
//   * wo and down: skinny_gemm with the STORE_F32 epilogue (the partial
//     sum) or, at p = 1, ADD_F32 (the same f32 add h + partial, in place).

#include "decode_attention.cuh"
#include "skinny_gemm.cuh"

namespace {

using namespace desta;

constexpr int NG_THREADS = 256;
constexpr int NG_BLOCKS_PER_SM = 4;

// h [M, K] f32, ln_w [K] bf16, w int8 [N*NW, K] with scale [N*NW] f32;
// out [M, N] through epilogue EPI (STORE or SWIGLU).  Dynamic shared memory:
// M*K bf16.
template <int MT, int EPI>
__global__ void __launch_bounds__(NG_THREADS)
norm_gemv_kernel(const float* __restrict__ h, const bf16* __restrict__ ln_w,
                 float eps, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int M, int N, int K) {
  constexpr int NW = (EPI == EPI_SWIGLU) ? 2 : 1;
  constexpr int VEC = WeightVec<int8_t>::VEC;
  extern __shared__ __align__(16) unsigned char ng_smem[];
  bf16* xs = reinterpret_cast<bf16*>(ng_smem);  // [M][K] normalised rows
  __shared__ float red[32];
  const int tid = threadIdx.x, lane = tid & 31;

  // xs[m] = bf16(bf16(h[m]) * rsqrt(mean(bf16(h[m])^2) + eps) * ln_w)
  for (int m = 0; m < M; ++m) {
    const float* hr = h + (size_t)m * K;
    float ss = 0.f;
    for (int k = tid; k < K; k += NG_THREADS) {
      const float v = round_bf16(hr[k]);
      ss += v * v;
    }
    ss = block_sum(ss, red);
    const float inv = rsqrtf(ss / (float)K + eps);
    for (int k = tid; k < K; k += NG_THREADS)
      xs[(size_t)m * K + k] = __float2bfloat16(round_bf16(hr[k]) * inv
                                               * __bfloat162float(ln_w[k]));
  }
  __syncthreads();

  constexpr int WARPS = NG_THREADS / 32;
  for (int n = blockIdx.x * WARPS + (tid >> 5); n < N; n += gridDim.x * WARPS) {
    const int8_t* wr = w + (size_t)n * NW * K;
    float acc[NW][MT];
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[j][m] = 0.f;
#pragma unroll 2
    for (int k = lane * VEC; k < K; k += 32 * VEC) {
      float wf[NW][VEC];
#pragma unroll
      for (int j = 0; j < NW; ++j)
        WeightVec<int8_t>::load(wr + (size_t)j * K + k, wf[j]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
#pragma unroll
          for (int hh = 0; hh < VEC; hh += 8) {
            float xf[8];
            bf16x8_to_f32(*reinterpret_cast<const uint4*>(
                              xs + (size_t)m * K + k + hh), xf);
#pragma unroll
            for (int j = 0; j < NW; ++j)
#pragma unroll
              for (int i = 0; i < 8; ++i)
                acc[j][m] = fmaf(wf[j][hh + i], xf[i], acc[j][m]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j)
        v[j] = warp_sum(acc[j][m]) * scale[(size_t)n * NW + j];
      if (lane == m && m < M)
        skinny_epilogue<EPI>(out, (size_t)m * N + n, n, v, nullptr);
    }
  }
}

template <int MT, int EPI>
cudaError_t launch_norm_gemv_mt(const float* h, const bf16* ln_w, float eps,
                                const int8_t* w, const float* scale, void* out,
                                int M, int N, int K, cudaStream_t stream) {
  const size_t smem = (size_t)M * K * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_gemv_kernel<MT, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return refuse(e);
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (N + NG_THREADS / 32 - 1) / (NG_THREADS / 32);
  const int grid = want < NG_BLOCKS_PER_SM * sms ? want
                                                 : NG_BLOCKS_PER_SM * sms;
  norm_gemv_kernel<MT, EPI><<<grid, NG_THREADS, smem, stream>>>(
      h, ln_w, eps, w, scale, out, M, N, K);
  return cudaGetLastError();
}

// All M rows in passes of SKINNY_ROWS, each pass normalising its own rows.
template <int EPI>
cudaError_t launch_norm_gemv(const float* h, const bf16* ln_w, float eps,
                             const int8_t* w, const float* scale, void* out,
                             int M, int N, int K, cudaStream_t stream) {
  for (int m0 = 0; m0 < M; m0 += SKINNY_ROWS) {
    const int mr = M - m0 < SKINNY_ROWS ? M - m0 : SKINNY_ROWS;
    const float* hm = h + (size_t)m0 * K;
    void* om = static_cast<bf16*>(out) + (size_t)m0 * N;
    cudaError_t e;
    if (mr == 1)
      e = launch_norm_gemv_mt<1, EPI>(hm, ln_w, eps, w, scale, om, mr, N, K, stream);
    else if (mr == 2)
      e = launch_norm_gemv_mt<2, EPI>(hm, ln_w, eps, w, scale, om, mr, N, K, stream);
    else if (mr <= 4)
      e = launch_norm_gemv_mt<4, EPI>(hm, ln_w, eps, w, scale, om, mr, N, K, stream);
    else if (mr <= 8)
      e = launch_norm_gemv_mt<8, EPI>(hm, ln_w, eps, w, scale, om, mr, N, K, stream);
    else
      e = launch_norm_gemv_mt<16, EPI>(hm, ln_w, eps, w, scale, om, mr, N, K, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// h [M, K] f32 -> out [M, N] bf16: q/k/v (swiglu = 0; w [N, K]) or the
// SwiGLU of row-interleaved gate/up weights (swiglu = 1; w [2N, K], scale
// [2N]); K % 16 == 0; rows go 16 a pass, each pass holding its rows in
// min(M, 16)*K*2 bytes of shared memory (ops/fused_decode_tp.perlayer_limits
// checks it)
extern "C" int desta_tp_norm_gemv(const void* h, const void* ln_w, float eps,
                                  const void* w, const void* scale, void* out,
                                  int M, int N, int K, int swiglu,
                                  void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      swiglu ? launch_norm_gemv<EPI_SWIGLU>(
                   (const float*)h, (const bf16*)ln_w, eps, (const int8_t*)w,
                   (const float*)scale, out, M, N, K, st)
             : launch_norm_gemv<EPI_STORE>(
                   (const float*)h, (const bf16*)ln_w, eps, (const int8_t*)w,
                   (const float*)scale, out, M, N, K, st);
  return (int)e;
}

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
