// ORCA deep injection inside the decode / verify step (K8i): after each
// layer's down-projection residual, every token row r = b*Kd + j gets
//   h += on[b] * bf16(sigmoid(g2 . gelu(g1 h)) * LN(Wo MHA(Wq h, Ka_b, Va_b)))
// over the Ta precomputed audio keys/values of its batch row b.
//
// Replaces: desta25_audio_tpu/ops/fused_decode.py::_make_kernel, the
//   ``m.inj`` phase (fused_decode.py:731-823) of the single-launch Pallas
//   TPU kernel behind fused_decode_layers / fused_verify_layers(inject=).
// Rounding points are the TPU kernel's (fused_decode.py:747-823):
//   iq  = bf16(Wq.h * s + bq)          skinny GEMM, EPI_BIAS
//   ig  = bf16(gelu(bf16(Wg1.h * s + bg1)))   skinny GEMM, EPI_BIAS_GELU
//   scores: the k (.) q products rounded to bf16 before the per-head f32
//     sum, times dh^-0.5, keys >= ta_real left out; f32 softmax, P rounded
//     to bf16; iat = bf16(sum_t P v_t) in f32       inject_attention_kernel
//   iao = bf16(Wo.iat * s + bo)        skinny GEMM, EPI_BIAS
//   gate = sigmoid(sum ig * wg2 + bg2) in f32; LN(iao) eps 1e-5 in f32;
//   h = bf16(h + bf16(on) * bf16(gate * LN))           inject_gate_kernel
// GELU is the exact erf (erff), as the port's encoder kernels and the JAX
// package's XLA path take it; the TPU kernel's A&S 7.1.26 erf is a stand-in
// for Mosaic's missing erf and differs from it by at most 1.5e-7.
// What bounds it on the H100: device-memory bandwidth.  Per layer it streams
//   the int8 q / o / gate1 weights (2*D^2 + D^2/4 bytes: 37.7 MB at
//   Llama-3.1-8B) and each batch row's audio K/V (2*Ta*D*2 bytes: 6.1 MB at
//   Ta = 375) once, against 2 FLOP per weight per token row and 4*Ta*D FLOP
//   per token row for the attention: far below the ridge.
// Design:
//   * the three projections reuse the weight-streaming GEMM of
//     csrc/skinny_gemm.cuh (16 token rows a pass) with bias epilogues;
//   * inject_attention_kernel: one block of 512 threads per (batch row b,
//     injection head), which reads row b's K/V slice of the head once for
//     all Kd draft tokens.  Scores: one warp per audio key, 4 dims (8 bytes)
//     a lane (any head dim divisible by 4 up to 256: 128 at Llama-3.1-8B,
//     80 at Qwen3-4B), each warp with the loads of 8 keys in flight; the
//     Kd x ta_real scores live in shared memory.  P.V: each thread owns 4
//     dims of the head and a share of the keys (512 / (dh/4) key groups),
//     again 8 loads in flight; partial sums meet in shared memory.  The
//     loads in flight, not the bytes, bound it: there are only B*H = 64
//     blocks at Llama-3.1-8B b2, so each keeps many loads outstanding.
//   * inject_gate_kernel: one block of 1024 threads per token row for
//     gate2, the sigmoid, the LayerNorm and the gated residual (only
//     R = B*Kd blocks: wide blocks shorten its latency-bound passes).
//   The injection adds 5 launches a layer (q, gate1, attention, o, gate) to
//   the tower's 7.

#include "common.cuh"

namespace {

using namespace desta;

constexpr int IA_THREADS = 512;
constexpr int IA_WARPS = IA_THREADS / 32;
constexpr int IA_KD_MAX = 8;  // draft tokens per row (the verify step's kd)
constexpr int IA_UNROLL = 8;  // keys whose loads a warp / thread keeps in flight
constexpr int IG_THREADS = 1024;  // inject_gate_kernel: one row of D per block

// P.V: each thread owns 4 dims (a quad) of the head; the block's threads
// split into key groups of dh/4 threads each.
__host__ __device__ __forceinline__ int ia_groups(int dh) {
  return IA_THREADS / (dh >> 2);
}

__device__ __forceinline__ void bf16x4(const uint2& u, float f[4]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// KDM: most tokens per row (1 decode, IA_KD_MAX verify); CPL: 4-dim chunks
// of the head per lane in the score loop (1 for dh <= 128, 2 for dh <= 256).
template <int KDM, int CPL>
__global__ void __launch_bounds__(IA_THREADS)
inject_attention_kernel(const bf16* __restrict__ iq,
                        const bf16* __restrict__ ka,
                        const bf16* __restrict__ va, bf16* __restrict__ out,
                        int kd, int Ta, int ta_real, int D, int dh,
                        float scale) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int nq = dh >> 2, ng = ia_groups(dh);
  float* qf = smem;                  // [kd][dh] bf16 q values as f32
  float* sc = qf + kd * dh;          // [kd][ta_real] scores, then bf16(P)
  float* part = sc + kd * ta_real;   // [ng][kd][dh] P.V partial sums

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bf16* kb = ka + (size_t)b * Ta * D + (size_t)h * dh;
  const bf16* vb = va + (size_t)b * Ta * D + (size_t)h * dh;

  for (int i = tid; i < kd * dh; i += IA_THREADS) {
    const int j = i / dh, d = i - j * dh;
    qf[i] = __bfloat162float(iq[(size_t)(b * kd + j) * D + (size_t)h * dh + d]);
  }
  __syncthreads();

  // scores: a warp takes IA_UNROLL keys at once (their loads in flight
  // together), each lane 4 dims (8 bytes) per chunk
  for (int t0 = warp; t0 < ta_real; t0 += IA_WARPS * IA_UNROLL) {
    uint2 u[IA_UNROLL][CPL];
#pragma unroll
    for (int i = 0; i < IA_UNROLL; ++i) {
      const int t = t0 + i * IA_WARPS;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = lane + 32 * cc;
        u[i][cc] = (t < ta_real && c < nq)
            ? __ldg(reinterpret_cast<const uint2*>(kb + (size_t)t * D + 4 * c))
            : make_uint2(0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < IA_UNROLL; ++i) {
      const int t = t0 + i * IA_WARPS;
      if (t >= ta_real) break;  // warp-uniform
      float acc[KDM];
#pragma unroll
      for (int j = 0; j < KDM; ++j) acc[j] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = lane + 32 * cc;
        if (c < nq) {
          float k[4];
          bf16x4(u[i][cc], k);
#pragma unroll
          for (int j = 0; j < KDM; ++j) {
            if (j < kd) {
              const float* q = qf + j * dh + 4 * c;
              acc[j] += round_bf16(k[0] * q[0]) + round_bf16(k[1] * q[1])
                      + round_bf16(k[2] * q[2]) + round_bf16(k[3] * q[3]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KDM; ++j) {
        if (j < kd) {
          const float s = warp_sum(acc[j]);
          if (lane == 0) sc[j * ta_real + t] = s * scale;
        }
      }
    }
  }
  __syncthreads();

  // softmax over the keys, one token at a time; P = bf16(e / den)
  for (int j = 0; j < kd; ++j) {
    float* s = sc + j * ta_real;
    float mx = -INFINITY;
    for (int t = tid; t < ta_real; t += IA_THREADS) mx = fmaxf(mx, s[t]);
    mx = block_max(mx, red);
    float den = 0.f;
    for (int t = tid; t < ta_real; t += IA_THREADS) den += expf(s[t] - mx);
    den = block_sum(den, red);
    for (int t = tid; t < ta_real; t += IA_THREADS)
      s[t] = round_bf16(expf(s[t] - mx) / den);
  }
  __syncthreads();

  // P.V: thread (key group g, dim quad p) sums keys g, g + ng, ...,
  // IA_UNROLL loads in flight
  if (tid < ng * nq) {
    const int g = tid / nq, p = tid - g * nq;
    float a[KDM][4];
#pragma unroll
    for (int j = 0; j < KDM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
    for (int t0 = g; t0 < ta_real; t0 += ng * IA_UNROLL) {
      uint2 u[IA_UNROLL];
#pragma unroll
      for (int i = 0; i < IA_UNROLL; ++i) {
        const int t = t0 + i * ng;
        u[i] = t < ta_real
            ? __ldg(reinterpret_cast<const uint2*>(vb + (size_t)t * D + 4 * p))
            : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < IA_UNROLL; ++i) {
        const int t = t0 + i * ng;
        if (t < ta_real) {
          float v[4];
          bf16x4(u[i], v);
#pragma unroll
          for (int j = 0; j < KDM; ++j) {
            if (j < kd) {
              const float pj = sc[j * ta_real + t];
#pragma unroll
              for (int e = 0; e < 4; ++e) a[j][e] = fmaf(pj, v[e], a[j][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KDM; ++j) {
      if (j < kd) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(g * kd + j) * dh + 4 * p + e] = a[j][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kd * dh; i += IA_THREADS) {
    const int j = i / dh, d = i - j * dh;
    float o = 0.f;
    for (int g = 0; g < ng; ++g) o += part[(g * kd + j) * dh + d];
    out[(size_t)(b * kd + j) * D + (size_t)h * dh + d] = __float2bfloat16(o);
  }
}

// One block per token row: gate2 + sigmoid, LayerNorm of the o-projection,
// gated bf16 residual into h (in place).
__global__ void __launch_bounds__(IG_THREADS)
inject_gate_kernel(bf16* __restrict__ h, const bf16* __restrict__ ig,
                   const bf16* __restrict__ iao, const float* __restrict__ wg2,
                   const float* __restrict__ bg2, const float* __restrict__ lns,
                   const float* __restrict__ lnb, const float* __restrict__ on,
                   int kd, int D, int Dg) {
  __shared__ float red[32];
  const int r = blockIdx.x;
  const bf16* gr = ig + (size_t)r * Dg;
  const bf16* xr = iao + (size_t)r * D;
  bf16* hr = h + (size_t)r * D;
  float gs = 0.f;
  for (int i = threadIdx.x; i < Dg; i += blockDim.x)
    gs += __bfloat162float(gr[i]) * wg2[i];
  gs = block_sum(gs, red) + bg2[0];
  const float gate = 1.f / (1.f + expf(-gs));
  float sum = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    sum += __bfloat162float(xr[i]);
  const float mu = block_sum(sum, red) / (float)D;
  float sq = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = __bfloat162float(xr[i]) - mu;
    sq += d * d;
  }
  const float inv = rsqrtf(block_sum(sq, red) / (float)D + 1e-5f);
  const float onr = round_bf16(on[r / kd]);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float lno = (__bfloat162float(xr[i]) - mu) * inv * lns[i] + lnb[i];
    const float contrib = round_bf16(gate * lno);
    hr[i] = __float2bfloat16(__bfloat162float(hr[i]) + round_bf16(onr * contrib));
  }
}

template <int KDM, int CPL>
cudaError_t launch_inject_attention(const bf16* iq, const bf16* ka,
                                    const bf16* va, bf16* out, int B, int kd,
                                    int Ta, int ta_real, int D, int heads,
                                    float scale, cudaStream_t stream) {
  const int dh = D / heads;
  const size_t smem = sizeof(float) * ((size_t)kd * dh + (size_t)kd * ta_real
                                       + (size_t)ia_groups(dh) * kd * dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        inject_attention_kernel<KDM, CPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return refuse(e);
  }
  inject_attention_kernel<KDM, CPL>
      <<<dim3(B, heads), IA_THREADS, smem, stream>>>(
          iq, ka, va, out, kd, Ta, ta_real, D, dh, scale);
  return cudaGetLastError();
}

template <int KDM>
cudaError_t launch_inject_cpl(const bf16* iq, const bf16* ka, const bf16* va,
                              bf16* out, int B, int kd, int Ta, int ta_real,
                              int D, int heads, float scale,
                              cudaStream_t stream) {
  return D / heads <= 128
      ? launch_inject_attention<KDM, 1>(iq, ka, va, out, B, kd, Ta, ta_real,
                                        D, heads, scale, stream)
      : launch_inject_attention<KDM, 2>(iq, ka, va, out, B, kd, Ta, ta_real,
                                        D, heads, scale, stream);
}

}  // namespace

// iq, out [B*kd, D] (row r = b*kd + j); ka, va [B, Ta, D] (one layer),
// keys 0..ta_real-1 attended; head dim D / heads, a multiple of 4, <= 256
extern "C" int desta_inject_attention(const void* iq, const void* ka,
                                      const void* va, void* out, int B,
                                      int kd, int Ta, int ta_real, int D,
                                      int heads, float scale, void* stream) {
  if (heads <= 0 || D % heads != 0 || (D / heads) % 4 != 0
      || D / heads > 256 || kd < 1 || kd > IA_KD_MAX || ta_real < 1
      || ta_real > Ta)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16 *q = (const bf16*)iq, *k = (const bf16*)ka, *v = (const bf16*)va;
  return (int)(kd == 1
      ? launch_inject_cpl<1>(q, k, v, (bf16*)out, B, kd, Ta, ta_real, D,
                             heads, scale, st)
      : launch_inject_cpl<IA_KD_MAX>(q, k, v, (bf16*)out, B, kd, Ta, ta_real,
                                     D, heads, scale, st));
}

// h, iao [R, D] bf16, ig [R, Dg] bf16, wg2 [Dg] f32, bg2 [1] f32, lns / lnb
// [D] f32, on [R / kd] f32
extern "C" int desta_inject_gate(void* h, const void* ig, const void* iao,
                                 const void* wg2, const void* bg2,
                                 const void* lns, const void* lnb,
                                 const void* on, int R, int kd, int D, int Dg,
                                 void* stream) {
  if (R < 1 || kd < 1 || R % kd != 0) return (int)cudaErrorInvalidValue;
  inject_gate_kernel<<<R, IG_THREADS, 0, (cudaStream_t)stream>>>(
      (bf16*)h, (const bf16*)ig, (const bf16*)iao, (const float*)wg2,
      (const float*)bg2, (const float*)lns, (const float*)lnb,
      (const float*)on, kd, D, Dg);
  return (int)cudaGetLastError();
}
