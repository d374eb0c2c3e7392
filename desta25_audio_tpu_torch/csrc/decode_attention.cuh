// Decode / verify attention with the in-place cache write, shared by the
// decode step (csrc/fused_decode.cu: K8, K8-int8, K8v) and the per-layer
// decode pair (csrc/fused_decode_tp.cu: K9's attention half).
//
// One block per (batch row b, kv head, draft token j), one thread per head
// dim (Dh = 128).  It applies qk-norm (Qwen3) and RoPE in f32 to the k of
// draft tokens 0..j of row b (rounded to bf16) and to the G = H/Hkv queries
// of token j, writes token j's k and v rows into the packed cache
// [B, S, Hkv*Dh] at ci + j (ci is row b's first write position; a position
// past the cache writes nothing), then attends the cached keys < ci that
// the attention mask allows plus the draft block 0..j, with an f32
// softmax.  P is normalised in f32 and rounded to bf16 for the cached keys;
// the draft tokens' weights stay f32 against their bf16 v, as in the TPU
// kernels' in-register block (here in registers too: every thread holds
// the draft scores).  Blocks of one row read only cache positions < ci and
// write only ci..ci+Kd-1, so no block reads what another writes.  Kd = 1
// (the decode step) is compiled apart with a one-token draft block.  The
// scores of one token's G heads over the cache live in shared memory (G*S
// f32), which bounds S (ops/fused_decode.kernel_limits states the limit).
#pragma once

#include "common.cuh"

namespace desta {

constexpr int DHD = 128;
constexpr int KD_MAX = 8;  // draft tokens per row (the TPU kernel's kd <= 8)

// qk-norm (optional) + half-split RoPE of one head vector, one element per
// thread.  `xchg` is DHD floats of shared memory.
__device__ __forceinline__ float norm_rope(float v, const bf16* nw, float eps,
                                           float c, float s, float* xchg,
                                           float* red) {
  const int d = threadIdx.x;
  if (nw != nullptr) {
    const float ss = block_sum(v * v, red);
    v = v * rsqrtf(ss / (float)DHD + eps) * __bfloat162float(nw[d]);
  }
  __syncthreads();
  xchg[d] = v;
  __syncthreads();
  const float rot = d < DHD / 2 ? -xchg[d + DHD / 2] : xchg[d - DHD / 2];
  return v * c + rot * s;
}

// KDM: the most draft tokens a block may see (1 for the decode step,
// KD_MAX for the verify step); the draft block's scores and weights stay in
// registers, dsc[gq][j2], every thread holding the same values.
template <int G, int KDM>
__global__ void __launch_bounds__(DHD)
decode_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ kc,
                        bf16* __restrict__ vc, const float* __restrict__ cosb,
                        const float* __restrict__ sinb,
                        const int* __restrict__ mask, int mask_stride,
                        const int* __restrict__ ci_arr,
                        const bf16* __restrict__ q_norm,
                        const bf16* __restrict__ k_norm,
                        bf16* __restrict__ out, int S, int Hkv, int kd,
                        float eps, float scale) {
  extern __shared__ float smem[];
  float* qf = smem;                   // [G][DHD] bf16-rounded q (as f32)
  float* xchg = qf + G * DHD;         // [DHD]
  float* red = xchg + DHD;            // [32]
  float* sc = red + 32;               // [G][S] scores, then probabilities

  const int b = blockIdx.x, kvh = blockIdx.y, j = blockIdx.z, d = threadIdx.x;
  const int warp = d >> 5, lane = d & 31;
  const int H = Hkv * G;
  const int HD = H * DHD, KVD = Hkv * DHD;
  const int ci = ci_arr[b];
  const int row_j = b * kd + j;       // this block's query row

  // draft tokens 0..j of row b: post-rope k rounded to bf16, and v (this
  // thread's dim); token j's pair goes into the cache at ci + j
  float kr[KDM], vd[KDM];
#pragma unroll
  for (int j2 = 0; j2 < KDM; ++j2) {
    if (j2 <= j) {  // uniform over the block: norm_rope synchronises
      const int r2 = b * kd + j2;
      const bf16* row2 = qkv + (size_t)r2 * (HD + 2 * KVD);
      kr[j2] = round_bf16(norm_rope(__bfloat162float(row2[HD + kvh * DHD + d]),
                                    k_norm, eps, cosb[r2 * DHD + d],
                                    sinb[r2 * DHD + d], xchg, red));
      const bf16 vnew = row2[HD + KVD + kvh * DHD + d];
      vd[j2] = __bfloat162float(vnew);
      if (j2 == j && ci >= 0 && ci + j < S) {
        const size_t cache_row = ((size_t)b * S + ci + j) * KVD + kvh * DHD + d;
        kc[cache_row] = __float2bfloat16(kr[j2]);
        vc[cache_row] = vnew;
      }
    }
  }

  const float c = cosb[row_j * DHD + d], s = sinb[row_j * DHD + d];
  const bf16* row = qkv + (size_t)row_j * (HD + 2 * KVD);
  float dsc[G][KDM];  // the draft block: scores, then probabilities
#pragma unroll
  for (int gq = 0; gq < G; ++gq) {
    const int h = kvh * G + gq;
    const float qv = round_bf16(norm_rope(__bfloat162float(row[h * DHD + d]),
                                          q_norm, eps, c, s, xchg, red));
    qf[gq * DHD + d] = qv;
    // token j attends draft tokens 0..j
#pragma unroll
    for (int j2 = 0; j2 < KDM; ++j2)
      if (j2 <= j) dsc[gq][j2] = block_sum(qv * kr[j2], red) * scale;
  }
  __syncthreads();

  // scores over cached keys s < ci allowed by the mask: one warp per key,
  // 4 dims per lane
  const int nkeys = ci < S ? ci : S;
  for (int key = warp; key < nkeys; key += DHD / 32) {
    const bool ok = mask[(size_t)b * mask_stride + key] > 0;
    float part[G];
    if (ok) {
      const bf16* kp = kc + ((size_t)b * S + key) * KVD + kvh * DHD + lane * 4;
      const uint2 u = *reinterpret_cast<const uint2*>(kp);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 k01 = __bfloat1622float2(p2[0]), k23 = __bfloat1622float2(p2[1]);
#pragma unroll
      for (int gq = 0; gq < G; ++gq) {
        const float* qq = qf + gq * DHD + lane * 4;
        part[gq] = warp_sum(qq[0] * k01.x + qq[1] * k01.y + qq[2] * k23.x
                            + qq[3] * k23.y);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int gq = 0; gq < G; ++gq)
        sc[gq * S + key] = ok ? part[gq] * scale : -INFINITY;
    }
  }
  __syncthreads();

  // softmax per head: P over cached keys (f32, normalised) + draft block
#pragma unroll
  for (int gq = 0; gq < G; ++gq) {
    float mx = dsc[gq][0];
#pragma unroll
    for (int j2 = 1; j2 < KDM; ++j2)
      if (j2 <= j) mx = fmaxf(mx, dsc[gq][j2]);
    for (int key = d; key < nkeys; key += DHD) mx = fmaxf(mx, sc[gq * S + key]);
    mx = block_max(mx, red);
    float den = 0.f;
    for (int key = d; key < nkeys; key += DHD) den += expf(sc[gq * S + key] - mx);
    den = block_sum(den, red);
#pragma unroll
    for (int j2 = 0; j2 < KDM; ++j2)
      if (j2 <= j) den += expf(dsc[gq][j2] - mx);
    const float inv = 1.f / den;
    for (int key = d; key < nkeys; key += DHD)
      sc[gq * S + key] = expf(sc[gq * S + key] - mx) * inv;
#pragma unroll
    for (int j2 = 0; j2 < KDM; ++j2)
      if (j2 <= j) dsc[gq][j2] = expf(dsc[gq][j2] - mx) * inv;
  }
  __syncthreads();

  // out = sum_s bf16(P) v_s + sum_{j2 <= j} p_j2 v_j2, thread d owns dim d
  float o[G];
#pragma unroll
  for (int gq = 0; gq < G; ++gq) o[gq] = 0.f;
  const bf16* vp = vc + (size_t)b * S * KVD + kvh * DHD + d;
  for (int key = 0; key < nkeys; ++key) {
    const float vv = __bfloat162float(vp[(size_t)key * KVD]);
#pragma unroll
    for (int gq = 0; gq < G; ++gq) o[gq] += round_bf16(sc[gq * S + key]) * vv;
  }
#pragma unroll
  for (int j2 = 0; j2 < KDM; ++j2) {
    if (j2 <= j) {
#pragma unroll
      for (int gq = 0; gq < G; ++gq) o[gq] += dsc[gq][j2] * vd[j2];
    }
  }
  bf16* orow = out + (size_t)row_j * HD;
#pragma unroll
  for (int gq = 0; gq < G; ++gq)
    orow[(kvh * G + gq) * DHD + d] = __float2bfloat16(o[gq]);
}

template <int G, int KDM>
cudaError_t launch_attention_kdm(const bf16* qkv, bf16* kc, bf16* vc,
                                 const float* cosb, const float* sinb,
                                 const int* mask, int mask_stride,
                                 const int* ci, const bf16* qn, const bf16* kn,
                                 bf16* out, int B, int kd, int S, int Hkv,
                                 float eps, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * DHD + DHD + 32
                                       + (size_t)G * S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<G, KDM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return refuse(e);
  }
  decode_attention_kernel<G, KDM><<<dim3(B, Hkv, kd), DHD, smem, stream>>>(
      qkv, kc, vc, cosb, sinb, mask, mask_stride, ci, qn, kn, out, S, Hkv, kd,
      eps, scale);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_attention(const bf16* qkv, bf16* kc, bf16* vc,
                             const float* cosb, const float* sinb,
                             const int* mask, int mask_stride, const int* ci,
                             const bf16* qn, const bf16* kn, bf16* out, int B,
                             int kd, int S, int Hkv, float eps, float scale,
                             cudaStream_t stream) {
  return kd == 1
      ? launch_attention_kdm<G, 1>(qkv, kc, vc, cosb, sinb, mask, mask_stride,
                                   ci, qn, kn, out, B, kd, S, Hkv, eps, scale,
                                   stream)
      : launch_attention_kdm<G, KD_MAX>(qkv, kc, vc, cosb, sinb, mask,
                                        mask_stride, ci, qn, kn, out, B, kd, S,
                                        Hkv, eps, scale, stream);
}

// qkv [B*kd, (H+2*Hkv)*Dh], cos/sin [B*kd, Dh], mask [B, >=S], ci [B],
// out [B*kd, H*Dh]; rows are token-major within a batch row (r = b*kd + j)
inline cudaError_t decode_attention(
    const void* qkv, void* k_cache, void* v_cache, const void* cosb,
    const void* sinb, const void* mask, int mask_stride, const void* ci,
    const void* q_norm, const void* k_norm, void* out, int B, int kd, int S,
    int H, int Hkv, int Dh, float eps, float scale, cudaStream_t st) {
  if (Dh != DHD || Hkv <= 0 || H % Hkv != 0 || kd < 1 || kd > KD_MAX)
    return cudaErrorInvalidValue;
#define DESTA_ATTN_ARGS                                                      \
  (const bf16*)qkv, (bf16*)k_cache, (bf16*)v_cache, (const float*)cosb,      \
      (const float*)sinb, (const int*)mask, mask_stride, (const int*)ci,     \
      (const bf16*)q_norm, (const bf16*)k_norm, (bf16*)out, B, kd, S, Hkv,   \
      eps, scale, st
  switch (H / Hkv) {
    case 1: return launch_attention<1>(DESTA_ATTN_ARGS);
    case 2: return launch_attention<2>(DESTA_ATTN_ARGS);
    case 4: return launch_attention<4>(DESTA_ATTN_ARGS);
    case 8: return launch_attention<8>(DESTA_ATTN_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DESTA_ATTN_ARGS
}

}  // namespace desta
