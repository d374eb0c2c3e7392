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
//     to bf16 after normalising; iat = bf16(sum_t P v_t) in f32
//                                                   inject_attention_kernel
//   iao = bf16(Wo.iat * s + bo)        skinny GEMM, EPI_BIAS
//   gate = sigmoid(sum ig * wg2 + bg2) in f32; LN(iao) eps 1e-5 in f32
//   (two-pass variance); h = bf16(h + bf16(on) * bf16(gate * LN))
//                                                   inject_gate_kernel
// GELU is the exact erf (erff), as the port's encoder kernels and the JAX
// package's XLA path take it; the TPU kernel's A&S 7.1.26 erf is a stand-in
// for Mosaic's missing erf and differs from it by at most 1.5e-7.
// What bounds it on the H100: device-memory bandwidth.  Per layer it streams
//   the int8 q / o / gate1 weights (2*D^2 + D^2/4 bytes: 37.7 MB at
//   Llama-3.1-8B) and each batch row's audio K/V (2*Ta*D*2 bytes: 6.1 MB at
//   Ta = 375) once, against 2 FLOP per weight per token row and 4*Ta*D FLOP
//   per token row for the attention: far below the ridge.  The gate moves
//   some 90 KB a layer: it is bound by latency alone.
// Design:
//   * the three projections reuse the weight-streaming GEMM of
//     csrc/skinny_gemm.cuh (16 token rows a pass) with bias epilogues;
//   * inject_attention_kernel: the keys of each (batch row b, injection
//     head) split across a thread-block cluster.  The grid is (NS, heads,
//     B), launched as clusters of NS CTAs along x: rank r attends keys
//     [r*keys, (r+1)*keys) of the row's ta_real audio keys, for all Kd draft
//     tokens of the row at once.  plan_inject picks NS from B*heads, ta_real,
//     the head dim and the SM count (never Kd): as many ranges as bring the
//     grid to the SM count, at most 8 (the portable cluster size), more if
//     a range's K and V would not fit IA_KV_BUDGET; every range but the
//     last a whole number of IA_TILE keys, none empty
//     (ops/fused_decode.plan_inject_splits is the same rule, tested on the
//     CPU).  The verify step takes the decode step's plan, so its token 0
//     is the decode step's bit for bit.  At Llama-3.1-8B b2 that is 3
//     ranges of <= 128 keys: 192 CTAs, not 64 blocks.
//   * The range's K and V, whole, in shared memory, loaded before the PDL
//     wait: no kernel of the step writes the audio K/V (precompute_cross_kv
//     writes them before the decode loop), so the loads overlap the gate1
//     GEMM's drain.  Head dims that are a multiple of 8 take two 3-D TMA
//     boxes [1, keys, dh] over the layer's [B, ta_real, D] K and V (keys
//     past ta_real are out of bounds: zero-filled, never read from memory),
//     completing on one mbarrier each; other multiples of 4 take 8-byte
//     cp.async, issued by every thread.  A range past IA_KV_BUDGET (ta_real
//     over 8 ranges of it) reads its keys from global memory instead, the
//     scores still in shared memory.  iq is read after the wait.
//   * 256 threads.  Scores: 8 lanes a key (4 dims an 8-byte load, chunk by
//     chunk, bf16x2 products: the exact product rounded to bf16), 4 keys a
//     warp at once, three shuffles; the Kd x keys scores in shared memory.
//     Softmax across the cluster through distributed shared memory, pushed
//     rather than pulled: each CTA stores its per-token (maximum, sum of
//     exp(s - m)) pair into every CTA's slot for its rank; after one cluster
//     barrier every CTA folds the NS pairs in rank order into the global
//     maximum and denominator and rounds P = bf16(exp(s - m) / den).  P.V:
//     a warp a key at a time, 4 dims a lane; the eight warps' partials
//     summed in a fixed order through four slots, each dim stored into the
//     inbox of the rank that combines it (rank r: dims [r*dh/NS,
//     (r+1)*dh/NS)); after a second cluster barrier rank r sums its inbox
//     in rank order and stores bf16.  No CTA reads another's memory, so
//     none waits for the others before it exits.  No atomics, no second
//     launch: two launches on the same inputs give the same bits.  The
//     dependents (the o GEMM, whose first weight tiles load before its own
//     wait) are released after P.V, so they overlap the combine.
//   * inject_gate_kernel: one CTA a token row (a row spread over a cluster
//     of 2 or 4 CTAs measured slower on the H100).  The LayerNorm's scale and bias, gate2's weight and
//     bias and the row's `on` flag are loaded before the PDL wait (weights
//     and per-call constants); ig, iao and h once each after it, 16-byte
//     loads of iao and h kept in registers.  Two reductions: (gate2's sum,
//     the row sum) together, then the sum of (x - mean)^2 from registers.
//   Both kernels are launched with programmatic dependent launch; the
//   injection adds 5 launches a layer (q, gate1, attention, o, gate) to the
//   tower's 7.

#include <cooperative_groups.h>

#include <mutex>
#include <unordered_map>

#include "attention_sm90.cuh"

namespace {

using namespace desta;
namespace cg = cooperative_groups;
using bf2 = __nv_bfloat162;

constexpr int IA_THREADS = 256;
constexpr int IA_WARPS = IA_THREADS / 32;
constexpr int IA_SLOTS = 4;        // partial outputs in shared memory
constexpr int IA_KD_MAX = 8;       // draft tokens a row (the verify's kd)
constexpr int IA_TILE = 8;         // keys: ranges are whole tiles
constexpr int IA_SPLITS_MAX = 8;   // the portable cluster size
constexpr int IA_KV_BUDGET = 160 * 1024;  // a resident range's K and V bytes
constexpr int IA_BOX_MAX = 256;    // TMA box rows
constexpr int IA_DH_MAX = 256;
constexpr int IA_LPK = 8;          // lanes a key in the score loop
constexpr int IA_KPW = 32 / IA_LPK;  // keys a warp scores at once
// floats of softmax statistics: the ranks' (max, sum) pairs [8][8] each,
// the warps' [warps][8] each, three [8] rows
constexpr int IA_STATS = 2 * 64 + 2 * IA_WARPS * IA_KD_MAX + 3 * IA_KD_MAX;
constexpr int IA_SMEM_MAX = 227 * 1024;
constexpr int IG_THREADS = 512;    // inject_gate_kernel: at most a CTA's

// The most keys a range holds in shared memory: K and V within
// IA_KV_BUDGET, one TMA box of rows, whole tiles.
inline int ia_cap_keys(int dh) {
  int c = IA_KV_BUDGET / (4 * dh) / IA_TILE * IA_TILE;
  if (c > IA_BOX_MAX) c = IA_BOX_MAX;
  return c < IA_TILE ? IA_TILE : c;
}

// NS ranges of `keys` keys each (the last may be shorter); resident: the
// range's K and V live in shared memory
struct InjectPlan {
  int ns;
  int keys;
  bool resident;
};

// The rule of ops/fused_decode.plan_inject_splits: reads B, the heads,
// ta_real, the head dim and the SM count, never Kd.  ta >= 1.
inline InjectPlan plan_inject(int B, int heads, int ta, int dh, int n_sm) {
  const long long clusters = (long long)B * heads;
  const int nt = (ta + IA_TILE - 1) / IA_TILE;
  const int cap = ia_cap_keys(dh) / IA_TILE;  // tiles
  long long want = (n_sm + clusters - 1) / clusters;
  const long long need = (nt + cap - 1) / cap;
  if (want < need) want = need;
  const int top = nt < IA_SPLITS_MAX ? nt : IA_SPLITS_MAX;
  int ns = (int)(want < top ? want : top);
  if (ns < 1) ns = 1;
  int tps, eff;
  for (;;) {
    tps = (nt + ns - 1) / ns;
    eff = (nt + tps - 1) / tps;
    if (eff >= want || ns >= top) break;
    ++ns;
  }
  return {eff, tps * IA_TILE, tps <= cap};
}

__host__ __device__ inline size_t up128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Dynamic shared memory of one CTA (ops/fused_decode.inject_attention_smem):
// 128 bytes of alignment; resident: K (then the warps' partial outputs),
// V and two barriers; else the partials alone; then q [kd][dh] in bf16
// (rounded up to 16 bytes), in f32 the scores [kd][keys], the inbox of
// the ranks' partial outputs (at most kd * (dh + 8)) and IA_STATS floats.
inline size_t ia_smem(int kd, int dh, int keys, bool resident) {
  const size_t kv = (size_t)keys * dh * 2;
  const size_t red = (size_t)4 * IA_SLOTS * kd * dh;
  size_t b = 128;
  if (resident) b += up128(kv > red ? kv : red) + up128(kv) + 16;
  else b += red;
  return b + ((size_t)kd * dh * 2 + 15) / 16 * 16
         + 4 * ((size_t)kd * keys + (size_t)kd * (dh + 8) + IA_STATS);
}

// barrier.cluster split in two: arrive without ordering (this CTA has
// started), and wait (every CTA of the cluster has arrived)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void bf16x4(const uint2& u, float f[4]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   sm90::smem_u32(smem)),
               "l"(gmem));
}

// KDM: most tokens per row (1 decode, IA_KD_MAX verify); RES: the range's
// K and V in shared memory (else read from global memory); CPL: 4-dim
// chunks a lane in P.V (1 for dh <= 128, 2 for dh <= 256), 4 * CPL in the
// score loop.
template <int KDM, bool RES, int CPL>
__global__ void __launch_bounds__(IA_THREADS)
inject_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const bf16* __restrict__ iq,
                        const bf16* __restrict__ ka,
                        const bf16* __restrict__ va, bf16* __restrict__ out,
                        int kd, int Ta, int ta_real, int D, int dh, int keys,
                        int use_tma, float scale) {
  extern __shared__ uint8_t smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ns = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int nq = dh >> 2;
  const int lo = rank * keys;
  const int n_my = (ta_real < lo + keys ? ta_real : lo + keys) - lo;  // >= 1

  const size_t kv = (size_t)keys * dh * 2;
  const size_t redb = (size_t)4 * IA_SLOTS * kd * dh;
  const int ndm = (dh + ns - 1) / ns;   // dims a rank combines, at most
  uint8_t* p = smem_raw
               + ((128 - (sm90::smem_u32(smem_raw) & 127)) & 127);
  bf16* ks = reinterpret_cast<bf16*>(p);   // [keys][dh] (resident)
  float* red = reinterpret_cast<float*>(p);  // [4][kd][dh]; K is dead
  bf16* vs = nullptr;
  uint64_t* bar = nullptr;
  if (RES) {
    p += up128(kv > redb ? kv : redb);
    vs = reinterpret_cast<bf16*>(p);
    p += up128(kv);
    bar = reinterpret_cast<uint64_t*>(p);
    p += 16;
  } else {
    p += redb;
  }
  bf16* qb = reinterpret_cast<bf16*>(p);     // [kd][dh]
  p += ((size_t)kd * dh * 2 + 15) / 16 * 16;
  float* sc = reinterpret_cast<float*>(p);   // [kd][keys] scores, then P
  float* inbox = sc + kd * keys;             // [ns][kd][ndm] partials in
  float* xm = inbox + kd * (dh + 8);         // [8 ranks][8] maxima in
  float* xd = xm + 64;                       // [8 ranks][8] sums in
  float* wm = xd + 64;                       // [warps][8] warp maxima
  float* wd = wm + IA_WARPS * IA_KD_MAX;     // [warps][8] warp sums
  float* lm = wd + IA_WARPS * IA_KD_MAX;     // [8] this range's maxima
  float* gm = lm + IA_KD_MAX;                // [8] global maxima
  float* gd = gm + IA_KD_MAX;                // [8] global denominators
  cluster_arrive_relaxed();  // waited on before the first remote store

  const size_t row0 = (size_t)b * Ta + lo;   // the range's first key row
  const bf16* kg = ka + row0 * D + (size_t)h * dh;
  const bf16* vg = va + row0 * D + (size_t)h * dh;
  if (RES) {
    if (use_tma) {
      if (tid == 0) {
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(&kmap) : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(&vmap) : "memory");
        sm90::mbar_init(&bar[0], 1);
        sm90::mbar_init(&bar[1], 1);
        sm90::fence_barrier_init();
        sm90::mbar_expect_tx(&bar[0], (uint32_t)kv);
        sm90::tma_load_3d(ks, &kmap, &bar[0], h * dh, lo, b);
        sm90::mbar_expect_tx(&bar[1], (uint32_t)kv);
        sm90::tma_load_3d(vs, &vmap, &bar[1], h * dh, lo, b);
      }
    } else {
      for (int i = tid; i < n_my * nq; i += IA_THREADS) {
        const int t = i / nq, c = i - t * nq;
        cp_async8(ks + t * dh + 4 * c, kg + (size_t)t * D + 4 * c);
      }
      cp_async_commit();
      for (int i = tid; i < n_my * nq; i += IA_THREADS) {
        const int t = i / nq, c = i - t * nq;
        cp_async8(vs + t * dh + 4 * c, vg + (size_t)t * D + 4 * c);
      }
      cp_async_commit();
    }
  }
  // The audio K/V above are written by precompute_cross_kv before the
  // decode loop and by no kernel of the step: their loads may precede the
  // wait.  iq is the q GEMM's: read after it.
  pdl_wait();
  for (int i = tid; i < kd * nq; i += IA_THREADS) {
    const int j = i / nq, c = i - j * nq;
    *reinterpret_cast<uint2*>(qb + j * dh + 4 * c) =
        *reinterpret_cast<const uint2*>(iq + (size_t)(b * kd + j) * D
                                        + (size_t)h * dh + 4 * c);
  }
  if (RES && !use_tma) cp_async_wait<1>();
  __syncthreads();  // q is in; thread 0's barriers are initialised
  if (RES && use_tma) sm90::mbar_wait(&bar[0], 0);

  // -- scores: 8 lanes a key, 4 keys a warp; bf16x2 products (the exact
  //    product rounded to bf16), summed in f32 ------------------------------
  const bf16* kb = RES ? ks : kg;
  const int krs = RES ? dh : D;   // key row stride (elements)
  const int sub = lane & (IA_LPK - 1), kq = lane / IA_LPK;
  // the lane's chunks c = sub, sub + 8, ...: q's in registers for every
  // key; a chunk past the head dim reads zeros (adding +0: no change)
  constexpr int NC = 4 * CPL;
  uint2 qr[KDM][NC];
#pragma unroll
  for (int j = 0; j < KDM; ++j)
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + IA_LPK * i;
      qr[j][i] = j < kd && c < nq
          ? *reinterpret_cast<const uint2*>(qb + j * dh + 4 * c)
          : make_uint2(0u, 0u);
    }
  float mloc[KDM];
#pragma unroll
  for (int j = 0; j < KDM; ++j) mloc[j] = -INFINITY;
#pragma unroll 2
  for (int t0 = w * IA_KPW; t0 < n_my; t0 += IA_THREADS / IA_LPK) {
    const int t = t0 + kq;
    const bf16* kr = kb + (size_t)t * krs;
    uint2 ku[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + IA_LPK * i;
      ku[i] = t < n_my && c < nq
          ? *reinterpret_cast<const uint2*>(kr + 4 * c)
          : make_uint2(0u, 0u);
    }
    float acc[KDM];
#pragma unroll
    for (int j = 0; j < KDM; ++j) {
      acc[j] = 0.f;
      if (j < kd) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const bf2* k2 = reinterpret_cast<const bf2*>(&ku[i]);
          const bf2* q2 = reinterpret_cast<const bf2*>(&qr[j][i]);
          const float2 a = __bfloat1622float2(__hmul2(k2[0], q2[0]));
          const float2 e = __bfloat1622float2(__hmul2(k2[1], q2[1]));
          acc[j] += ((a.x + a.y) + e.x) + e.y;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KDM; ++j) {
      if (j < kd) {
        float s = acc[j];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s *= scale;
        if (t < n_my) {
          if (sub == 0) sc[j * keys + t] = s;
          mloc[j] = fmaxf(mloc[j], s);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KDM; ++j) {
    if (j < kd) {
      const float m = warp_max(mloc[j]);
      if (lane == 0) wm[w * IA_KD_MAX + j] = m;
    }
  }
  __syncthreads();
  if (tid < kd) {
    float m = -INFINITY;
    for (int q = 0; q < IA_WARPS; ++q) m = fmaxf(m, wm[q * IA_KD_MAX + tid]);
    lm[tid] = m;
  }
  __syncthreads();

  // -- this range's (maximum, sum of exp(s - m)) per token, stored into
  //    every rank's slot for this rank -----------------------------------
  float part[KDM];
#pragma unroll
  for (int j = 0; j < KDM; ++j) part[j] = 0.f;
  for (int t = tid; t < n_my; t += IA_THREADS) {
#pragma unroll
    for (int j = 0; j < KDM; ++j)
      if (j < kd) part[j] += expf(sc[j * keys + t] - lm[j]);
  }
#pragma unroll
  for (int j = 0; j < KDM; ++j) {
    if (j < kd) {
      const float v = warp_sum(part[j]);
      if (lane == 0) wd[w * IA_KD_MAX + j] = v;
    }
  }
  __syncthreads();
  cluster_wait();  // every CTA of the cluster has started
  if (tid < kd) {
    float d = 0.f;
    for (int q = 0; q < IA_WARPS; ++q) d += wd[q * IA_KD_MAX + tid];
    for (int q = 0; q < ns; ++q) {
      cluster.map_shared_rank(xm, q)[rank * 8 + tid] = lm[tid];
      cluster.map_shared_rank(xd, q)[rank * 8 + tid] = d;
    }
  }
  cluster.sync();
  // every CTA folds the NS pairs in rank order: the same global (m, den)
  if (tid < kd) {
    float m = -INFINITY;
    for (int r = 0; r < ns; ++r) m = fmaxf(m, xm[r * 8 + tid]);
    float den = 0.f;
    for (int r = 0; r < ns; ++r)
      den += xd[r * 8 + tid] * expf(xm[r * 8 + tid] - m);
    gm[tid] = m;
    gd[tid] = den;
  }
  __syncthreads();
  for (int t = tid; t < n_my; t += IA_THREADS) {
#pragma unroll
    for (int j = 0; j < KDM; ++j)
      if (j < kd)
        sc[j * keys + t] = round_bf16(expf(sc[j * keys + t] - gm[j]) / gd[j]);
  }
  if (RES) {
    if (use_tma) sm90::mbar_wait(&bar[1], 0);
    else cp_async_wait<0>();
  }
  __syncthreads();

  // -- P.V: a warp a key at a time, 4 dims a lane ---------------------------
  const bf16* vb = RES ? vs : vg;
  float o[KDM][4 * CPL];
#pragma unroll
  for (int j = 0; j < KDM; ++j)
#pragma unroll
    for (int e = 0; e < 4 * CPL; ++e) o[j][e] = 0.f;
  // keys w, w + 8, ... in order, four at once (their loads first)
  for (int t0 = w; t0 < n_my; t0 += 4 * IA_WARPS) {
    uint2 vu[4][CPL];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * IA_WARPS;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = lane + 32 * cc;
        vu[u][cc] = t < n_my && c < nq
            ? *reinterpret_cast<const uint2*>(vb + (size_t)t * krs + 4 * c)
            : make_uint2(0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * IA_WARPS;
      if (t < n_my) {   // warp-uniform
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {   // zeros past the head dim
          float v[4];
          bf16x4(vu[u][cc], v);
#pragma unroll
          for (int j = 0; j < KDM; ++j) {
            if (j < kd) {
              const float pj = sc[j * keys + t];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                o[j][cc * 4 + e] = fmaf(pj, v[e], o[j][cc * 4 + e]);
            }
          }
        }
      }
    }
  }
  pdl_launch_dependents();
  // K is dead (every warp is past the scores): the partials go there, four
  // slots: the last four warps store theirs, then each earlier group of
  // four adds its own to slot w % 4
#pragma unroll
  for (int round = IA_WARPS / IA_SLOTS - 1; round >= 0; --round) {
    if (w / IA_SLOTS == round) {
      float* slot = red + (w % IA_SLOTS) * kd * dh;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = lane + 32 * cc;
        if (c < nq) {
#pragma unroll
          for (int j = 0; j < KDM; ++j) {
            if (j < kd) {
              float4* d4 = reinterpret_cast<float4*>(slot + j * dh + 4 * c);
              float4 v = make_float4(o[j][cc * 4], o[j][cc * 4 + 1],
                                     o[j][cc * 4 + 2], o[j][cc * 4 + 3]);
              if (round < IA_WARPS / IA_SLOTS - 1) {
                const float4 u = *d4;
                v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
              }
              *d4 = v;
            }
          }
        }
      }
    }
    __syncthreads();
  }
  // the slots summed in order, each dim stored into the inbox of the rank
  // that combines it (rank q's dims: [q*dh/ns, (q+1)*dh/ns))
  const int A = kd * dh;
  for (int i = tid; i < A; i += IA_THREADS) {
    float v = red[i];
#pragma unroll
    for (int q = 1; q < IA_SLOTS; ++q) v += red[q * A + i];
    const int j = i / dh, d = i - j * dh;
    const int q = ((d + 1) * ns - 1) / dh;
    cluster.map_shared_rank(inbox, q)[(rank * kd + j) * ndm + d
                                      - q * dh / ns] = v;
  }
  cluster.sync();

  // -- rank r sums its dims over the ranks, in rank order -------------------
  const int d0 = rank * dh / ns, nd = (rank + 1) * dh / ns - d0;
  for (int i = tid; i < kd * nd; i += IA_THREADS) {
    const int j = i / nd, dl = i - j * nd;
    float acc = 0.f;
    for (int r = 0; r < ns; ++r) acc += inbox[(r * kd + j) * ndm + dl];
    out[(size_t)(b * kd + j) * D + (size_t)h * dh + d0 + dl] =
        __float2bfloat16(acc);
  }
}

// The [B, ta_real, D] view of one layer's K or V (row stride D, batch
// stride Ta*D), in boxes [1, keys, dh], no swizzle, zeros out of bounds.
// A map holds nothing but the address, the shape and the box, so the
// cache, keyed by all of them, can never hand out a stale one; it is
// cleared when it passes 4096 maps.
cudaError_t inject_kv_map(const void* base, int B, int Ta, int ta_real, int D,
                          int dh, int keys, CUtensorMap* map) {
  struct Key {
    const void* p;
    int B, Ta, ta, D, dh, keys;
    bool operator==(const Key& o) const {
      return p == o.p && B == o.B && Ta == o.Ta && ta == o.ta && D == o.D
             && dh == o.dh && keys == o.keys;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.p) ^ ((size_t)k.ta << 20)
             ^ ((size_t)k.keys << 8) ^ ((size_t)k.dh << 40) ^ (size_t)k.B;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{base, B, Ta, ta_real, D, dh, keys};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)ta_real,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)Ta * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)dh, (cuuint32_t)keys, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

template <int KDM, bool RES, int CPL>
cudaError_t launch_inject_attention(const InjectPlan& p, size_t smem,
                                    const CUtensorMap& km,
                                    const CUtensorMap& vm, const bf16* iq,
                                    const bf16* ka, const bf16* va, bf16* out,
                                    int B, int kd, int Ta, int ta_real, int D,
                                    int heads, int use_tma, float scale,
                                    cudaStream_t stream) {
  auto kern = inject_attention_kernel<KDM, RES, CPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = sm90::allow_smem(kern, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ns, heads, B);
  cfg.blockDim = dim3(IA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1] = pdl_attribute();
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, km, vm, iq, ka, va, out, kd, Ta, ta_real, D, D / heads,
      p.keys, use_tma, scale);
  return e == cudaSuccess ? cudaGetLastError() : refuse(e);
}

template <int KDM>
cudaError_t launch_inject_kdm(const InjectPlan& p, size_t smem,
                              const CUtensorMap& km, const CUtensorMap& vm,
                              const bf16* iq, const bf16* ka, const bf16* va,
                              bf16* out, int B, int kd, int Ta, int ta_real,
                              int D, int heads, int use_tma, float scale,
                              cudaStream_t st) {
#define DESTA_IA_ARGS                                                        \
  p, smem, km, vm, iq, ka, va, out, B, kd, Ta, ta_real, D, heads, use_tma,   \
      scale, st
  const bool narrow = D / heads <= 128;
  if (p.resident)
    return narrow ? launch_inject_attention<KDM, true, 1>(DESTA_IA_ARGS)
                  : launch_inject_attention<KDM, true, 2>(DESTA_IA_ARGS);
  return narrow ? launch_inject_attention<KDM, false, 1>(DESTA_IA_ARGS)
                : launch_inject_attention<KDM, false, 2>(DESTA_IA_ARGS);
#undef DESTA_IA_ARGS
}

// One CTA a row: gate2's sum and the LayerNorm statistics of the row, then
// the gated residual of h, in place.  NV: 16-byte vectors a thread.
template <int NV>
__global__ void __launch_bounds__(IG_THREADS)
inject_gate_kernel(bf16* __restrict__ h, const bf16* __restrict__ ig,
                   const bf16* __restrict__ iao, const float* __restrict__ wg2,
                   const float* __restrict__ bg2, const float* __restrict__ lns,
                   const float* __restrict__ lnb, const float* __restrict__ on,
                   int kd, int D, int Dg) {
  __shared__ float red[3][IG_THREADS / 32];
  const int r = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, wq = tid >> 5, nw = T >> 5;
  const int nvec = D >> 3;
  constexpr int NG = 2 * NV;  // gate2 weights a thread keeps (Dg = D / 4)

  // weights and the per-call flag: no kernel of the step writes them
  float4 ls[NV][2], lb[NV][2];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = tid + i * T;
    if (v < nvec) {
      const float4* s4 = reinterpret_cast<const float4*>(lns) + 2 * v;
      const float4* b4 = reinterpret_cast<const float4*>(lnb) + 2 * v;
      ls[i][0] = __ldg(s4);
      ls[i][1] = __ldg(s4 + 1);
      lb[i][0] = __ldg(b4);
      lb[i][1] = __ldg(b4 + 1);
    }
  }
  float wg[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int i = tid + k * T;
    wg[k] = i < Dg ? __ldg(wg2 + i) : 0.f;
  }
  const float b2 = __ldg(bg2);
  const float onr = round_bf16(__ldg(on + r / kd));
  pdl_wait();
  pdl_launch_dependents();

  const uint4* xr = reinterpret_cast<const uint4*>(iao + (size_t)r * D);
  uint4* hr = reinterpret_cast<uint4*>(h + (size_t)r * D);
  const bf16* gr = ig + (size_t)r * Dg;
  uint4 xv[NV], hv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = tid + i * T;
    if (v < nvec) {
      xv[i] = xr[v];
      hv[i] = hr[v];
    }
  }
  float gs = 0.f;
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int i = tid + k * T;
    if (i < Dg) gs += __bfloat162float(gr[i]) * wg[k];
  }
  for (int i = tid + NG * T; i < Dg; i += T)  // a wider gate1
    gs += __bfloat162float(gr[i]) * wg2[i];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (tid + i * T < nvec) {
      const bf2* x2 = reinterpret_cast<const bf2*>(&xv[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(x2[e]);
        sum += f.x;
        sum += f.y;
      }
    }
  }
  // (gate2's sum, the row sum) together, in warp order
  gs = warp_sum(gs);
  sum = warp_sum(sum);
  if (lane == 0) {
    red[0][wq] = gs;
    red[1][wq] = sum;
  }
  __syncthreads();
  float tg = 0.f, tx = 0.f;
  for (int q = 0; q < nw; ++q) {
    tg += red[0][q];
    tx += red[1][q];
  }
  const float gate = 1.f / (1.f + expf(-(tg + b2)));
  const float mu = tx / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (tid + i * T < nvec) {
      const bf2* x2 = reinterpret_cast<const bf2*>(&xv[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(x2[e]);
        const float a = f.x - mu, c = f.y - mu;
        sq += a * a;
        sq += c * c;
      }
    }
  }
  sq = warp_sum(sq);
  if (lane == 0) red[2][wq] = sq;
  __syncthreads();
  float ts = 0.f;
  for (int q = 0; q < nw; ++q) ts += red[2][q];
  const float inv = rsqrtf(ts / (float)D + 1e-5f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = tid + i * T;
    if (v < nvec) {
      const bf2* x2 = reinterpret_cast<const bf2*>(&xv[i]);
      const bf2* h2 = reinterpret_cast<const bf2*>(&hv[i]);
      const float* s8 = reinterpret_cast<const float*>(ls[i]);
      const float* b8 = reinterpret_cast<const float*>(lb[i]);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(x2[e]);
        const float2 hh = __bfloat1622float2(h2[e]);
        const float l0 = (x.x - mu) * inv * s8[2 * e] + b8[2 * e];
        const float l1 = (x.y - mu) * inv * s8[2 * e + 1] + b8[2 * e + 1];
        o[e] = pack_bf16(hh.x + round_bf16(onr * round_bf16(gate * l0)),
                         hh.y + round_bf16(onr * round_bf16(gate * l1)));
      }
      hr[v] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int NV>
cudaError_t launch_inject_gate(bf16* h, const bf16* ig, const bf16* iao,
                               const float* wg2, const float* bg2,
                               const float* lns, const float* lnb,
                               const float* on, int R, int kd, int D, int Dg,
                               int threads, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)R);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0] = pdl_attribute();
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, inject_gate_kernel<NV>, h,
                                           ig, iao, wg2, bg2, lns, lnb, on,
                                           kd, D, Dg);
  return e == cudaSuccess ? cudaGetLastError() : refuse(e);
}

}  // namespace

// iq, out [B*kd, D] (row r = b*kd + j); ka, va [B, Ta, D] (one layer),
// keys 0..ta_real-1 attended; head dim D / heads, a multiple of 4, <= 256;
// 16-byte aligned rows
extern "C" int desta_inject_attention(const void* iq, const void* ka,
                                      const void* va, void* out, int B,
                                      int kd, int Ta, int ta_real, int D,
                                      int heads, float scale, void* stream) {
  if (heads <= 0 || D % heads != 0 || (D / heads) % 4 != 0
      || D / heads > IA_DH_MAX || D % 8 != 0 || kd < 1 || kd > IA_KD_MAX
      || ta_real < 1 || ta_real > Ta || B < 1 || B > 65535 || heads > 65535
      || (reinterpret_cast<uintptr_t>(ka) | reinterpret_cast<uintptr_t>(va))
             % 16)
    return (int)cudaErrorInvalidValue;
  const int dh = D / heads;
  const InjectPlan p = plan_inject(B, heads, ta_real, dh, sm_count());
  const size_t smem = ia_smem(kd, dh, p.keys, p.resident);
  if (smem > IA_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int use_tma = p.resident && dh % 8 == 0;
  CUtensorMap km = {}, vm = {};
  if (use_tma
      && (inject_kv_map(ka, B, Ta, ta_real, D, dh, p.keys, &km) != cudaSuccess
          || inject_kv_map(va, B, Ta, ta_real, D, dh, p.keys, &vm)
                 != cudaSuccess))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16 *q = (const bf16*)iq, *k = (const bf16*)ka, *v = (const bf16*)va;
  return (int)(kd == 1
      ? launch_inject_kdm<1>(p, smem, km, vm, q, k, v, (bf16*)out, B, kd, Ta,
                             ta_real, D, heads, use_tma, scale, st)
      : launch_inject_kdm<IA_KD_MAX>(p, smem, km, vm, q, k, v, (bf16*)out, B,
                                     kd, Ta, ta_real, D, heads, use_tma,
                                     scale, st));
}

// out[4] = the attention's plan on the current device: key ranges, keys
// per range, dynamic shared bytes, 1 if the range lives in shared memory
// (ops/fused_decode.plan_inject_splits and inject_attention_smem are the
// same rules)
extern "C" int desta_inject_attention_plan(int B, int kd, int ta_real, int D,
                                           int heads, void* out) {
  if (B < 1 || heads < 1 || D % heads || kd < 1 || kd > IA_KD_MAX
      || ta_real < 1 || D / heads < 4)
    return (int)cudaErrorInvalidValue;
  const int dh = D / heads;
  const InjectPlan p = plan_inject(B, heads, ta_real, dh, sm_count());
  int* o = (int*)out;
  o[0] = p.ns;
  o[1] = p.keys;
  o[2] = (int)ia_smem(kd, dh, p.keys, p.resident);
  o[3] = (int)p.resident;
  return 0;
}

// h, iao [R, D] bf16 (16-byte aligned rows, D a multiple of 8 up to
// 32768), ig [R, Dg] bf16, wg2 [Dg] f32, bg2 [1] f32, lns / lnb [D] f32
// (16-byte aligned), on [R / kd] f32; one CTA a row
extern "C" int desta_inject_gate(void* h, const void* ig, const void* iao,
                                 const void* wg2, const void* bg2,
                                 const void* lns, const void* lnb,
                                 const void* on, int R, int kd, int D, int Dg,
                                 void* stream) {
  const int nvec = D / 8;
  if (R < 1 || kd < 1 || R % kd != 0 || D < 8 || D % 8 != 0 || Dg < 1
      || (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(iao)
          | reinterpret_cast<uintptr_t>(lns) | reinterpret_cast<uintptr_t>(lnb))
             % 16)
    return (int)cudaErrorInvalidValue;
  const int threads = nvec < IG_THREADS ? (nvec + 31) / 32 * 32 : IG_THREADS;
  const int nv = (nvec + threads - 1) / threads;
  if (nv > 8) return (int)cudaErrorInvalidValue;
#define DESTA_IG_ARGS                                                        \
  (bf16*)h, (const bf16*)ig, (const bf16*)iao, (const float*)wg2,            \
      (const float*)bg2, (const float*)lns, (const float*)lnb,               \
      (const float*)on, R, kd, D, Dg, threads, (cudaStream_t)stream
  return (int)(nv == 1 ? launch_inject_gate<1>(DESTA_IG_ARGS)
               : nv == 2 ? launch_inject_gate<2>(DESTA_IG_ARGS)
               : nv <= 4 ? launch_inject_gate<4>(DESTA_IG_ARGS)
                         : launch_inject_gate<8>(DESTA_IG_ARGS));
#undef DESTA_IG_ARGS
}
