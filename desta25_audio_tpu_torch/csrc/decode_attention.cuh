// Decode / verify attention with the in-place cache write, shared by the
// decode step (csrc/fused_decode.cu: K8, K8-int8, K8v, and K8i's
// self-attention) and the per-layer decode pair (csrc/fused_decode_tp.cu:
// K9's attention half, and so K10's per-rank steps).
//
// Replaces: the attention of desta25_audio_tpu/ops/fused_decode.py::
//   _make_kernel (:504-665): per (batch row b, kv head, draft token j)
//   qk-norm (Qwen3) and half-split RoPE in f32 of the G = H/Hkv queries of
//   token j and the k of draft tokens 0..j (rounded to bf16), token j's k
//   and v rows written into the packed cache [B, S, Hkv*Dh] at ci + j (ci is
//   row b's first write position; a position past the cache writes
//   nothing), then f32 scores over the cached keys < ci that the mask
//   allows plus the draft block 0..j, one f32 softmax over both, P
//   normalised in f32 and rounded to bf16 for the cached keys (the TPU
//   kernel's rounding point), the draft tokens' weights kept in f32 against
//   their bf16 v, P.V summed in f32 and stored as bf16.  Kd = 1 (the decode
//   step) is compiled apart with a one-token draft block.
//
// What bounds it on the H100: bytes.  Per (b, kv head) it reads each cached
//   key's K and V rows once (512 bytes at Dh = 128) against 4*G*Dh
//   operations: G operations a byte, far below the 295 ops/byte ridge, so
//   tensor cores buy nothing; what counts is SMs in use and bytes in flight.
//
// Design:
//   * Keys split across a thread-block cluster.  The grid is (NS, Hkv,
//     B*Kd), launched as clusters of NS CTAs along x: rank r attends keys
//     [r*keys, (r+1)*keys) of the row's cache.  plan_decode picks NS from
//     the cache capacity S (never ci, which lives on the device), B*Hkv and
//     the SM count: as many ranges as fill the card with one draft token's
//     clusters, at most 8 (the portable cluster size), every range but the
//     last a whole number of 32-key tiles, none empty
//     (ops/fused_decode.plan_decode_splits is the same rule, tested on the
//     CPU).  The verify step takes the decode step's plan, so its token 0
//     is the decode step's bit for bit.  At the b2 decode (2 x 8 clusters)
//     and S = 256 that is 8 ranges of one tile: 128 CTAs, not 16 blocks.
//   * Tile loads by TMA.  A range's K tiles, then its V tiles, pass through
//     a ring of 4 stages of [32 keys, 128 dims] bf16 (two 64-dim halves in
//     the 128-byte swizzle, 8 KB), loaded from a 2-D map over the layer's
//     cache viewed as [B*S, Hkv*128] and completed on one mbarrier a stage.
//     Thread 0 is the producer: it fills the ring at the start and refills
//     a stage as soon as the block has read it, so the first V tiles load
//     while the scores, the softmax and the cluster exchanges run.  Only
//     tiles below ci are loaded.  128 threads: scores take 4 lanes a key
//     (32 dims each, then two shuffles), a warp 8 keys of a tile; P.V a
//     warp 8 keys, 4 dims a lane; both read the swizzled tile without bank
//     conflicts.  (On the H100, 256 threads ran a 4096-key cache about 8 %
//     faster and the verify step's 512-CTA grid about 45 % slower.)
//   * Softmax across the cluster at the TPU kernel's rounding point,
//     through distributed shared memory, in rank order: (a) each CTA
//     publishes its per-head maximum, every CTA folds all NS (and the draft
//     scores) into the same global maximum; (b) each publishes its sum of
//     exp(s - m), every CTA adds all NS in rank order plus the draft terms;
//     (c) each rounds P = bf16(exp(s - m) / den), sums its partial o[G, 128]
//     in f32 and publishes it; rank r adds dims [r*128/NS, (r+1)*128/NS) of
//     every rank's partial in rank order plus the draft block's f32 terms and
//     stores bf16; (d) a last cluster sync keeps every CTA's shared memory
//     alive until it has been read.  No atomics, no second launch: two
//     launches on the same inputs give the same bits.  A CTA whose range
//     starts at or past ci contributes a maximum of -inf and a sum of 0; a
//     row with ci = 0 attends its draft block alone.
//   * The prologue (qk-norm, RoPE, the draft scores) runs in every CTA of a
//     cluster, a warp a head vector; only rank 0 writes token j's cache row.
//     CTAs read only cache rows < ci and write only ci..ci+Kd-1, so no CTA
//     reads what another writes (a tile's tail past ci may hold such rows;
//     they are never used).
//   * Programmatic dependent launch (common.cuh): the barriers and the
//     tensor-map prefetch come before the wait on the kernel before (the
//     qkv GEMM); every read of qkv, ci, the mask or the cache after it.
//   The scores of one range live in shared memory (G * keys f32), which
//   bounds S (ops/fused_decode.kernel_limits states the limit).
#pragma once

#include <cooperative_groups.h>

#include "attention_sm90.cuh"

namespace desta {

constexpr int DHD = 128;
constexpr int KD_MAX = 8;   // draft tokens per row (the TPU kernel's kd <= 8)
constexpr int DA_THREADS = 128;   // 4 warps
constexpr int DA_TILE = 32;       // keys per TMA tile
constexpr int DA_STAGES = 4;
constexpr int DA_SPLITS_MAX = 8;  // the portable cluster size
constexpr int DA_HALF_BYTES = DA_TILE * 64 * 2;       // [32 keys, 64 dims]
constexpr int DA_TILE_BYTES = 2 * DA_HALF_BYTES;      // 8 KB
constexpr int DA_SMEM_MAX = 227 * 1024;
constexpr int DA_MAX_DEVICES = 64;

// NS key ranges of `keys` keys each (the last may be shorter)
struct DecodePlan {
  int ns;
  int keys;
};

// The rule of ops/fused_decode.plan_decode_splits: B*Hkv clusters a draft
// token (the verify step takes the decode step's plan, so that its token 0
// is the decode step's, bit for bit).  S >= 1.
inline DecodePlan plan_decode(int B, int Hkv, int S, int n_sm) {
  const long long clusters = (long long)B * Hkv;
  const int nt = (S + DA_TILE - 1) / DA_TILE;
  long long ns = n_sm / clusters;
  if (ns > DA_SPLITS_MAX) ns = DA_SPLITS_MAX;
  if (ns > nt) ns = nt;
  if (ns < 1) ns = 1;
  const int tps = (int)((nt + ns - 1) / ns);
  return {(nt + tps - 1) / tps, tps * DA_TILE};
}

// Dynamic shared memory of one CTA (ops/fused_decode.decode_attention_smem):
// alignment, the ring and its barriers, then f32 q and the partial o
// [G][DHD], the draft keys [KDM][DHD], the draft scores [G][KDM], 64 floats
// of reductions, the range's scores [G][keys].
inline size_t decode_smem(int G, int kdm, int keys) {
  return 1024 + (size_t)DA_STAGES * (DA_TILE_BYTES + 8)
         + sizeof(float) * ((size_t)2 * G * DHD + (size_t)kdm * DHD
                            + (size_t)G * kdm + 64 + (size_t)G * keys);
}

// Four bf16 (8 bytes) -> four floats.
__device__ __forceinline__ void unpack4(uint2 u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// KDM: the most draft tokens a CTA may see (1 for the decode step, KD_MAX
// for the verify step).
template <int G, int KDM>
__global__ void __launch_bounds__(DA_THREADS)
decode_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const bf16* __restrict__ qkv, bf16* __restrict__ kc,
                        bf16* __restrict__ vc, const float* __restrict__ cosb,
                        const float* __restrict__ sinb,
                        const int* __restrict__ mask, int mask_stride,
                        const int* __restrict__ ci_arr,
                        const bf16* __restrict__ q_norm,
                        const bf16* __restrict__ k_norm,
                        bf16* __restrict__ out, int S, int Hkv, int kd,
                        int keys, float eps, float scale) {
  namespace cg = cooperative_groups;
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = aligned_smem(smem_raw);          // [STAGES][2][32][64] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DA_STAGES * DA_TILE_BYTES);
  float* qf = reinterpret_cast<float*>(full + DA_STAGES);  // [G][DHD]
  float* op = qf + G * DHD;        // [G][DHD] this CTA's partial output
  float* kdr = op + G * DHD;       // [KDM][DHD] draft keys (bf16-rounded)
  float* dsc = kdr + KDM * DHD;    // [G][KDM] draft scores, then weights
  float* wred = dsc + G * KDM;     // [4][8] per-warp reductions
  float* xm = wred + 32;           // [8] published maxima
  float* xd = xm + 8;              // [8] published denominators
  float* mg = xd + 8;              // [8] global maxima
  float* ivs = mg + 8;             // [8] 1 / denominators
  float* sc = ivs + 8;             // [G][keys] scores, then exp(s - m)
  float* red = reinterpret_cast<float*>(ring);  // [4][G][DHD], ring done

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ns = (int)cluster.num_blocks();
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.y, b = blockIdx.z / kd, j = blockIdx.z % kd;
  const int H = Hkv * G, HD = H * DHD, KVD = Hkv * DHD;
  const int QKVW = HD + 2 * KVD;
  const int row_j = b * kd + j;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&kmap) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&vmap) : "memory");
#pragma unroll
    for (int s = 0; s < DA_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  // qkv, ci, the mask and the cache are the step's: read after the wait
  pdl_wait();
  pdl_launch_dependents();
  const int ci = ci_arr[b];
  const int nk = ci < S ? ci : S;          // cached keys below ci
  const int lo = rank * keys;
  int n_my = (nk < lo + keys ? nk : lo + keys) - lo;
  if (n_my < 0) n_my = 0;
  const int T = (n_my + DA_TILE - 1) / DA_TILE;   // tiles of K (and of V)
  const int n_load = 2 * T;
  // tile i of the ring sequence: K tiles 0..T-1, then V tiles
  auto issue = [&](int i) {
    const int s = i % DA_STAGES;
    const CUtensorMap* map = i < T ? &kmap : &vmap;
    const int row = b * S + lo + (i < T ? i : i - T) * DA_TILE;
    uint8_t* dst = ring + s * DA_TILE_BYTES;
    mbar_expect_tx(&full[s], DA_TILE_BYTES);
    tma_load_2d(dst, map, &full[s], kvh * DHD, row);
    tma_load_2d(dst + DA_HALF_BYTES, map, &full[s], kvh * DHD + 64, row);
  };
  if (tid == 0)
    for (int i = 0; i < n_load && i < DA_STAGES; ++i) issue(i);

  // -- prologue: a warp per head vector, 4 dims a lane ---------------------
  // items 0..G-1: the queries of token j; G..G+j: the k of draft tokens
  for (int it = w; it < G + j + 1; it += DA_THREADS / 32) {
    const bool isq = it < G;
    const int r2 = isq ? row_j : b * kd + (it - G);
    const bf16* src = qkv + (size_t)r2 * QKVW
                      + (isq ? (kvh * G + it) * DHD : HD + kvh * DHD)
                      + lane * 4;
    float x[4];
    unpack4(*reinterpret_cast<const uint2*>(src), x);
    const bf16* nw = isq ? q_norm : k_norm;
    if (nw != nullptr) {
      const float ss = warp_sum(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]
                                + x[3] * x[3]);
      const float rs = rsqrtf(ss / (float)DHD + eps);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = x[e] * rs * __bfloat162float(nw[lane * 4 + e]);
    }
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // half-split RoPE: dim d < 64 pairs with d + 64, held 16 lanes away
      const float pr = __shfl_xor_sync(0xffffffffu, x[e], 16);
      const float rot = lane < 16 ? -pr : pr;
      y[e] = round_bf16(x[e] * cosb[r2 * DHD + lane * 4 + e]
                        + rot * sinb[r2 * DHD + lane * 4 + e]);
    }
    float* dst = isq ? qf + it * DHD : kdr + (it - G) * DHD;
    *reinterpret_cast<float4*>(dst + lane * 4) =
        make_float4(y[0], y[1], y[2], y[3]);
    if (!isq && it - G == j && rank == 0 && ci >= 0 && ci + j < S) {
      const size_t crow = ((size_t)b * S + ci + j) * KVD + kvh * DHD
                          + lane * 4;
      uint2 kv;
      kv.x = pack_bf16(y[0], y[1]);
      kv.y = pack_bf16(y[2], y[3]);
      *reinterpret_cast<uint2*>(kc + crow) = kv;
      *reinterpret_cast<uint2*>(vc + crow) =
          *reinterpret_cast<const uint2*>(src + KVD);
    }
  }
  __syncthreads();
  // the draft block's scores: token j against draft tokens 0..j
  for (int it = w; it < G * (j + 1); it += DA_THREADS / 32) {
    const int g = it / (j + 1), j2 = it % (j + 1);
    const float4 a = *reinterpret_cast<const float4*>(qf + g * DHD + lane * 4);
    const float4 k = *reinterpret_cast<const float4*>(kdr + j2 * DHD + lane * 4);
    const float s = warp_sum(a.x * k.x + a.y * k.y + a.z * k.z + a.w * k.w);
    if (lane == 0) dsc[g * KDM + j2] = s * scale;
  }

  // -- scores over the range's cached keys --------------------------------
  // a warp takes 8 keys of a tile, 4 lanes a key (32 dims each)
  const int key_in = w * 8 + (lane & 7), qd = lane >> 3;
  float mloc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mloc[g] = -INFINITY;
  for (int t = 0; t < T; ++t) {
    const int s = t % DA_STAGES;
    mbar_wait(&full[s], (uint32_t)(t / DA_STAGES) & 1u);
    const uint8_t* krow = ring + s * DA_TILE_BYTES + (qd >> 1) * DA_HALF_BYTES
                          + key_in * 128;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ch = (qd & 1) * 4 + c;  // 16-byte chunk within the half
      const uint4 u = *reinterpret_cast<const uint4*>(
          krow + ((ch ^ (key_in & 7)) << 4));
      float kf[8];
      unpack4(make_uint2(u.x, u.y), kf);
      unpack4(make_uint2(u.z, u.w), kf + 4);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4* qp =
            reinterpret_cast<const float4*>(qf + g * DHD + qd * 32 + c * 8);
        const float4 a0 = qp[0], a1 = qp[1];
        acc[g] += a0.x * kf[0] + a0.y * kf[1] + a0.z * kf[2] + a0.w * kf[3]
                  + a1.x * kf[4] + a1.y * kf[5] + a1.z * kf[6] + a1.w * kf[7];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 8);
      acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 16);
    }
    const int kl = t * DA_TILE + key_in;  // index within the range
    if (qd == 0) {
      const bool ok = kl < n_my
                      && mask[(size_t)b * mask_stride + lo + kl] > 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sv = ok ? acc[g] * scale : -INFINITY;
        sc[g * keys + kl] = sv;
        mloc[g] = fmaxf(mloc[g], sv);
      }
    }
    __syncthreads();  // the stage is read: refill it
    if (tid == 0 && t + DA_STAGES < n_load) issue(t + DA_STAGES);
  }

  // -- (a) the global maximum ------------------------------------------------
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m = warp_max(mloc[g]);
    if (lane == 0) wred[w * 8 + g] = m;
  }
  __syncthreads();
  if (tid < G)
    xm[tid] = fmaxf(fmaxf(wred[tid], wred[8 + tid]),
                    fmaxf(wred[16 + tid], wred[24 + tid]));
  cluster.sync();
  if (tid < G) {
    float m = -INFINITY;
    for (int r = 0; r < ns; ++r)
      m = fmaxf(m, *cluster.map_shared_rank(xm + tid, r));
    for (int j2 = 0; j2 <= j; ++j2) m = fmaxf(m, dsc[tid * KDM + j2]);
    mg[tid] = m == -INFINITY ? 0.f : m;  // token j's own score is finite
  }
  __syncthreads();

  // -- (b) the denominator -------------------------------------------------
  float part[G];
#pragma unroll
  for (int g = 0; g < G; ++g) part[g] = 0.f;
  for (int kl = tid; kl < T * DA_TILE; kl += DA_THREADS) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float e = expf(sc[g * keys + kl] - mg[g]);  // -inf -> 0
      sc[g * keys + kl] = e;
      part[g] += e;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float v = warp_sum(part[g]);
    if (lane == 0) wred[w * 8 + g] = v;
  }
  __syncthreads();
  if (tid < G)
    xd[tid] = ((wred[tid] + wred[8 + tid]) + wred[16 + tid]) + wred[24 + tid];
  cluster.sync();
  if (tid < G) {
    float den = 0.f;
    for (int r = 0; r < ns; ++r) den += *cluster.map_shared_rank(xd + tid, r);
    for (int j2 = 0; j2 <= j; ++j2)
      den += expf(dsc[tid * KDM + j2] - mg[tid]);
    const float inv = 1.f / den;
    ivs[tid] = inv;
    for (int j2 = 0; j2 <= j; ++j2)
      dsc[tid * KDM + j2] = expf(dsc[tid * KDM + j2] - mg[tid]) * inv;
  }
  __syncthreads();

  // -- (c) P.V over the range: a warp 8 keys of a tile, 4 dims a lane -----
  float inv[G], o[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    inv[g] = ivs[g];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[g][e] = 0.f;
  }
  // lane's 8 bytes in a swizzled 128-byte row of half lane / 16
  const int vch = (lane & 15) >> 1, vbyte = (lane & 1) * 8;
  for (int t = 0; t < T; ++t) {
    const int i = T + t, s = i % DA_STAGES;
    mbar_wait(&full[s], (uint32_t)(i / DA_STAGES) & 1u);
    const uint8_t* vt = ring + s * DA_TILE_BYTES + (lane >> 4) * DA_HALF_BYTES;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int kin = w * 8 + kk, kl = t * DA_TILE + kin;
      if (kl >= n_my) break;
      float v[4];
      unpack4(*reinterpret_cast<const uint2*>(
                  vt + kin * 128 + ((vch ^ (kin & 7)) << 4) + vbyte),
              v);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = round_bf16(sc[g * keys + kl] * inv[g]);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[g][e] += p * v[e];
      }
    }
    __syncthreads();
    if (tid == 0 && i + DA_STAGES < n_load) issue(i + DA_STAGES);
  }
  // the ring is idle (every load issued has been waited on): the four
  // warps' partials meet there, summed in warp order
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float4*>(red + (w * G + g) * DHD + lane * 4) =
        make_float4(o[g][0], o[g][1], o[g][2], o[g][3]);
  __syncthreads();
  for (int idx = tid; idx < G * DHD; idx += DA_THREADS)
    op[idx] = ((red[idx] + red[G * DHD + idx]) + red[2 * G * DHD + idx])
              + red[3 * G * DHD + idx];
  cluster.sync();

  // -- (d) rank r sums its share of the dims over the ranks, in rank order
  const int d0 = rank * DHD / ns, nd = (rank + 1) * DHD / ns - d0;
  for (int idx = tid; idx < G * nd; idx += DA_THREADS) {
    const int g = idx / nd, d = d0 + idx % nd;
    float acc = 0.f;
    for (int r = 0; r < ns; ++r)
      acc += cluster.map_shared_rank(op, r)[g * DHD + d];
    for (int j2 = 0; j2 <= j; ++j2)
      acc += dsc[g * KDM + j2]
             * __bfloat162float(qkv[(size_t)(b * kd + j2) * QKVW + HD + KVD
                                    + kvh * DHD + d]);
    out[(size_t)row_j * HD + (kvh * G + g) * DHD + d] = __float2bfloat16(acc);
  }
  cluster.sync();  // no CTA leaves while another may read its memory
}

template <int G, int KDM>
cudaError_t launch_attention_kdm(const bf16* qkv, bf16* kc, bf16* vc,
                                 const float* cosb, const float* sinb,
                                 const int* mask, int mask_stride,
                                 const int* ci, const bf16* qn, const bf16* kn,
                                 bf16* out, int B, int kd, int S, int Hkv,
                                 float eps, float scale, cudaStream_t stream) {
  const DecodePlan p = plan_decode(B, Hkv, S, sm_count());
  const size_t smem = decode_smem(G, KDM, p.keys);
  if (smem > DA_SMEM_MAX) return cudaErrorInvalidValue;
  // the kernel's dynamic shared-memory limit, raised to DA_SMEM_MAX once per
  // device: without it a launch past the default limit is refused with
  // cudaErrorInvalidValue, and that limit lies below 48 KB (the verify step
  // at B = 16, Kd = 4, S = 384 asks 48,544 bytes and was refused)
  static bool raised[DA_MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0 || dev >= DA_MAX_DEVICES || !raised[dev]) {
    const cudaError_t e = sm90::allow_smem(decode_attention_kernel<G, KDM>,
                                           DA_SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < DA_MAX_DEVICES) raised[dev] = true;
  }
  // the layer's cache as [B*S, Hkv*128] bf16, read in boxes of 32 keys x
  // 64 dims (two a tile)
  const cuuint64_t dims[2] = {(cuuint64_t)Hkv * DHD, (cuuint64_t)B * S};
  const cuuint64_t strides[1] = {(cuuint64_t)Hkv * DHD * 2};
  const cuuint32_t box[2] = {64, DA_TILE};
  CUtensorMap km, vm;
  if (sm90::make_map(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kc, dims,
                     strides, box) != cudaSuccess
      || sm90::make_map(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vc, dims,
                        strides, box) != cudaSuccess)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ns, Hkv, B * kd);
  cfg.blockDim = dim3(DA_THREADS);
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
      &cfg, decode_attention_kernel<G, KDM>, km, vm, qkv, kc, vc, cosb, sinb,
      mask, mask_stride, ci, qn, kn, out, S, Hkv, kd, p.keys, eps, scale);
  if (e != cudaSuccess) return refuse(e);
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
  if (Dh != DHD || Hkv <= 0 || H % Hkv != 0 || kd < 1 || kd > KD_MAX
      || B < 1 || S < 1 || mask_stride < S || (long long)B * kd > 65535)
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

// The plan the launch takes on the current device: {NS, keys per range,
// dynamic shared bytes} (G = H / Hkv).
inline cudaError_t decode_attention_plan(int B, int Hkv, int kd, int S, int H,
                                         int* out) {
  if (B < 1 || Hkv < 1 || H % Hkv || kd < 1 || kd > KD_MAX || S < 1)
    return cudaErrorInvalidValue;
  const DecodePlan p = plan_decode(B, Hkv, S, sm_count());
  out[0] = p.ns;
  out[1] = p.keys;
  out[2] = (int)decode_smem(H / Hkv, kd == 1 ? 1 : KD_MAX, p.keys);
  return cudaSuccess;
}

}  // namespace desta
