// Skinny weight-streaming GEMM: out[m, n] = epi(s[n] * (x[m, :] . w[n, :]))
// for a few activation rows m, with the weight in the port's [out, in]
// layout as bf16 or int8 (one f32 scale per output row).
//
// Replaces: the weight ring of desta25_audio_tpu/ops/fused_decode.py::
//   _make_kernel (wdma / RING, :405-443: int8 or bf16 weight tiles streamed
//   by DMA ahead of the matrix unit, int8 cast to bf16, an f32 accumulator
//   over the K tiles, the scale applied once to the f32 sum) and the
//   weight-only int8 matmul of ops/quant.py::_qmm_kernel at M <= 16.
// Used by the decode step (csrc/fused_decode.cu: K8, its int8 stream, the
// verify step K8v, the ORCA injection's q / o / gate1 projections of K8i),
// by the int8 matmul at small M (csrc/qmm.cu: K7), by the per-layer decode
// pair (K9: its q/k/v and gate/up products, and csrc/fused_decode_tp.cu's
// wo / down partial sums) and by the tensor-parallel step's peer stores
// (csrc/tp_allreduce.cu: K10).
// What bounds it on the H100: device-memory bandwidth.  Every weight byte
//   is read once for up to 16 activation rows (2*M FLOP per byte, far below
//   the 295 FLOP/byte ridge); Llama-3.1-8B's four layer GEMMs are 218 MB of
//   int8 a layer, ~65 us at 3.35 TB/s.
// Design (one launch per 16 rows):
//   * Tensor cores with A and B swapped: a CTA owns SG_BN = 64 weight rows
//     (the M side of mma.sync m16n8k16, one 16-row slice per consumer warp)
//     and the R <= 16 activation rows are the N side (one or two n8 tiles),
//     so the per-row FMAs and the re-reads of x through L1 of a warp-per-
//     column design are gone.  int8 weights become bf16 in registers
//     (exact: |q| <= 128 fits bf16's 8-bit significand); the f32 sums are
//     the mma's.
//   * An asynchronous ring of SG_STAGES stages in shared memory, fed by one
//     producer thread: a stage is a 64-row x 128-byte weight tile, one TMA
//     load in the 128B swizzle (conflict-free fragment loads; rows past N
//     and columns past K read as 0), and the R activation rows' matching
//     k-range, one 1-D bulk copy a row into padded rows (so x is staged
//     once per CTA, never re-read per weight vector).  Each stage has a
//     "full" mbarrier (the copies' bytes) and an "empty" one (the consumer
//     warps).  The weight maps are encoded once per weight tensor and kept
//     (skinny_weight_map): a launch encodes nothing when the weights are
//     the same as a previous launch's, as the decode step's are.
//   * K split across a thread-block cluster of up to 8 CTAs, as many as
//     bring the grid to SG_CTAS_PER_SM CTAs an SM (plan_skinny, the rule of
//     ops/skinny_gemm.plan_skinny_gemm): rank r walks its own
//     k-tiles, writes its f32 partial tile to shared memory, and after a
//     cluster barrier each output is summed over the ranks' partials
//     through distributed shared memory in rank order 0, 1, ... (fixed,
//     so two launches give the same bits).  The ranks share the tile's
//     outputs, so each output's epilogue runs once, in one CTA, on the
//     full sum: RESID and ADD_F32 read-modify-write without atomics, and a
//     SWIGLU gate/up pair (rows 2n, 2n+1) always lies in one tile.  The
//     plan reads only N, K and the card's SM count, never the rows, so the
//     verify step's rows are summed as the decode step's.
//   * Programmatic dependent launch (common.cuh): the weight tiles of the
//     first SG_STAGES stages are requested before the wait on the kernel
//     before (the weights are no kernel's output); the rows' k-ranges after
//     it, and the epilogue's reads and writes of out after it too; the
//     next kernel is let start once this one's mainloop is done.  A
//     launch's fixed cost and its first weight bytes thus overlap the
//     previous kernel's tail, in a graph and on a stream alike.
// The scale multiplies the f32 sum (the TPU kernels' scale point,
// desta25_audio_tpu/ops/quant.py:74-77 and ops/fused_decode.py:428-443),
// then the epilogue rounds:
//   STORE      bf16(v)
//   STORE_F32  v
//   ADD_F32    out = out + v                   (f32, no fused multiply-add)
//   RESID      h = bf16(h + bf16(v))                      (bf16 residual)
//   SWIGLU     mid = bf16(bf16(silu(bf16(gate))) * bf16(up)) over
//              row-interleaved gate/up weights, each with its own scale
//   BIAS       bf16(v + b[n])                 (f32 bias, no fused multiply-add)
//   BIAS_GELU  bf16(gelu(bf16(v + b[n])))     erf GELU in f32
//   PEER_F32   v into slot [slot][my] of every mesh rank's receive buffer,
//              then, once every CTA of every pass has stored, the round's
//              epoch (the step's base word on the device + the launch's
//              round) into each rank's flag word [slot][my] (PeerStore
//              below; read by the all-reduce of csrc/tp_allreduce.cu)
// Rows go 16 at a time; a pass over more rows re-streams the weights.
#pragma once

#include <cooperative_groups.h>

#include <mutex>
#include <unordered_map>

#include "attention_sm90.cuh"

namespace desta {

enum Epilogue { EPI_STORE = 0, EPI_RESID = 1, EPI_SWIGLU = 2,
                EPI_STORE_F32 = 3, EPI_BIAS = 4, EPI_BIAS_GELU = 5,
               EPI_ADD_F32 = 6, EPI_PEER_F32 = 7 };

constexpr int SKINNY_ROWS = 16;  // activation rows per pass

// The PEER_F32 epilogue's operands.  dst[d]: rank d's receive buffer [2, p,
// M, N] f32 and flags[d]: its flag words [2, p] (device tables of p
// pointers, the rank's own included); offset: this pass's first element in
// slot [slot][my], (slot * p + my) * M * N + m0 * N; flag: slot * p + my.
// Arrival: every CTA stores its outputs, fences them at system scope and
// counts itself in *counter; the CTA that makes the count reach `blocks`
// (all CTAs of all passes) resets the counter for the next use and, after
// another system-scope fence, release-stores the round's epoch, *base +
// round, into every rank's flag word.  base: the rank's step word on the
// device, filled by the host before each step (ops/tp_allreduce.py
// MeshBuffers.begin), read here after the epilogue's programmatic-launch
// wait; round: fixed per launch, so a CUDA graph's replays publish new
// epochs.  Epochs only grow (base advances by every step's rounds), so no
// flag is ever reset.
struct PeerStore {
  const unsigned long long* dst = nullptr;
  const unsigned long long* flags = nullptr;
  unsigned int* counter = nullptr;
  long long offset = 0;
  const long long* base = nullptr;
  long long round = 0;
  unsigned int blocks = 0;
  int p = 0;
  int flag = 0;
};

__device__ __forceinline__ void st_release_sys(long long* addr, long long v) {
  asm volatile("st.release.sys.global.b64 [%0], %1;" ::"l"(addr), "l"(v)
               : "memory");
}

// Called by every thread of a CTA after its epilogue stores.
__device__ __forceinline__ void peer_arrive(const PeerStore& ps) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(ps.counter, 1u) + 1u == ps.blocks) {
      __threadfence_system();
      atomicExch(ps.counter, 0u);
      const long long epoch = __ldcg(ps.base) + ps.round;
      for (int d = 0; d < ps.p; ++d)
        st_release_sys(reinterpret_cast<long long*>(ps.flags[d]) + ps.flag,
                       epoch);
    }
  }
}

// The epilogue of output element o = (row m, column n), from its scaled f32
// sums v (v[0]; SWIGLU: v[0] gate, v[1] up).  bias: the BIAS epilogues'.
template <int EPI>
__device__ __forceinline__ void skinny_epilogue(void* out, size_t o, int n,
                                                const float* v,
                                                const float* bias,
                                                const PeerStore& ps = {}) {
  if constexpr (EPI == EPI_PEER_F32) {
    for (int d = 0; d < ps.p; ++d)
      reinterpret_cast<float*>(ps.dst[d])[ps.offset + (long long)o] = v[0];
  } else if constexpr (EPI == EPI_STORE_F32) {
    static_cast<float*>(out)[o] = v[0];
  } else if constexpr (EPI == EPI_ADD_F32) {
    float* of = static_cast<float*>(out) + o;
    *of = __fadd_rn(*of, v[0]);
  } else {
    bf16* ob = static_cast<bf16*>(out) + o;
    if constexpr (EPI == EPI_STORE) {
      *ob = __float2bfloat16(v[0]);
    } else if constexpr (EPI == EPI_RESID) {
      *ob = __float2bfloat16(__bfloat162float(*ob) + round_bf16(v[0]));
    } else if constexpr (EPI == EPI_BIAS) {
      *ob = __float2bfloat16(__fadd_rn(v[0], bias[n]));
    } else if constexpr (EPI == EPI_BIAS_GELU) {
      const float y = round_bf16(__fadd_rn(v[0], bias[n]));
      *ob = __float2bfloat16(0.5f * y * (1.f + erff(y * 0.70710678118654752f)));
    } else {
      const float gt = round_bf16(v[0]);
      const float up = round_bf16(v[1]);
      const float act = round_bf16(gt / (1.f + expf(-gt)));
      *ob = __float2bfloat16(act * up);
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core GEMM
// ---------------------------------------------------------------------------

constexpr int SG_BN = 64;             // weight rows a CTA (4 x 16)
constexpr int SG_WARPS = 4;           // consumer warps, 16 weight rows each
constexpr int SG_THREADS = 32 * (SG_WARPS + 1);  // + the producer warp
constexpr int SG_STAGES = 4;
constexpr int SG_ROW_BYTES = 128;     // a weight row's bytes a stage (TMA box)
constexpr int SG_SPLITS_MAX = 8;      // the portable cluster size
constexpr int SG_CTAS_PER_SM = 2;     // planner: resident CTAs an SM to aim at
constexpr int SG_RED_LD = SKINNY_ROWS + 1;  // f32 partial tile row stride
constexpr int SG_MAX_DEVICES = 64;

// Per weight type: k-values a stage, mma k-steps a stage, and the padded
// byte stride of a staged x row (conflict-free B-fragment loads: rows 8
// banks apart for int8's 8-byte loads, 4 apart for bf16's 4-byte ones).
template <typename WT> struct SgTile {
  static constexpr int BK = SG_ROW_BYTES / (int)sizeof(WT);
  static constexpr int KSTEPS = BK / 16;
  static constexpr int XLD = BK * 2 + (sizeof(WT) == 1 ? 32 : 16);
};

// ns ranks (CTAs of a cluster) of tps k-tiles each over nkt k-tiles of
// SG_ROW_BYTES weight bytes, for each of `tiles` SG_BN-row tiles.
struct SkinnyPlan {
  int ns;
  int tps;
  int nkt;
  int tiles;
};

// The rule of ops/skinny_gemm.plan_skinny_gemm: as many ranks as bring the
// CTAs to SG_CTAS_PER_SM an SM (a CTA alone cannot keep an SM's share of
// the memory stream in flight), at most SG_SPLITS_MAX and at most one a
// k-tile, then evened out so that no rank is empty.  Reads the weight's
// rows (N, or 2N for SWIGLU), its row bytes and the SM count.
inline SkinnyPlan plan_skinny(long long rows, long long row_bytes, int n_sm) {
  const long long tiles = (rows + SG_BN - 1) / SG_BN;
  const int nkt = (int)((row_bytes + SG_ROW_BYTES - 1) / SG_ROW_BYTES);
  long long ns = ((long long)SG_CTAS_PER_SM * n_sm + tiles - 1) / tiles;
  if (ns > SG_SPLITS_MAX) ns = SG_SPLITS_MAX;
  if (ns > nkt) ns = nkt;
  if (ns < 1) ns = 1;
  const int tps = (int)((nkt + ns - 1) / ns);
  return {(nkt + tps - 1) / tps, tps, nkt, (int)tiles};
}

// Dynamic shared memory of a CTA: alignment, the weight ring, the x ring
// (8 * NT rows a stage), the f32 partial tile, the barriers.
template <typename WT>
inline size_t skinny_smem(int nt) {
  return 1024 + (size_t)SG_STAGES * SG_BN * SG_ROW_BYTES
         + (size_t)SG_STAGES * 8 * nt * SgTile<WT>::XLD
         + sizeof(float) * SG_BN * SG_RED_LD + 2 * SG_STAGES * sizeof(uint64_t);
}

// 1-D bulk copy global -> shared, completing on an mbarrier (16-byte
// aligned addresses, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Four int8 (bytes 0..3 of w) -> two bf16x2: lo = (b0, b1), hi = (b2, b3).
// Exact: each byte, offset to unsigned, becomes the f32 2^23 + u, from which
// 2^23 + 128 is subtracted; the integer's bf16 is the f32's upper half.
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i))
           - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// Fragments of k-step ks of a stage.  A: the warp's 16 weight rows r0..,
// from the 128B-swizzled tile (16-byte chunk c of row r at c ^ (r % 8)).
// B: x row `xr` (n = lane / 4).  int8 reads its k-step's 16 bytes with the
// k order permuted, identically for A and B (a sum over the same products):
// lane t's logical k {2t, 2t+1, 2t+8, 2t+9} are the bytes 4t..4t+3, so A is
// one 4-byte load a row and B one 8-byte load.  bf16 keeps the natural order
// (ldmatrix for A, two 4-byte loads for B).
template <typename WT>
__device__ __forceinline__ void load_a(uint32_t a[4], const uint8_t* wt,
                                       int r0, int ks, int lane) {
  if constexpr (sizeof(WT) == 1) {
    const int g = lane >> 2, t = lane & 3;
    const uint8_t* p = wt + (r0 + g) * SG_ROW_BYTES + ((ks ^ g) << 4) + 4 * t;
    s8x4_to_bf16x2(*reinterpret_cast<const uint32_t*>(p), a[0], a[2]);
    s8x4_to_bf16x2(*reinterpret_cast<const uint32_t*>(p + 8 * SG_ROW_BYTES),
                   a[1], a[3]);
  } else {
    const int r = r0 + (lane & 15);
    const int c = (2 * ks + (lane >> 4)) ^ (r & 7);
    ldmatrix_x4(a, sm90::smem_u32(wt + r * SG_ROW_BYTES + (c << 4)));
  }
}

template <typename WT>
__device__ __forceinline__ void load_b(uint32_t b[2], const uint8_t* xr,
                                       int ks, int t) {
  if constexpr (sizeof(WT) == 1) {
    const uint2 v = *reinterpret_cast<const uint2*>(xr + ks * 32 + 8 * t);
    b[0] = v.x;
    b[1] = v.y;
  } else {
    b[0] = *reinterpret_cast<const uint32_t*>(xr + ks * 32 + 4 * t);
    b[1] = *reinterpret_cast<const uint32_t*>(xr + ks * 32 + 16 + 4 * t);
  }
}

// One pass of M <= 8 * NT rows.  Grid: ns * tiles CTAs, clusters of ns
// along x (rank = k-range, cluster index = weight tile); tps k-tiles a
// rank.  wmap: the weight [rows, K] in boxes of SG_BN rows x 128 bytes.
template <typename WT, int NT, int EPI>
__global__ void __launch_bounds__(SG_THREADS)
skinny_gemm_kernel(const __grid_constant__ CUtensorMap wmap,
                   const bf16* __restrict__ x, const float* __restrict__ scale,
                   void* __restrict__ out, int M, int N, int K, int tps,
                   const float* __restrict__ bias, const PeerStore ps) {
  namespace cg = cooperative_groups;
  using T = SgTile<WT>;
  constexpr int NW = (EPI == EPI_SWIGLU) ? 2 : 1;  // weight rows per output
  constexpr int XROWS = 8 * NT;
  constexpr int WSTAGE = SG_BN * SG_ROW_BYTES;
  constexpr int XSTAGE = XROWS * T::XLD;
  extern __shared__ uint8_t sg_raw[];
  uint8_t* wring = sm90::aligned_smem(sg_raw);
  uint8_t* xring = wring + SG_STAGES * WSTAGE;
  float* red = reinterpret_cast<float*>(xring + SG_STAGES * XSTAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + SG_BN * SG_RED_LD);
  uint64_t* empty = full + SG_STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ns = (int)cluster.num_blocks();
  const int row0 = (int)(blockIdx.x / ns) * SG_BN;  // the tile's first row
  const int nkt = (K * (int)sizeof(WT) + SG_ROW_BYTES - 1) / SG_ROW_BYTES;
  const int kt0 = rank * tps;
  const int mine = min(nkt, kt0 + tps) - kt0;       // >= 1 by the plan
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == SG_WARPS * 32)  // the producer: the weight map, while we set up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&wmap) : "memory");

  // x past K in a ragged last k-tile meets weights read as 0; zeroing the
  // ring first keeps those products 0 (never 0 * NaN from stale memory)
  for (int i = tid; i < SG_STAGES * XSTAGE / 16; i += SG_THREADS)
    reinterpret_cast<uint4*>(xring)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < SG_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], SG_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  float acc[2][NT][4];  // two chains of k-steps (even, odd), added at the end
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;

  if (warp == SG_WARPS) {
    if (lane == 0) {  // the producer
      // stage i: one expect_tx for the weight tile and the rows' k-range
      auto xbytes = [&](int i) {
        return (uint32_t)min(T::BK, K - (kt0 + i) * T::BK) * 2u;
      };
      auto load_w = [&](int i) {
        const sm90::RingSlot<SG_STAGES> sl(i);
        uint64_t* bar = &full[sl.stage];
        sm90::mbar_expect_tx(bar, WSTAGE + (uint32_t)M * xbytes(i));
        sm90::tma_load_2d(wring + sl.stage * WSTAGE, &wmap, bar,
                          (kt0 + i) * T::BK, row0);
      };
      auto load_x = [&](int i) {
        const sm90::RingSlot<SG_STAGES> sl(i);
        uint8_t* xs = xring + sl.stage * XSTAGE;
        const size_t k0 = (size_t)(kt0 + i) * T::BK;
        for (int m = 0; m < M; ++m)
          bulk_load(xs + m * T::XLD, x + (size_t)m * K + k0, xbytes(i),
                    &full[sl.stage]);
      };
      // the first stages' weights before the wait: no kernel writes them
      const int early = min(mine, SG_STAGES);
      for (int i = 0; i < early; ++i) load_w(i);
      pdl_wait();
      for (int i = 0; i < early; ++i) load_x(i);
      for (int i = early; i < mine; ++i) {
        const sm90::RingSlot<SG_STAGES> sl(i);
        sm90::mbar_wait(&empty[sl.stage], sl.parity ^ 1u);
        load_w(i);
        load_x(i);
      }
    }
    __syncwarp();
  } else {  // the consumers: warp w owns weight rows 16w..16w+15
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < mine; ++i) {
      const sm90::RingSlot<SG_STAGES> sl(i);
      sm90::mbar_wait(&full[sl.stage], sl.parity);
      const uint8_t* wt = wring + sl.stage * WSTAGE;
      const uint8_t* xs = xring + sl.stage * XSTAGE;
#pragma unroll
      for (int ks = 0; ks < T::KSTEPS; ++ks) {
        uint32_t a[4];
        load_a<WT>(a, wt, warp * 16, ks, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[2];
          load_b<WT>(b, xs + (j * 8 + g) * T::XLD, ks, t);
          mma_bf16_16816(acc[ks & 1][j], a, b);
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[sl.stage]);
    }
    // the partial tile: c0,c1 (row g, x rows 2t, 2t+1), c2,c3 (row g + 8)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * 16 + g + (e >> 1) * 8) * SG_RED_LD + j * 8 + 2 * t
            + (e & 1)] = acc[0][j][e] + acc[1][j][e];
  }
  // the next kernel may start now: its CTAs find the SMs this grid leaves
  // as its CTAs finish (a trigger at the mainloop's start let them take
  // free slots early and ran the step 0.06-0.08 ms slower on the H100)
  pdl_launch_dependents();
  if (ns > 1) cluster.sync();
  else __syncthreads();
  pdl_wait();  // out (RESID / ADD_F32 read it) is a predecessor's

  // the tile's outputs: SG_BN / NW columns x M rows, the ranks taking
  // consecutive column ranges; each sums the ranks' partials in rank order
  constexpr int NO = SG_BN / NW;
  const int per = (NO + ns - 1) / ns;
  const int j0 = rank * per;
  const int cnt = max(0, min(NO, j0 + per) - j0) * M;
  const int n0 = row0 / NW;
  for (int it = tid; it < cnt; it += SG_THREADS) {
    const int j = j0 + it / M, m = it % M;
    const int n = n0 + j;
    if (n >= N) continue;
    float v[NW];
#pragma unroll
    for (int jj = 0; jj < NW; ++jj) {
      float* p = red + (j * NW + jj) * SG_RED_LD + m;
      float part[SG_SPLITS_MAX];  // every rank's load in flight at once
#pragma unroll
      for (int q = 0; q < SG_SPLITS_MAX; ++q)
        if (q < ns) part[q] = *cluster.map_shared_rank(p, q);
      float s = part[0];
#pragma unroll
      for (int q = 1; q < SG_SPLITS_MAX; ++q)
        if (q < ns) s = __fadd_rn(s, part[q]);
      if (scale != nullptr) s *= scale[(size_t)n * NW + jj];
      v[jj] = s;
    }
    skinny_epilogue<EPI>(out, (size_t)m * N + n, n, v, bias, ps);
  }
  if (ns > 1) cluster.sync();  // no CTA leaves while another reads its partials
  if constexpr (EPI == EPI_PEER_F32) peer_arrive(ps);
}

// The weight's tensor map: [rows, K] in boxes of box_rows rows (SG_BN here,
// K7's 128 in csrc/qmm.cu) x 128 bytes, 128B swizzle, zeros out of bounds.
// A map holds nothing but the address, the shape and the box, so the cache,
// keyed by all of them, can never hand out a stale one; it is cleared when
// it passes 4096 maps.
inline cudaError_t skinny_weight_map(const void* w, long long rows, int K,
                                     bool int8, CUtensorMap* map,
                                     int box_rows = SG_BN) {
  struct Key {
    const void* w;
    long long rows;
    int K;
    bool int8;
    int box_rows;
    bool operator==(const Key& o) const {
      return w == o.w && rows == o.rows && K == o.K && int8 == o.int8
             && box_rows == o.box_rows;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.w) ^ ((size_t)k.rows << 20)
             ^ ((size_t)k.K << 1) ^ (size_t)k.int8
             ^ ((size_t)k.box_rows << 40);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{w, rows, K, int8, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t esize = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(SG_ROW_BYTES / esize),
                             (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = fn(
      map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(w), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

// The plan a launch of this weight takes on the current device.
template <typename WT, int EPI>
inline SkinnyPlan skinny_plan(int N, int K) {
  constexpr int NW = (EPI == EPI_SWIGLU) ? 2 : 1;
  return plan_skinny((long long)N * NW, (long long)K * sizeof(WT),
                     sm_count());
}

template <typename WT, int NT, int EPI>
cudaError_t launch_skinny_pass(const CUtensorMap& map, const SkinnyPlan& p,
                               const bf16* x, const float* scale, void* out,
                               int M, int N, int K, const float* bias,
                               const PeerStore& ps, cudaStream_t stream) {
  auto kern = skinny_gemm_kernel<WT, NT, EPI>;
  const int smem = (int)skinny_smem<WT>(NT);
  // the dynamic shared-memory limit, raised once per device
  static bool raised[SG_MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0 || dev >= SG_MAX_DEVICES || !raised[dev]) {
    const cudaError_t e = sm90::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < SG_MAX_DEVICES) raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.ns * p.tiles));
  cfg.blockDim = dim3(SG_THREADS);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, map, x, scale, out, M,
                                           N, K, p.tps, bias, ps);
  if (e != cudaSuccess) return refuse(e);
  return cudaGetLastError();
}

// All M rows in passes of SKINNY_ROWS; K % (16 / sizeof(WT)) == 0 and
// 16-byte aligned x and w.  bias: N floats, read by the BIAS epilogues
// only; ps: PEER_F32's operands (out unused), each pass's offset and the
// CTA count set here.
template <typename WT, int EPI>
cudaError_t launch_skinny(const bf16* x, const WT* w, const float* scale,
                          void* out, int M, int N, int K,
                          cudaStream_t stream, const float* bias = nullptr,
                          PeerStore ps = PeerStore()) {
  constexpr int NW = (EPI == EPI_SWIGLU) ? 2 : 1;
  if (M < 1 || N < 1 || K < 1 || (K * sizeof(WT)) % 16
      || reinterpret_cast<uintptr_t>(x) % 16
      || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = skinny_weight_map(w, (long long)N * NW, K,
                                    sizeof(WT) == 1, &map);
  if (e != cudaSuccess) return e;
  const SkinnyPlan p = skinny_plan<WT, EPI>(N, K);
  const size_t out_bytes =
      (EPI == EPI_STORE_F32 || EPI == EPI_ADD_F32) ? sizeof(float) : sizeof(bf16);
  const long long offset0 = ps.offset;
  ps.blocks = (unsigned int)(p.ns * p.tiles)
              * (unsigned int)((M + SKINNY_ROWS - 1) / SKINNY_ROWS);
  for (int m0 = 0; m0 < M; m0 += SKINNY_ROWS) {
    const int mr = M - m0 < SKINNY_ROWS ? M - m0 : SKINNY_ROWS;
    const bf16* xm = x + (size_t)m0 * K;
    void* om = EPI == EPI_PEER_F32
                   ? out
                   : static_cast<char*>(out) + (size_t)m0 * N * out_bytes;
    ps.offset = offset0 + (long long)m0 * N;
    e = mr <= 8 ? launch_skinny_pass<WT, 1, EPI>(map, p, xm, scale, om, mr, N,
                                                 K, bias, ps, stream)
                : launch_skinny_pass<WT, 2, EPI>(map, p, xm, scale, om, mr, N,
                                                 K, bias, ps, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace desta
