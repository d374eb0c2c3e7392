// Weight-only int8 matmul at small M: out[m, n] = (sum_k bf16(x[m, k]) *
// q[n, k]) * s[n], f32 sum, the scale applied after the sum, output f32 or
// rounded once to bf16.
//
// Replaces: desta25_audio_tpu/ops/quant.py::_qmm_kernel (K7, the Pallas TPU
//   kernel of _qmm_dispatch at M < 128 rows): the LLM's prefill projections
//   of a short prompt, the int8 ORCA stack's injection projections and the
//   int8 LM head at every decode step.  Its block holds all M rows, so
//   every weight byte is read once per call; both paths here keep that.
// What bounds it on the H100: at M <= 16 device-memory bandwidth (2*M FLOP
//   per weight byte; the Llama-3.1-8B head is 535 MB of int8); towards
//   M = 127 the bf16 tensor cores nearly as much (254 FLOP/byte against the
//   295 FLOP/byte bf16 ridge; at M = 121 the operations are 0.86 of the
//   bytes' time, counting the x rows padded to 128).  As built the wgmma
//   path runs a Llama-3.1-8B layer's four products at M = 121 in 2.4x
//   their bound (bench_enc_gemm.py --k7-rows 121, cold L2): phase clocks
//   put the pace in the consumer warps' conversion and wgmma issue (~2,000
//   clocks a stage a warp against ~1,000 of tensor work a CTA), not in the
//   weight stream, which alone ran 1.7x its bound at this grid.
// Design (M picks the path, the caller never sees the difference):
//   * M <= 16: the skinny weight-streaming GEMM of csrc/skinny_gemm.cuh
//     (tensor cores with the weight as the M side, a TMA / bulk-copy ring,
//     K split across a cluster where the columns leave SMs idle), all rows
//     in one pass.
//   * 16 < M <= 128: wgmma with the int8 weight as the M side.  A CTA of
//     384 threads owns QMM_BW = 128 weight rows (output columns): two
//     consumer warpgroups of 64 rows each and a producer warpgroup, one
//     thread of which starts every load.  The M activation rows are
//     wgmma's N side, NX = 64 (M <= 64) or 128 wide (m64nNXk16), so a CTA
//     stages x's k-range once for all its 128 weight rows.
//   * K walks in k-tiles of 128 values through an mbarrier ring fed by one
//     producer thread (4 stages of 48 KB at NX = 128, 7 of 32 KB at NX =
//     64): a stage is one TMA box of the weight (128 rows x 128 bytes,
//     128B swizzle, the map cached per weight tensor) and two of x (NX rows
//     x 64 bf16; rows past M and values past K read as TMA's zeros).  (A
//     deeper weight ring beside a shorter x ring, a weight stage released
//     once converted, ran 5 % slower on the H100.)
//   * The weight is A from registers (wgmma RS) and x is B, K-major from
//     shared memory.  Each consumer thread reads its A fragment's int8
//     bytes from the swizzled weight tile (two 4-byte loads and a byte
//     permute a row and k-step) and converts them to bf16 pairs in
//     registers (exact: |q| <= 127 fits bf16's 8-bit significand; a byte
//     permute, two LOP3 and a bf16x2 add a pair, qmm_s8x2_to_bf16x2), two
//     k-steps ahead of the tensor cores: k-step s + 2's fragment is
//     converted while k-step s's wgmma runs (a stage's eight converted
//     before its first wgmma left the tensor cores idle during the
//     conversion; converting stage i + 1 between stage i's wgmma issues
//     made ptxas serialise the wgmmas, on the H100).  A stage's eight
//     wgmmas are one group, one group in flight; the A registers are
//     double-buffered across stages.
//   * K is split across a thread-block cluster of up to 8 CTAs where the
//     column tiles alone fill the card poorly (plan_qmm below: the fewest
//     cluster waves times a CTA's k-tiles, the rule of ops/qmm.plan_qmm;
//     it reads N, K and the SM count, never M).  Each rank writes its f32
//     partial tile to its own shared memory (the ring, no longer needed)
//     and, after a cluster barrier, each rank takes a slice of the rows and
//     sums every rank's partial through distributed shared memory in rank
//     order 0, 1, ... (fixed: two launches give the same bits).  The scale
//     and the one rounding run once, on the full sum, with the stores
//     along the output rows (4 columns a thread, 16-byte loads of each
//     rank's partials, two rows' loads in flight).  One launch a call;
//     nothing but the output is written to device memory.
// Requires K % 64 == 0, 16-byte aligned x and q; any N (the last column
// tile is masked).

#include <cooperative_groups.h>

#include "gemm_sm90.cuh"
#include "skinny_gemm.cuh"

namespace desta {

constexpr int QMM_BW = 128;          // weight rows (output columns) a CTA
constexpr int QMM_THREADS = 384;     // two consumer warpgroups + producer's
constexpr int QMM_K_BYTES = 128;     // a k-tile: 128 weight bytes a row
constexpr int QMM_KSTEPS = QMM_K_BYTES / 16;  // wgmma k16 steps a k-tile
constexpr int QMM_SPLITS_MAX = 8;    // the portable cluster size
constexpr int QMM_RING = 229376;     // the ring's shared memory
constexpr int QMM_RED_LD = QMM_BW + 4;  // f32 partial tile [NX][RED_LD]
constexpr int QMM_MAX_ROWS = 128;
// the planner's costs in k-tiles: a CTA's fixed part (ring fill, epilogue)
// and a split rank's more (the cluster's partial-tile sum)
constexpr int QMM_FIXED_KT = 2;
constexpr int QMM_SPLIT_KT = 2;

// Shared memory of a CTA: a ring of STAGES stages, each one weight box
// (128 rows x 128 bytes) and two x boxes (NX rows x 64 bf16), with a
// "full" and an "empty" mbarrier a stage.
template <int NX>
struct QmmTile {
  static constexpr int W_BYTES = QMM_BW * QMM_K_BYTES;   // 16 KB
  static constexpr int X_BYTES = NX * 2 * QMM_K_BYTES;   // two x boxes
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
  static constexpr int STAGES = QMM_RING / STAGE_BYTES;  // 4 (NX 128), 7 (64)
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(NX * QMM_RED_LD * 4 <= STAGES * STAGE_BYTES,
                "the partial tile reuses the ring");
  static_assert(SMEM <= 232448, "a CTA's shared memory");
};

// CTAs the card runs at once in clusters of s CTAs of this kernel, one CTA
// an SM: on the H100 SXM (132 SMs) a cluster lives in one GPC, whose SM
// counts are not all multiples of 3..8 (ops/gemm.H100_CLUSTER_CTAS, the
// same occupancy; chip_smoke.py holds this kernel to it)
inline int qmm_cluster_ctas(int s, int n_sm) {
  if (n_sm == 132) {
    switch (s) {
      case 3: return 117;
      case 4: return 120;
      case 5: return 110;
      case 6: return 102;
      case 7: return 105;
      case 8: return 120;
      default: break;
    }
  }
  return n_sm / s * s;
}

// nx-wide x side; `splits` ranks of `tps` k-tiles each over nkt k-tiles of
// QMM_K_BYTES, for each of `tiles` QMM_BW-row weight tiles
struct QmmPlan {
  int nx;
  int splits;
  int tps;
  int nkt;
  int tiles;
};

// The rule of ops/qmm.plan_qmm: nx from M; the split minimising the
// cluster waves times a CTA's k-tiles (tps + QMM_FIXED_KT, + QMM_SPLIT_KT
// when split) among the splits of 1..QMM_SPLITS_MAX that leave no rank
// empty, ties to fewer ranks.  Reads M only for nx.
inline QmmPlan plan_qmm(int M, int N, int K, int n_sm) {
  const long long tiles = (N + QMM_BW - 1) / QMM_BW;
  const int nkt = (K + QMM_K_BYTES - 1) / QMM_K_BYTES;
  QmmPlan best{M <= 64 ? 64 : 128, 1, nkt, nkt, (int)tiles};
  long long best_cost = -1;
  for (int s = 1; s <= QMM_SPLITS_MAX && s <= nkt; ++s) {
    const int tps = (nkt + s - 1) / s;
    if ((nkt + tps - 1) / tps != s) continue;   // an empty rank
    const long long slots = qmm_cluster_ctas(s, n_sm);
    if (slots < 1) continue;
    const long long waves = (tiles * s + slots - 1) / slots;
    const long long cost =
        waves * (tps + QMM_FIXED_KT + (s > 1 ? QMM_SPLIT_KT : 0));
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best.splits = s;
      best.tps = tps;
    }
  }
  return best;
}

// Two int8 of w, picked by sel into the low bytes of the halves (0x00b1
// 0x00b0), as bf16x2, exactly: (128 + (b & 127)) - (128 + 128 s) with s
// the sign bit, both terms bf16 by their bits (exponent 2^7, the low seven
// bits as the significand; 0xC380 = -256), one bf16x2 add.
__device__ __forceinline__ uint32_t qmm_s8x2_to_bf16x2(uint32_t w,
                                                       uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0u, sel);
  const uint32_t mag = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (p & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(mag), "r"(0x3F803F80u), "r"(off));
  return d;
}

// The A fragment of k-step ks for rows r and r + 8 of the weight tile (wr:
// row r's first byte; r % 8 == g): a0 (r, k 2t..2t+1), a1 (r+8, 2t..),
// a2 (r, 2t+8..), a3 (r+8, 2t+8..), in bf16.  The k-step's 16 bytes are
// chunk ks ^ g of the row (128B swizzle); lane t's bytes 2t, 2t+1 and
// 2t+8, 2t+9 lie in the 4-byte words at cofs = 4 (t / 2) and cofs + 8, in
// their low (t even: sel 0x4140) or high half (0x4342).
__device__ __forceinline__ void qmm_load_a(uint32_t (&a)[4],
                                           const uint8_t* wr, int ks, int g,
                                           int cofs, uint32_t sel) {
  const uint8_t* p0 = wr + ((ks ^ g) << 4) + cofs;
  const uint8_t* p1 = p0 + 8 * QMM_K_BYTES;
  a[0] = qmm_s8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p0), sel);
  a[2] = qmm_s8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p0 + 8), sel);
  a[1] = qmm_s8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p1), sel);
  a[3] = qmm_s8x2_to_bf16x2(*reinterpret_cast<const uint32_t*>(p1 + 8), sel);
}

// Grid: splits * tiles CTAs in clusters of `splits` along x (rank = the
// k-range, cluster index = the weight tile).  wmap: q [N, K] in boxes of
// QMM_BW rows x 128 bytes; xmap: x [M, K] in boxes of NX rows x 64 bf16.
template <int NX>
__global__ void __launch_bounds__(QMM_THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int M, int N, int K, int tps, int out_f32) {
  using namespace sm90;
  using TL = QmmTile<NX>;
  constexpr int STAGES = TL::STAGES;
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t qmm_raw[];
  uint8_t* ring = aligned_smem(qmm_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * TL::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ns = (int)cluster.num_blocks();
  const int n0 = (int)(blockIdx.x / ns) * QMM_BW;
  const int nkt = (K + QMM_K_BYTES - 1) / QMM_K_BYTES;
  const int kt0 = rank * tps;
  const int nk = min(nkt, kt0 + tps) - kt0;   // >= 1 by the plan
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 256) {  // the producer: the maps, while the barriers are set up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&wmap) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&xmap) : "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // the consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (tid == 256) {
      for (int i = 0; i < nk; ++i) {
        const RingSlot<STAGES> sl(i);
        uint8_t* st = ring + sl.stage * TL::STAGE_BYTES;
        uint8_t* xs = st + TL::W_BYTES;
        const int k = (kt0 + i) * QMM_K_BYTES;
        mbar_wait(&empty[sl.stage], sl.parity ^ 1u);
        mbar_expect_tx(&full[sl.stage], TL::STAGE_BYTES);
        tma_load_2d(st, &wmap, &full[sl.stage], k, n0);
        tma_load_2d(xs, &xmap, &full[sl.stage], k, 0);
        tma_load_2d(xs + NX * 128, &xmap, &full[sl.stage], k + 64, 0);
      }
    }
  } else {
    // consumer warpgroup wg: weight rows 64 wg.. of the tile; this thread's
    // rows wrow and wrow + 8, x rows (the accumulator's columns) 8 j + 2 t
    const int w = (tid & 127) >> 5, g = lane >> 2, t = lane & 3;
    const int wrow = wg * 64 + w * 16 + g;
    const uint32_t sel = (t & 1) ? 0x4342u : 0x4140u;
    const int cofs = 4 * (t >> 1);
    float acc[NX / 2];
    zero(acc);
    uint32_t a0[QMM_KSTEPS][4], a1[QMM_KSTEPS][4];
    // stage i's group: each k-step's A fragment is read and converted two
    // k-steps ahead, while the wgmmas before it run on the tensor cores (an
    // RS wgmma's issue waits for room in the tensor cores' queue, so
    // converting a whole stage ahead left them idle meanwhile)
    auto stage = [&](uint32_t (&a)[QMM_KSTEPS][4], int i) {
      const RingSlot<STAGES> sl(i);
      mbar_wait(&full[sl.stage], sl.parity);
      const uint8_t* st = ring + sl.stage * TL::STAGE_BYTES;
      const uint8_t* wr = st + wrow * QMM_K_BYTES;
      const bf16* xs = reinterpret_cast<const bf16*>(st + TL::W_BYTES);
      fence_regs(acc);
      qmm_load_a(a[0], wr, 0, g, cofs, sel);
      qmm_load_a(a[1], wr, 1, g, cofs, sel);
#pragma unroll
      for (int ks = 0; ks < QMM_KSTEPS; ++ks) {
        asm volatile("" : "+r"(a[ks][0]), "+r"(a[ks][1]), "+r"(a[ks][2]),
                     "+r"(a[ks][3])::"memory");
        wgmma_fence();  // a[ks] was written since the last wgmma
        Wgmma<NX>::rs_k(acc, a[ks], desc_k<NX>(xs, 0, ks));
        if (ks + 2 < QMM_KSTEPS)
          qmm_load_a(a[ks + 2], wr, ks + 2, g, cofs, sel);
      }
      wgmma_commit();
    };
    auto release = [&](int i) {  // stage i's group has completed
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % STAGES]);
    };
    // one group in flight; a register buffer is rewritten only after the
    // group that read it has completed
    for (int i = 0; i < nk; i += 2) {
      stage(a0, i);
      if (i > 0) {
        wgmma_wait<1>();  // group i - 1 (a1) done
        release(i - 1);
      }
      if (i + 1 >= nk) break;
      stage(a1, i + 1);
      wgmma_wait<1>();    // group i (a0) done
      release(i);
    }
    wgmma_wait<0>();
    release(nk - 1);

    // the partial tile, [x row m][weight row n]: acc[4 j + e] is weight row
    // wrow + 8 (e >> 1), x row 8 j + 2 t + (e & 1)
    named_barrier(1, 256);  // both consumer warpgroups are done with the ring
    float* red = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int j = 0; j < NX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * j + 2 * t + (e & 1)) * QMM_RED_LD + wrow + 8 * (e >> 1)] =
            acc[4 * j + e];
  }
  if (ns > 1) cluster.sync();
  else __syncthreads();

  // rank r sums rows r * per.. over the ranks' partials in rank order; a
  // thread takes 4 columns (a 16-byte load from each rank's tile) of every
  // 12th row, two rows' loads in flight at once
  const float* red = reinterpret_cast<const float*>(ring);
  const int per = (M + ns - 1) / ns;
  const int m0 = rank * per, m1 = min(M, m0 + per);
  const int j = 4 * (tid & 31), n = n0 + j;
  constexpr int RL = QMM_THREADS / 32;  // rows a pass
  float sc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[e] = n + e < N ? scale[n + e] : 0.f;
  const bool vec = (N & 3) == 0 && n + 3 < N;
  auto sum_row = [&](int m, float (&v)[4]) {
    const float* p = red + m * QMM_RED_LD + j;
    float4 part[QMM_SPLITS_MAX];  // every rank's load in flight at once
#pragma unroll
    for (int r = 0; r < QMM_SPLITS_MAX; ++r)
      if (r < ns)
        part[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(p, r));
    v[0] = part[0].x;
    v[1] = part[0].y;
    v[2] = part[0].z;
    v[3] = part[0].w;
#pragma unroll
    for (int r = 1; r < QMM_SPLITS_MAX; ++r)
      if (r < ns) {
        v[0] = __fadd_rn(v[0], part[r].x);
        v[1] = __fadd_rn(v[1], part[r].y);
        v[2] = __fadd_rn(v[2], part[r].z);
        v[3] = __fadd_rn(v[3], part[r].w);
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(v[e], sc[e]);
  };
  auto store_row = [&](int m, const float (&v)[4]) {
    const size_t o = (size_t)m * N + n;
    if (out_f32) {
      float* of = static_cast<float*>(out) + o;
      if (vec) {
        *reinterpret_cast<float4*>(of) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) of[e] = v[e];
      }
    } else {
      bf16* ob = static_cast<bf16*>(out) + o;
      if (vec) {
        *reinterpret_cast<uint2*>(ob) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) ob[e] = __float2bfloat16(v[e]);
      }
    }
  };
  if (n < N) {
    for (int m = m0 + (tid >> 5); m < m1; m += 2 * RL) {
      float v0[4], v1[4];
      const bool two = m + RL < m1;
      sum_row(m, v0);
      if (two) sum_row(m + RL, v1);
      store_row(m, v0);
      if (two) store_row(m + RL, v1);
    }
  }
  if (ns > 1) cluster.sync();  // no CTA leaves while another reads its tile
}

template <int NX>
cudaError_t qmm_configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          int splits, dim3 grid, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0 || dev >= kMaxDevices || !raised[dev]) {
    const cudaError_t e =
        sm90::allow_smem(qmm_wgmma_kernel<NX>, QmmTile<NX>::SMEM);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < kMaxDevices) raised[dev] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(QMM_THREADS);
  cfg->dynamicSmemBytes = QmmTile<NX>::SMEM;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int NX>
cudaError_t launch_qmm_wgmma(const bf16* x, const int8_t* w, const float* s,
                             void* out, int M, int N, int K,
                             const QmmPlan& p, int out_f32,
                             cudaStream_t st) {
  CUtensorMap wmap, xmap;
  cudaError_t e = skinny_weight_map(w, N, K, true, &wmap, QMM_BW);
  if (e == cudaSuccess) e = gemm::make_kmajor_map(&xmap, false, x, M, K, NX);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  e = qmm_configure<NX>(&cfg, attr, p.splits,
                        dim3((unsigned)(p.splits * p.tiles)), st);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, qmm_wgmma_kernel<NX>, wmap, xmap, s, out, M,
                         N, K, p.tps, out_f32);
  if (e != cudaSuccess) return refuse(e);
  return cudaGetLastError();
}

}  // namespace desta

using namespace desta;

// x bf16 [M, K], q int8 [N, K], s f32 [N] -> out [M, N] (f32 if out_f32,
// else bf16).  M <= 16: the skinny path; 16 < M <= 128: the wgmma kernel
// with plan_qmm's split, or `splits` ranks when splits > 0 (a sweep's
// choice; refused if it leaves a rank empty).
extern "C" int desta_qmm(const void* x, const void* q, const void* s,
                         void* out, int M, int N, int K, int splits,
                         int out_f32, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  const int8_t* w = (const int8_t*)q;
  const float* sc = (const float*)s;
  if (M < 1 || M > QMM_MAX_ROWS || N < 1 || K < 64 || K % 64 != 0
      || splits < 0 || splits > QMM_SPLITS_MAX
      || reinterpret_cast<uintptr_t>(x) % 16
      || reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  if (M <= SKINNY_ROWS) {
    return (int)(out_f32
        ? launch_skinny<int8_t, EPI_STORE_F32>(xb, w, sc, out, M, N, K, st)
        : launch_skinny<int8_t, EPI_STORE>(xb, w, sc, out, M, N, K, st));
  }
  QmmPlan p = plan_qmm(M, N, K, sm_count());
  if (splits > 0) {
    const int tps = (p.nkt + splits - 1) / splits;
    if ((p.nkt + tps - 1) / tps != splits) return (int)cudaErrorInvalidValue;
    p.splits = splits;
    p.tps = tps;
  }
  return (int)(p.nx == 64
      ? launch_qmm_wgmma<64>(xb, w, sc, out, M, N, K, p, out_f32, st)
      : launch_qmm_wgmma<128>(xb, w, sc, out, M, N, K, p, out_f32, st));
}

// out[5] = the plan of a 16 < M <= 128 call on a card of n_sm SMs (the
// current device's when n_sm <= 0): nx, splits, k-tiles a rank, k-tiles,
// weight tiles (ops/qmm.plan_qmm is the same rule)
extern "C" int desta_qmm_plan(int M, int N, int K, int n_sm, void* out) {
  if (M <= SKINNY_ROWS || M > QMM_MAX_ROWS || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const QmmPlan p = plan_qmm(M, N, K, n_sm > 0 ? n_sm : sm_count());
  int* o = static_cast<int*>(out);
  o[0] = p.nx;
  o[1] = p.splits;
  o[2] = p.tps;
  o[3] = p.nkt;
  o[4] = p.tiles;
  return 0;
}

// out[1] = how many clusters of `splits` CTAs of the nx-wide kernel the
// current device runs at once (cudaOccupancyMaxActiveClusters)
extern "C" int desta_qmm_max_clusters(int nx, int splits, void* out) {
  if (splits < 1 || splits > QMM_SPLITS_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const dim3 grid((unsigned)(splits * 132));
  cudaError_t e = cudaErrorInvalidValue;
  if (nx == 64) {
    e = qmm_configure<64>(&cfg, attr, splits, grid, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(static_cast<int*>(out),
                                         qmm_wgmma_kernel<64>, &cfg);
  } else if (nx == 128) {
    e = qmm_configure<128>(&cfg, attr, splits, grid, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(static_cast<int*>(out),
                                         qmm_wgmma_kernel<128>, &cfg);
  }
  return (int)(e == cudaSuccess ? e : refuse(e));
}
