// K11: causal flash attention with segment ids, forward and backward, for
// the cache-less LLM forward of the training step.
//
// Replaces: the library Pallas TPU kernel the JAX package calls from
//   desta25_audio_tpu/ops/attention.py:60 (mha -> jax.experimental.pallas.
//   ops.tpu.flash_attention, with its custom VJP: _flash_attention_kernel,
//   _flash_attention_dkv_kernel, _flash_attention_dq_kernel).
// Computes: q [B, T, H, Dh], k/v [B, T, Hkv, Dh] bf16 (GQA: query head h
//   reads kv head h / (H / Hkv)), segment ids [B, T] int32.  Query i attends
//   key j iff seg[i] == seg[j] and, when causal, j <= i; pad queries
//   (segment 0) attend pad keys, as the library kernel does.  Scores
//   s = (q . k) * scale in f32; o = softmax(s) v in bf16; the forward saves
//   lse = m + log(l) [B, H, T] f32.  The backward recomputes
//   P = exp(s - lse) with the same scale and mask and keeps the library
//   kernel's rounding points: dV += bf16(P)^T dO, dS = P (dO v^T - D) scale,
//   dK += bf16(dS)^T q, dQ += bf16(dS) k, all sums in f32, one rounding to
//   bf16 at the end; D = rowsum(dO * O) in f32 from the bf16 output.  The
//   forward rounds the unnormalised weights exp(s - m) to bf16 and divides
//   by the f32 sum at the end (FlashAttention-2); the library kernel's
//   single-block path normalises first, a difference of one bf16 rounding.
//   Exponentials are exp2 with log2 e folded into the scale.
// What bounds it on the H100: the bytes, just.  At the training shape
//   (B=4, T=512, H=32, Hkv=8, Dh=128, causal, one row padded from 400) the
//   forward moves ~42 MB (q and o 16.8 MB each, k and v 4.2 MB) and does
//   ~7.9 GFLOP on the 480,512 (query, key) pairs a head that the causal and
//   segment rules allow: 0.0126 ms at 3.35 TB/s against 0.008 ms at 989
//   TFLOP/s.  The backward moves ~84 MB (q, o, dO, dq; k, v, dk, dv) for
//   2.5x the operations: 0.0251 ms against 0.020 ms.  chip_smoke.py
//   computes both bounds from its inputs.  The [T, T] score matrix never
//   leaves registers.
// Design (Hopper: TMA, an mbarrier ring, wgmma; attention_sm90.cuh).  Every
//   tile load is a TMA copy through 4-D tensor maps over [B, T, heads, Dh]
//   (dims (Dh, heads, T, B), boxes (64, 1, 64, 1): a 256-byte Dh=128 row is
//   two 128-byte swizzle spans, so a tile is two column halves) or 1-D maps
//   over the segment ids, lse and D.  Blocks have 384 threads: two consumer
//   warpgroups and a producer warpgroup, one thread of which keeps the ring
//   full; setmaxnreg moves the producer's registers to the consumers (24
//   against 240: it moves them only within the block's own allocation, so
//   the producer is a whole warpgroup).  The grid's slowest dimension walks
//   the causal blocks from the longest down, so the long ones start first.
//   The mask costs more than the products when it is tested per element:
//   a warp reads a tile's segment ids once (a min and a max over the warp),
//   and only a tile of mixed segments, one that crosses T or one that
//   crosses the diagonal tests its elements.  No atomics anywhere: each
//   output element is summed by one thread, or by two in a fixed order, so
//   two runs give the same bits.
//   forward  one block per (128 query rows, head, batch); each warpgroup
//            owns 64 rows; k/v tiles of 128 keys and their segment ids
//            stream through a ring (2 stages at Dh=128, 3 at 64) up to the
//            block's diagonal tile; S = Q K^T by wgmma m64n128k16 (SS),
//            mask and online softmax in registers, O += bf16(P) V by wgmma
//            m64nDhk16 (RS, V MN-major).
//   delta    D = rowsum(dO * O), Dh / 8 lanes a (batch, row, head).
//   dK/dV    one block per (64 keys, kv head, batch); K and V stay in
//            shared memory; the q, dO, lse, D and segment-id tiles of 64
//            rows, over the G query heads of the kv head and the q tiles at
//            or below the diagonal, go to the two warpgroups in turn, each
//            through its own two stages of the ring.  S^T = K Q^T and
//            dP^T = V dO^T by wgmma m64n64k16 (SS), then dV += bf16(P^T) dO
//            and dK += bf16(dS^T) Q by wgmma RS (dO and Q read MN-major),
//            with P^T's exponentials under dP^T's product and dS^T under
//            dV's.  dK and dV stay in registers; at the end the second
//            warpgroup hands its sums to the first through shared memory,
//            which adds them to its own: the GQA sum needs no atomics.
//   dQ       one block per (128 query rows, head, batch), a warpgroup per
//            64 rows; Q, dO, lse, D stay; k/v tiles of 64 keys stream up to
//            the diagonal; S and dP by wgmma SS (P's exponentials under
//            dP's product), dQ += bf16(dS) K by wgmma RS (K read MN-major).

#include "attention_sm90.cuh"

namespace {

using namespace desta;
using namespace desta::sm90;

constexpr int THREADS = 384;   // 2 consumer warpgroups + 1 producer
constexpr int PRODUCER = 256;  // the thread that starts the TMA loads
constexpr float LOG2E = 1.4426950408889634f;

// A [ROWS, DH] tile of a (DH, heads, T, B) map at (head, t0, b), in boxes of
// 64 rows x 64 columns: column half c at c * ROWS * 64 elements.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int t0,
                                          int b) {
#pragma unroll
  for (int c = 0; c < DH / 64; ++c)
#pragma unroll
    for (int r = 0; r < ROWS / 64; ++r)
      tma_load_4d(dst + c * ROWS * 64 + r * 64 * 64, map, bar, c * 64, head,
                  t0 + 64 * r, b);
}

// Segment ids, lse and D are read through flat maps, up to 128 values of a
// row at a time, in one box of VEC from the 16-byte-aligned start at or
// below the first value wanted (a 1-D box starts on a 16-byte boundary):
// value j of a row read from c0 lands at (c0 & 3) + j.  A slot holds a box
// in shared memory at a 128-byte boundary, as every TMA destination must.
constexpr int VEC = 132;
constexpr int VEC_BYTES = VEC * 4;  // the bytes a load brings
constexpr int VSLOT = 160;          // 32-bit values between slots
constexpr int VSLOT_BYTES = VSLOT * 4;

__device__ __forceinline__ void load_vec(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0) {
  tma_load_1d(dst, map, bar, c0 & ~3);
}

// The smallest and largest of n segment ids in shared memory, over the
// warp (every lane of the warp calls it).
__device__ __forceinline__ void seg_range(const int* seg, int n, int& lo,
                                          int& hi) {
  int a = seg[threadIdx.x & 31], b = a;
  for (int j = (threadIdx.x & 31) + 32; j < n; j += 32) {
    a = min(a, seg[j]);
    b = max(b, seg[j]);
  }
  lo = __reduce_min_sync(0xffffffffu, a);
  hi = __reduce_max_sync(0xffffffffu, b);
}

// The mask of a tile whose rows are this thread's two queries and whose
// columns are n keys from k0 (the forward and dQ): query i keeps key j iff
// j < T, seg[i] == seg[j] and, when causal, j <= i.  `any` is false when
// it keeps every key for both rows; a tile of one segment compares the
// rows' segments once.
struct RowMask {
  bool any, mixed;
  bool same[2];  // one-segment tile: the row's segment is the tile's
  const int* sk;
  int k0, T, causal;
  int sq[2], rows[2];

  __device__ RowMask(const int* sk_, int n, int k0_, int T_, int causal_,
                     const int (&sq_)[2], const int (&rows_)[2])
      : sk(sk_), k0(k0_), T(T_), causal(causal_) {
    int lo, hi;
    seg_range(sk, n, lo, hi);
    mixed = lo != hi;
    for (int r = 0; r < 2; ++r) {
      sq[r] = sq_[r];
      rows[r] = rows_[r];
      same[r] = !mixed && sq[r] == lo;
    }
    any = mixed || !same[0] || !same[1] || k0 + n > T
          || (causal && k0 + n - 1 > rows[0]);
  }
  __device__ bool keep(int r, int col) const {
    const int key = k0 + col;
    return key < T && (!causal || key <= rows[r])
           && (mixed ? sk[col] == sq[r] : same[r]);
  }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DH>
struct FwdSmem {
  static constexpr int STAGES = DH == 128 ? 2 : 3;
  static constexpr int TILE = 128 * DH * 2;  // a [128, DH] tile
  static constexpr int SEGK = TILE * (1 + 2 * STAGES);
  static constexpr int SEGQ = SEGK + STAGES * VSLOT_BYTES;
  static constexpr int BARS = SEGQ + VSLOT_BYTES;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// A forward block's key tiles, as fwd_loop reads them: tile i holds keys
// 128 i.. of the ring's stage i % S with their segment ids.
template <int DH, int S>
struct FlashTiles {
  const bf16* ring;
  const int* segk;
  uint64_t* full;
  uint64_t* empty;
  int seg0, T, causal;  // seg0: the batch's first flat segment index
  int sq[2], rows[2];   // this thread's rows and their segments

  __device__ const bf16* k(int i) const {
    return ring + (i % S) * 2 * 128 * DH;
  }
  __device__ const bf16* v(int i) const { return k(i) + 128 * DH; }
  __device__ void wait(int i) const {
    mbar_wait(&full[i % S], (uint32_t)(i / S) & 1u);
  }
  __device__ void release(int i) const { mbar_arrive(&empty[i % S]); }
  __device__ RowMask mask(int i) const {
    return RowMask(segk + VSLOT * (i % S) + ((seg0 + 128 * i) & 3), 128,
                   128 * i, T, causal, sq, rows);
  }
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mseg,
                 bf16* __restrict__ o, float* __restrict__ lse, int T, int H,
                 int Hkv, int causal, float scale_log2) {
  using L = FwdSmem<DH>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* ring = Qs + 128 * DH;  // stage s: k at ring + 2 s 128 DH, v after
  int* segk = reinterpret_cast<int*>(sm + L::SEGK);  // VSLOT a stage
  int* segq = reinterpret_cast<int*>(sm + L::SEGQ);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 128;
  const int nt = ((causal ? min(T, q0 + 128) : T) + 127) / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == PRODUCER) {
      mbar_expect_tx(q_full, L::TILE + VEC_BYTES);
      load_tile<DH, 128>(Qs, &mq, q_full, h, q0, b);
      load_vec(segq, &mseg, q_full, b * T + q0);
      for (int i = 0; i < nt; ++i) {
        const RingSlot<S> slot(i);
        bf16* Ks = ring + slot.stage * 2 * 128 * DH;
        uint64_t* bar = &full[slot.stage];
        mbar_wait(&empty[slot.stage], slot.parity ^ 1);
        mbar_expect_tx(bar, 2 * L::TILE + VEC_BYTES);
        load_tile<DH, 128>(Ks, &mk, bar, hk, 128 * i, b);
        load_tile<DH, 128>(Ks + 128 * DH, &mv, bar, hk, 128 * i, b);
        load_vec(segk + VSLOT * slot.stage, &mseg, bar, b * T + 128 * i);
      }
    }
  } else {
    reg_alloc<240>();
    const int t = threadIdx.x & 127, g = (t & 31) >> 2, q = t & 3;
    const int qrow0 = 64 * wg, lr = qrow0 + (t >> 5) * 16 + g;
    const int rows[2] = {q0 + lr, q0 + lr + 8};
    mbar_wait(q_full, 0);
    const int* sqv = segq + ((b * T + q0) & 3);
    const FlashTiles<DH, S> tiles{ring,   segk,   full,
                                  empty,  b * T,  T,
                                  causal, {sqv[lr], sqv[lr + 8]},
                                  {rows[0], rows[1]}};
    FwdState<DH> st;
    st.init();
    fwd_loop<DH, 128>(st, Qs, qrow0, nt, scale_log2, tiles);
    for (int r = 0; r < 2; ++r) {
      const float l = st.row_sum(r);
      if (rows[r] >= T) continue;
      bf16* orow = o + (((size_t)b * T + rows[r]) * H + h) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * q) =
            __floats2bfloat162_rn(st.o[4 * j + 2 * r] / l,
                                  st.o[4 * j + 2 * r + 1] / l);
      if (q == 0)
        lse[((size_t)b * H + h) * T + rows[r]] =
            (st.m[r] * scale_log2 + log2f(l)) * 0.6931471805599453f;
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: DH / 8 lanes a row,
// 16 bytes a lane, a shuffle sum within the row's lanes.
template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int T, int H) {
  constexpr int LANES = DH / 8;
  const int r = (blockIdx.x * 256 + threadIdx.x) / LANES;
  const int c = (threadIdx.x % LANES) * 8;
  float acc = 0.f;
  if (r < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + (size_t)r * DH + c);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + (size_t)r * DH + c);
    const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(ap[i]), y = __bfloat1622float2(dp[i]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int m = LANES / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (r < rows && threadIdx.x % LANES == 0) {
    const int h = r % H, i = (r / H) % T, b = r / (H * T);
    delta[((size_t)b * H + h) * T + i] = acc;
  }
}

// P = exp(s scale - lse) where mk.keep(r, col) (everywhere when !mk.any),
// else 0, in place of the scores s.  lse2(r, col): the log-sum-exp of the
// column's (the dK/dV kernel's queries) or the row's (the dQ kernel's)
// query, in log2 units.
template <class Mask, class Lse>
__device__ __forceinline__ void bwd_p(float (&s)[32], float scale_log2,
                                      const Mask& mk, const Lse& lse2) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = 8 * j + 2 * q + (e & 1);
      const float p = fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse2(r, col)));
      s[4 * j + e] = !mk.any || mk.keep(r, col) ? p : 0.f;
    }
}

// dS = P (dP - D) scale in place of dP; del(r, col) as lse2 above.
template <class Del>
__device__ __forceinline__ void bwd_ds(float (&dp)[32], const float (&p)[32],
                                       float scale, const Del& del) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = 8 * j + 2 * q + (e & 1);
      dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - del(r, col)) * scale;
    }
}

// The mask of a dK/dV tile, whose rows are this thread's two keys and
// whose columns are 64 queries from qt0 (RowMask transposed).
struct ColMask {
  bool any, mixed;
  bool same[2];
  const int* segq;
  int qt0, T, causal;
  int sk[2], keys[2];

  __device__ ColMask(const int* segq_, int qt0_, int T_, int causal_,
                     const int (&sk_)[2], const int (&keys_)[2])
      : segq(segq_), qt0(qt0_), T(T_), causal(causal_) {
    int lo, hi;
    seg_range(segq, 64, lo, hi);
    mixed = lo != hi;
    for (int r = 0; r < 2; ++r) {
      sk[r] = sk_[r];
      keys[r] = keys_[r];
      same[r] = !mixed && sk[r] == lo;
    }
    any = mixed || !same[0] || !same[1] || qt0 + 64 > T || keys[1] >= T
          || (causal && keys[1] > qt0);
  }
  __device__ bool keep(int r, int col) const {
    const int qrow = qt0 + col;
    return keys[r] < T && qrow < T && (!causal || keys[r] <= qrow)
           && (mixed ? segq[col] == sk[r] : same[r]);
  }
};

template <int DH>
struct DkdvSmem {
  static constexpr int STAGES = 4;         // two for each warpgroup
  static constexpr int TILE = 64 * DH * 2;  // a [64, DH] tile
  static constexpr int RING = 2 * TILE;     // after the block's k and v
  static constexpr int SEGK = RING + STAGES * 2 * TILE;
  static constexpr int VECS = SEGK + VSLOT_BYTES;  // a stage: lse, D, segq
  static constexpr int BARS = VECS + STAGES * 3 * VSLOT_BYTES;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// Warpgroup w's m-th q tile is load 2 m + w of the block's sequence (the
// loads alternate), in stage 2 w + m % 2 of the ring: each warpgroup has
// stages of its own, so neither waits on a stage a whole phase early.
__device__ __forceinline__ void dkdv_slot(int w, int m, int& stage,
                                          uint32_t& parity) {
  stage = 2 * w + (m & 1);
  parity = (uint32_t)(m >> 1) & 1u;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo,
                      const __grid_constant__ CUtensorMap mseg,
                      const __grid_constant__ CUtensorMap mlse,
                      const __grid_constant__ CUtensorMap mdelta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                      int H, int Hkv, int causal, float scale) {
  using L = DkdvSmem<DH>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = Ks + 64 * DH;
  bf16* ring = reinterpret_cast<bf16*>(sm + L::RING);  // q, then dO
  int* segk = reinterpret_cast<int*>(sm + L::SEGK);
  float* vecs = reinterpret_cast<float*>(sm + L::VECS);  // 3 VSLOT a stage
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int hk = blockIdx.x, b = blockIdx.y, G = H / Hkv;
  const int k0 = blockIdx.z * 64;  // the longest causal blocks first
  const int qstart = causal ? k0 : 0;
  const int nq = (T - qstart + 63) / 64, loads = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // the owning warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == PRODUCER) {
      mbar_expect_tx(kv_full, 2 * L::TILE + VEC_BYTES);
      load_tile<DH, 64>(Ks, &mk, kv_full, hk, k0, b);
      load_tile<DH, 64>(Vs, &mv, kv_full, hk, k0, b);
      load_vec(segk, &mseg, kv_full, b * T + k0);
      for (int i = 0; i < loads; ++i) {
        int stage;
        uint32_t parity;
        dkdv_slot(i & 1, i >> 1, stage, parity);
        const int h = hk * G + i / nq, qt0 = qstart + 64 * (i % nq);
        bf16* Qs = ring + stage * 2 * 64 * DH;
        float* v = vecs + 3 * VSLOT * stage;
        uint64_t* bar = &full[stage];
        mbar_wait(&empty[stage], parity ^ 1);
        mbar_expect_tx(bar, 2 * L::TILE + 3 * VEC_BYTES);
        load_tile<DH, 64>(Qs, &mq, bar, h, qt0, b);
        load_tile<DH, 64>(Qs + 64 * DH, &mdo, bar, h, qt0, b);
        load_vec(v, &mlse, bar, (b * H + h) * T + qt0);
        load_vec(v + VSLOT, &mdelta, bar, (b * H + h) * T + qt0);
        load_vec(v + 2 * VSLOT, &mseg, bar, b * T + qt0);
      }
    }
  } else {
    reg_alloc<240>();
    const int t = threadIdx.x & 127, g = (t & 31) >> 2, q = t & 3;
    const int lk = (t >> 5) * 16 + g;
    const int keys[2] = {k0 + lk, k0 + lk + 8};
    const float scale_log2 = scale * LOG2E;
    mbar_wait(kv_full, 0);
    const int* skv = segk + ((b * T + k0) & 3);
    const int sk[2] = {skv[lk], skv[lk + 8]};
    float dka[DH / 2], dva[DH / 2];
    zero(dka);
    zero(dva);
    for (int m = 0; 2 * m + wg < loads; ++m) {
      const int i = 2 * m + wg;
      int stage;
      uint32_t parity;
      dkdv_slot(wg, m, stage, parity);
      const int h = hk * G + i / nq, qt0 = qstart + 64 * (i % nq);
      const bf16* Qs = ring + stage * 2 * 64 * DH;
      const bf16* Ds = Qs + 64 * DH;
      const float* v = vecs + 3 * VSLOT * stage;
      const float* lse_s = v + (((b * H + h) * T + qt0) & 3);
      const float* del_s = lse_s + VSLOT;
      const int* segq =
          reinterpret_cast<const int*>(v + 2 * VSLOT) + ((b * T + qt0) & 3);
      mbar_wait(&full[stage], parity);
      // S^T [64 keys, 64 queries] = K Q^T, dP^T = V dO^T as two groups
      float st[32], dpt[32];
      uint32_t ap[4][4], ad[4][4];
      zero(st);
      zero(dpt);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        Wgmma<64>::ss(st, desc_k<64>(Ks, 0, ks), desc_k<64>(Qs, 0, ks));
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        Wgmma<64>::ss(dpt, desc_k<64>(Vs, 0, ks), desc_k<64>(Ds, 0, ks));
      wgmma_commit();
      const ColMask mk(segq, qt0, T, causal, sk, keys);
      wgmma_wait<1>();
      fence_regs(st);
      // P^T = exp(S^T scale - lse); dV += bf16(P^T) dO
      bwd_p(st, scale_log2, mk, [&](int, int c) { return lse_s[c] * LOG2E; });
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(ap[kk], st + 8 * kk);
      fence_regs(dva);
      fence_regs(ap);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<DH>::rs(dva, ap[kk], desc_mn<64>(Ds, kk));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is in; dV may still run
      fence_regs(dpt);
      // dS^T = P^T (dP^T - D) scale; dK += bf16(dS^T) Q
      bwd_ds(dpt, st, scale, [&](int, int c) { return del_s[c]; });
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(ad[kk], dpt + 8 * kk);
      fence_regs(dka);
      fence_regs(ad);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<DH>::rs(dka, ad[kk], desc_mn<64>(Qs, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(ap);
      fence_regs(ad);
      mbar_arrive(&empty[stage]);
    }
    // the second warpgroup's sums, through its own (spent) stages, to the
    // first, which adds them to its own: dK = first + second, in that order
    float* hand = reinterpret_cast<float*>(ring + 2 * 2 * 64 * DH);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) {
        hand[j * 128 + t] = dka[j];
        hand[(DH / 2 + j) * 128 + t] = dva[j];
      }
    }
    named_barrier(1, 256);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < DH / 2; ++j) {
        dka[j] += hand[j * 128 + t];
        dva[j] += hand[(DH / 2 + j) * 128 + t];
      }
      for (int r = 0; r < 2; ++r) {
        if (keys[r] >= T) continue;
        const size_t off = (((size_t)b * T + keys[r]) * Hkv + hk) * DH;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const int col = 8 * j + 2 * q;
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
              __floats2bfloat162_rn(dka[4 * j + 2 * r],
                                    dka[4 * j + 2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
              __floats2bfloat162_rn(dva[4 * j + 2 * r],
                                    dva[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int DH>
struct DqSmem {
  static constexpr int STAGES = 3;
  static constexpr int QT = 128 * DH * 2;  // the block's q or dO tile
  static constexpr int KT = 64 * DH * 2;   // a streamed k or v tile
  static constexpr int RING = 2 * QT;
  static constexpr int VECS = RING + STAGES * 2 * KT;  // lse, D, segq
  static constexpr int SEGK = VECS + 3 * VSLOT_BYTES;  // VSLOT a stage
  static constexpr int BARS = SEGK + STAGES * VSLOT_BYTES;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mseg,
                    const __grid_constant__ CUtensorMap mlse,
                    const __grid_constant__ CUtensorMap mdelta,
                    bf16* __restrict__ dq, int T, int H, int Hkv, int causal,
                    float scale) {
  using L = DqSmem<DH>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Ds = Qs + 128 * DH;  // dO
  bf16* ring = reinterpret_cast<bf16*>(sm + L::RING);  // k, then v
  float* lse_s = reinterpret_cast<float*>(sm + L::VECS);
  float* del_s = lse_s + VSLOT;
  int* segq = reinterpret_cast<int*>(del_s + VSLOT);
  int* segk = reinterpret_cast<int*>(sm + L::SEGK);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 128;
  const int nk = ((causal ? min(T, q0 + 128) : T) + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == PRODUCER) {
      mbar_expect_tx(q_full, 2 * L::QT + 3 * VEC_BYTES);
      load_tile<DH, 128>(Qs, &mq, q_full, h, q0, b);
      load_tile<DH, 128>(Ds, &mdo, q_full, h, q0, b);
      load_vec(lse_s, &mlse, q_full, (b * H + h) * T + q0);
      load_vec(del_s, &mdelta, q_full, (b * H + h) * T + q0);
      load_vec(segq, &mseg, q_full, b * T + q0);
      for (int i = 0; i < nk; ++i) {
        const RingSlot<S> slot(i);
        bf16* Kt = ring + slot.stage * 2 * 64 * DH;
        uint64_t* bar = &full[slot.stage];
        mbar_wait(&empty[slot.stage], slot.parity ^ 1);
        mbar_expect_tx(bar, 2 * L::KT + VEC_BYTES);
        load_tile<DH, 64>(Kt, &mk, bar, hk, 64 * i, b);
        load_tile<DH, 64>(Kt + 64 * DH, &mv, bar, hk, 64 * i, b);
        load_vec(segk + VSLOT * slot.stage, &mseg, bar, b * T + 64 * i);
      }
    }
  } else {
    reg_alloc<240>();
    const int t = threadIdx.x & 127, g = (t & 31) >> 2, q = t & 3;
    const int qw = 64 * wg, lr = qw + (t >> 5) * 16 + g;
    const int rows[2] = {q0 + lr, q0 + lr + 8};
    const float scale_log2 = scale * LOG2E;
    mbar_wait(q_full, 0);
    const int lo = ((b * H + h) * T + q0) & 3, so = (b * T + q0) & 3;
    const int sq[2] = {segq[so + lr], segq[so + lr + 8]};
    const float lse2[2] = {lse_s[lo + lr] * LOG2E, lse_s[lo + lr + 8] * LOG2E};
    const float del[2] = {del_s[lo + lr], del_s[lo + lr + 8]};
    float dqa[DH / 2];
    zero(dqa);
    for (int i = 0; i < nk; ++i) {
      const RingSlot<S> slot(i);
      const int k0 = 64 * i;
      const bf16* Kt = ring + slot.stage * 2 * 64 * DH;
      const bf16* Vt = Kt + 64 * DH;
      const int* sk = segk + VSLOT * slot.stage + ((b * T + k0) & 3);
      mbar_wait(&full[slot.stage], slot.parity);
      if (!(causal && k0 > q0 + qw + 63)) {  // else wholly above the rows
        // S [64 rows, 64 keys] = Q K^T, dP = dO V^T as two groups
        float s[32], dp[32];
        uint32_t a[4][4];
        zero(s);
        zero(dp);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks)
          Wgmma<64>::ss(s, desc_k<128>(Qs, qw, ks), desc_k<64>(Kt, 0, ks));
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks)
          Wgmma<64>::ss(dp, desc_k<128>(Ds, qw, ks), desc_k<64>(Vt, 0, ks));
        wgmma_commit();
        const RowMask mk(sk, 64, k0, T, causal, sq, rows);
        wgmma_wait<1>();
        fence_regs(s);
        bwd_p(s, scale_log2, mk, [&](int r, int) { return lse2[r]; });
        wgmma_wait<0>();
        fence_regs(dp);
        // dS = P (dP - D) scale; dQ += bf16(dS) K
        bwd_ds(dp, s, scale, [&](int r, int) { return del[r]; });
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], dp + 8 * kk);
        fence_regs(dqa);
        fence_regs(a);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<DH>::rs(dqa, a[kk], desc_mn<64>(Kt, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        fence_regs(a);
      }
      mbar_arrive(&empty[slot.stage]);
    }
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= T) continue;
      bf16* qrow = dq + (((size_t)b * T + rows[r]) * H + h) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j + 2 * q) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// A (Dh, heads, T, B) map over a contiguous [B, T, heads, Dh] bf16 tensor.
cudaError_t map_bthd(CUtensorMap* m, const void* p, int B, int T, int heads,
                     int DH) {
  const cuuint64_t e = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads,
                              (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {DH * e, heads * DH * e,
                                 (cuuint64_t)T * heads * DH * e};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims, strides,
                  box);
}

// The maps every K11 kernel reads: q, k, v, dO, segment ids, lse, D (the
// forward leaves dO, lse and D unset).
struct Maps {
  CUtensorMap q, k, v, dout, seg, lse, delta;
  cudaError_t make(const void* q_, const void* k_, const void* v_,
                   const void* seg_, const void* dout_, const void* lse_,
                   const void* delta_, int B, int T, int H, int Hkv, int DH) {
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    cudaError_t e = cudaSuccess;
    if (e == cudaSuccess) e = map_bthd(&q, q_, B, T, H, DH);
    if (e == cudaSuccess) e = map_bthd(&k, k_, B, T, Hkv, DH);
    if (e == cudaSuccess) e = map_bthd(&v, v_, B, T, Hkv, DH);
    if (e == cudaSuccess)
      e = make_map_1d(&seg, CU_TENSOR_MAP_DATA_TYPE_INT32, seg_,
                      (size_t)B * T, VEC);
    if (dout_ == nullptr) return e;
    if (e == cudaSuccess) e = map_bthd(&dout, dout_, B, T, H, DH);
    if (e == cudaSuccess)
      e = make_map_1d(&lse, f32, lse_, (size_t)B * H * T, VEC);
    if (e == cudaSuccess)
      e = make_map_1d(&delta, f32, delta_, (size_t)B * H * T, VEC);
    return e;
  }
};

template <int DH>
int launch_fwd(const Maps& m, void* o, void* lse, int B, int T, int H,
               int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = FwdSmem<DH>::BYTES;
  const cudaError_t e = allow_smem(flash_fwd_kernel<DH>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (T + 127) / 128);
  flash_fwd_kernel<DH><<<grid, THREADS, smem, stream>>>(
      m.q, m.k, m.v, m.seg, (bf16*)o, (float*)lse, T, H, Hkv, causal,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkdv(const Maps& m, void* dk, void* dv, int B, int T, int H,
                int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = DkdvSmem<DH>::BYTES;
  const cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<DH>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hkv, B, (T + 63) / 64);
  flash_bwd_dkdv_kernel<DH><<<grid, THREADS, smem, stream>>>(
      m.q, m.k, m.v, m.dout, m.seg, m.lse, m.delta, (bf16*)dk, (bf16*)dv, T,
      H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dq(const Maps& m, void* dq, int B, int T, int H, int Hkv,
              int causal, float scale, cudaStream_t stream) {
  constexpr int smem = DqSmem<DH>::BYTES;
  const cudaError_t e = allow_smem(flash_bwd_dq_kernel<DH>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (T + 127) / 128);
  flash_bwd_dq_kernel<DH><<<grid, THREADS, smem, stream>>>(
      m.q, m.k, m.v, m.dout, m.seg, m.lse, m.delta, (bf16*)dq, T, H, Hkv,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int desta_flash_fwd(const void* q, const void* k, const void* v,
                               const void* seg, void* o, void* lse, int B,
                               int T, int H, int Hkv, int Dh, int causal,
                               float scale, void* stream) {
  if (Dh != 64 && Dh != 128) return (int)cudaErrorInvalidValue;
  Maps m;
  if (m.make(q, k, v, seg, nullptr, nullptr, nullptr, B, T, H, Hkv, Dh)
      != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return Dh == 128
             ? launch_fwd<128>(m, o, lse, B, T, H, Hkv, causal, scale, s)
             : launch_fwd<64>(m, o, lse, B, T, H, Hkv, causal, scale, s);
}

extern "C" int desta_flash_bwd_delta(const void* o, const void* dout,
                                     void* delta, int B, int T, int H, int Dh,
                                     void* stream) {
  const int rows = B * T * H;
  if (Dh != 64 && Dh != 128) return (int)cudaErrorInvalidValue;
  const int blocks = (rows * (Dh / 8) + 255) / 256;
  if (Dh == 128)
    flash_bwd_delta_kernel<128><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)o, (const bf16*)dout, (float*)delta, rows, T, H);
  else
    flash_bwd_delta_kernel<64><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)o, (const bf16*)dout, (float*)delta, rows, T, H);
  return (int)cudaGetLastError();
}

extern "C" int desta_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* seg,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    int B, int T, int H, int Hkv, int Dh,
                                    int causal, float scale, void* stream) {
  if (Dh != 64 && Dh != 128) return (int)cudaErrorInvalidValue;
  Maps m;
  if (m.make(q, k, v, seg, dout, lse, delta, B, T, H, Hkv, Dh) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return Dh == 128
             ? launch_dkdv<128>(m, dk, dv, B, T, H, Hkv, causal, scale, s)
             : launch_dkdv<64>(m, dk, dv, B, T, H, Hkv, causal, scale, s);
}

extern "C" int desta_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* seg, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  int B, int T, int H, int Hkv, int Dh,
                                  int causal, float scale, void* stream) {
  if (Dh != 64 && Dh != 128) return (int)cudaErrorInvalidValue;
  Maps m;
  if (m.make(q, k, v, seg, dout, lse, delta, B, T, H, Hkv, Dh) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return Dh == 128 ? launch_dq<128>(m, dq, B, T, H, Hkv, causal, scale, s)
                   : launch_dq<64>(m, dq, B, T, H, Hkv, causal, scale, s);
}
