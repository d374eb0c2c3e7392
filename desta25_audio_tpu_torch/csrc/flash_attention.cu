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
// What bounds it on the H100: the bytes, just.  At the training shape
//   (B=4, T=512, H=32, Hkv=8, Dh=128, causal, one row padded from 400) the
//   forward moves ~42 MB (q and o 16.8 MB each, k and v 4.2 MB) and does
//   ~7.9 GFLOP on the 480,512 (query, key) pairs a head that the causal and
//   segment rules allow: 0.0126 ms at 3.35 TB/s against 0.008 ms at 989
//   TFLOP/s.  The backward moves ~84 MB (q, o, dO, dq; k, v, dk, dv) for
//   2.5x the operations: 0.0251 ms against 0.020 ms.  chip_smoke.py
//   computes both bounds from its inputs and reports bound_by "bytes".  The
//   [T, T] score matrix never leaves registers.
// Design (mma.sync m16n8k16, bf16 in, f32 accumulate, 4 warps a block):
//   forward  one block per (q tile of 64 rows, head, batch); each warp keeps
//            its 16 rows' q fragments, running max and sum and the [16, Dh]
//            accumulator in registers and walks the key tiles of 64 staged
//            in shared memory with an online softmax; tiles above the
//            diagonal are skipped, the segment and bounds tests run per
//            element (T need not be a multiple of 64).
//   delta    one warp per (batch, row, head): D = rowsum(dO * O).
//   dK/dV    one block per (k tile of 64 keys, kv head, batch); each warp
//            owns 16 keys and keeps their [16, Dh] dK and dV sums in
//            registers while the block loops over the G query heads of its
//            kv head and over the q tiles at or below the diagonal; S^T,
//            P^T and dP^T are formed with the keys as rows, so the GQA sum
//            needs no atomics and is deterministic.
//   dQ       one block per (q tile of 64 rows, head, batch), looping over
//            the key tiles at or below the diagonal.
//   Shared-memory rows are padded by 8 bf16 (a 16-byte shift) so the
//   fragment loads of the 256-byte Dh=128 rows hit 32 distinct banks.
// Left for later PRs: wgmma/TMA pipelines, warp specialisation, a split of
//   the long early k tiles of dK/dV across blocks.

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block (4 warps x 16)
constexpr int BK = 64;  // keys per tile

// [64, DH] rows r0.. of a strided [T, stride] bf16 matrix into shared
// memory (row stride DH + 8); rows at or past T are zero.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int r0,
                                          int T, size_t stride) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

__device__ __forceinline__ void load_seg(int* s, const int* g, int r0, int T) {
  for (int i = threadIdx.x; i < 64; i += blockDim.x)
    s[i] = r0 + i < T ? g[r0 + i] : 0;
}

// A fragment (16 rows from `row0`, 16 columns from `col0`) of a shared
// [.., LD] bf16 matrix stored row-major.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int row0,
                                       int col0, int g, int t) {
  a[0] = *reinterpret_cast<const uint32_t*>(s + (row0 + g) * LD + col0 + 2 * t);
  a[1] = *reinterpret_cast<const uint32_t*>(s + (row0 + g + 8) * LD + col0 + 2 * t);
  a[2] = *reinterpret_cast<const uint32_t*>(s + (row0 + g) * LD + col0 + 2 * t + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(s + (row0 + g + 8) * LD + col0 + 2 * t + 8);
}

// B fragment (k = 16 columns from `col0`, n = 8 rows from `row0`) of a
// shared matrix whose rows are the n index: B = M^T.
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t b[2], const bf16* s, int row0,
                                        int col0, int g, int t) {
  b[0] = *reinterpret_cast<const uint32_t*>(s + (row0 + g) * LD + col0 + 2 * t);
  b[1] = *reinterpret_cast<const uint32_t*>(s + (row0 + g) * LD + col0 + 2 * t + 8);
}

// B fragment (k = 16 rows from `row0`, n = 8 columns from `col0`) of a
// shared matrix whose rows are the k index: B = M.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* s, int row0,
                                       int col0, int g, int t) {
  const int r = row0 + 2 * t, c = col0 + g;
  b[0] = desta::pack_raw(s[r * LD + c], s[(r + 1) * LD + c]);
  b[1] = desta::pack_raw(s[(r + 8) * LD + c], s[(r + 9) * LD + c]);
}

// The accumulators of n-tiles 2j and 2j+1 (16 columns) as one A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = desta::pack_bf16(lo[0], lo[1]);
  a[1] = desta::pack_bf16(lo[2], lo[3]);
  a[2] = desta::pack_bf16(hi[0], hi[1]);
  a[3] = desta::pack_bf16(hi[2], hi[3]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ o, float* __restrict__ lse, int T, int H,
                 int Hkv, int causal, float scale) {
  using namespace desta;
  constexpr int LD = DH + 8;
  __shared__ __align__(16) bf16 Ks[BK * LD];
  __shared__ __align__(16) bf16 Vs[BK * LD];
  __shared__ int segk[BK];

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt0 = blockIdx.x * BQ, q0 = qt0 + warp * 16;
  const size_t qstride = (size_t)H * DH, kstride = (size_t)Hkv * DH;
  const bf16* qb = q + ((size_t)b * T * H + h) * DH;
  const bf16* kb = k + ((size_t)b * T * Hkv + hk) * DH;
  const bf16* vb = v + ((size_t)b * T * Hkv + hk) * DH;
  const int* sb = seg + (size_t)b * T;

  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + g + (r & 1) * 8;
      const int col = ks * 16 + 2 * t + (r >> 1) * 8;
      qf[ks][r] = row < T ? *reinterpret_cast<const uint32_t*>(
                                qb + (size_t)row * qstride + col)
                          : 0u;
    }
  const int rows[2] = {q0 + g, q0 + g + 8};
  const int segq[2] = {rows[0] < T ? sb[rows[0]] : 0,
                       rows[1] < T ? sb[rows[1]] : 0};

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int kend = causal ? min(T, qt0 + BQ) : T;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<DH>(Ks, kb, k0, T, kstride);
    load_tile<DH>(Vs, vb, k0, T, kstride);
    load_seg(segk, sb, k0, T);
    __syncthreads();
    if (causal && k0 > q0 + 15) continue;  // the whole tile is above the diagonal

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t bb[2];
        load_bt<LD>(bb, Ks, nt * 8, ks * 16, g, t);
        mma_bf16_16816(s[nt], qf[ks], bb);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = nt * 8 + 2 * t + (j & 1), key = k0 + kj;
        const int i = j >> 1;
        const bool ok = key < T && segk[kj] == segq[i]
                        && (!causal || key <= rows[i]);
        s[nt][j] = ok ? s[nt][j] * scale : -INFINITY;
      }
    }

    // online softmax; a row whose keys in this tile are all masked keeps
    // its state (base 0 avoids inf - inf)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float base = mx == -INFINITY ? 0.f : mx;
      const float corr = expf(m_run[i] - base);
      m_run[i] = mx;
      l_run[i] *= corr;
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        acc[dt][2 * i] *= corr;
        acc[dt][2 * i + 1] *= corr;
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const float e0 = expf(s[nt][2 * i] - base);
        const float e1 = expf(s[nt][2 * i + 1] - base);
        l_run[i] += e0 + e1;
        s[nt][2 * i] = e0;
        s[nt][2 * i + 1] = e1;
      }
    }

    // O += bf16(P) V
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      acc_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        uint32_t bb[2];
        load_b<LD>(bb, Vs, 16 * j, dt * 8, g, t);
        mma_bf16_16816(acc[dt], a, bb);
      }
    }
  }

  bf16* ob = o + ((size_t)b * T * H + h) * DH;
  float* lb = lse + ((size_t)b * H + h) * T;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = rows[i];
    if (row < T) {
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        const int col = dt * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * qstride + col) =
            __floats2bfloat162_rn(acc[dt][2 * i] / l, acc[dt][2 * i + 1] / l);
      }
      if (t == 0) lb[row] = m_run[i] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp per row.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int T, int H,
                       int DH) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  const bf16* ob = o + (size_t)r * DH;
  const bf16* db = dout + (size_t)r * DH;
  float acc = 0.f;
  for (int d = 2 * lane; d < DH; d += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(ob + d));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(db + d));
    acc += a.x * c.x + a.y * c.y;
  }
  acc = desta::warp_sum(acc);
  if (lane == 0) {
    const int h = r % H, i = (r / H) % T, b = r / (H * T);
    delta[((size_t)b * H + h) * T + i] = acc;
  }
}

template <int DH>
constexpr int bwd_smem_bytes() {
  return 4 * 64 * (DH + 8) * 2 + 4 * 64 * 4;
}

template <int DH>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ seg,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int T, int H, int Hkv, int causal,
                      float scale) {
  using namespace desta;
  constexpr int LD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + 64 * LD;
  bf16* Qs = Vs + 64 * LD;
  bf16* Ds = Qs + 64 * LD;  // dO tile
  float* lse_s = reinterpret_cast<float*>(Ds + 64 * LD);
  float* del_s = lse_s + 64;
  int* segq = reinterpret_cast<int*>(del_s + 64);
  int* segk = segq + 64;

  const int hk = blockIdx.y, b = blockIdx.z, G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, kw = warp * 16;
  const size_t qstride = (size_t)H * DH, kstride = (size_t)Hkv * DH;
  const int* sb = seg + (size_t)b * T;

  load_tile<DH>(Ks, k + ((size_t)b * T * Hkv + hk) * DH, k0, T, kstride);
  load_tile<DH>(Vs, v + ((size_t)b * T * Hkv + hk) * DH, k0, T, kstride);
  load_seg(segk, sb, k0, T);
  const int keys[2] = {k0 + kw + g, k0 + kw + g + 8};

  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const bf16* qb = q + ((size_t)b * T * H + h) * DH;
    const bf16* db = dout + ((size_t)b * T * H + h) * DH;
    const float* lb = lse + ((size_t)b * H + h) * T;
    const float* eb = delta + ((size_t)b * H + h) * T;
    for (int qt0 = causal ? k0 : 0; qt0 < T; qt0 += BQ) {
      __syncthreads();  // the previous q tile is consumed
      load_tile<DH>(Qs, qb, qt0, T, qstride);
      load_tile<DH>(Ds, db, qt0, T, qstride);
      for (int i = threadIdx.x; i < 64; i += blockDim.x) {
        const bool in = qt0 + i < T;
        lse_s[i] = in ? lb[qt0 + i] : 0.f;
        del_s[i] = in ? eb[qt0 + i] : 0.f;
        segq[i] = in ? sb[qt0 + i] : 0;
      }
      __syncthreads();

#pragma unroll
      for (int qc = 0; qc < BQ; qc += 32) {
        // S^T [16 keys, 32 queries] = K Q^T and dP^T = V dO^T
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[nt][j] = dpt[nt][j] = 0.f;
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
          uint32_t ak[4], av[4];
          load_a<LD>(ak, Ks, kw, ks * 16, g, t);
          load_a<LD>(av, Vs, kw, ks * 16, g, t);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            uint32_t bq[2], bd[2];
            load_bt<LD>(bq, Qs, qc + nt * 8, ks * 16, g, t);
            load_bt<LD>(bd, Ds, qc + nt * 8, ks * 16, g, t);
            mma_bf16_16816(st[nt], ak, bq);
            mma_bf16_16816(dpt[nt], av, bd);
          }
        }
        // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - D) scale
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qi = qc + nt * 8 + 2 * t + (j & 1), qrow = qt0 + qi;
            const int key = keys[j >> 1];
            const bool ok = key < T && qrow < T
                            && segk[key - k0] == segq[qi]
                            && (!causal || key <= qrow);
            const float p = ok ? expf(st[nt][j] * scale - lse_s[qi]) : 0.f;
            st[nt][j] = p;
            dpt[nt][j] = p * (dpt[nt][j] - del_s[qi]) * scale;
          }
        // dV += bf16(P^T) dO, dK += bf16(dS^T) Q over these 32 queries
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ap[4], ads[4];
          acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
          acc_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int dt = 0; dt < DH / 8; ++dt) {
            uint32_t bd[2], bq[2];
            load_b<LD>(bd, Ds, qc + 16 * kk, dt * 8, g, t);
            load_b<LD>(bq, Qs, qc + 16 * kk, dt * 8, g, t);
            mma_bf16_16816(dva[dt], ap, bd);
            mma_bf16_16816(dka[dt], ads, bq);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = keys[i];
    if (key >= T) continue;
    const size_t off = ((size_t)b * T * Hkv + hk) * DH + (size_t)key * kstride;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
          __floats2bfloat162_rn(dka[dt][2 * i], dka[dt][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(dva[dt][2 * i], dva[dt][2 * i + 1]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int T, int H, int Hkv, int causal, float scale) {
  using namespace desta;
  constexpr int LD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + 64 * LD;  // dO tile
  bf16* Ks = Ds + 64 * LD;
  bf16* Vs = Ks + 64 * LD;
  int* segk = reinterpret_cast<int*>(Vs + 64 * LD);

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt0 = blockIdx.x * BQ, qw = warp * 16, q0 = qt0 + qw;
  const size_t qstride = (size_t)H * DH, kstride = (size_t)Hkv * DH;
  const bf16* kb = k + ((size_t)b * T * Hkv + hk) * DH;
  const bf16* vb = v + ((size_t)b * T * Hkv + hk) * DH;
  const int* sb = seg + (size_t)b * T;

  load_tile<DH>(Qs, q + ((size_t)b * T * H + h) * DH, qt0, T, qstride);
  load_tile<DH>(Ds, dout + ((size_t)b * T * H + h) * DH, qt0, T, qstride);
  const int rows[2] = {q0 + g, q0 + g + 8};
  float lse_r[2], del_r[2];
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < T;
    lse_r[i] = in ? lse[((size_t)b * H + h) * T + rows[i]] : 0.f;
    del_r[i] = in ? delta[((size_t)b * H + h) * T + rows[i]] : 0.f;
    segq[i] = in ? sb[rows[i]] : 0;
  }

  float dqa[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqa[i][j] = 0.f;

  const int kend = causal ? min(T, qt0 + BQ) : T;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous k tile is consumed
    load_tile<DH>(Ks, kb, k0, T, kstride);
    load_tile<DH>(Vs, vb, k0, T, kstride);
    load_seg(segk, sb, k0, T);
    __syncthreads();
    if (causal && k0 > q0 + 15) continue;

    // S [16 queries, 64 keys] = Q K^T and dP = dO V^T
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t aq[4], ad[4];
      load_a<LD>(aq, Qs, qw, ks * 16, g, t);
      load_a<LD>(ad, Ds, qw, ks * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        uint32_t bk[2], bv[2];
        load_bt<LD>(bk, Ks, nt * 8, ks * 16, g, t);
        load_bt<LD>(bv, Vs, nt * 8, ks * 16, g, t);
        mma_bf16_16816(s[nt], aq, bk);
        mma_bf16_16816(dp[nt], ad, bv);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = nt * 8 + 2 * t + (j & 1), key = k0 + kj;
        const int i = j >> 1;
        const bool ok = key < T && rows[i] < T && segk[kj] == segq[i]
                        && (!causal || key <= rows[i]);
        const float p = ok ? expf(s[nt][j] * scale - lse_r[i]) : 0.f;
        dp[nt][j] = p * (dp[nt][j] - del_r[i]) * scale;  // dS
      }
    // dQ += bf16(dS) K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        uint32_t bb[2];
        load_b<LD>(bb, Ks, 16 * kk, dt * 8, g, t);
        mma_bf16_16816(dqa[dt], a, bb);
      }
    }
  }

  bf16* qo = dq + ((size_t)b * T * H + h) * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= T) continue;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(qo + (size_t)rows[i] * qstride + col) =
          __floats2bfloat162_rn(dqa[dt][2 * i], dqa[dt][2 * i + 1]);
    }
  }
}

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg,
               void* o, void* lse, int B, int T, int H, int Hkv, int causal,
               float scale, cudaStream_t stream) {
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, 128, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg,
      (bf16*)o, (float*)lse, T, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkdv(const void* q, const void* k, const void* v, const void* seg,
                const void* dout, const void* lse, const void* delta, void* dk,
                void* dv, int B, int T, int H, int Hkv, int causal, float scale,
                cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<DH>();
  cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((T + BK - 1) / BK, Hkv, B);
  flash_bwd_dkdv_kernel<DH><<<grid, 128, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, T, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* seg,
              const void* dout, const void* lse, const void* delta, void* dq,
              int B, int T, int H, int Hkv, int causal, float scale,
              cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<DH>();
  cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<DH><<<grid, 128, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg,
      (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dq,
      T, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int desta_flash_fwd(const void* q, const void* k, const void* v,
                               const void* seg, void* o, void* lse, int B,
                               int T, int H, int Hkv, int Dh, int causal,
                               float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh == 128)
    return launch_fwd<128>(q, k, v, seg, o, lse, B, T, H, Hkv, causal, scale, s);
  if (Dh == 64)
    return launch_fwd<64>(q, k, v, seg, o, lse, B, T, H, Hkv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int desta_flash_bwd_delta(const void* o, const void* dout,
                                     void* delta, int B, int T, int H, int Dh,
                                     void* stream) {
  const int rows = B * T * H;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, rows, T, H, Dh);
  return (int)cudaGetLastError();
}

extern "C" int desta_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* seg,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    int B, int T, int H, int Hkv, int Dh,
                                    int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh == 128)
    return launch_dkdv<128>(q, k, v, seg, dout, lse, delta, dk, dv, B, T, H,
                            Hkv, causal, scale, s);
  if (Dh == 64)
    return launch_dkdv<64>(q, k, v, seg, dout, lse, delta, dk, dv, B, T, H,
                           Hkv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int desta_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* seg, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  int B, int T, int H, int Hkv, int Dh,
                                  int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Dh == 128)
    return launch_dq<128>(q, k, v, seg, dout, lse, delta, dq, B, T, H, Hkv,
                          causal, scale, s);
  if (Dh == 64)
    return launch_dq<64>(q, k, v, seg, dout, lse, delta, dq, B, T, H, Hkv,
                         causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
