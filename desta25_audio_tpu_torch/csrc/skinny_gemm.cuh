// Skinny weight-streaming GEMM: out[m, n] = epi(s[n] * (x[m, :] . w[n, :]))
// for a few activation rows m, with the weight in the port's [out, in]
// layout as bf16 or int8 (one f32 scale per output row).
//
// Used by the decode step (csrc/fused_decode.cu: K8, its int8 stream, the
// verify step K8v and the ORCA injection's q / o / gate1 projections of
// K8i), by the int8 matmul at small M (csrc/qmm.cu: K7) and by the
// per-layer decode pair (csrc/fused_decode_tp.cu: K9's wo / down partial
// sums, and its epilogues after the fused-norm projections).
// Bound by device-memory bandwidth: each weight byte is read once for up
// to 16 activation rows (2*M FLOP per weight).
// Design: one warp per output column n streams the weight row w[n, :] with
// 16-byte loads (8 bf16 or 16 int8 values a lane; int8 -> f32 is exact);
// the few activation rows come through L1; partial sums are f32 and
// reduced with shuffles.  The scale multiplies the f32 sum (the TPU
// kernels' scale point, desta25_audio_tpu/ops/quant.py:74-77 and
// ops/fused_decode.py:428-443), then the epilogue rounds:
//   STORE      bf16(v)
//   STORE_F32  v
//   ADD_F32    out = out + v                   (f32, no fused multiply-add)
//   RESID      h = bf16(h + bf16(v))                      (bf16 residual)
//   SWIGLU     mid = bf16(bf16(silu(bf16(gate))) * bf16(up)) over
//              row-interleaved gate/up weights, each with its own scale
//   BIAS       bf16(v + b[n])                 (f32 bias, no fused multiply-add)
//   BIAS_GELU  bf16(gelu(bf16(v + b[n])))     erf GELU in f32
//   PEER_F32   v into slot [slot][my] of every mesh rank's receive buffer,
//              then, once every block of every pass has stored, the rank's
//              epoch into each rank's flag word [slot][my] (PeerStore below;
//              read by the all-reduce of csrc/tp_allreduce.cu)
// Rows go 16 at a time; a pass over more rows re-streams the weights.
#pragma once

#include "common.cuh"

namespace desta {

enum Epilogue { EPI_STORE = 0, EPI_RESID = 1, EPI_SWIGLU = 2,
                EPI_STORE_F32 = 3, EPI_BIAS = 4, EPI_BIAS_GELU = 5,
               EPI_ADD_F32 = 6, EPI_PEER_F32 = 7 };

constexpr int SKINNY_ROWS = 16;  // activation rows per pass

// The PEER_F32 epilogue's operands.  dst[d]: rank d's receive buffer [2, p,
// M, N] f32 and flags[d]: its flag words [2, p] (device tables of p
// pointers, the rank's own included); offset: this pass's first element in
// slot [slot][my], (slot * p + my) * M * N + m0 * N; flag: slot * p + my.
// Arrival: every block stores its outputs, fences them at system scope and
// counts itself in *counter; the block that makes the count reach `blocks`
// (all blocks of all passes) resets the counter for the next use and, after
// another system-scope fence, release-stores `epoch` into every rank's flag
// word.  Epochs only grow (one per all-reduce round of the mesh's buffers),
// so no flag is ever reset.
struct PeerStore {
  const unsigned long long* dst = nullptr;
  const unsigned long long* flags = nullptr;
  unsigned int* counter = nullptr;
  long long offset = 0;
  long long epoch = 0;
  unsigned int blocks = 0;
  int p = 0;
  int flag = 0;
};

__device__ __forceinline__ void st_release_sys(long long* addr, long long v) {
  asm volatile("st.release.sys.global.b64 [%0], %1;" ::"l"(addr), "l"(v)
               : "memory");
}

// Called by every thread of a block after its epilogue stores.
__device__ __forceinline__ void peer_arrive(const PeerStore& ps) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(ps.counter, 1u) + 1u == ps.blocks) {
      __threadfence_system();
      atomicExch(ps.counter, 0u);
      for (int d = 0; d < ps.p; ++d)
        st_release_sys(reinterpret_cast<long long*>(ps.flags[d]) + ps.flag,
                       ps.epoch);
    }
  }
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float f[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// 16 bytes of weights -> VEC floats (exact for both types)
template <typename WT> struct WeightVec;
template <> struct WeightVec<bf16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void load(const bf16* p, float f[8]) {
    bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
};
template <> struct WeightVec<int8_t> {
  static constexpr int VEC = 16;
  static __device__ __forceinline__ void load(const int8_t* p, float f[16]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = (float)(int8_t)((w[i] >> (8 * b)) & 0xff);
  }
};

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

// One warp's output column n for all M rows (the whole warp calls it).
template <typename WT, int MT, int EPI>
__device__ __forceinline__ void skinny_rows(
    const bf16* __restrict__ x, const WT* __restrict__ wr,
    const float* __restrict__ scale, void* __restrict__ out, int M, int N,
    int K, const float* __restrict__ bias, const PeerStore& ps, int n,
    int lane) {
  constexpr int NW = (EPI == EPI_SWIGLU) ? 2 : 1;  // weight rows per output
  constexpr int VEC = WeightVec<WT>::VEC;
  float acc[NW][MT];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[j][m] = 0.f;

#pragma unroll 2
  for (int k = lane * VEC; k < K; k += 32 * VEC) {
    float wf[NW][VEC];
#pragma unroll
    for (int j = 0; j < NW; ++j) WeightVec<WT>::load(wr + (size_t)j * K + k, wf[j]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
#pragma unroll
        for (int h = 0; h < VEC; h += 8) {
          float xf[8];
          bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k + h)), xf);
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              acc[j][m] = fmaf(wf[j][h + i], xf[i], acc[j][m]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float v[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      v[j] = warp_sum(acc[j][m]);
      if (scale != nullptr) v[j] *= scale[(size_t)n * NW + j];
    }
    if (lane == m && m < M)
      skinny_epilogue<EPI>(out, (size_t)m * N + n, n, v, bias, ps);
  }
}

template <typename WT, int MT, int EPI>
__global__ void __launch_bounds__(256)
skinny_gemm_kernel(const bf16* __restrict__ x, const WT* __restrict__ w,
                   const float* __restrict__ scale, void* __restrict__ out,
                   int M, int N, int K, const float* __restrict__ bias,
                   const PeerStore ps) {
  constexpr int NW = (EPI == EPI_SWIGLU) ? 2 : 1;  // weight rows per output
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n < N) skinny_rows<WT, MT, EPI>(x, w + (size_t)n * NW * K, scale, out,
                                      M, N, K, bias, ps, n, lane);
  if constexpr (EPI == EPI_PEER_F32) peer_arrive(ps);
}


// All M rows in passes of SKINNY_ROWS; K % VEC == 0, 16-byte aligned rows.
// bias: N floats, read by the BIAS epilogues only; ps: PEER_F32's operands
// (out unused), each pass's offset and the block count set here.
template <typename WT, int EPI>
cudaError_t launch_skinny(const bf16* x, const WT* w, const float* scale,
                          void* out, int M, int N, int K,
                          cudaStream_t stream, const float* bias = nullptr,
                          PeerStore ps = PeerStore()) {
  const dim3 block(256), grid((N + 7) / 8);
  const size_t out_bytes =
      (EPI == EPI_STORE_F32 || EPI == EPI_ADD_F32) ? sizeof(float) : sizeof(bf16);
  const long long offset0 = ps.offset;
  ps.blocks = grid.x * (unsigned int)((M + SKINNY_ROWS - 1) / SKINNY_ROWS);
  for (int m0 = 0; m0 < M; m0 += SKINNY_ROWS) {
    const int mr = M - m0 < SKINNY_ROWS ? M - m0 : SKINNY_ROWS;
    const bf16* xm = x + (size_t)m0 * K;
    void* om = EPI == EPI_PEER_F32
                   ? out
                   : static_cast<char*>(out) + (size_t)m0 * N * out_bytes;
    ps.offset = offset0 + (long long)m0 * N;
    if (mr == 1)
      skinny_gemm_kernel<WT, 1, EPI><<<grid, block, 0, stream>>>(xm, w, scale, om, mr, N, K, bias, ps);
    else if (mr == 2)
      skinny_gemm_kernel<WT, 2, EPI><<<grid, block, 0, stream>>>(xm, w, scale, om, mr, N, K, bias, ps);
    else if (mr <= 4)
      skinny_gemm_kernel<WT, 4, EPI><<<grid, block, 0, stream>>>(xm, w, scale, om, mr, N, K, bias, ps);
    else if (mr <= 8)
      skinny_gemm_kernel<WT, 8, EPI><<<grid, block, 0, stream>>>(xm, w, scale, om, mr, N, K, bias, ps);
    else
      skinny_gemm_kernel<WT, 16, EPI><<<grid, block, 0, stream>>>(xm, w, scale, om, mr, N, K, bias, ps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace desta
