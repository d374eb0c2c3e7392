// Weight-only int8 matmul at small M: out[m, n] = (sum_k bf16(x[m, k]) *
// q[n, k]) * s[n], f32 sum, the scale applied after the sum, output f32 or
// rounded once to bf16.
//
// Replaces: desta25_audio_tpu/ops/quant.py::_qmm_kernel (K7, the Pallas TPU
//   kernel of _qmm_dispatch at M < 128 rows): the LLM's prefill projections
//   of a short prompt and the int8 LM head at every decode step.  Its block
//   holds all M rows, so every weight byte is read once per call; both
//   paths here keep that.
// What bounds it on the H100: at M <= 16 device-memory bandwidth (2*M FLOP
//   per weight byte; the Llama-3.1-8B head is 535 MB of int8); towards
//   M = 127 the bf16 tensor cores as well (254 FLOP/byte against the
//   295 FLOP/byte bf16 ridge).
// Design (M picks the path, the caller never sees the difference):
//   * M <= 16: the skinny weight-streaming GEMM of csrc/skinny_gemm.cuh
//     (tensor cores with the weight as the M side, a TMA / bulk-copy ring,
//     K split across a cluster where the columns leave SMs idle), all rows
//     in one pass.
//   * 16 < M < 128: a tensor-core tile.  A block owns 128 output columns
//     and all M rows (BM = 32, 64 or 128, rows past M zero-filled), walks K
//     in 64-wide steps through a three-stage cp.async ring (x rows padded
//     to 144 bytes, int8 weight rows to 80 bytes: conflict-free fragment
//     loads), converts each int8 weight pair to a bf16 pair on its way into
//     the B fragment (exact: |q| <= 127 fits bf16's 8-bit significand) and
//     runs mma.sync m16n8k16 bf16 with f32 accumulation.  8 warps, 2 (M) x
//     4 (N), each 16*MI rows x 32 columns.  When the columns give fewer
//     than two blocks per SM, K is split across blocks: each writes an f32
//     partial sum, and a second kernel adds the partials in split order and
//     applies the scale.  wgmma/TMA are later work.
// Requires K % 64 == 0; any N (the last column tile is masked).

#include "skinny_gemm.cuh"

namespace {

using namespace desta;

constexpr int QBN = 128, QBK = 64, QSTAGES = 3;
constexpr int QLDA = QBK + 8;   // bf16 per shared x row (144 bytes)
constexpr int QLDW = QBK + 16;  // bytes per shared weight row (80)

template <int MI>
struct QmmSmem {
  bf16 a[QSTAGES][32 * MI][QLDA];
  int8_t w[QSTAGES][QBN][QLDW];
};

// two consecutive int8 weights (k, k+1) -> one bf16x2 fragment register
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(const int8_t* p) {
  const uint16_t u = *reinterpret_cast<const uint16_t*>(p);
  return pack_bf16((float)(int8_t)(u & 0xff), (float)(int8_t)(u >> 8));
}

template <int MI>
__global__ void __launch_bounds__(256)
qmm_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, void* __restrict__ out,
               float* __restrict__ part, int M, int N, int K,
               int kt_per_split, int out_f32) {
  constexpr int BM = 32 * MI;
  extern __shared__ __align__(16) unsigned char qmm_smem[];
  QmmSmem<MI>& sm = *reinterpret_cast<QmmSmem<MI>*>(qmm_smem);

  const int bn = blockIdx.x * QBN;
  const int KT = K / QBK;
  const int kt0 = blockIdx.y * kt_per_split;
  const int kt1 = min(KT, kt0 + kt_per_split);
  const int nkt = kt1 - kt0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 16*MI rows x 32 cols
  const int g = lane >> 2, t = lane & 3;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * QBK;
    for (int c = tid; c < BM * 8; c += 256) {   // x: 8 chunks of 16 B a row
      const int r = c >> 3, kc = (c & 7) * 8;
      cp_async16(&sm.a[stage][r][kc], x + (size_t)(r < M ? r : 0) * K + k0 + kc,
                 r < M ? 16 : 0);
    }
    for (int c = tid; c < QBN * 4; c += 256) {  // w: 4 chunks of 16 B a row
      const int r = c >> 2, kc = (c & 3) * 16;
      const int n = bn + r;
      cp_async16(&sm.w[stage][r][kc], w + (size_t)(n < N ? n : 0) * K + k0 + kc,
                 n < N ? 16 : 0);
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < QSTAGES - 1; ++s) {
    if (s < nkt) load_tile(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<QSTAGES - 2>();  // tile i has landed
    __syncthreads();               // ... for every thread; stage (i-1) is free
    if (i + QSTAGES - 1 < nkt)
      load_tile((i + QSTAGES - 1) % QSTAGES, kt0 + i + QSTAGES - 1);
    cp_async_commit();
    const int st = i % QSTAGES;
#pragma unroll
    for (int ks = 0; ks < QBK / 16; ++ks) {
      const int c = ks * 16 + 2 * t;
      uint32_t af[MI][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * 16 * MI + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r][c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r + 8][c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r][c + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bfr[ni][0] = s8x2_to_bf16x2(&sm.w[st][n][c]);
        bfr[ni][1] = s8x2_to_bf16x2(&sm.w[st][n][c + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = bn + wn * 32 + ni * 8 + 2 * t + e;
      if (col >= N) continue;
      const float sc = scale[col];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wm * 16 * MI + mi * 16 + g + 8 * hh;
          if (row >= M) continue;
          const float v = acc[mi][ni][2 * hh + e];
          const size_t o = (size_t)row * N + col;
          if (part != nullptr) {
            part[(size_t)blockIdx.y * M * N + o] = v;
          } else if (out_f32) {
            static_cast<float*>(out)[o] = v * sc;
          } else {
            static_cast<bf16*>(out)[o] = __float2bfloat16(v * sc);
          }
        }
      }
    }
  }
}

// out = (sum over splits of part, in split order) * s[n]
__global__ void __launch_bounds__(256)
qmm_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                  void* __restrict__ out, int M, int N, int splits,
                  int out_f32) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  float v = 0.f;
  for (int sp = 0; sp < splits; ++sp) v += part[sp * MN + i];
  v *= scale[i % N];
  if (out_f32) static_cast<float*>(out)[i] = v;
  else static_cast<bf16*>(out)[i] = __float2bfloat16(v);
}

template <int MI>
cudaError_t launch_qmm_mma(const bf16* x, const int8_t* w, const float* s,
                           void* out, float* part, int M, int N, int K,
                           int splits, int out_f32, cudaStream_t st) {
  const int KT = K / QBK;
  const int kps = (KT + splits - 1) / splits;
  const size_t smem = sizeof(QmmSmem<MI>);
  cudaError_t e = cudaFuncSetAttribute(
      qmm_mma_kernel<MI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return refuse(e);
  const dim3 grid((N + QBN - 1) / QBN, splits);
  qmm_mma_kernel<MI><<<grid, 256, smem, st>>>(
      x, w, s, out, splits > 1 ? part : nullptr, M, N, K, kps, out_f32);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t MN = (size_t)M * N;
  qmm_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      part, s, out, M, N, splits, out_f32);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K], q int8 [N, K], s f32 [N] -> out [M, N] (f32 if out_f32,
// else bf16).  M <= 16: skinny path (part, splits unused); 16 < M <= 128:
// tensor-core tile with `splits` K-splits, part f32 [splits, M, N] when
// splits > 1.
extern "C" int desta_qmm(const void* x, const void* q, const void* s,
                         void* out, void* part, int M, int N, int K,
                         int splits, int out_f32, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  const int8_t* w = (const int8_t*)q;
  const float* sc = (const float*)s;
  if (M < 1 || M > 128 || K % QBK != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (M <= SKINNY_ROWS) {
    return (int)(out_f32
        ? launch_skinny<int8_t, EPI_STORE_F32>(xb, w, sc, out, M, N, K, st)
        : launch_skinny<int8_t, EPI_STORE>(xb, w, sc, out, M, N, K, st));
  }
  float* pf = (float*)part;
  if (M <= 32) return (int)launch_qmm_mma<1>(xb, w, sc, out, pf, M, N, K, splits, out_f32, st);
  if (M <= 64) return (int)launch_qmm_mma<2>(xb, w, sc, out, pf, M, N, K, splits, out_f32, st);
  return (int)launch_qmm_mma<4>(xb, w, sc, out, pf, M, N, K, splits, out_f32, st);
}
