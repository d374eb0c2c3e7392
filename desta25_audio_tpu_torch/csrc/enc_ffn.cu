// Tiled bf16 GEMM with a bias (and optional erf-GELU) epilogue: the two
// products of the Whisper encoder FFN.
//
// Replaces: desta25_audio_tpu/ops/enc_ffn.py::_kernel (the fused Pallas
//   fc1 -> gelu -> fc2 TPU kernel behind encoder_ffn).
// Computes: out[M, N] = epi(a[M, K] @ w[N, K]^T + bias[N]) in bf16, with f32
//   accumulation.  encoder_ffn launches it twice: fc1 with the GELU epilogue
//   (GELU of the unrounded f32 sum, output rounded to bf16 -- the same
//   rounding points as the TPU kernel, whose GELU output is rounded to bf16
//   before fc2), then fc2 with the bias epilogue.  GELU uses CUDA's erff;
//   the TPU kernel's A&S 7.1.26 erf differs from it by at most 1.5e-7.
// What bounds it on the H100: tensor-core math.  At B=2 (M=3000, D=1280,
//   F=5120) the two products are 79 GFLOP over ~60 MB of traffic.
// Design: 128x128 output tile per block of 8 warps (each warp 64x32, i.e.
//   4x4 mma.sync m16n8k16 tiles), K walked in steps of 32 through a
//   two-stage cp.async ring in shared memory (rows padded to 40 bf16 so the
//   32-bit fragment loads are bank-conflict free).  Rows past M are
//   zero-filled on load and never stored.  The [M, F] hidden makes one
//   round trip through device memory (30 MB at B=2); keeping it on chip as
//   the TPU kernel does is a follow-up in ROADMAP.md.
// Requires N % 128 == 0 and K % 32 == 0 (whisper: D=1280, F=5120).

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BKT = 32;
constexpr int LDA = BKT + 8;  // 40 bf16 = 80 bytes per row

__global__ void __launch_bounds__(256)
gemm_bias_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, bf16* __restrict__ out,
                 int M, int N, int K, int gelu) {
  using namespace desta;
  __shared__ __align__(16) bf16 As[2][BM][LDA];
  __shared__ __align__(16) bf16 Ws[2][BN][LDA];

  const int bn = blockIdx.x * BN, bm = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols
  const int g = lane >> 2, t = lane & 3;

  // each thread stages two 16-byte chunks of A and two of W per k-tile
  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;       // 512 chunks: 128 rows x 4
      const int r = c >> 2, kc = (c & 3) * 8;
      const int ar = bm + r;
      const bf16* src = a + (size_t)(ar < M ? ar : 0) * K + k0 + kc;
      cp_async16(&As[stage][r][kc], src, ar < M ? 16 : 0);
      const bf16* wsrc = w + (size_t)(bn + r) * K + k0 + kc;
      cp_async16(&Ws[stage][r][kc], wsrc, 16);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int KT = K / BKT;
  load_tile(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      load_tile(st ^ 1, (kt + 1) * BKT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BKT / 16; ++ks) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        const int c = ks * 16 + 2 * t;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][c + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        const int c = ks * 16 + 2 * t;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Ws[st][n][c]);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Ws[st][n][c + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();  // stage st is free for the load two steps ahead
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = bn + wn * 32 + ni * 8 + 2 * t;
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = bm + wm * 64 + mi * 16 + g + 8 * hh;
        if (row >= M) continue;
        float y0 = acc[mi][ni][2 * hh] + b0;
        float y1 = acc[mi][ni][2 * hh + 1] + b1;
        if (gelu) {
          y0 = 0.5f * y0 * (1.f + erff(y0 * 0.70710678118654752f));
          y1 = 0.5f * y1 * (1.f + erff(y1 * 0.70710678118654752f));
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

}  // namespace

extern "C" int desta_gemm_bias(const void* a, const void* w, const void* bias,
                               void* out, int M, int N, int K, int gelu,
                               void* stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_bias_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const bf16*)bias, (bf16*)out, M, N, K,
      gelu);
  return (int)cudaGetLastError();
}
