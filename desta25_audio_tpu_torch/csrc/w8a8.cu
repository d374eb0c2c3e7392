// W8A8 products of the int8 Whisper encoder: int8 weights with one scale per
// output channel, activations quantized to int8 per row at run time, int8
// tensor-core products accumulated exactly in int32, f32 epilogues.
//
// Replaces three TPU kernels of desta25_audio_tpu:
//   K5 ops/w8a8_proj.py::_kernel_qkv   (q, k, v projections, one act quant)
//   K6 ops/w8a8_proj.py::_kernel_one   (the attention output projection)
//   K4 ops/enc_ffn.py::_kernel_w8a8    (fc1 -> GELU -> fc2)
// and serves the int8 LLM's prefill at M >= 128 rows, which the JAX
// package runs through XLA on the TPU (ops/quant.py:116-130, the LLM
// formula below).
// Two kernels, launched by ops/w8a8_proj.py and ops/enc_ffn.py:
//   quant_rows_kernel: x[M, K] (bf16 or f32) -> int8 q[M, K] and f32 scales
//     [M, nseg], one scale per row and per `seg`-wide column segment:
//     s = max(max|x|, 1e-8) * (1/127), q = clip(rint(x / s), -127, 127)
//     (IEEE division, __fdiv_rn: a different rounding would move int8
//     values); the LLM formula divides, s = max(max|x|, 1e-8) / 127
//     (`div127`).  Bandwidth-bound: one warp per (row, segment), 16-byte
//     loads, two passes (the second hits L1/L2).
//   gemm_s8_kernel<EPI>: int32 acc = a[M, K] . w[N, K]^T with
//     mma.sync m16n8k32 s8 (the [out, in] weight is the K-contiguous "col"
//     operand), then one of three epilogues at the TPU kernels' rounding
//     points (__fmul_rn/__fadd_rn, so no contraction into FMAs):
//       PROJ: bf16(f32(acc) * (sa[row] * s[col]) + b[col])        K5, K6
//       GELU: f32 gelu(f32(acc) * (sa[row] * s[col]) + b[col])     K4 fc1
//       SEG:  acc is closed at every `seg`-wide K segment c and folded
//             as accf += (f32(acc_c) * sa[row, c]) * s[col]; then
//             bf16(accf + b[col])                                  K4 fc2
//       LLM:  (f32(acc) * sa[row]) * s[col], no bias, f32 or bf16 out
//                                                   int8 LLM at M >= 128
//     K4 quantizes the GELU output per row *per 1280-column chunk*
//     (enc_ffn.py:174-185), so fc2 must not sum int32 across chunks.
//     Up to three operand sets share one launch and one quantized A: the
//     output tile's column picks q, k or v (K5).  A null bias adds 0, as
//     the JAX package's zeros for Whisper's bias-free k projection.
// What bounds it on the H100: at M=3000 (B=2) the products are compute-
//   bound (K4 78.6 GOP, K5 29.5 GOP, K6 9.8 GOP against 1,979 dense int8
//   TOPS); the quantisation passes and K4's f32 [M, 5120] hidden (61 MB at
//   M=3000, written once, read once) are bandwidth-bound.
// Design: the byte geometry of csrc/enc_ffn.cu's bf16 GEMM -- a 128x128
//   output tile per block of 8 warps (each 64x32 = 4x4 mma tiles), K walked
//   in 64-byte steps through a two-stage cp.async ring, shared rows padded
//   to 80 bytes (conflict-free 32-bit fragment loads) -- with int8 operands
//   and int32 accumulators.  Rows past M are zero-filled and never stored.
//   wgmma/TMA for s8, fusing the row quantisation into the GEMM and keeping
//   K4's hidden on chip (as the TPU kernel does) are later work.
// Requires N % 128 == 0, K % 64 == 0, seg % 64 == 0 (whisper: D=1280,
// F=5120, seg=1280).

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // BK in int8 elements (bytes)
constexpr int LDS = BK + 16;                // 80 bytes per shared row

enum { EPI_PROJ = 0, EPI_GELU = 1, EPI_SEG = 2, EPI_LLM_BF16 = 3,
       EPI_LLM_F32 = 4 };

struct Operand {
  const int8_t* w;   // [N, K]
  const float* s;    // [N]
  const bf16* bias;  // [N], or null for zeros
  void* out;         // [M, N]: bf16 (PROJ, SEG, LLM_BF16) or f32
};
struct Operands {
  Operand op[3];
};

// D = A(16x32, row) * B(32x8, col) + D, s8 inputs, s32 accumulation.
// The fragments have the byte layout of the bf16 m16n8k16 ones:
//   a0 (g, 4t..4t+3)  a1 (g+8, 4t..)  a2 (g, 16+4t..)  a3 (g+8, 16+4t..)
//   b0 (k=4t..4t+3, n=g)  b1 (k=16+4t.., n=g)
//   c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ signed char quant8(float v, float s) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

template <typename T>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, int M, int K, int seg,
                  int div127) {
  using namespace desta;
  const int nseg = (K + seg - 1) / seg;
  const long item = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (item >= (long)M * nseg) return;
  const int lane = threadIdx.x & 31;
  const int row = (int)(item / nseg), c = (int)(item % nseg);
  const int c0 = c * seg, c1 = min(c0 + seg, K);
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = c0 + 4 * lane; k < c1; k += 128) {
    const float4 v = load4(xr + k);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  amax = warp_max(amax);
  const float s = div127 ? __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f)
                         : fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  if (lane == 0) scale[item] = s;
  int8_t* qr = q + (size_t)row * K;
  for (int k = c0 + 4 * lane; k < c1; k += 128) {
    const float4 v = load4(xr + k);
    char4 o;
    o.x = quant8(v.x, s);
    o.y = quant8(v.y, s);
    o.z = quant8(v.z, s);
    o.w = quant8(v.w, s);
    *reinterpret_cast<char4*>(qr + k) = o;
  }
}

__device__ __forceinline__ float gelu_f32(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

template <int EPI>
__global__ void __launch_bounds__(256)
gemm_s8_kernel(const int8_t* __restrict__ a, const float* __restrict__ sa,
               Operands ops, int M, int N, int K, int seg) {
  using namespace desta;
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Ws[2][BN][LDS];

  const int ntile = N / BN;
  const int which = blockIdx.x / ntile;  // selects, no local-memory indexing
  const Operand op = which == 0 ? ops.op[0] : which == 1 ? ops.op[1] : ops.op[2];
  const int bn = (blockIdx.x % ntile) * BN, bm = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 rows x 32 cols
  const int g = lane >> 2, t = lane & 3;

  // each thread stages two 16-byte chunks of A and two of W per k-tile
  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256;  // 512 chunks: 128 rows x 4
      const int r = c >> 2, kc = (c & 3) * 16;
      const int ar = bm + r;
      cp_async16(&As[stage][r][kc], a + (size_t)(ar < M ? ar : 0) * K + k0 + kc,
                 ar < M ? 16 : 0);
      cp_async16(&Ws[stage][r][kc], op.w + (size_t)(bn + r) * K + k0 + kc, 16);
    }
    cp_async_commit();
  };

  int acc[4][4][4];
  float accf[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = 0;
        accf[i][j][r] = 0.f;
      }

  const int KT = K / BK;
  const int nseg = (K + seg - 1) / seg;
  load_tile(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      load_tile(st ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4], bfr[4][2];
      const int c = ks * 32 + 4 * t;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][c + 16]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][c + 16]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Ws[st][n][c]);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Ws[st][n][c + 16]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8_16832(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();  // stage st is free for the load two steps ahead

    if (EPI == EPI_SEG) {
      const int kend = (kt + 1) * BK;
      if (kend % seg == 0 || kt == KT - 1) {  // close segment (kend-1)/seg
        const int cseg = (kend - 1) / seg;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = bn + wn * 32 + ni * 8 + 2 * t;
          const float s0 = op.s[col], s1 = op.s[col + 1];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = bm + wm * 64 + mi * 16 + g + 8 * hh;
              const float sr = row < M ? sa[(size_t)row * nseg + cseg] : 0.f;
              float* f = &accf[mi][ni][2 * hh];
              int* i = &acc[mi][ni][2 * hh];
              f[0] = __fadd_rn(f[0], __fmul_rn(__fmul_rn((float)i[0], sr), s0));
              f[1] = __fadd_rn(f[1], __fmul_rn(__fmul_rn((float)i[1], sr), s1));
              i[0] = 0;
              i[1] = 0;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = bn + wn * 32 + ni * 8 + 2 * t;
    const float s0 = op.s[col], s1 = op.s[col + 1];
    const float b0 = op.bias ? __bfloat162float(op.bias[col]) : 0.f;
    const float b1 = op.bias ? __bfloat162float(op.bias[col + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = bm + wm * 64 + mi * 16 + g + 8 * hh;
        if (row >= M) continue;
        float y0, y1;
        if (EPI == EPI_SEG) {
          y0 = __fadd_rn(accf[mi][ni][2 * hh], b0);
          y1 = __fadd_rn(accf[mi][ni][2 * hh + 1], b1);
        } else if (EPI == EPI_LLM_BF16 || EPI == EPI_LLM_F32) {
          const float sr = sa[row];
          y0 = __fmul_rn(__fmul_rn((float)acc[mi][ni][2 * hh], sr), s0);
          y1 = __fmul_rn(__fmul_rn((float)acc[mi][ni][2 * hh + 1], sr), s1);
        } else {
          const float sr = sa[row];
          y0 = __fadd_rn(__fmul_rn((float)acc[mi][ni][2 * hh], __fmul_rn(sr, s0)), b0);
          y1 = __fadd_rn(__fmul_rn((float)acc[mi][ni][2 * hh + 1], __fmul_rn(sr, s1)), b1);
        }
        if (EPI == EPI_GELU) {
          *reinterpret_cast<float2*>((float*)op.out + (size_t)row * N + col) =
              make_float2(gelu_f32(y0), gelu_f32(y1));
        } else if (EPI == EPI_LLM_F32) {
          *reinterpret_cast<float2*>((float*)op.out + (size_t)row * N + col) =
              make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>((bf16*)op.out + (size_t)row * N + col) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

}  // namespace

extern "C" int desta_quant_rows(const void* x, int x_is_f32, void* q,
                                void* scale, int M, int K, int seg,
                                int div127, void* stream) {
  const long items = (long)M * ((K + seg - 1) / seg);
  const dim3 grid((unsigned)((items + 7) / 8));
  if (x_is_f32)
    quant_rows_kernel<float><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)q, (float*)scale, M, K, seg, div127);
  else
    quant_rows_kernel<bf16><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (int8_t*)q, (float*)scale, M, K, seg, div127);
  return (int)cudaGetLastError();
}

// epi: 0 PROJ, 1 GELU, 2 SEG, 3 LLM_BF16, 4 LLM_F32; nproj operand sets
// (1..3) share `a` and `sa`.
extern "C" int desta_gemm_s8(int epi, const void* a, const void* sa,
                             int nproj, const void* w0, const void* s0,
                             const void* b0, void* o0, const void* w1,
                             const void* s1, const void* b1, void* o1,
                             const void* w2, const void* s2, const void* b2,
                             void* o2, int M, int N, int K, int seg,
                             void* stream) {
  Operands ops;
  ops.op[0] = {(const int8_t*)w0, (const float*)s0, (const bf16*)b0, o0};
  ops.op[1] = {(const int8_t*)w1, (const float*)s1, (const bf16*)b1, o1};
  ops.op[2] = {(const int8_t*)w2, (const float*)s2, (const bf16*)b2, o2};
  const dim3 grid(nproj * (N / BN), (M + BM - 1) / BM);
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t* A = (const int8_t*)a;
  const float* SA = (const float*)sa;
  if (epi == EPI_PROJ)
    gemm_s8_kernel<EPI_PROJ><<<grid, 256, 0, st>>>(A, SA, ops, M, N, K, seg);
  else if (epi == EPI_GELU)
    gemm_s8_kernel<EPI_GELU><<<grid, 256, 0, st>>>(A, SA, ops, M, N, K, seg);
  else if (epi == EPI_SEG)
    gemm_s8_kernel<EPI_SEG><<<grid, 256, 0, st>>>(A, SA, ops, M, N, K, seg);
  else if (epi == EPI_LLM_BF16)
    gemm_s8_kernel<EPI_LLM_BF16><<<grid, 256, 0, st>>>(A, SA, ops, M, N, K, seg);
  else if (epi == EPI_LLM_F32)
    gemm_s8_kernel<EPI_LLM_F32><<<grid, 256, 0, st>>>(A, SA, ops, M, N, K, seg);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
