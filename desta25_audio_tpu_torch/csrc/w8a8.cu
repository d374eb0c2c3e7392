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
// epilogue).
// Two kernels, launched by ops/w8a8_proj.py, ops/enc_ffn.py and ops/qmm.py
// through ops/quant.py (K4: the row quantiser and two GEMMs, three
// launches; K5, K6 and the prefill: the row quantiser and one GEMM):
//   quant_rows_kernel: x[M, K] bf16 -> int8 q[M, K] and f32 scales [M,
//     nseg], one scale per row and per `seg`-wide column segment:
//     s = max(max|x|, 1e-8) * (1/127), q = clip(rint(x / s), -127, 127)
//     (IEEE division, __fdiv_rn: a different rounding would move int8
//     values); the LLM formula divides, s = max(max|x|, 1e-8) / 127
//     (`div127`).  Bandwidth-bound: one warp per (row, segment), or a block
//     where there are few, 8-byte loads, two passes (the second hits
//     L1/L2).
//   the int8 GEMM of gemm_sm90.cuh (wgmma m64nNk32 .s32.s8.s8, TMA, an
//     mbarrier ring; K split across a cluster at few row tiles) with its
//     PROJ (K5, K6), GELU_Q8 (K4 fc1: GELU, then the hidden quantized per
//     row *per 1280-column chunk*, enc_ffn.py:174-185, across a cluster of
//     the CTAs that span the chunk, so the hidden never reaches device
//     memory in f32), SEG (K4 fc2, which must not sum int32 across chunks)
//     and LLM epilogues.
//     Up to three operand sets share one launch and one quantized A: the
//     output tile's column picks q, k or v (K5).
// What bounds it on the H100: at M=3000 (B=2) the products are compute-
//   bound (K4 78.6 GOP, K5 29.5 GOP, K6 9.8 GOP against 1,979 dense int8
//   TOPS); the row quantisation of x is bandwidth-bound.  K4's hidden
//   makes one round trip as int8 (15 MB at M=3000).
// Requires N a multiple of the plan's bn, K % 16 == 0 (the predicates ask
// K % 64), seg a multiple of 128, K4's F a multiple of 1280 (whisper:
// D=1280, F=5120, seg=1280).

#include "gemm_sm90.cuh"

namespace {

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One item (a row's `seg`-wide segment) a warp, or, with BLOCK, a block of
// 8 warps (few long rows: the LLM prefill's 250 x 14336 would otherwise
// keep 32 SMs busy).  Each thread reads 4 values at a time, twice (the
// second pass hits L1/L2).
template <bool BLOCK>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scale, int M, int K, int seg,
                  int div127) {
  using namespace desta;
  using desta::gemm::quant8;
  __shared__ float red[8];
  const int nseg = (K + seg - 1) / seg;
  const long item =
      BLOCK ? (long)blockIdx.x : (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (item >= (long)M * nseg) return;  // never with BLOCK (a block an item)
  const int lane = BLOCK ? threadIdx.x : threadIdx.x & 31;
  const int step = BLOCK ? 1024 : 128;
  const int row = (int)(item / nseg), c = (int)(item % nseg);
  const int c0 = c * seg, c1 = min(c0 + seg, K);
  const bf16* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = c0 + 4 * lane; k < c1; k += step) {
    const float4 v = load4(xr + k);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  amax = BLOCK ? block_max(amax, red) : warp_max(amax);
  const float s = div127 ? __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f)
                         : fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  if (lane == 0) scale[item] = s;
  int8_t* qr = q + (size_t)row * K;
  for (int k = c0 + 4 * lane; k < c1; k += step) {
    const float4 v = load4(xr + k);
    char4 o;
    o.x = quant8(v.x, s);
    o.y = quant8(v.y, s);
    o.z = quant8(v.z, s);
    o.w = quant8(v.w, s);
    *reinterpret_cast<char4*>(qr + k) = o;
  }
}

}  // namespace

extern "C" int desta_quant_rows(const void* x, void* q, void* scale, int M,
                                int K, int seg, int div127, void* stream) {
  const long items = (long)M * ((K + seg - 1) / seg);
  const cudaStream_t st = (cudaStream_t)stream;
  if ((items + 7) / 8 < 2 * desta::sm_count())  // a block an item
    quant_rows_kernel<true><<<(unsigned)items, 256, 0, st>>>(
        (const bf16*)x, (int8_t*)q, (float*)scale, M, K, seg, div127);
  else
    quant_rows_kernel<false><<<(unsigned)((items + 7) / 8), 256, 0, st>>>(
        (const bf16*)x, (int8_t*)q, (float*)scale, M, K, seg, div127);
  return (int)cudaGetLastError();
}

// epi: ops/gemm.py's (gemm_sm90.cuh's) PROJ, GELU_Q8, SEG, LLM_BF16 or
// LLM_F32; nproj operand sets (1..3) share `a` and `sa`; sq: GELU_Q8's
// output scales [M, N / 1280]; (bm, bn, splits, cluster) from
// ops/gemm.plan_gemm.
extern "C" int desta_gemm_s8(int epi, const void* a, const void* sa,
                             int nproj, const void* w0, const void* s0,
                             const void* b0, void* o0, const void* w1,
                             const void* s1, const void* b1, void* o1,
                             const void* w2, const void* s2, const void* b2,
                             void* o2, void* sq, int M, int N, int K, int seg,
                             int bm, int bn, int splits, int cluster,
                             void* stream) {
  using namespace desta::gemm;
  if (nproj < 1 || nproj > 3 || (nproj > 1 && epi != PROJ)
      || (epi == GELU_Q8 && sq == nullptr))
    return (int)cudaErrorInvalidValue;
  Args args = {};
  const cudaError_t e =
      plan_args<int8_t>(&args, M, N, K, nproj, bn, splits, cluster, seg, epi);
  if (e != cudaSuccess) return (int)e;
  args.op[0] = {(const float*)s0, (const bf16*)b0, o0};
  args.op[1] = {(const float*)s1, (const bf16*)b1, o1};
  args.op[2] = {(const float*)s2, (const bf16*)b2, o2};
  args.sa = (const float*)sa;
  args.sq = (float*)sq;
  const void* ws[3] = {w0, w1, w2};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (epi) {
    case PROJ:
      return (int)dispatch<int8_t, PROJ>(bm, bn, a, ws, nproj, args, st);
    case GELU_Q8:
      return (int)dispatch<int8_t, GELU_Q8>(bm, bn, a, ws, nproj, args, st);
    case SEG:
      return (int)dispatch<int8_t, SEG>(bm, bn, a, ws, nproj, args, st);
    case LLM_BF16:
      return (int)dispatch<int8_t, LLM_BF16>(bm, bn, a, ws, nproj, args, st);
    case LLM_F32:
      return (int)dispatch<int8_t, LLM_F32>(bm, bn, a, ws, nproj, args, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of `splits` CTAs of the int8 (bm, bn) GEMM the current
// device runs at once: the wave the planner assumes (ops/gemm.CLUSTER_SLOTS).
extern "C" int desta_gemm_max_clusters(int bm, int bn, int splits,
                                       void* count) {
  return (int)desta::gemm::max_clusters<int8_t, desta::gemm::PROJ>(
      bm, bn, splits, (int*)count);
}
