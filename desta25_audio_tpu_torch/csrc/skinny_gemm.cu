// C entry points of the skinny weight-streaming GEMM (csrc/skinny_gemm.cuh,
// whose note says what it replaces, what bounds it and how it is built):
// the decode and verify steps' projections (ops/fused_decode.FusedStep)
// and the standalone wrapper ops/skinny_gemm.skinny_gemm.

#include "skinny_gemm.cuh"

using namespace desta;

// x [M, K] bf16; w [N*NW, K] bf16 (scale null) or int8 (w_int8 = 1, one
// f32 scale per row of w); NW = 2 for SWIGLU (gate / up rows interleaved).
// out [M, N]: bf16, or f32 for STORE_F32 / ADD_F32; bias (N floats) is read
// by the BIAS epilogues.  PEER_F32 goes through csrc/tp_allreduce.cu.
extern "C" int desta_skinny_gemm(const void* x, const void* w,
                                 const void* scale, const void* bias,
                                 void* out, int M, int N, int K, int epilogue,
                                 int w_int8, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  const float* sc = (const float*)scale;
  const float* bs = (const float*)bias;
  if ((epilogue == EPI_BIAS || epilogue == EPI_BIAS_GELU) && bs == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((w_int8 != 0) != (sc != nullptr)) return (int)cudaErrorInvalidValue;
#define DESTA_SKINNY(WT, EPI) \
  launch_skinny<WT, EPI>(xb, (const WT*)w, sc, out, M, N, K, st, bs)
#define DESTA_SKINNY_EPI(WT)                                      \
  switch (epilogue) {                                             \
    case EPI_STORE: return (int)DESTA_SKINNY(WT, EPI_STORE);      \
    case EPI_RESID: return (int)DESTA_SKINNY(WT, EPI_RESID);      \
    case EPI_SWIGLU: return (int)DESTA_SKINNY(WT, EPI_SWIGLU);    \
    case EPI_STORE_F32: return (int)DESTA_SKINNY(WT, EPI_STORE_F32); \
    case EPI_ADD_F32: return (int)DESTA_SKINNY(WT, EPI_ADD_F32);  \
    case EPI_BIAS: return (int)DESTA_SKINNY(WT, EPI_BIAS);        \
    case EPI_BIAS_GELU: return (int)DESTA_SKINNY(WT, EPI_BIAS_GELU); \
    default: return (int)cudaErrorInvalidValue;                   \
  }
  if (w_int8) {
    DESTA_SKINNY_EPI(int8_t)
  } else {
    DESTA_SKINNY_EPI(bf16)
  }
  return (int)cudaErrorInvalidValue;
#undef DESTA_SKINNY_EPI
#undef DESTA_SKINNY
}

// out[4] = the plan a launch takes on the current device for a weight of
// `rows` rows (N, or 2N for SWIGLU) of K values: ranks, k-tiles a rank,
// k-tiles, row tiles (ops/skinny_gemm.plan_skinny_gemm is the same rule)
extern "C" int desta_skinny_gemm_plan(int rows, int K, int w_int8, void* out) {
  if (rows < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const SkinnyPlan p = plan_skinny(rows, (long long)K * (w_int8 ? 1 : 2),
                                   sm_count());
  int* o = static_cast<int*>(out);
  o[0] = p.ns;
  o[1] = p.tps;
  o[2] = p.nkt;
  o[3] = p.tiles;
  return 0;
}
