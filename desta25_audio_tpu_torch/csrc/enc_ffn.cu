// K3: the two bf16 products of the Whisper encoder FFN, on the Hopper GEMM
// of gemm_sm90.cuh (TMA, an mbarrier ring, wgmma m64nNk16 .f32.bf16.bf16).
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
// Design: gemm_sm90.cuh, its tile and schedule from ops/gemm.plan_gemm.  The
//   [M, F] hidden makes one round trip through device memory (30 MB at
//   B=2); keeping it on chip as the TPU kernel does is later work.
// Requires N a multiple of bn and K % 8 == 0 (whisper: D=1280, F=5120).

#include "gemm_sm90.cuh"

// (bm, bn, cluster) from ops/gemm.plan_gemm.
extern "C" int desta_gemm_bias(const void* a, const void* w, const void* bias,
                               void* out, int M, int N, int K, int gelu,
                               int bm, int bn, int cluster, void* stream) {
  using namespace desta::gemm;
  const int epi = gelu ? BIAS_GELU : BIAS;
  Args args = {};
  const cudaError_t e =
      plan_args<bf16>(&args, M, N, K, 1, bn, 1, cluster, 0, epi);
  if (e != cudaSuccess) return (int)e;
  args.op[0] = {nullptr, (const bf16*)bias, out};
  const void* ws[1] = {w};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(gelu ? dispatch<bf16, BIAS_GELU>(bm, bn, a, ws, 1, args, st)
                    : dispatch<bf16, BIAS>(bm, bn, a, ws, 1, args, st));
}
