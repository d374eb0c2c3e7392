// The Hopper GEMM of the encoder FFN (K3, K4), the int8 encoder's
// projections (K5, K6) and the int8 LLM's W8A8 prefill: out[M, N] =
// epi(a[M, K] . w[N, K]^T), with a and w both K-major ([rows, K], the
// port's [out, in] weight layout), in bf16 (f32 sums) or int8 (exact int32
// sums).
//
// Replaces the products of desta25_audio_tpu/ops/enc_ffn.py::_kernel (K3)
// and ::_kernel_w8a8 (K4) and of ops/w8a8_proj.py::_kernel_qkv /
// _kernel_one (K5, K6); serves ops/quant.py:116-130 (the W8A8 prefill, XLA
// on the TPU).  csrc/enc_ffn.cu and csrc/w8a8.cu hold the entry points.
// What bounds it on the H100: at the encoder's M = B * 1500 rows the
//   tensor cores (K3 at M=3000: 79 GFLOP, 0.080 ms at 989 TFLOP/s; K4's two
//   products 79 GOP, 0.040 ms at 1,979 TOP/s); at the LLM prefill's M <= 256
//   rows the weight bytes (Llama-3.1-8B's four layer GEMMs: 218 MB of int8
//   a layer, 0.065 ms at 3.35 TB/s) nearly as much as the operations.  As
//   built it reaches 0.49-0.62 of the bf16 peak at the encoder's shapes
//   (bench_enc_gemm.py); the tiles rank there by the bytes their k-tiles
//   move (the planner's cost), not by their operations, yet loading A's
//   tile once for a CTA pair (TMA multicast) did not speed it up, so L2's
//   rate is not what holds it.
// Design (TMA, an mbarrier ring, wgmma; the pieces of attention_sm90.cuh):
//   * a CTA of 384 threads owns a BM x BN output tile: two consumer
//     warpgroups of BM / 2 rows each (BM / 128 m64 blocks, wgmma
//     m64nBNk16 .f32.bf16.bf16 or m64nBNk32 .s32.s8.s8, both operands
//     K-major from shared memory) and a producer warpgroup, one thread of
//     which starts every load (a whole warpgroup, so that setmaxnreg can
//     hand its registers to the consumers: 24 against 240);
//   * K walks in k-tiles of 128 bytes a row (64 bf16 or 128 int8), one TMA
//     box each of A (BM rows) and W (BN rows) in the 128B swizzle, through a
//     ring of STAGES stages (4 of 48 KB, 4 of 40 KB or 6 of 32 KB) with a
//     "full" and an "empty" mbarrier a stage; rows past M and k-values past
//     K come in as TMA's zero fill and are never stored;
//   * each stage's wgmma group is committed and the previous one waited
//     for (one group in flight), then the previous stage is released;
//   * tiles (BM, BN): (256, 128), (128, 256) or (128, 128), SEG (128, 128)
//     or (256, 64), GELU_Q8 (128, 256), chosen by the planner
//     ops/gemm.plan_gemm (the wave count, and one M tile at M <= 256, so
//     that each weight byte is read from device memory once);
//   * int8 epilogues other than SEG and GELU_Q8 may split K across a
//     thread-block cluster of up to 8 CTAs (the planner does so at
//     M <= 256, one row tile; rank r takes k-tiles r * tps..): each rank
//     writes its int32 partial tile to its shared memory, and after a
//     cluster barrier each rank sums a slice of the tile's rows over the
//     ranks through distributed shared memory (exact in any order: the
//     outputs are the unsplit kernel's bit for bit) and runs the epilogue;
//   * GELU_Q8 (K4's fc1) keeps the hidden off device memory as the TPU
//     kernel does: a cluster of Q8_CHUNK / BN = 5 CTAs spans one 1280-column
//     chunk of the hidden, each CTA's row maxima of |gelu| meet through
//     distributed shared memory (a maximum: exact in any order), and each
//     CTA writes its columns quantized per row and chunk, int8, with the
//     chunk's scale: the int8 hidden and scales quant_rows_kernel made from
//     the f32 hidden, bit for bit, without the f32 hidden.
// Epilogues (int8: __fmul_rn / __fadd_rn, no contraction into FMAs, the
// rounding points of the TPU kernels and of the plain versions):
//   BIAS       bf16(acc + b[col])                                    K3 fc2
//   BIAS_GELU  bf16(gelu(acc + b[col]))                              K3 fc1
//   PROJ       bf16(f32(acc) * (sa[row] * s[col]) + b[col])          K5, K6
//   GELU_Q8    g = gelu(f32(acc) * (sa[row] * s[col]) + b[col]), then per
//              row and 1280-column chunk c: sq[row, c] = max(max|g|, 1e-8)
//              * (1/127), int8 clip(rint(g / sq[row, c]), -127, 127)
//              (IEEE division)                                       K4 fc1
//   SEG        acc closed at every `seg`-wide K segment c and folded as
//              accf += (f32(acc_c) * sa[row, c]) * s[col], in segment
//              order; then bf16(accf + b[col])                       K4 fc2
//   LLM_BF16 / LLM_F32  (f32(acc) * sa[row]) * s[col], no bias   W8A8 prefill
// GELU is 0.5 y (1 + erff(y / sqrt 2)) with CUDA's erff.  Up to three
// operand sets (w, s, bias, out) share one launch and one A (K5: q, k, v);
// the tile's column picks the set.  A null bias adds 0.
#pragma once

#include <cooperative_groups.h>

#include "attention_sm90.cuh"

namespace desta {
namespace gemm {

enum Epi { BIAS = 0, BIAS_GELU = 1, PROJ = 2, GELU_Q8 = 3, SEG = 4,
           LLM_BF16 = 5, LLM_F32 = 6 };

constexpr int THREADS = 384;   // two consumer warpgroups + the producer's
constexpr int K_BYTES = 128;   // a k-tile's bytes a row (one 128B-swizzle box)
constexpr int SPLITS_MAX = 8;  // the portable cluster size
constexpr int SMEM_RING = 196608;  // the ring's shared memory at most
constexpr int Q8_CHUNK = 1280; // GELU_Q8: columns quantized together

// ---------------------------------------------------------------------------
// wgmma: D (64 x N) (+)= A (64 x k) * B (k x N), A and B K-major in shared
// memory (128B-swizzled descriptors); scale_d = 0 overwrites D.  The
// accumulator's type and length pick the instruction: f32 bf16 k16 or s32
// s8 k32, N = 2 x the registers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma(int (&d)[128], uint64_t da,
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Pin accumulator registers here: no access moves across a wgmma's start
// or its wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// tiles, operands
// ---------------------------------------------------------------------------

template <typename T> struct Elem;
template <> struct Elem<bf16> {
  using Acc = float;
  static constexpr int KE = K_BYTES / 2;  // k-values a k-tile
};
template <> struct Elem<int8_t> {
  using Acc = int;
  static constexpr int KE = K_BYTES;
};

template <int BM, int BN>
struct Tile {
  static constexpr int MB = BM / 128;   // m64 blocks a consumer warpgroup
  static constexpr int ACC = BN / 2;    // accumulator registers a block
  static constexpr int STAGE_BYTES = (BM + BN) * K_BYTES;
  static constexpr int STAGES = SMEM_RING / STAGE_BYTES < 6
                                    ? SMEM_RING / STAGE_BYTES : 6;
  static constexpr int RED_LD = BN + 8;  // int32 partial tile: row stride
  // alignment, the ring, its barriers, a float a row (GELU_Q8's maxima)
  static constexpr int BARS = 16 * STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + BARS + 4 * BM;
  static_assert(BM * RED_LD * 4 <= STAGES * STAGE_BYTES,
                "the split-K partial tile reuses the ring");
};

struct Out {
  const float* s;    // [N] column scales (int8 epilogues)
  const bf16* bias;  // [N], or null for zeros
  void* out;         // [M, N]: bf16, f32 (LLM_F32) or int8 (GELU_Q8)
};

struct Args {
  Out op[3];
  const float* sa;  // int8: row scales [M, nseg]
  float* sq;        // GELU_Q8: the output's scales [M, N / Q8_CHUNK]
  int M, N, K;      // N: one operand set's columns
  int nseg;         // row-scale columns (SEG: segments; else 1)
  int seg_kt;       // SEG: k-tiles a segment
  int splits;       // CTAs of a cluster, rank r taking k-tiles r * tps..
  int tps;
  int ntn;          // BN-column tiles of one operand set
  int tn;           // BN-column tiles of all operand sets
};

__device__ __forceinline__ float gelu(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

// The int8 code of v at scale s, as quant_rows_kernel rounds it.
__device__ __forceinline__ signed char quant8(float v, float s) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

__device__ __forceinline__ float bias_at(const bf16* b, int col) {
  return b ? __bfloat162float(b[col]) : 0.f;
}

// The epilogue of the output pair (row, col..col+1) from the sums v0, v1
// (SEG: the folded f32 sums); sr: the row's scale (int8, not SEG).
template <int EPI, typename V>
__device__ __forceinline__ void store_pair(const Out& o, int N, int row,
                                           int col, V v0, V v1, float sr) {
  const size_t idx = (size_t)row * N + col;
  float y0, y1;
  if constexpr (EPI == BIAS || EPI == BIAS_GELU) {
    y0 = v0 + bias_at(o.bias, col);
    y1 = v1 + bias_at(o.bias, col + 1);
    if constexpr (EPI == BIAS_GELU) {
      y0 = gelu(y0);
      y1 = gelu(y1);
    }
  } else if constexpr (EPI == SEG) {
    y0 = __fadd_rn(v0, bias_at(o.bias, col));
    y1 = __fadd_rn(v1, bias_at(o.bias, col + 1));
  } else if constexpr (EPI == LLM_BF16 || EPI == LLM_F32) {
    y0 = __fmul_rn(__fmul_rn((float)v0, sr), o.s[col]);
    y1 = __fmul_rn(__fmul_rn((float)v1, sr), o.s[col + 1]);
  } else {  // PROJ
    y0 = __fadd_rn(__fmul_rn((float)v0, __fmul_rn(sr, o.s[col])),
                   bias_at(o.bias, col));
    y1 = __fadd_rn(__fmul_rn((float)v1, __fmul_rn(sr, o.s[col + 1])),
                   bias_at(o.bias, col + 1));
  }
  if constexpr (EPI == LLM_F32)
    *reinterpret_cast<float2*>(static_cast<float*>(o.out) + idx) =
        make_float2(y0, y1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(o.out) + idx) =
        __floats2bfloat162_rn(y0, y1);
}

// GELU_Q8: one consumer warpgroup's 64 x BN block (MB = 1) of a CTA whose
// cluster of Q8_CHUNK / BN CTAs spans one chunk.  g in registers; each row's
// max|g| over the CTA's columns into cmax (a float a tile row), the
// cluster's maxima over the chunk through distributed shared memory, then
// int8 g and, from the cluster's rank 0, the chunk's row scales.  Two
// cluster barriers (the producer warpgroup's match them).
template <int BM, int BN>
__device__ __forceinline__ void gelu_q8_epilogue(
    const int (&acc)[BN / 2], const Out& o, const Args& args, uint8_t* smem,
    int m0, int n0, int r0, int q) {
  namespace cg = cooperative_groups;
  float* cmax = reinterpret_cast<float*>(smem);
  float gv[BN / 2];
  float rmax[2] = {0.f, 0.f};
  float sr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r0 + 8 * h;
    sr[h] = row < args.M ? args.sa[row] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = o.s[col + e], b = bias_at(o.bias, col + e);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        gv[i] = gelu(__fadd_rn(__fmul_rn((float)acc[i], __fmul_rn(sr[h], s)),
                               b));
        rmax[h] = fmaxf(rmax[h], fabsf(gv[i]));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 1));
    rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 2));
    if (q == 0) cmax[r0 + 8 * h] = rmax[h];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = (int)cluster.num_blocks();
  const int nchunk = args.N / Q8_CHUNK;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float amax = 0.f;
    for (int r = 0; r < ranks; ++r)
      amax = fmaxf(amax, *cluster.map_shared_rank(cmax + r0 + 8 * h, r));
    const float s = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
    const int row = m0 + r0 + 8 * h;
    if (row >= args.M) continue;
    int8_t* qrow = static_cast<int8_t*>(o.out) + (size_t)row * args.N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      char2 v;
      v.x = quant8(gv[4 * j + 2 * h], s);
      v.y = quant8(gv[4 * j + 2 * h + 1], s);
      *reinterpret_cast<char2*>(qrow + col) = v;
    }
    if (cluster.block_rank() == 0 && q == 0)
      args.sq[(size_t)row * nchunk + n0 / Q8_CHUNK] = s;
  }
  cluster.sync();  // no CTA leaves while another reads its maxima
}

// ---------------------------------------------------------------------------
// the consumers' mainloop and epilogue
// ---------------------------------------------------------------------------

// One consumer warpgroup's pass over nk k-tiles (kt0.. of K): each stage
// holds BM rows of A then BN rows of W; the warpgroup's MB m64 blocks
// start at A row a_row0 of the stage.  Each stage's products are committed
// as a group and the previous group waited for (one in flight), then the
// previous stage is released.  SEG closes the int32 sums at each
// segment's end and folds them into accf (rows m0 + r0 + 64 mb + 8 h,
// columns n0 + 8 j + 2 q + e).
template <typename T, int BM, int BN, int EPI, int MB = BM / 128>
__device__ __forceinline__ void consume(
    typename Elem<T>::Acc (&acc)[MB][BN / 2],
    float (&accf)[EPI == SEG ? MB : 1][EPI == SEG ? BN / 2 : 1],
    uint8_t* sm, uint64_t* full, uint64_t* empty, int nk, int kt0,
    int a_row0, const Args& args, const Out& o, int m0, int n0, int r0,
    int q) {
  using namespace sm90;
  using Acc = typename Elem<T>::Acc;
  constexpr int STAGES = Tile<BM, BN>::STAGES;
  constexpr int STAGE_BYTES = Tile<BM, BN>::STAGE_BYTES;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      acc[mb][i] = 0;
      if constexpr (EPI == SEG) accf[mb][i] = 0.f;
    }
  int pend = -1;  // the stage whose wgmma group is still to be released
  for (int i = 0; i < nk; ++i) {
    const RingSlot<STAGES> sl(i);
    const int kt = kt0 + i;
    mbar_wait(&full[sl.stage], sl.parity);
    const uint8_t* st = sm + sl.stage * STAGE_BYTES;
    const uint8_t* As = st + a_row0 * K_BYTES;
    const uint8_t* Bs = st + BM * K_BYTES;
    // the first k-step of the sum (of a segment, for SEG) overwrites
    const bool fresh = EPI == SEG ? kt % args.seg_kt == 0 : i == 0;
    const bool close = EPI == SEG && ((kt + 1) % args.seg_kt == 0
                                      || i == nk - 1);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        mma(acc[mb], desc_sw128(As + mb * 64 * K_BYTES + ks * 32, 16, 1024),
            desc_sw128(Bs + ks * 32, 16, 1024), (ks == 0 && fresh) ? 0 : 1);
    wgmma_commit();
    if (close) {
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
      if (pend >= 0) mbar_arrive(&empty[pend]);
      mbar_arrive(&empty[sl.stage]);
      pend = -1;
      if constexpr (EPI == SEG) {
        // fold segment c: accf += (f32(acc) * sa[row, c]) * s[col]
        const int c = kt / args.seg_kt;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + r0 + 64 * mb + 8 * h;
            const float sr =
                row < args.M ? args.sa[(size_t)row * args.nseg + c] : 0.f;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = n0 + 8 * j + 2 * q;
              const float s0 = o.s[col], s1 = o.s[col + 1];
              float* f = &accf[mb][4 * j + 2 * h];
              const Acc* a = &acc[mb][4 * j + 2 * h];
              f[0] = __fadd_rn(f[0],
                               __fmul_rn(__fmul_rn((float)a[0], sr), s0));
              f[1] = __fadd_rn(f[1],
                               __fmul_rn(__fmul_rn((float)a[1], sr), s1));
            }
          }
      }
    } else {
      wgmma_wait<1>();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
      if (pend >= 0) mbar_arrive(&empty[pend]);
      pend = sl.stage;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
  if (pend >= 0) mbar_arrive(&empty[pend]);
}

// The epilogue from the accumulator fragments: d[4j + e] of m64 block mb
// holds row r0 + 64 mb + 8 (e >> 1), column 8 j + 2 q + (e & 1).
template <typename T, int MB, int BN, int EPI>
__device__ __forceinline__ void store_tile(
    const typename Elem<T>::Acc (&acc)[MB][BN / 2],
    const float (&accf)[EPI == SEG ? MB : 1][EPI == SEG ? BN / 2 : 1],
    const Args& args, const Out& o, int m0, int n0, int r0, int q) {
  constexpr bool INT8 = sizeof(T) == 1;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 64 * mb + 8 * h;
      if (row >= args.M) continue;
      const float sr = INT8 && EPI != SEG ? args.sa[row] : 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        if constexpr (EPI == SEG)
          store_pair<EPI>(o, args.N, row, col, accf[mb][4 * j + 2 * h],
                          accf[mb][4 * j + 2 * h + 1], sr);
        else
          store_pair<EPI>(o, args.N, row, col, acc[mb][4 * j + 2 * h],
                          acc[mb][4 * j + 2 * h + 1], sr);
      }
    }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// Both consumer warpgroups on one BM x BN tile (BM / 2 rows each).  Grid:
// x = splits * tn (the split rank fastest, then the column tile over the
// operand sets), y = the BM-row tiles; clusters along x of `splits` CTAs,
// or of Q8_CHUNK / BN for GELU_Q8.  mb0..mb2: the operand sets' weights
// [N, K] in boxes of BN rows; ma: a [M, K] in boxes of BM rows.
template <typename T, int BM, int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ma,
            const __grid_constant__ CUtensorMap mb0,
            const __grid_constant__ CUtensorMap mb1,
            const __grid_constant__ CUtensorMap mb2, const Args args) {
  using namespace sm90;
  using TL = Tile<BM, BN>;
  using Acc = typename Elem<T>::Acc;
  constexpr int MB = TL::MB, ACC = TL::ACC, STAGES = TL::STAGES;
  constexpr bool INT8 = sizeof(T) == 1;
  namespace cg = cooperative_groups;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * TL::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int splits = args.splits;
  const int rank = (int)(blockIdx.x % splits);
  const int tile = (int)(blockIdx.x / splits);
  const int which = tile / args.ntn;
  const int n0 = (tile % args.ntn) * BN, m0 = (int)blockIdx.y * BM;
  const int nkt = (args.K * (int)sizeof(T) + K_BYTES - 1) / K_BYTES;
  const int kt0 = rank * args.tps;
  const int nk = min(nkt, kt0 + args.tps) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // producer warpgroup: one thread starts the loads
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      const CUtensorMap* mb = which == 0 ? &mb0 : which == 1 ? &mb1 : &mb2;
      for (int i = 0; i < nk; ++i) {
        const RingSlot<STAGES> sl(i);
        uint8_t* st = sm + sl.stage * TL::STAGE_BYTES;
        const int k = (kt0 + i) * Elem<T>::KE;
        mbar_wait(&empty[sl.stage], sl.parity ^ 1);
        mbar_expect_tx(&full[sl.stage], TL::STAGE_BYTES);
        tma_load_2d(st, &ma, &full[sl.stage], k, m0);
        tma_load_2d(st + BM * K_BYTES, mb, &full[sl.stage], k, n0);
      }
    }
    if (splits > 1 || EPI == GELU_Q8) {  // the consumers' cluster barriers
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  // consumer warpgroup wg: rows wg * BM / 2.. of the tile
  reg_alloc<240>();
  const Out o = which == 0 ? args.op[0] : which == 1 ? args.op[1] : args.op[2];
  const int t = threadIdx.x & 127;
  const int g = (t & 31) >> 2, q = t & 3;
  const int r0 = wg * (BM / 2) + 16 * (t >> 5) + g;  // + 64 mb + 8 h
  Acc acc[MB][ACC];
  float accf[EPI == SEG ? MB : 1][EPI == SEG ? ACC : 1];
  consume<T, BM, BN, EPI>(acc, accf, sm, full, empty, nk, kt0, wg * (BM / 2),
                          args, o, m0, n0, r0, q);

  if constexpr (EPI == GELU_Q8) {
    gelu_q8_epilogue<BM, BN>(acc[0], o, args,
                             sm + STAGES * TL::STAGE_BYTES + TL::BARS, m0,
                             n0, r0, q);
    return;
  }
  if (splits == 1) {
    store_tile<T, MB, BN, EPI>(acc, accf, args, o, m0, n0, r0, q);
    return;
  }

  if constexpr (INT8 && EPI != SEG) {
    // split K: the int32 partial tile into this CTA's ring, then each rank
    // sums its slice of rows over the cluster's ranks (exact in any order)
    named_barrier(1, 256);  // both consumer warpgroups are done with the ring
    int* red = reinterpret_cast<int*>(sm);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<int2*>(
              red + (r0 + 64 * mb + 8 * h) * TL::RED_LD + 8 * j + 2 * q) =
              make_int2(acc[mb][4 * j + 2 * h], acc[mb][4 * j + 2 * h + 1]);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int per = (BM + splits - 1) / splits;
    const int lo = rank * per, hi = min(BM, lo + per);
    for (int it = threadIdx.x; it < (hi - lo) * (BN / 2); it += 256) {
      const int lr = lo + it / (BN / 2), c2 = 2 * (it % (BN / 2));
      const int row = m0 + lr;
      if (row >= args.M) continue;
      int* p = red + lr * TL::RED_LD + c2;
      int2 s = make_int2(0, 0);
      for (int r = 0; r < splits; ++r) {
        const int2 v = *reinterpret_cast<const int2*>(
            cluster.map_shared_rank(p, r));
        s.x += v.x;
        s.y += v.y;
      }
      store_pair<EPI>(o, args.N, row, n0 + c2, s.x, s.y, args.sa[row]);
    }
    cluster.sync();  // no CTA leaves while another reads its partials
  }
}


// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// A K-major [rows, K] operand's tensor map: boxes of box_rows rows x 128
// bytes, 128B swizzle, zeros out of bounds.
inline cudaError_t make_kmajor_map(CUtensorMap* map, bool int8,
                                   const void* base, int rows, int K,
                                   int box_rows) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t esize = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(K_BYTES / esize),
                             (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = fn(
      map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch configuration of a kernel: its dynamic shared memory, raised
// once per device, and a cluster of `cluster` CTAs along x.
template <typename T, int BM, int BN, int EPI>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int cluster, dim3 grid, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0 || dev >= kMaxDevices || !raised[dev]) {
    const cudaError_t e =
        sm90::allow_smem(gemm_kernel<T, BM, BN, EPI>, Tile<BM, BN>::SMEM);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < kMaxDevices) raised[dev] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = Tile<BM, BN>::SMEM;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// One launch: a [M, K] against nproj (1..3) weights w[p] [N, K]; args holds
// everything but the maps (plan_args has set its shape and cluster fields).
template <typename T, int BM, int BN, int EPI>
cudaError_t launch(const void* a, const void* const* w, int nproj,
                   const Args& args, cudaStream_t stream) {
  constexpr bool INT8 = sizeof(T) == 1;
  CUtensorMap ma, mb[3];
  cudaError_t e = make_kmajor_map(&ma, INT8, a, args.M, args.K, BM);
  for (int p = 0; p < nproj && e == cudaSuccess; ++p)
    e = make_kmajor_map(&mb[p], INT8, w[p], args.N, args.K, BN);
  if (e != cudaSuccess) return e;
  for (int p = nproj; p < 3; ++p) mb[p] = mb[0];  // unread: no encode
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const dim3 grid((unsigned)(args.splits * args.tn),
                  (unsigned)((args.M + BM - 1) / BM));
  const int cluster = EPI == GELU_Q8 ? Q8_CHUNK / BN : args.splits;
  e = configure<T, BM, BN, EPI>(&cfg, attr, cluster, grid, stream);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, gemm_kernel<T, BM, BN, EPI>, ma, mb[0], mb[1],
                         mb[2], args);
  if (e != cudaSuccess) return refuse(e);
  return cudaGetLastError();
}

// The tiles an epilogue is built for: (256, 128), (128, 256) and
// (128, 128); SEG (128, 128) and (256, 64) (its f32 sums beside the int32
// ones fit the registers of 64 columns a row only at 256 rows); GELU_Q8
// (128, 256).
template <typename T, int EPI>
cudaError_t dispatch(int bm, int bn, const void* a, const void* const* w,
                     int nproj, const Args& args, cudaStream_t stream) {
  if constexpr (EPI == GELU_Q8) {
    if (bm == 128 && bn == 256)
      return launch<T, 128, 256, EPI>(a, w, nproj, args, stream);
  } else if constexpr (EPI == SEG) {
    if (bm == 128 && bn == 128)
      return launch<T, 128, 128, EPI>(a, w, nproj, args, stream);
    if (bm == 256 && bn == 64)
      return launch<T, 256, 64, EPI>(a, w, nproj, args, stream);
  } else {
    if (bm == 256 && bn == 128)
      return launch<T, 256, 128, EPI>(a, w, nproj, args, stream);
    if (bm == 128 && bn == 256)
      return launch<T, 128, 256, EPI>(a, w, nproj, args, stream);
    if (bm == 128 && bn == 128)
      return launch<T, 128, 128, EPI>(a, w, nproj, args, stream);
  }
  return cudaErrorInvalidValue;
}

// Fill args' shape fields and check a plan: M >= 1, N a multiple of bn,
// 16-byte rows, 1..SPLITS_MAX ranks (1 for bf16, SEG and GELU_Q8) of tps
// k-tiles, none empty, the cluster the launch takes (the ranks, or
// GELU_Q8's Q8_CHUNK / bn); SEG: seg a multiple of the k-tile; GELU_Q8: N
// a multiple of Q8_CHUNK.
template <typename T>
cudaError_t plan_args(Args* args, int M, int N, int K, int nproj, int bn,
                      int splits, int cluster, int seg, int epi) {
  constexpr bool INT8 = sizeof(T) == 1;
  if (M < 1 || N < bn || bn < 1 || N % bn || K < 1
      || (K * (int)sizeof(T)) % 16 || splits < 1 || splits > SPLITS_MAX
      || (splits > 1 && (!INT8 || epi == SEG || epi == GELU_Q8)))
    return cudaErrorInvalidValue;
  const int nkt = (K * (int)sizeof(T) + K_BYTES - 1) / K_BYTES;
  const int tps = (nkt + splits - 1) / splits;
  if ((splits - 1) * tps >= nkt) return cudaErrorInvalidValue;
  if (epi == SEG && (seg < K_BYTES || seg % K_BYTES))
    return cudaErrorInvalidValue;
  if (epi == GELU_Q8 && (N % Q8_CHUNK || Q8_CHUNK % bn || splits > 1))
    return cudaErrorInvalidValue;
  if (cluster != (epi == GELU_Q8 ? Q8_CHUNK / bn : splits))
    return cudaErrorInvalidValue;
  args->M = M;
  args->N = N;
  args->K = K;
  args->splits = splits;
  args->tps = tps;
  args->ntn = N / bn;
  args->tn = nproj * (N / bn);
  args->nseg = epi == SEG ? (K + seg - 1) / seg : 1;
  args->seg_kt = epi == SEG ? seg / K_BYTES : 1;
  return cudaSuccess;
}

// How many clusters of `splits` CTAs of a cooperative (bm, bn) kernel the
// current device runs at once (cudaOccupancyMaxActiveClusters): the
// planner's slots of a wave.
template <typename T, int EPI>
cudaError_t max_clusters(int bm, int bn, int splits, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const dim3 grid((unsigned)(splits * 132), 1);
  cudaError_t e = cudaErrorInvalidValue;
  if (bm == 128 && bn == 256) {
    e = configure<T, 128, 256, EPI>(&cfg, attr, splits, grid, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(count, gemm_kernel<T, 128, 256, EPI>,
                                         &cfg);
  } else if (bm == 256 && bn == 128) {
    e = configure<T, 256, 128, EPI>(&cfg, attr, splits, grid, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(count, gemm_kernel<T, 256, 128, EPI>,
                                         &cfg);
  } else if (bm == 128 && bn == 128) {
    e = configure<T, 128, 128, EPI>(&cfg, attr, splits, grid, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(count, gemm_kernel<T, 128, 128, EPI>,
                                         &cfg);
  }
  return e == cudaSuccess ? e : refuse(e);
}

}  // namespace gemm
}  // namespace desta
