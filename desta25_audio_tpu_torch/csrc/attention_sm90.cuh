// Hopper (sm_90a) building blocks shared by the attention kernels K2
// (enc_attention.cu), K11 (flash_attention.cu) and the decode attention
// (decode_attention.cuh: the TMA maps, mbarriers and loads), and reusable by
// any later wgmma/TMA kernel of the package:
//
//   - TMA tensor maps, encoded on the host with cuTensorMapEncodeTiled (found
//     through cudaGetDriverEntryPoint, so the library links no -lcuda) and
//     passed to a kernel by value as `const __grid_constant__ CUtensorMap`;
//     bf16 tiles use the 128-byte swizzle, out-of-bounds elements read as 0;
//   - mbarrier helpers (init, arrive, arrive.expect_tx, try_wait.parity) for
//     a ring of STAGES tiles with one "full" and one "empty" barrier a stage;
//   - TMA loads (cp.async.bulk.tensor, 1-D to 4-D) that complete on an
//     mbarrier;
//   - wgmma.mma_async wrappers, bf16 in and f32 accumulate, m64n64k16 and
//     m64n128k16: SS (A and B from shared memory, both K-major) and RS (A
//     from registers, B from shared memory stored MN-major, tnspB = 1, or
//     K-major, tnspB = 0: K7's int8 weights as A, csrc/qmm.cu), with
//     the shared-memory descriptors of a 128B-swizzled tile;
//   - setmaxnreg, to hand registers from the producer warpgroup to the
//     consumer warpgroups.
//
// Tile layout in shared memory: a [ROWS, D] bf16 tile (D = 64 or 128) is
// stored as D / 64 column halves of [ROWS, 64], half c at byte c * ROWS *
// 128, each row 128 bytes, in TMA's 128B swizzle (16-byte chunk j of row r
// at chunk j ^ (r % 8)).  Every half starts on a 1024-byte boundary, so the
// swizzle phase is the address's own and descriptors need no base offset.
//   K-major view (the tile's rows are M or N, its columns K): a k-step of
//     16 columns starts 32 bytes further inside a half, the next half after
//     4 steps; 8-row groups are 1024 bytes apart (SBO).
//   MN-major view (rows are K, columns N; tnspB): a k-step of 16 rows starts
//     2048 bytes further; 8-row groups are 1024 bytes apart (SBO) and the
//     64-column halves ROWS * 128 bytes apart (LBO).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include "common.cuh"

namespace desta {
namespace sm90 {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tiled tensor map over `rank` dims (innermost first) with unit element
// strides.  `strides` holds the byte strides of dims 1..rank-1.  bf16 maps
// take the 128B swizzle (box[0] must then be 64); others none.  Returns
// cudaErrorInvalidValue if cuTensorMapEncodeTiled refuses the map.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type,
                            int rank, const void* base,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint64_t none[1] = {0};
  const CUresult r = fn(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
      rank > 1 ? strides : none, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A flat map over n 32-bit elements read in boxes of `box` (segment ids,
// log-sum-exp rows): any start coordinate, zeros past n.
inline cudaError_t make_map_1d(CUtensorMap* map, CUtensorMapDataType type,
                               const void* base, size_t n, unsigned box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint32_t boxes[1] = {box};
  return make_map(map, type, 1, base, dims, nullptr, boxes);
}

// Raise the kernel's dynamic shared-memory limit, then launch-check.
template <class Kernel>
inline cudaError_t allow_smem(Kernel* k, int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e == cudaSuccess ? e : refuse(e);
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The dynamic shared-memory base rounded up to 1024 bytes (the launch asks
// for 1024 bytes more than it uses).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's current phase parity differs from `parity`.  A
// wait that lasts 2^33 clocks (seconds; a tile takes microseconds) is a
// broken ring: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > (1ll << 33)) __trap();
  }
}

// Ring bookkeeping for the i-th tile of a producer/consumer sequence.
template <int STAGES>
struct RingSlot {
  int stage;
  uint32_t parity;  // the consumers' wait parity; the producer waits on ^1
  __device__ __forceinline__ explicit RingSlot(int i)
      : stage(i % STAGES), parity((uint32_t)(i / STAGES) & 1u) {}
};

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Barrier `id` (not 0, which __syncthreads uses) over `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// device: register rebalancing
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin an accumulator's registers at this point of the program: no access
// to them moves across an asynchronous wgmma's start or its wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x by the SFU (ex2.approx, flushing results below 2^-126 to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// Shared-memory matrix descriptor of a 128B-swizzled operand.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}

// K-major operand: rows row0.. of a [ROWS, D] tile, k-step ks (16 columns).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int row0,
                                           int ks) {
  return desc_sw128(reinterpret_cast<const uint8_t*>(tile)
                        + (ks >> 2) * ROWS * 128 + (ks & 3) * 32 + row0 * 128,
                    16, 1024);
}

// MN-major operand (tnspB): k-step ks covers rows 16 ks.. of a [ROWS, D]
// tile, N runs along its columns.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int ks) {
  return desc_sw128(reinterpret_cast<const uint8_t*>(tile) + ks * 2048,
                    ROWS * 128, 1024);
}

// Accumulator layout of m64nN (f32) for thread t of the warpgroup (warp
// w = t / 32, g = t % 32 / 4, q = t % 4): d[4j + e] holds row 16 w + g +
// 8 (e >> 1), column 8 j + 2 q + (e & 1).  The RS form's A fragment of a
// k-step (16 columns) takes the same places, so columns 16 kk..16 kk + 15
// of an accumulator become the A operand of k-step kk in bf16:
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* d) {
  a[0] = pack_bf16(d[0], d[1]);
  a[1] = pack_bf16(d[2], d[3]);
  a[2] = pack_bf16(d[4], d[5]);
  a[3] = pack_bf16(d[6], d[7]);
}

// D (64 x N, f32) += A (64 x 16) * B (16 x N), bf16.  SS: A and B K-major in
// shared memory.  RS: A from registers, B MN-major (TNSP_B = 1, the
// default: Wgmma<N>::rs) or K-major (TNSP_B = 0: Wgmma<N>::rs_k, B's
// descriptor as the SS form's, desc_k).  scale-d = 1.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

template <int TNSP_B = 1>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TNSP_B));
}

template <int TNSP_B = 1>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TNSP_B));
}


template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b) {
    wgmma_ss_n64(d, a, b);
  }
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
  __device__ __forceinline__ static void rs_k(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    wgmma_rs_n64<0>(d, a, b);
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b) {
    wgmma_ss_n128(d, a, b);
  }
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
  __device__ __forceinline__ static void rs_k(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    wgmma_rs_n128<0>(d, a, b);
  }
};

// ---------------------------------------------------------------------------
// the attention forward step shared by K2 and K11
// ---------------------------------------------------------------------------

// One consumer warpgroup's online-softmax state over its 64 query rows;
// this thread's rows are 16 w + g and 16 w + g + 8 of the warpgroup.
template <int DH>
struct FwdState {
  float o[DH / 2];  // unnormalised output: the m64nDH accumulator
  float m[2];       // running max of the raw scores q . k
  float l[2];       // this thread's share of the running f32 sum
  __device__ __forceinline__ void init() {
    zero(o);
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
  // the full row sum of row r (the four threads of a row hold its columns)
  __device__ __forceinline__ float row_sum(int r) const {
    float v = l[r];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
  }
};

constexpr int FWD_BK = 128;  // keys per tile of the forward

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// S = Q K^T for one key tile (SS, both K-major); started, not committed.
template <int DH, int QROWS>
__device__ __forceinline__ void start_scores(float (&s)[FWD_BK / 2],
                                             const bf16* Qs, int qrow0,
                                             const bf16* Ks) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    Wgmma<FWD_BK>::ss(s, desc_k<QROWS>(Qs, qrow0, ks),
                      desc_k<FWD_BK>(Ks, 0, ks));
}

// O += P V for one key tile (RS, V read MN-major); started, not committed.
template <int DH>
__device__ __forceinline__ void start_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[FWD_BK / 16][4],
                                         const bf16* Vs) {
#pragma unroll
  for (int kk = 0; kk < FWD_BK / 16; ++kk)
    Wgmma<DH>::rs(o, a[kk], desc_mn<FWD_BK>(Vs, kk));
}

// The online softmax of key tile i's scores s = q . k: where the tile's
// mask mk = tl.mask(i) has mk.any, the keys with mk.keep(r, col) false (r:
// the thread's row 0 or 1, col: the key in the tile) at -inf; the new row max m; the weights
// 2^(s c - m c) with c = scale_log2 (the softmax scale times log2 e, one
// FFMA and one ex2 an element) and their f32 row sum; `corr`, the factor
// the output accumulator takes for the new max; the weights rounded to
// bf16 as the A operand `a` of O += P V.  A row whose keys in the tile are
// all masked keeps its state.
template <int DH, class Tiles>
__device__ __forceinline__ void softmax_step(FwdState<DH>& st,
                                             float (&s)[FWD_BK / 2],
                                             float scale_log2, int i,
                                             const Tiles& tl, float (&corr)[2],
                                             uint32_t (&a)[FWD_BK / 16][4]) {
  constexpr int BK = FWD_BK;
  const int q = threadIdx.x & 3;
  const auto mk = tl.mask(i);
  if (mk.any) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!mk.keep(e >> 1, 8 * j + 2 * q + (e & 1)))
          s[4 * j + e] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = st.m[r];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float base = mx == -INFINITY ? 0.f : mx * scale_log2;  // no inf-inf
    corr[r] = fast_exp2(st.m[r] * scale_log2 - base);
    st.m[r] = mx;
    st.l[r] *= corr[r];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float e0 = fast_exp2(fmaf(s[4 * j + 2 * r], scale_log2, -base));
      const float e1 =
          fast_exp2(fmaf(s[4 * j + 2 * r + 1], scale_log2, -base));
      st.l[r] += e0 + e1;  // the f32 denominator, unrounded
      s[4 * j + 2 * r] = e0;
      s[4 * j + 2 * r + 1] = e1;
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(a[kk], s + 8 * kk);
}

template <int DH>
__device__ __forceinline__ void rescale(FwdState<DH>& st,
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[4 * j + e] *= corr[e >> 1];
}

// One consumer warpgroup's pass over its n key tiles.  `tl` gives tile i's
// k and v (tl.k(i), tl.v(i)), waits for it (tl.wait(i)), releases it to the
// producer (tl.release(i)) and gives its mask (tl.mask(i)).  Each tile's
// products and softmax run in turn; the two consumer warpgroups of a block
// interleave, so one's softmax overlaps the other's products.  (Overlapping
// a tile's softmax with the previous tile's P V inside one warpgroup was no
// faster on the H100 and made ptxas serialise the wgmma.)  Qs: a [QROWS, DH]
// tile, the warpgroup's rows from qrow0; k and v tiles are [FWD_BK, DH].
template <int DH, int QROWS, class Tiles>
__device__ __forceinline__ void fwd_loop(FwdState<DH>& st, const bf16* Qs,
                                         int qrow0, int n, float scale_log2,
                                         const Tiles& tl) {
  float s[FWD_BK / 2], corr[2];
  uint32_t a[FWD_BK / 16][4];
  for (int i = 0; i < n; ++i) {
    tl.wait(i);
    zero(s);
    fence_regs(s);
    wgmma_fence();
    start_scores<DH, QROWS>(s, Qs, qrow0, tl.k(i));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_step(st, s, scale_log2, i, tl, corr, a);
    rescale(st, corr);
    fence_regs(st.o);
    fence_regs(a);
    wgmma_fence();
    start_pv<DH>(st.o, a, tl.v(i));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st.o);
    fence_regs(a);
    tl.release(i);
  }
}

}  // namespace sm90
}  // namespace desta
