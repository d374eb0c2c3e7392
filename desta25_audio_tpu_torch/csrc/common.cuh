// Shared helpers for the desta25_audio_tpu_torch Hopper kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace desta {

// A failed runtime call's status, with the runtime's last-error state read
// and so cleared: the entry points return cudaGetLastError() after their
// launches, and a refusal left behind would fail the next, good, launch.
inline cudaError_t refuse(cudaError_t e) {
  cudaGetLastError();
  return e;
}

// Two floats -> one 32-bit register of two bf16 (round to nearest even);
// `lo` lands in the low half, the element with the smaller index in an
// mma fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The current device, or 0 if the runtime cannot say.
inline int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return dev;
}

// The current device's SM count, read once per device (132 where the
// runtime cannot say): the planners' card size.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0 || dev >= kMaxDevices) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess) {
      cudaGetLastError();
      return 132;
    }
    counts[dev] = n;
  }
  return counts[dev];
}

// Programmatic dependent launch (sm_90).  A kernel launched with
// pdl_attribute() may start while the kernel before it in the stream (or
// the graph) drains.  Before pdl_wait() it may only do what depends on no
// predecessor: set up shared memory and barriers, prefetch tensor maps,
// read inputs no kernel writes (weights); it reads nothing a predecessor
// writes and writes no global memory.  pdl_wait() returns once every
// predecessor has completed and its writes are visible, so a chain of such
// kernels keeps stream order for what comes after the wait.  Every thread
// of such a kernel calls pdl_wait() before its first dependent access.
// pdl_launch_dependents() lets the next kernel's CTAs start (its own
// pdl_wait() still waits for this kernel to complete); without it they
// start as this kernel's CTAs exit.  Both are no-ops in a kernel launched
// without the attribute.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

inline cudaLaunchAttribute pdl_attribute() {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  a.val.programmaticStreamSerializationAllowed = 1;
  return a;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// RMSNorm's arithmetic on one thread's 8-value vectors, shared by the decode
// step's norm (csrc/fused_decode.cu) and the all-reduce that writes the next
// half's norm (csrc/tp_allreduce.cu), so that both give the same bits for
// the same row and thread layout: the squares summed into ss by fused
// multiply-adds in vector order, the block's sum (block_sum), then
// out = bf16(x * inv * w) with inv = rsqrtf(ss / D + eps).
__device__ __forceinline__ void rms_unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ float rms_sumsq8(const float f[8], float ss) {
#pragma unroll
  for (int e = 0; e < 8; ++e) ss = __fmaf_rn(f[e], f[e], ss);
  return ss;
}
__device__ __forceinline__ float rms_inv(float ss, int D, float eps) {
  return rsqrtf(ss / (float)D + eps);
}
__device__ __forceinline__ uint4 rms_scale8(const float f[8], const uint4& w,
                                            float inv) {
  float g[8];
  rms_unpack8(w, g);
  uint4 o;
  o.x = pack_bf16(f[0] * inv * g[0], f[1] * inv * g[1]);
  o.y = pack_bf16(f[2] * inv * g[2], f[3] * inv * g[3]);
  o.z = pack_bf16(f[4] * inv * g[4], f[5] * inv * g[5]);
  o.w = pack_bf16(f[6] * inv * g[6], f[7] * inv * g[7]);
  return o;
}
// The norm's block: min(RMS_THREADS_MAX, D / 8 rounded up to a warp)
// threads, each holding its vectors t, t + threads, ... (up to RMS_NV_MAX).
constexpr int RMS_THREADS_MAX = 512;  // D = 4096: 512 threads x 8
constexpr int RMS_NV_MAX = 8;         // 16-byte vectors a thread: D <= 32768
inline int rms_threads(int D) {
  const int nvec = D / 8;
  return nvec < RMS_THREADS_MAX ? (nvec + 31) / 32 * 32 : RMS_THREADS_MAX;
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulation.
// Fragment layout (g = lane / 4, t = lane % 4):
//   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   b0 (k=2t..2t+1, n=g)  b1 (k=2t+8.., n=g)
//   c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte global -> shared copy that bypasses L1; src_bytes = 0 zero-fills
// the destination (ragged row edges).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum / max over the whole block; `red` holds one float per warp.  Every
// thread gets the result.  Contains __syncthreads(): call uniformly.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = -INFINITY;
  for (int i = 0; i < nw; ++i) t = fmaxf(t, red[i]);
  return t;
}

}  // namespace desta
