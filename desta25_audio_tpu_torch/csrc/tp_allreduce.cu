// K10's collective: the all-reduce of the "model" ranks' f32 partial sums
// of the wo and w_down products, for a decode / verify step run once per
// tensor-parallel shard (ops/fused_decode_mesh.py; and the per-layer pair
// K9 under a mesh, ops/fused_decode_tp.py), fused with the residual add and
// the next half's RMSNorm.
//
// Replaces: desta25_audio_tpu/ops/fused_decode.py::_make_kernel's
//   allreduce_into_h (:660-729) -- inside the single-launch TPU kernel,
//   every shard remote-DMAs its [Mp, D] f32 partial into slot [slot, my] of
//   every peer's receive buffer, waits for the p-1 receives and adds the sum
//   into the bf16 residual, h += bf16(tot), which the next half's rmsn
//   (:385) then normalises; and the psum of fused_decode_tp.py:631-736 (f32
//   residual, h = h + tot).
// Two halves, launched on each rank's own stream, both with programmatic
// dependent launch (common.cuh pdl_*):
//   * the producer: the wo / down GEMM of csrc/skinny_gemm.cuh with the
//     PEER_F32 epilogue (desta_gemm_peer below).  Each output element is
//     stored, unrounded, into slot [slot][my] of every rank's receive
//     buffer [2, p, R, D] (the rank's own included), through a device table
//     of the ranks' buffer pointers; the last of its blocks to finish then
//     release-stores the round's epoch into every rank's flag word
//     [slot][my] (system scope: the stores are fenced first).
//   * the consumer (tp_allreduce_kernel): one block a row (at most
//     AR_MAX_BLOCKS blocks, each taking rows r, r + grid, ...), thread 0
//     spins with ld.acquire.sys until every rank's flag [slot][d] holds the
//     round's epoch; then each thread sums its 8-value vectors of the row in
//     rank order d = 0..p-1 (bypassing L1, whose lines may hold a previous
//     round), adds the sum into h at the TPU kernel's rounding point, h =
//     bf16(h + bf16(tot)) for K10's bf16 residual, h = h + tot (f32) for
//     K9's, and, given the next half's norm weight, writes that norm of the
//     new row, xn = bf16(h * rsqrt(mean(h^2) + eps) * w), with the thread
//     layout and arithmetic of the step's own norm (csrc/fused_decode.cu,
//     common.cuh rms_*): for a bf16 residual xn is, bit for bit, what that
//     norm's launch on the new h gives.  One launch replaces the all-reduce
//     and the norm after it.
// Epochs on the device: each rank holds a base word (int64) that the host
//   fills before every step, stream-ordered (MeshBuffers.begin in
//   ops/tp_allreduce.py), with the group's count of rounds so far; a launch
//   carries only its round within the step, 2 * layer + half + 1, fixed
//   across a CUDA graph's replays, and producer and consumer both take
//   epoch = base + round.  base grows by every step's 2 * L rounds, across
//   steps and generate() calls alike, so no epoch repeats and no flag is
//   ever reset.
// Summation order: the JAX kernel sums its own partial first, then d =
//   0..p-1 past its own (its own slot reads 0), tot = pres + sum_d rbuf.  At
//   p = 2 that is p0 + p1 on both ranks (f32 addition commutes), which this
//   kernel computes.  At p >= 3 the JAX order differs between ranks (rank 2
//   adds (p2 + p0) + p1, rank 0 (p0 + p1) + p2), so the ranks' residuals can
//   part by one rounding and the shards then run on different inputs; here
//   every rank sums in rank order, which is rank 0's JAX order, and the
//   residuals stay replicated bit for bit at any p.
// Slots: attention round 0, MLP round 1, alternating in every step.  A
//   slot is never overwritten before it is read (the argument of
//   fused_decode.py:666-671): rank q's next write into rank r's slot 0 is
//   its next layer's wo GEMM, whose stores and flag follow its
//   programmatic-launch wait, so they come after q's MLP consumer
//   completed, which saw r's MLP flag; r's down GEMM publishes that flag
//   only after its own wait, so after r's attention consumer completed
//   reading slot 0 (a kernel completes only after its wait, so completion
//   follows stream order down the chain, the gate/up GEMM in between).  The
//   same holds with the slots swapped, and across steps and a graph's
//   replays (the next step's wo GEMM follows the last MLP consumer).
// PDL, what the consumer reads and when: before griddepcontrol.wait only
//   the norm weight (no kernel writes it); after it the error word, the
//   base word (filled by the host before the step: the wait orders every
//   kernel before this one), the flags, the partials and h.  The peers'
//   flags could be polled before the wait (they are release-stored and
//   read with acquire), but the round's epoch needs the base word, and its
//   own producer completes just before, so nothing is gained.  The consumer
//   lets its dependents start only after its spin has seen every flag.
// Liveness: every spin is bounded (SPIN_CYCLES of clock64, about two
//   seconds); a timeout sets the error word and leaves h and xn untouched.
//   A consumer that finds the error word already set does not wait again,
//   so a step after a lost round runs to its end in about one timeout; the
//   wrapper reads the word after the step, or generate() once at the end of
//   its call, and raises a RuntimeError.  The grid is at most AR_MAX_BLOCKS
//   blocks, so p ranks' spinning consumers on one card never take the SMs a
//   peer's GEMM still needs.  Under PDL a consumer becomes resident when
//   its producer GEMM's CTAs have finished their mainloops, so all of them
//   are resident already; and it triggers its own dependents only after
//   its spin, so no kernel of its rank that waits on it (the next GEMM, two
//   CTAs an SM) is resident while it spins and a peer still needs the SMs.
// What bounds it on the H100: device-memory bandwidth, p*R*D*4 bytes of
//   partials read, h read and written, the weight read and xn written, a
//   few tens of KB at decode sizes: launch latency and the wait dominate.

#include "skinny_gemm.cuh"

namespace {

using namespace desta;

constexpr int AR_MAX_BLOCKS = 16;
constexpr long long SPIN_CYCLES = 4000000000LL;

__device__ __forceinline__ long long ld_acquire_sys(const long long* addr) {
  long long v;
  asm volatile("ld.acquire.sys.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void load8_cg(const float* p, float f[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// rbuf [2, p, rows, D] f32 and flags [2, p]: this rank's; h [rows, D] f32
// (F32) or bf16; w [D] bf16 and xn [rows, D] bf16, or both null (no norm).
// Thread t holds the row's vectors t, t + blockDim.x, ... (NV of them).
template <bool F32, int NV>
__global__ void __launch_bounds__(RMS_THREADS_MAX)
tp_allreduce_kernel(const float* __restrict__ rbuf, const long long* flags,
                    void* h, const bf16* __restrict__ w, bf16* xn, int p,
                    int slot, const long long* base, long long round,
                    int rows, int D, float eps, int* err) {
  __shared__ float red[RMS_THREADS_MAX / 32];
  __shared__ int ready;
  const int nvec = D / 8;
  uint4 wr[NV];
  if (w != nullptr) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {  // the weight: no kernel writes it
      const int v = threadIdx.x + i * blockDim.x;
      if (v < nvec) wr[i] = __ldg(reinterpret_cast<const uint4*>(w) + v);
    }
  }
  pdl_wait();
  if (threadIdx.x == 0) {
    int ok = __ldcg(err) == 0;
    const long long epoch = __ldcg(base) + round;
    const long long* f = flags + (size_t)slot * p;
    const long long t0 = clock64();
    for (int d = 0; d < p && ok; ++d)
      while (ld_acquire_sys(f + d) < epoch) {
        if (clock64() - t0 > SPIN_CYCLES) {
          ok = 0;
          break;
        }
        __nanosleep(64);
      }
    if (!ok) atomicExch(err, 1);
    ready = ok;
  }
  __syncthreads();
  if (!ready) return;
  pdl_launch_dependents();
  const size_t n = (size_t)rows * D;
  const float* part = rbuf + (size_t)slot * p * n;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    float hv[NV][8];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v < nvec) {
        const size_t o = (size_t)r * D + (size_t)v * 8;
        float tot[8];
        load8_cg(part + o, tot);
        for (int d = 1; d < p; ++d) {
          float q[8];
          load8_cg(part + (size_t)d * n + o, q);
#pragma unroll
          for (int e = 0; e < 8; ++e) tot[e] = __fadd_rn(tot[e], q[e]);
        }
        if constexpr (F32) {
          float4* hf = reinterpret_cast<float4*>(static_cast<float*>(h) + o);
          const float4 a = hf[0], b = hf[1];
          const float old[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) hv[i][e] = __fadd_rn(old[e], tot[e]);
          hf[0] = make_float4(hv[i][0], hv[i][1], hv[i][2], hv[i][3]);
          hf[1] = make_float4(hv[i][4], hv[i][5], hv[i][6], hv[i][7]);
        } else {
          uint4* hb = reinterpret_cast<uint4*>(static_cast<bf16*>(h) + o);
          float old[8];
          rms_unpack8(*hb, old);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            hv[i][e] = round_bf16(old[e] + round_bf16(tot[e]));
          uint4 u;
          u.x = pack_bf16(hv[i][0], hv[i][1]);
          u.y = pack_bf16(hv[i][2], hv[i][3]);
          u.z = pack_bf16(hv[i][4], hv[i][5]);
          u.w = pack_bf16(hv[i][6], hv[i][7]);
          *hb = u;
        }
        ss = rms_sumsq8(hv[i], ss);
      }
    }
    if (xn == nullptr) continue;  // uniform across the block
    ss = block_sum(ss, red);
    const float inv = rms_inv(ss, D, eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v < nvec)
        reinterpret_cast<uint4*>(xn + (size_t)r * D)[v] =
            rms_scale8(hv[i], wr[i], inv);
    }
  }
}

template <bool F32, int NV>
cudaError_t launch_allreduce(const float* rbuf, const long long* flags,
                             void* h, const bf16* w, bf16* xn, int p,
                             int slot, const long long* base, long long round,
                             int rows, int D, float eps, int* err,
                             int threads, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows < AR_MAX_BLOCKS ? rows : AR_MAX_BLOCKS));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {pdl_attribute()};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, tp_allreduce_kernel<F32, NV>, rbuf, flags, h, w, xn, p, slot, base,
      round, rows, D, eps, err);
  return e == cudaSuccess ? cudaGetLastError() : refuse(e);
}

template <bool F32>
cudaError_t dispatch_allreduce(const float* rbuf, const long long* flags,
                               void* h, const bf16* w, bf16* xn, int p,
                               int slot, const long long* base,
                               long long round, int rows, int D, float eps,
                               int* err, cudaStream_t st) {
  const int threads = rms_threads(D);
  const int nv = (D / 8 + threads - 1) / threads;
  return nv == 1 ? launch_allreduce<F32, 1>(rbuf, flags, h, w, xn, p, slot,
                                            base, round, rows, D, eps, err,
                                            threads, st)
         : nv == 2 ? launch_allreduce<F32, 2>(rbuf, flags, h, w, xn, p, slot,
                                              base, round, rows, D, eps, err,
                                              threads, st)
         : nv <= 4 ? launch_allreduce<F32, 4>(rbuf, flags, h, w, xn, p, slot,
                                              base, round, rows, D, eps, err,
                                              threads, st)
                   : launch_allreduce<F32, 8>(rbuf, flags, h, w, xn, p, slot,
                                              base, round, rows, D, eps, err,
                                              threads, st);
}

}  // namespace

// The producer: x [M, K] bf16 times w [N, K] (bf16, or int8 with one f32
// scale per row: w_int8 = 1), the scaled f32 sums stored into every rank's
// receive buffer and the round's epoch, *base + round, published (PeerStore
// in skinny_gemm.cuh).  dst_table / flag_table: device arrays of p
// pointers; counter: this rank's arrival counter for the slot (0 between
// uses); offset, flag: the slot's; base: this rank's step word (int64).
extern "C" int desta_gemm_peer(const void* x, const void* w, const void* scale,
                               int w_int8, int M, int N, int K,
                               const void* dst_table, const void* flag_table,
                               void* counter, long long offset, int p, int flag,
                               const void* base, long long round,
                               void* stream) {
  const int vec = w_int8 ? 16 : 8;
  if (M < 1 || N < 8 || N % 8 || K < vec || K % vec || p < 1 || round < 1
      || base == nullptr)
    return (int)cudaErrorInvalidValue;
  PeerStore ps;
  ps.dst = static_cast<const unsigned long long*>(dst_table);
  ps.flags = static_cast<const unsigned long long*>(flag_table);
  ps.counter = static_cast<unsigned int*>(counter);
  ps.offset = offset;
  ps.base = static_cast<const long long*>(base);
  ps.round = round;
  ps.p = p;
  ps.flag = flag;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      w_int8 ? launch_skinny<int8_t, EPI_PEER_F32>(
                   (const bf16*)x, (const int8_t*)w, (const float*)scale,
                   nullptr, M, N, K, st, nullptr, ps)
             : launch_skinny<bf16, EPI_PEER_F32>(
                   (const bf16*)x, (const bf16*)w, nullptr, nullptr, M, N, K,
                   st, nullptr, ps);
  return (int)e;
}

// The consumer: h [rows, D] (bf16, or f32 with h_f32 = 1) += the sum of
// slot `slot` of rbuf [2, p, rows, D] once every flag [slot][d] >= *base +
// round; with norm_w [D] bf16, also xn [rows, D] bf16 = the norm of the new
// rows (eps); err: an int32 word set to 1 on a timeout (and read: a set
// word skips the wait).  D a multiple of 8 up to 32768, 16-byte aligned
// rows.
extern "C" int desta_tp_allreduce(const void* rbuf, const void* flags, void* h,
                                  int h_f32, int p, int slot, const void* base,
                                  long long round, int rows, int D,
                                  const void* norm_w, void* xn, float eps,
                                  void* err, void* stream) {
  if (rows < 1 || D < 8 || D % 8 || D / 8 > RMS_THREADS_MAX * RMS_NV_MAX
      || p < 1 || slot < 0 || slot > 1 || round < 1 || base == nullptr
      || err == nullptr || (norm_w == nullptr) != (xn == nullptr)
      || (reinterpret_cast<uintptr_t>(rbuf) | reinterpret_cast<uintptr_t>(h)
          | reinterpret_cast<uintptr_t>(norm_w)
          | reinterpret_cast<uintptr_t>(xn)) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* rb = (const float*)rbuf;
  const long long* fl = (const long long*)flags;
  const long long* bs = (const long long*)base;
  const bf16* wb = (const bf16*)norm_w;
  bf16* xb = (bf16*)xn;
  return (int)(h_f32 ? dispatch_allreduce<true>(rb, fl, h, wb, xb, p, slot, bs,
                                                round, rows, D, eps, (int*)err,
                                                st)
                     : dispatch_allreduce<false>(rb, fl, h, wb, xb, p, slot,
                                                 bs, round, rows, D, eps,
                                                 (int*)err, st));
}

// Let device `dev` reach device `peer`'s memory (dev != peer); a pair
// already enabled is no error.
extern "C" int desta_enable_peer_access(int dev, int peer) {
  if (dev == peer) return (int)cudaErrorInvalidDevice;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}
