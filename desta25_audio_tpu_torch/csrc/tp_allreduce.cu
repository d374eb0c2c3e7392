// K10's collective: the all-reduce of the "model" ranks' f32 partial sums
// of the wo and w_down products, for a decode / verify step run once per
// tensor-parallel shard (ops/fused_decode_mesh.py; and the per-layer pair
// K9 under a mesh, ops/fused_decode_tp.py).
//
// Replaces: desta25_audio_tpu/ops/fused_decode.py::_make_kernel's
//   allreduce_into_h (:660-729) -- inside the single-launch TPU kernel,
//   every shard remote-DMAs its [Mp, D] f32 partial into slot [slot, my] of
//   every peer's receive buffer, waits for the p-1 receives and adds the sum
//   into the bf16 residual, h += bf16(tot); and the psum of
//   fused_decode_tp.py:631-736 (f32 residual, h = h + tot).
// Two halves, launched on each rank's own stream:
//   * the producer: the wo / down GEMM of csrc/skinny_gemm.cuh with the
//     PEER_F32 epilogue (desta_gemm_peer below).  Each output element is
//     stored, unrounded, into slot [slot][my] of every rank's receive
//     buffer [2, p, R, D] (the rank's own included), through a device table
//     of the ranks' buffer pointers; the last of its blocks to finish then
//     release-stores the round's epoch into every rank's flag word
//     [slot][my] (system scope: the stores are fenced first).
//   * the consumer (tp_allreduce_kernel): one thread of each block spins
//     with ld.acquire.sys until every rank's flag [slot][d] holds the epoch,
//     then the block sums its elements in rank order d = 0..p-1 (bypassing
//     L1, whose lines may hold a previous round) and adds the sum into h at
//     the TPU kernel's rounding point: h = bf16(h + bf16(tot)) for K10's
//     bf16 residual, h = h + tot (f32) for K9's.
// Summation order: the JAX kernel sums its own partial first, then d =
//   0..p-1 past its own (its own slot reads 0), tot = pres + sum_d rbuf.  At
//   p = 2 that is p0 + p1 on both ranks (f32 addition commutes), which this
//   kernel computes.  At p >= 3 the JAX order differs between ranks (rank 2
//   adds (p2 + p0) + p1, rank 0 (p0 + p1) + p2), so the ranks' residuals can
//   part by one rounding and the shards then run on different inputs; here
//   every rank sums in rank order, which is rank 0's JAX order, and the
//   residuals stay replicated bit for bit at any p.
// Slots: attention round 0, MLP round 1, and an epoch per round that only
//   grows (one per all-reduce of the mesh's buffers; flags are never reset).
//   A slot is never overwritten before it is read (the argument of
//   fused_decode.py:666-671, carried by stream order): rank q's next write
//   into rank r's slot 0 is its next layer's wo GEMM, which q's stream runs
//   only after q's MLP all-reduce saw r's MLP flag; r's stream publishes
//   that flag (its down GEMM) only after r's attention all-reduce finished
//   reading slot 0.  The same holds with the slots swapped.
// Liveness: every spin is bounded (SPIN_CYCLES of clock64, about two
//   seconds); a timeout sets the error word, which the wrapper reads after
//   the step and raises as a RuntimeError, and leaves h untouched.  The
//   grid is at most AR_MAX_BLOCKS blocks, so p ranks' spinning blocks on
//   one card never take the SMs a peer's GEMM still needs; the wrapper
//   launches every rank's producer before any rank's consumer.
// What bounds it on the H100: device-memory bandwidth, p*R*D*4 bytes of
//   partials read and h read and written (R*D*2 each way for bf16), a few
//   hundred KB at decode sizes: launch latency and the wait dominate.

#include "skinny_gemm.cuh"

namespace {

using namespace desta;

constexpr int AR_THREADS = 256;
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

// rbuf [2, p, n] f32 and flags [2, p]: this rank's; h [n] f32 or bf16.
template <bool F32>
__global__ void __launch_bounds__(AR_THREADS)
tp_allreduce_kernel(const float* rbuf, const long long* flags, void* h,
                    int p, int slot, long long epoch, int n, int* err) {
  __shared__ int ready;
  if (threadIdx.x == 0) {
    const long long* f = flags + (size_t)slot * p;
    const long long t0 = clock64();
    int ok = 1;
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
  const float* part = rbuf + (size_t)slot * p * n;
  for (int i = blockIdx.x * AR_THREADS + threadIdx.x; i < n;
       i += gridDim.x * AR_THREADS) {
    float tot = __ldcg(part + i);
    for (int d = 1; d < p; ++d) tot = __fadd_rn(tot, __ldcg(part + (size_t)d * n + i));
    if constexpr (F32) {
      float* hf = static_cast<float*>(h);
      hf[i] = __fadd_rn(hf[i], tot);
    } else {
      bf16* hb = static_cast<bf16*>(h);
      hb[i] = __float2bfloat16(__bfloat162float(hb[i]) + round_bf16(tot));
    }
  }
}

}  // namespace

// The producer: x [M, K] bf16 times w [N, K] (bf16, or int8 with one f32
// scale per row: w_int8 = 1), the scaled f32 sums stored into every rank's
// receive buffer and the epoch published (PeerStore in skinny_gemm.cuh).
// dst_table / flag_table: device arrays of p pointers; counter: this rank's
// arrival counter for the slot (0 between uses); offset, flag: the slot's.
extern "C" int desta_gemm_peer(const void* x, const void* w, const void* scale,
                               int w_int8, int M, int N, int K,
                               const void* dst_table, const void* flag_table,
                               void* counter, long long offset, int p, int flag,
                               long long epoch, void* stream) {
  const int vec = w_int8 ? 16 : 8;
  if (M < 1 || N < 8 || N % 8 || K < vec || K % vec || p < 1 || epoch < 1)
    return (int)cudaErrorInvalidValue;
  PeerStore ps;
  ps.dst = static_cast<const unsigned long long*>(dst_table);
  ps.flags = static_cast<const unsigned long long*>(flag_table);
  ps.counter = static_cast<unsigned int*>(counter);
  ps.offset = offset;
  ps.epoch = epoch;
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
// slot `slot` of rbuf [2, p, rows, D] once every flag [slot][d] >= epoch;
// err: an int32 word set to 1 on a timeout.
extern "C" int desta_tp_allreduce(const void* rbuf, const void* flags, void* h,
                                  int h_f32, int p, int slot, long long epoch,
                                  int rows, int D, void* err, void* stream) {
  if (rows < 1 || D < 1 || p < 1 || slot < 0 || slot > 1 || epoch < 1)
    return (int)cudaErrorInvalidValue;
  const int n = rows * D;
  const int want = (n + AR_THREADS - 1) / AR_THREADS;
  const int grid = want < AR_MAX_BLOCKS ? want : AR_MAX_BLOCKS;
  const cudaStream_t st = (cudaStream_t)stream;
  if (h_f32)
    tp_allreduce_kernel<true><<<grid, AR_THREADS, 0, st>>>(
        (const float*)rbuf, (const long long*)flags, h, p, slot, epoch, n,
        (int*)err);
  else
    tp_allreduce_kernel<false><<<grid, AR_THREADS, 0, st>>>(
        (const float*)rbuf, (const long long*)flags, h, p, slot, epoch, n,
        (int*)err);
  return (int)cudaGetLastError();
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
