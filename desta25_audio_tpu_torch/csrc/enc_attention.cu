// K2: packed bidirectional attention for the Whisper encoder and the
// Q-Former cross-attention.
//
// Replaces: desta25_audio_tpu/ops/enc_attention.py::_kernel (the Pallas TPU
//   kernel behind packed_encoder_attention).
// Computes: per (batch, head), softmax(q k^T / sqrt(Dh)) v on the packed
//   projection layout q [B, Tq, H*Dh], k/v [B, Tkv, H*Dh] bf16 -> o [B, Tq,
//   H*Dh] bf16.  Rounding points of the TPU kernel are kept: the scale is
//   folded into q in bf16 when it is a power of two (1/8 at Dh=64: exact,
//   so the kernel applies it to the f32 score and gets the same bits),
//   scores and softmax are f32, P is rounded to bf16 before the PV product,
//   and the f32 sum of exponentials divides the output once at the end.
// What bounds it on the H100: tensor-core math for the encoder's self-
//   attention (B=2, T=1500, H=20: 4*B*H*T*T*Dh = 23 GFLOP against 23 MB,
//   0.0233 ms at 989 TFLOP/s); the bytes for the Q-Former's cross-attention
//   (8 x 64 queries against 1500 keys: 64 MB of k and v, 0.0191 ms at 3.35
//   TB/s).  The [Tq, Tkv] score matrix never leaves registers.
// Design (Hopper: TMA, an mbarrier ring, wgmma; attention_sm90.cuh):
//   one block of 384 threads per (128 query rows, head, batch): two
//   consumer warpgroups of 64 rows and a producer warpgroup, one thread of
//   which starts every load (a whole warpgroup, so that setmaxnreg can move
//   its registers to the consumers: 24 against 240).  The producer loads
//   the q tile once and streams k/v tiles of 128 keys through a ring of 4
//   stages by TMA, reading the packed layout in place through 3-D tensor
//   maps (H*64, T, B) with boxes (64, 128, 1) at column h*64: no
//   transposes.  Each consumer forms S = Q K^T with wgmma m64n128k16 (both
//   operands in shared memory), runs the online softmax in registers
//   (exp2 with log2 e folded into the scale), rounds P to bf16 in registers
//   and feeds it as the A operand of O += P V (wgmma m64n64k16, V read
//   MN-major from the ring), then releases the stage.  Keys at or past Tkv
//   score -inf (TMA's zero fill is not a mask); query rows past Tq are
//   computed on zeros and never stored.
//   The cross shape (Tq <= 64: one warpgroup's rows per (head, batch))
//   would leave half of each block idle and launch too few blocks: the
//   wrapper's planner (ops/enc_attention.plan_key_splits) cuts the keys
//   into ranges of whole tiles, each block's two warpgroups take two ranges
//   (two stages each; the loads alternate), each range writes its f32
//   (acc, m, l) to scratch, and a second launch combines the ranges in a
//   fixed order and divides once.

#include "attention_sm90.cuh"

namespace {

using namespace desta;
using namespace desta::sm90;

constexpr int DH = 64;            // head dim (every Whisper and Q-Former size)
constexpr int BQ = 128;           // query rows per block: 2 warpgroups x 64
constexpr int BK = FWD_BK;        // keys per tile
constexpr int STAGES = 4;  // split: 2 per warpgroup
constexpr int TILE_BYTES = BK * DH * 2;  // one k, v or q tile: 16 KB
constexpr int SMEM_BYTES =
    TILE_BYTES * (1 + 2 * STAGES) + 8 * (1 + 2 * STAGES) + 1024;
constexpr int THREADS = 384;      // 2 consumer warpgroups + 1 producer
constexpr float LOG2E = 1.4426950408889634f;

// Which key tiles each consumer warpgroup takes, in which ring stage each
// lands, and in what order the producer loads them.  One range: both
// warpgroups take every tile, through one ring of STAGES.  Split: warpgroup
// w takes range 2 * blockIdx.x + w through its own ring, stages 2w and
// 2w + 1 (a shared ring would let one warpgroup, skipping the other's
// tiles, wait on a stage a whole phase early and pass on the stale parity),
// and the loads alternate between the two ranges while both have tiles.
struct Schedule {
  bool split;
  int a[2], n[2];  // first tile and tile count of each warpgroup's range

  __device__ Schedule(int Tkv, int splits, int tps) {
    const int nt = (Tkv + BK - 1) / BK;
    split = splits > 1;
    for (int w = 0; w < 2; ++w) {
      const int p = 2 * blockIdx.x + w;
      a[w] = split ? p * tps : 0;
      n[w] = !split ? nt : p < splits ? min(tps, nt - a[w]) : 0;
    }
  }
  __device__ int loads() const { return split ? n[0] + n[1] : n[0]; }
  // load i -> (warpgroup w, its tile m); one range: w = 0 for both
  __device__ void load(int i, int& w, int& m) const {
    const int mn = min(n[0], n[1]);
    if (!split) {
      w = 0;
      m = i;
    } else if (i < 2 * mn) {
      w = i & 1;
      m = i >> 1;
    } else {
      w = n[0] > n[1] ? 0 : 1;
      m = mn + i - 2 * mn;
    }
  }
};

// The stage and the consumers' wait parity of warpgroup w's m-th tile.
__device__ __forceinline__ void enc_slot(bool split, int w, int m, int& stage,
                                         uint32_t& parity) {
  stage = split ? 2 * w + (m & 1) : m % STAGES;
  parity = (uint32_t)(split ? m >> 1 : m / STAGES) & 1u;
}

// Warpgroup w's key tiles, as fwd_loop reads them: tile i starts at key
// (a + i) * BK; keys at or past Tkv are masked.
struct EncTiles {
  bool split;
  int w, a, Tkv;
  const bf16* ring;
  uint64_t* full;
  uint64_t* empty;

  __device__ int stage(int i) const {
    int st;
    uint32_t parity;
    enc_slot(split, w, i, st, parity);
    return st;
  }
  __device__ const bf16* k(int i) const {
    return ring + stage(i) * 2 * BK * DH;
  }
  __device__ const bf16* v(int i) const { return k(i) + BK * DH; }
  __device__ void wait(int i) const {
    int st;
    uint32_t parity;
    enc_slot(split, w, i, st, parity);
    mbar_wait(&full[st], parity);
  }
  __device__ void release(int i) const { mbar_arrive(&empty[stage(i)]); }
  // only the last tile of the keys holds keys at or past Tkv
  struct Mask {
    bool any;
    int k0, Tkv;
    __device__ bool keep(int, int col) const { return k0 + col < Tkv; }
  };
  __device__ Mask mask(int i) const {
    const int k0 = (a + i) * BK;
    return Mask{k0 + BK > Tkv, k0, Tkv};
  }
};

__global__ void __launch_bounds__(THREADS, 1)
enc_attention_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     bf16* __restrict__ o, float* __restrict__ part,
                     float* __restrict__ part_ml, int B, int Tq, int Tkv,
                     int H, float scale_log2, int splits, int tps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* ring = Qs + BQ * DH;  // stage s: k at ring + 2 s BK DH, v after it
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(sm + TILE_BYTES * (1 + 2 * STAGES));
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.y, b = blockIdx.z;
  const Schedule sc(Tkv, splits, tps);
  const int q0 = sc.split ? 0 : blockIdx.x * BQ;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], sc.split ? 128 : 256);  // the owners' threads
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // producer warpgroup: one thread starts the loads
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, TILE_BYTES);
      tma_load_3d(Qs, &mq, q_full, h * DH, q0, b);
      for (int i = 0; i < sc.loads(); ++i) {
        int w, m, stage;
        uint32_t parity;
        sc.load(i, w, m);
        enc_slot(sc.split, w, m, stage, parity);
        const int k0 = (sc.a[w] + m) * BK;
        bf16* Ks = ring + stage * 2 * BK * DH;
        mbar_wait(&empty[stage], parity ^ 1);
        mbar_expect_tx(&full[stage], 2 * TILE_BYTES);
        tma_load_3d(Ks, &mk, &full[stage], h * DH, k0, b);
        tma_load_3d(Ks + BK * DH, &mv, &full[stage], h * DH, k0, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows qrow0.. of the q tile
    reg_alloc<240>();
    const int t = threadIdx.x & 127, g = (t & 31) >> 2, q = t & 3;
    const int qrow0 = sc.split ? 0 : 64 * wg;
    FwdState<DH> st;
    st.init();
    mbar_wait(q_full, 0);
    // (constant indices: a runtime index would put `sc` in local memory)
    const int a = wg ? sc.a[1] : sc.a[0], n = wg ? sc.n[1] : sc.n[0];
    const EncTiles tiles{sc.split, wg, a, Tkv, ring, full, empty};
    fwd_loop<DH, BQ>(st, Qs, qrow0, n, scale_log2, tiles);

    const int p = 2 * blockIdx.x + wg;  // the split's index
    for (int r = 0; r < 2; ++r) {
      const float l = st.row_sum(r);
      const int row = q0 + qrow0 + (t >> 5) * 16 + g + 8 * r;
      if (row >= Tq || (sc.split && p >= splits)) continue;
      if (!sc.split) {
        bf16* orow = o + ((size_t)b * Tq + row) * H * DH + h * DH;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * q) =
              __floats2bfloat162_rn(st.o[4 * j + 2 * r] / l,
                                    st.o[4 * j + 2 * r + 1] / l);
      } else {
        const size_t idx = (((size_t)p * B + b) * H + h) * Tq + row;
        float* prow = part + idx * DH;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<float2*>(prow + 8 * j + 2 * q) =
              make_float2(st.o[4 * j + 2 * r], st.o[4 * j + 2 * r + 1]);
        if (q == 0) {
          part_ml[2 * idx] = st.m[r] * scale_log2;  // log2 units
          part_ml[2 * idx + 1] = l;
        }
      }
    }
  }
}

// The key ranges' (acc, m, l) -> o: one warp per (batch, head, query row),
// the ranges summed in order, one division.
__global__ void __launch_bounds__(256)
enc_attention_combine_kernel(const float* __restrict__ part,
                             const float* __restrict__ part_ml,
                             bf16* __restrict__ o, int B, int Tq, int H,
                             int splits) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int rows = B * H * Tq;
  if (r >= rows) return;
  const int row = r % Tq, h = (r / Tq) % H, b = r / (Tq * H);
  float mx = -INFINITY;
  for (int p = 0; p < splits; ++p)
    mx = fmaxf(mx, part_ml[2 * ((size_t)p * rows + r)]);
  float l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int p = 0; p < splits; ++p) {
    const size_t idx = (size_t)p * rows + r;
    const float w = exp2f(part_ml[2 * idx] - mx);
    const float2 v =
        *reinterpret_cast<const float2*>(part + idx * DH + 2 * lane);
    l += w * part_ml[2 * idx + 1];
    a0 += w * v.x;
    a1 += w * v.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(
      o + ((size_t)b * Tq + row) * H * DH + h * DH + 2 * lane) =
      __floats2bfloat162_rn(a0 / l, a1 / l);
}

}  // namespace

extern "C" int desta_enc_attention(const void* q, const void* k, const void* v,
                                   void* o, void* part, void* part_ml, int B,
                                   int Tq, int Tkv, int H, float scale,
                                   int splits, int tps, void* stream) {
  if (splits < 1 || (splits > 1 && (Tq > 64 || tps < 1)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  const cuuint64_t row = (cuuint64_t)H * DH * 2;
  const cuuint64_t dq[3] = {(cuuint64_t)H * DH, (cuuint64_t)Tq, (cuuint64_t)B};
  const cuuint64_t dk[3] = {(cuuint64_t)H * DH, (cuuint64_t)Tkv,
                            (cuuint64_t)B};
  const cuuint64_t sq[2] = {row, row * Tq}, sk[2] = {row, row * Tkv};
  const cuuint32_t box[3] = {DH, BK, 1};
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (make_map(&mq, bf, 3, q, dq, sq, box) != cudaSuccess
      || make_map(&mk, bf, 3, k, dk, sk, box) != cudaSuccess
      || make_map(&mv, bf, 3, v, dk, sk, box) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  dim3 grid(splits > 1 ? (splits + 1) / 2 : (Tq + BQ - 1) / BQ, H, B);
  const cudaError_t e = allow_smem(enc_attention_kernel, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  enc_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, (float*)part, (float*)part_ml, B, Tq, Tkv, H,
      scale * LOG2E, splits, tps);
  return (int)cudaGetLastError();
}

extern "C" int desta_enc_attention_combine(const void* part,
                                           const void* part_ml, void* o,
                                           int B, int Tq, int H, int splits,
                                           void* stream) {
  const int rows = B * H * Tq;
  enc_attention_combine_kernel<<<(rows + 7) / 8, 256, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)part, (const float*)part_ml, (bf16*)o, B, Tq, H, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* desta_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
