// K1: the Whisper log-mel frontend before its clip-wide clamp.
//
// Replaces: desta25_audio_tpu/ops/mel_pallas.py::_mel_kernel (wrapper
//   log_mel_pallas): per block of frames, the windowed real DFT as three
//   f32 products over hop rows (Precision.HIGHEST), power re^2 + im^2, the
//   filterbank product and log10(max(mel, 1e-10)), the [F, bins] power kept
//   in VMEM.  The clip-wide max(x, max - 8) and (x + 4) / 4 stay outside.
// What bounds it on the H100: device-memory bytes.  Per frame the function
//   needs a real 400-point FFT (~8.6 kFLOP) and the filterbank's nonzero
//   entries (at most two filters a bin: 394 entries at 128 mels, 391 at
//   80), ~30 MFLOP a 3000-frame clip, ~0.5 us at 67 TFLOP/s f32, against
//   ~3.5 MB moved (the audio in, the log-mels out), ~1 us at 3.35 TB/s.
//   The TPU kernel's dense DFT (400 x 402 multiply-adds a frame, ~1.1 GFLOP
//   a clip) would be bound by f32 FMA instead, so this kernel does not do
//   it: it computes the same function as an FFT and a sparse filterbank,
//   in f32 throughout (no TF32, bf16 or tensor cores: the reference runs
//   HIGHEST), with every trigonometric value taken from the host's float64
//   tables rounded to f32 (no sin / cos in the kernel).
// Design: one 320-thread CTA per (clip, tile of FT = 8 frames): 375 CTAs
//   at B = 1 x 3000 frames, 2.8 a 132-SM card's SM, all resident at once.
//   1. The CTA stages the tile's 160 * 7 + 400 samples in shared memory
//      with coalesced 16-byte loads where they are 16-byte aligned (else
//      4-byte loads), reflect-padding by index at the clip's
//      ends (padded sample p is audio[|p - 200|] mirrored at the end), so
//      no padded copy of the audio exists; with them the window, the
//      twiddles and the sparse filterbank, so that no later phase waits on
//      device memory.
//   2. The 400-point real transform of frame f is one 200-point complex FFT
//      of z[j] = x_w[2j] + i x_w[2j + 1] (x_w the windowed samples, the
//      window applied as the pairs are read), a Stockham autosort FFT of
//      three stages, radix 8, 5 and 5, ping-ponging between two shared
//      buffers: stage s's butterfly j reads v[r] = in[j + r * 200 / R],
//      turns v[r] by W200^(k r 200 / (Ns R)) (k = j % Ns, Ns the length
//      transformed so far), takes their R-point DFT and writes it to
//      out[(j / Ns) Ns R + k + r Ns].  A frame's butterflies are one group
//      of 25 (radix 8) or 40 (radix 5) threads.  Index i of a buffer lives
//      at i + i / 8: the radix-8 stage writes 8 consecutive values a thread,
//      a stride of 9 float2 between neighbours, no two of 16 threads in one
//      bank pair; the radix-5 stages read and write at strides of 8 and 40.
//   3. Bins 0..200 come from the split
//        X[k] = (Z[k] + conj Z[200 - k]) / 2
//               - i W400^k (Z[k] - conj Z[200 - k]) / 2,
//      a thread taking bins k and 200 - k from the same two loads; the power
//      is rounded as the plain version rounds it (two products, then the
//      sum) into shared memory, over the buffer the last stage read.  The
//      [F, 201] spectrum and power never reach device memory.
//   4. A thread a (mel, 4 frames) sums the mel's contiguous nonzero bins
//      in f32 in ascending order (the dense product adds exact zeros
//      besides), reading each weight once for its four frames, and writes
//      log10f(fmaxf(mel, 1e-10f)); a warp's stores are 32 consecutive mels
//      of a frame row, and the tile's [8, n_mels] output one contiguous
//      run.
//   Any frame count: the last tile's frames past `frames` are computed on
//   zero samples and not written.

#include "common.cuh"

namespace {

constexpr int HOP = 160;
constexpr int NFFT = 400;
constexpr int NC = NFFT / 2;                 // the complex FFT's 200 points
constexpr int NBINS = NC + 1;                // 201
constexpr int FT = 8;                        // frames a CTA
constexpr int THREADS = 320;                 // 8 frames x 40 radix-5 groups
constexpr int SAMPLES = HOP * (FT - 1) + NFFT;
constexpr int ZPAD = NC + NC / 8;            // a frame's padded buffer: 225
constexpr int PW = 204;                      // a frame's power row
constexpr int NTW = NC + NBINS;              // twiddle rows: 200 + 201
constexpr int MAX_MELS = 128;
constexpr int FB_WEIGHTS = 2 * NBINS;        // at most two filters a bin

static_assert(SAMPLES % 4 == 0 && (HOP * FT) % 4 == 0 && NFFT % 8 == 0,
              "16-byte staging of the samples");
static_assert(THREADS == FT * (NC / 5), "one radix-5 butterfly a thread");
static_assert(FT == 8 && 2 * MAX_MELS <= THREADS, "a mel of 4 frames a thread");
static_assert(FT * PW <= 2 * FT * ZPAD, "the power fits a buffer");

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}
// a * e^{-i t}, w = (cos t, sin t)
__device__ __forceinline__ float2 turn(float2 a, float2 w) {
  return make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}

// in-place 8-point DFT, W8 = e^{-2 pi i / 8}; h = cos(pi / 4)
__device__ __forceinline__ void dft8(float2 (&v)[8], float h) {
  const float2 a0 = cadd(v[0], v[4]), a1 = csub(v[0], v[4]);
  const float2 a2 = cadd(v[2], v[6]), a3 = csub(v[2], v[6]);
  const float2 a4 = cadd(v[1], v[5]), a5 = csub(v[1], v[5]);
  const float2 a6 = cadd(v[3], v[7]), a7 = csub(v[3], v[7]);
  const float2 e0 = cadd(a0, a2), e2 = csub(a0, a2);
  const float2 e1 = cadd(a1, mul_mi(a3)), e3 = csub(a1, mul_mi(a3));
  const float2 o0 = cadd(a4, a6), o2 = csub(a4, a6);
  const float2 o1 = cadd(a5, mul_mi(a7)), o3 = csub(a5, mul_mi(a7));
  // W8 o1, W8^2 o2 = -i o2, W8^3 o3
  const float2 w1 = make_float2(h * (o1.x + o1.y), h * (o1.y - o1.x));
  const float2 w2 = mul_mi(o2);
  const float2 w3 = make_float2(h * (o3.y - o3.x), -(h * (o3.x + o3.y)));
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, w1);
  v[5] = csub(e1, w1);
  v[2] = cadd(e2, w2);
  v[6] = csub(e2, w2);
  v[3] = cadd(e3, w3);
  v[7] = csub(e3, w3);
}

// in-place 5-point DFT, W5 = e^{-2 pi i / 5}: (c1, s1) = (cos, sin) of
// 2 pi / 5, (c2, s2) of 4 pi / 5
__device__ __forceinline__ void dft5(float2 (&v)[5], float c1, float s1,
                                     float c2, float s2) {
  const float2 b1 = cadd(v[1], v[4]), d1 = csub(v[1], v[4]);
  const float2 b2 = cadd(v[2], v[3]), d2 = csub(v[2], v[3]);
  const float2 t1 = make_float2(v[0].x + c1 * b1.x + c2 * b2.x,
                                v[0].y + c1 * b1.y + c2 * b2.y);
  const float2 t2 = make_float2(v[0].x + c2 * b1.x + c1 * b2.x,
                                v[0].y + c2 * b1.y + c1 * b2.y);
  const float2 u1 = make_float2(s1 * d1.x + s2 * d2.x,
                                s1 * d1.y + s2 * d2.y);
  const float2 u2 = make_float2(s2 * d1.x - s1 * d2.x,
                                s2 * d1.y - s1 * d2.y);
  v[0] = cadd(cadd(v[0], b1), b2);
  v[1] = cadd(t1, mul_mi(u1));
  v[4] = csub(t1, mul_mi(u1));
  v[2] = cadd(t2, mul_mi(u2));
  v[3] = csub(t2, mul_mi(u2));
}

// a radix-5 Stockham stage over the CTA's frames: NS points transformed so
// far; one butterfly a thread (THREADS == FT * NC / 5)
template <int NS>
__device__ __forceinline__ void radix5(const float2* in, float2* out,
                                       const float2* tw, int tid, float c1,
                                       float s1, float c2, float s2) {
  constexpr int Q = NC / 5;                    // 40 butterflies a frame
  constexpr int STEP = NC / (NS * 5);          // twiddle index step
  const int f = tid / Q, j = tid % Q, k = j % NS;
  const float2* src = in + f * ZPAD;
  float2* dst = out + f * ZPAD;
  float2 v[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) v[r] = src[pad(j + r * Q)];
#pragma unroll
  for (int r = 1; r < 5; ++r) v[r] = turn(v[r], tw[k * r * STEP]);
  dft5(v, c1, s1, c2, s2);
  const int d = (j / NS) * NS * 5 + k;
#pragma unroll
  for (int r = 0; r < 5; ++r) dst[pad(d + r * NS)] = v[r];
}

// bin k of the real transform from Z[k], Z[200 - k] (mod 200) and
// W400^k = (cos, sin) of 2 pi k / 400, as its power
__device__ __forceinline__ float split_power(float2 zk, float2 zm,
                                             float2 w) {
  const float2 e = make_float2(zk.x + zm.x, zk.y - zm.y);   // Z[k] + conj
  const float2 d = make_float2(zk.x - zm.x, zk.y + zm.y);   // Z[k] - conj
  // i W400^k d = (s d.x - c d.y) + i (c d.x + s d.y)
  const float re = 0.5f * (e.x - (w.y * d.x - w.x * d.y));
  const float im = 0.5f * (e.y - (w.x * d.x + w.y * d.y));
  // the power as the plain version rounds it: two products, then the sum
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio,
               const float* __restrict__ window,
               const float2* __restrict__ twiddles,
               const int* __restrict__ fb_index,
               const float* __restrict__ fb_weights,
               float* __restrict__ out, int n, int frames, int n_mels) {
  __shared__ __align__(16) float xs[SAMPLES];
  __shared__ __align__(16) float2 win[NC];
  __shared__ float2 tw[NTW];
  __shared__ int fbi[3 * MAX_MELS];
  __shared__ float fbw[FB_WEIGHTS];
  __shared__ __align__(16) float2 za[FT * ZPAD];
  __shared__ __align__(16) float2 zb[FT * ZPAD];
  const int b = blockIdx.y, f0 = blockIdx.x * FT, tid = threadIdx.x;
  const float* a = audio + (size_t)b * n;

  // 1. samples, window and twiddles
  const int p0 = HOP * f0 - NFFT / 2;   // padded position of xs[0]
  // 16-byte loads only where the tile's first sample is 16-byte aligned
  // (p0 is a multiple of 4: the clip's start and the caller's pointer)
  if (p0 >= 0 && p0 + SAMPLES <= n &&
      (reinterpret_cast<uintptr_t>(a + p0) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(a + p0);
    for (int i = tid; i < SAMPLES / 4; i += THREADS)
      reinterpret_cast<float4*>(xs)[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < SAMPLES; i += THREADS) {
      int p = p0 + i;
      if (p < 0) p = -p;
      if (p > n - 1) p = 2 * (n - 1) - p;
      // past the last frame's window (ragged tile) the value is never used
      xs[i] = (p >= 0 && p < n) ? __ldg(a + p) : 0.f;
    }
  }
  for (int i = tid; i < NC; i += THREADS)
    win[i] = __ldg(reinterpret_cast<const float2*>(window) + i);
  for (int i = tid; i < NTW; i += THREADS) tw[i] = __ldg(twiddles + i);
  for (int i = tid; i < 3 * n_mels; i += THREADS) fbi[i] = __ldg(fb_index + i);
  for (int i = tid; i < FB_WEIGHTS; i += THREADS)
    fbw[i] = __ldg(fb_weights + i);
  __syncthreads();
  const float h = tw[25].x;                    // cos(pi / 4)
  const float c1 = tw[40].x, s1 = tw[40].y;    // 2 pi / 5
  const float c2 = tw[80].x, s2 = tw[80].y;    // 4 pi / 5

  // 2. stage 1, radix 8 (Ns = 1: no twiddles): z[j] read from the samples
  //    as (even, odd) pairs, windowed; 25 butterflies a frame
  if (tid < FT * (NC / 8)) {
    const int f = tid / (NC / 8), j = tid % (NC / 8);
    const float2* x2 = reinterpret_cast<const float2*>(xs) + (HOP / 2) * f;
    float2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = j + r * (NC / 8);
      const float2 x = x2[m], w = win[m];
      v[r] = make_float2(x.x * w.x, x.y * w.y);
    }
    dft8(v, h);
    float2* dst = za + f * ZPAD;
#pragma unroll
    for (int r = 0; r < 8; ++r) dst[pad(8 * j + r)] = v[r];
  }
  __syncthreads();
  radix5<8>(za, zb, tw, tid, c1, s1, c2, s2);
  __syncthreads();
  radix5<40>(zb, za, tw, tid, c1, s1, c2, s2);
  __syncthreads();

  // 3. the split and the power, bins k and 200 - k a thread (za -> zb)
  float* pw = reinterpret_cast<float*>(zb);
  for (int it = tid; it < FT * (NC / 2 + 1); it += THREADS) {
    const int f = it / (NC / 2 + 1), k = it % (NC / 2 + 1);
    const float2* z = za + f * ZPAD;
    const float2 zk = z[pad(k)], zm = z[pad((NC - k) % NC)];
    pw[f * PW + k] = split_power(zk, zm, tw[NC + k]);
    if (k != NC / 2)
      pw[f * PW + NC - k] = split_power(zm, zk, tw[2 * NC - k]);
  }
  __syncthreads();

  // 4. the sparse filterbank and log10: a thread takes one mel of four
  //    frames (2 * n_mels <= THREADS), reading the mel's index and each
  //    weight once for the four; a warp's stores are 32 consecutive mels of
  //    a frame row
  if (tid < 2 * n_mels) {
    const int g = tid < n_mels ? 0 : 1, m = tid - g * n_mels;
    const int fa = 4 * g, valid = frames - f0 - fa;
    const float* p = pw + fa * PW + fbi[3 * m];
    const float* w = fbw + fbi[3 * m + 2];
    const int count = fbi[3 * m + 1];
    float mel[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < count; ++t) {
      const float wt = w[t];
#pragma unroll
      for (int i = 0; i < 4; ++i) mel[i] = fmaf(p[i * PW + t], wt, mel[i]);
    }
    float* o = out + ((size_t)b * frames + f0 + fa) * n_mels + m;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < valid) o[(size_t)i * n_mels] = log10f(fmaxf(mel[i], 1e-10f));
  }
}

}  // namespace

// audio [B, n] f32; window [400] f32 (the periodic Hann window);
// twiddles [401, 2] f32: (cos, sin) of 2 pi m / 200 for m = 0..199, then of
// 2 pi k / 400 for k = 0..200; fb_index [n_mels, 3] int32 (each mel's first
// nonzero bin, its count of bins, the offset of its weights) and
// fb_weights f32 [402], zero past the last mel's (ops/mel.py's
// kernel_tables); out [B, frames, n_mels] f32, frames <= n / 160
extern "C" int desta_log_mel(const void* audio, const void* window,
                             const void* twiddles, const void* fb_index,
                             const void* fb_weights, void* out, int B, int n,
                             int frames, int n_mels, void* stream) {
  if (B < 1 || n <= NFFT / 2 || frames < 1 || frames > n / HOP || n_mels < 1
      || n_mels > MAX_MELS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((frames + FT - 1) / FT, B);
  log_mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)window, (const float2*)twiddles,
      (const int*)fb_index, (const float*)fb_weights, (float*)out, n, frames,
      n_mels);
  return (int)cudaGetLastError();
}
