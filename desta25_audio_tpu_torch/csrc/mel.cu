// K1: the Whisper log-mel frontend before its clip-wide clamp.
//
// Replaces: desta25_audio_tpu/ops/mel_pallas.py::_mel_kernel (wrapper
//   log_mel_pallas): per block of frames, the windowed real DFT as three
//   f32 products over hop rows (Precision.HIGHEST), power re^2 + im^2, the
//   filterbank product and log10(max(mel, 1e-10)), the [F, bins] power kept
//   in VMEM.  The clip-wide max(x, max - 8) and (x + 4) / 4 stay outside.
// What bounds it on the H100: device-memory bytes.  The function needs per
//   frame a real 400-point FFT (~8.6 kFLOP) and the filterbank's nonzero
//   entries (at most two filters a bin, ~0.8 kFLOP at 128 mels): ~32 MFLOP
//   per 3000-frame clip against ~3.5 MB moved, ~1 us at 3.35 TB/s.  This
//   kernel does the dense DFT instead (400 x 402 multiply-adds a frame, the
//   TPU kernel's form, ~1.12 GFLOP a clip), so it runs far above that
//   bound; an FFT form is a later step.  The TPU kernel's HIGHEST precision
//   is kept: f32 FMA throughout, no TF32 (3xTF32 or wgmma is a later step).
// Design: one 256-thread block per (clip, tile of 32 frames).  The block
//   stages the tile's 160 * 31 + 400 samples in shared memory, reflect-
//   padding by index (padded sample p is audio[|p - 200|] mirrored at the
//   clip's end), so no padded copy of the audio exists.  It then loops over
//   7 tiles of 32 DFT bins (bins padded 201 -> 224 with zero columns): each
//   warp owns 4 frames, each lane one bin, and accumulates re and im over
//   the 400 samples in registers (the DFT matrices stream through L1/L2,
//   one coalesced 128-byte row segment per sample; the samples are shared-
//   memory broadcasts).  The tile's power goes to shared memory and is
//   folded straight into the frame tile's mel sums (lane = filter column,
//   4 columns a thread), so the [F, 201] power never reaches device memory.
//   Any frame count: the last tile masks its frames past F.

#include "common.cuh"

namespace {

constexpr int HOP = 160;
constexpr int NFFT = 400;
constexpr int FT = 32;                       // frames a block
constexpr int BT = 32;                       // bins a tile (one per lane)
constexpr int BINS_PAD = 224;                // 201 bins in 7 tiles of 32
constexpr int THREADS = 256;
constexpr int FPW = FT / (THREADS / 32);     // frames a warp: 4
constexpr int MCOL = 4;                      // filter columns a thread
constexpr int SAMPLES = HOP * (FT - 1) + NFFT;

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ wc,
               const float* __restrict__ ws, const float* __restrict__ fb,
               float* __restrict__ out, int n, int frames, int n_mels) {
  __shared__ float xs[SAMPLES];
  __shared__ float pw[FT * BT];
  const int b = blockIdx.y, f0 = blockIdx.x * FT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* a = audio + (size_t)b * n;

  for (int i = tid; i < SAMPLES; i += THREADS) {
    int p = HOP * f0 + i - NFFT / 2;
    if (p < 0) p = -p;
    if (p > n - 1) p = 2 * (n - 1) - p;
    // past the last frame's window (ragged tile) the value is never used
    xs[i] = (p >= 0 && p < n) ? a[p] : 0.f;
  }
  __syncthreads();

  float mel[FPW][MCOL];
#pragma unroll
  for (int i = 0; i < FPW; ++i)
#pragma unroll
    for (int c = 0; c < MCOL; ++c) mel[i][c] = 0.f;
  const float* x0 = xs + HOP * FPW * warp;

  for (int bt = 0; bt < BINS_PAD; bt += BT) {
    float re[FPW], im[FPW];
#pragma unroll
    for (int i = 0; i < FPW; ++i) re[i] = im[i] = 0.f;
    const float* cp = wc + bt + lane;
    const float* sp = ws + bt + lane;
#pragma unroll 4
    for (int k = 0; k < NFFT; ++k) {
      const float c = __ldg(cp + (size_t)k * BINS_PAD);
      const float s = __ldg(sp + (size_t)k * BINS_PAD);
#pragma unroll
      for (int i = 0; i < FPW; ++i) {
        const float x = x0[HOP * i + k];
        re[i] = fmaf(x, c, re[i]);
        im[i] = fmaf(x, s, im[i]);
      }
    }
    // power as the plain version rounds it: two products, then the sum
#pragma unroll
    for (int i = 0; i < FPW; ++i)
      pw[(warp * FPW + i) * BT + lane] =
          __fadd_rn(__fmul_rn(re[i], re[i]), __fmul_rn(im[i], im[i]));
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float* frow = fb + (size_t)(bt + j) * n_mels;
      float fv[MCOL];
#pragma unroll
      for (int c = 0; c < MCOL; ++c) {
        const int m = lane + 32 * c;
        fv[c] = m < n_mels ? __ldg(frow + m) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FPW; ++i) {
        const float p = pw[(warp * FPW + i) * BT + j];
#pragma unroll
        for (int c = 0; c < MCOL; ++c) mel[i][c] = fmaf(p, fv[c], mel[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FPW; ++i) {
    const int f = f0 + warp * FPW + i;
    if (f >= frames) continue;
    float* orow = out + ((size_t)b * frames + f) * n_mels;
#pragma unroll
    for (int c = 0; c < MCOL; ++c) {
      const int m = lane + 32 * c;
      if (m < n_mels) orow[m] = log10f(fmaxf(mel[i][c], 1e-10f));
    }
  }
}

}  // namespace

// audio [B, n] f32; wc / ws [400, 224] f32 windowed cos / -sin with zero
// columns past bin 200; fb [224, n_mels] f32 with zero rows past bin 200;
// out [B, frames, n_mels] f32, frames = n / 160
extern "C" int desta_log_mel(const void* audio, const void* wc, const void* ws,
                             const void* fb, void* out, int B, int n,
                             int frames, int n_mels, void* stream) {
  if (B < 1 || n <= NFFT / 2 || frames < 1 || frames > n / HOP || n_mels < 1
      || n_mels > 32 * MCOL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((frames + FT - 1) / FT, B);
  log_mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)wc, (const float*)ws,
      (const float*)fb, (float*)out, n, frames, n_mels);
  return (int)cudaGetLastError();
}
