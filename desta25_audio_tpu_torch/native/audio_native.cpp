// Native audio runtime: WAV decode + polyphase resample + channel mixdown.
//
// The PyTorch port's own copy of the JAX package's native audio runtime
// (desta25_audio_tpu/native/audio_native.cpp): the reference gets its
// decode/resample speed from libsndfile/librosa C cores; this is the
// equivalent native path for the data loader.  Exposed through a minimal C
// ABI consumed via ctypes.  All entry points release the GIL by
// construction (pure C, no Python API), so a Python thread pool scales
// decode across cores.
//
// Build: at first use by desta25_audio_tpu_torch/native/build.py
//        (g++ -O3 -march=native -shared -fPIC, the JAX build's flags)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

// Decodes a RIFF/WAVE file (PCM 8/16/24/32 + IEEE float 32/64).
// Returns 0 on success.  *out is malloc'd interleaved float32 [frames, ch];
// caller frees with audio_free.
int wav_decode(const char* path, float** out, int64_t* n_frames,
               int32_t* n_channels, int32_t* sample_rate) {
  *out = nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  char id[4];
  uint32_t riff_size;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0 ||
      fread(&riff_size, 4, 1, f) != 1 || fread(id, 1, 4, f) != 4 ||
      memcmp(id, "WAVE", 4) != 0) {
    fclose(f);
    return -2;
  }

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  std::vector<uint8_t> payload;
  bool have_fmt = false, have_data = false;

  while (fread(id, 1, 4, f) == 4) {
    uint32_t size;
    if (fread(&size, 4, 1, f) != 1) break;
    if (memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[16];
      if (size < 16 || fread(buf, 1, 16, f) != 16) { fclose(f); return -3; }
      memcpy(&fmt, buf, 2);
      memcpy(&channels, buf + 2, 2);
      memcpy(&sr, buf + 4, 4);
      memcpy(&bits, buf + 14, 2);
      if (size > 16) fseek(f, size - 16 + (size & 1), SEEK_CUR);
      else if (size & 1) fseek(f, 1, SEEK_CUR);
      have_fmt = true;
    } else if (memcmp(id, "data", 4) == 0) {
      payload.resize(size);
      if (fread(payload.data(), 1, size, f) != size) { fclose(f); return -4; }
      if (size & 1) fseek(f, 1, SEEK_CUR);
      have_data = true;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (!have_fmt || !have_data || channels == 0) return -5;
  if (fmt == 0xFFFE) fmt = (bits == 32 || bits == 64) ? 3 : 1;  // extensible

  const int64_t bytes_per = bits / 8;
  const int64_t total = (int64_t)payload.size() / bytes_per;
  const int64_t frames = total / channels;
  float* dst = (float*)malloc(sizeof(float) * total);
  if (!dst) return -6;

  const uint8_t* p = payload.data();
  if (fmt == 1 && bits == 16) {
    const int16_t* s = (const int16_t*)p;
    for (int64_t i = 0; i < total; ++i) dst[i] = s[i] / 32768.0f;
  } else if (fmt == 1 && bits == 32) {
    const int32_t* s = (const int32_t*)p;
    for (int64_t i = 0; i < total; ++i) dst[i] = s[i] / 2147483648.0f;
  } else if (fmt == 1 && bits == 24) {
    for (int64_t i = 0; i < total; ++i) {
      int32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      dst[i] = v / 8388608.0f;
    }
  } else if (fmt == 1 && bits == 8) {
    for (int64_t i = 0; i < total; ++i) dst[i] = (p[i] - 128) / 128.0f;
  } else if (fmt == 3 && bits == 32) {
    memcpy(dst, p, sizeof(float) * total);
  } else if (fmt == 3 && bits == 64) {
    const double* s = (const double*)p;
    for (int64_t i = 0; i < total; ++i) dst[i] = (float)s[i];
  } else {
    free(dst);
    return -7;
  }

  *out = dst;
  *n_frames = frames;
  *n_channels = channels;
  *sample_rate = (int32_t)sr;
  return 0;
}

void audio_free(float* p) { free(p); }

// ---------------------------------------------------------------------------
// Channel mixdown (average) — [frames, ch] interleaved -> [frames]
// ---------------------------------------------------------------------------

void mix_average(const float* in, int64_t frames, int32_t channels,
                 float* out) {
  const float inv = 1.0f / (float)channels;
  for (int64_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    for (int32_t c = 0; c < channels; ++c) acc += in[i * channels + c];
    out[i] = acc * inv;
  }
}

// ---------------------------------------------------------------------------
// Polyphase resampler (windowed-sinc, Kaiser window)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // series expansion, converges quickly for the beta range used here
  double sum = 1.0, term = 1.0;
  const double y = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= y / (k * (double)k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) { int64_t t = a % b; a = b; b = t; }
  return a;
}

// Resample mono float32 from sr_in to sr_out.  Matches
// scipy.signal.resample_poly's design (Kaiser beta 5.0, 10 taps per
// phase-branch half-width) closely enough for 16 kHz speech use.
// Returns number of output samples, or <0 on error.  *out is malloc'd.
int64_t resample_poly(const float* in, int64_t n_in, int32_t sr_in,
                      int32_t sr_out, float** out) {
  *out = nullptr;
  if (sr_in == sr_out) {
    float* dst = (float*)malloc(sizeof(float) * n_in);
    if (!dst) return -1;
    memcpy(dst, in, sizeof(float) * n_in);
    *out = dst;
    return n_in;
  }
  const int64_t g = gcd64(sr_in, sr_out);
  const int64_t up = sr_out / g, down = sr_in / g;

  // windowed-sinc prototype at the composite rate
  const int64_t max_rate = up > down ? up : down;
  const double f_c = 1.0 / (double)max_rate;   // normalized (Nyquist = 1)
  const int64_t half_len = 10 * max_rate;      // scipy default
  const int64_t n_taps = 2 * half_len + 1;
  const double beta = 5.0;
  std::vector<double> h(n_taps);
  const double i0b = bessel_i0(beta);
  for (int64_t i = 0; i < n_taps; ++i) {
    const double t = (double)(i - half_len);
    const double x = t * M_PI * f_c;
    const double sinc = (t == 0.0) ? 1.0 : sin(x) / x;
    const double r = t / (double)half_len;
    const double w = bessel_i0(beta * sqrt(1.0 - r * r > 0 ? 1.0 - r * r : 0)) / i0b;
    h[i] = f_c * sinc * w * (double)up;
  }

  const int64_t n_out = (n_in * up + down - 1) / down;
  float* dst = (float*)malloc(sizeof(float) * n_out);
  if (!dst) return -1;

  // polyphase evaluation: y[m] corresponds to composite index m*down;
  // y[m] = sum_k h[m*down - k*up + half_len] * x[k]
  for (int64_t m = 0; m < n_out; ++m) {
    const int64_t pos = m * down;  // composite-rate position
    // k range where 0 <= pos - k*up + half_len < n_taps
    int64_t k_min = (pos + half_len - (n_taps - 1) + up - 1) / up;
    int64_t k_max = (pos + half_len) / up;
    if (k_min < 0) k_min = 0;
    if (k_max >= n_in) k_max = n_in - 1;
    double acc = 0.0;
    for (int64_t k = k_min; k <= k_max; ++k) {
      acc += h[pos - k * up + half_len] * (double)in[k];
    }
    dst[m] = (float)acc;
  }
  *out = dst;
  return n_out;
}

// ---------------------------------------------------------------------------
// One-shot pipeline: decode + mixdown + resample (loader hot path)
// ---------------------------------------------------------------------------

int64_t load_audio_16k(const char* path, int32_t target_sr, float** out) {
  float* raw = nullptr;
  int64_t frames;
  int32_t channels, sr;
  int rc = wav_decode(path, &raw, &frames, &channels, &sr);
  if (rc != 0) return rc;

  float* mono;
  if (channels == 1) {
    mono = raw;
  } else {
    mono = (float*)malloc(sizeof(float) * frames);
    if (!mono) { free(raw); return -6; }
    mix_average(raw, frames, channels, mono);
    free(raw);
  }
  if (sr == target_sr) {
    *out = mono;
    return frames;
  }
  float* res = nullptr;
  int64_t n = resample_poly(mono, frames, sr, target_sr, &res);
  free(mono);
  if (n < 0) return n;
  *out = res;
  return n;
}

}  // extern "C"
