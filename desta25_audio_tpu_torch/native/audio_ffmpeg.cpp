// Universal audio decode/encode via the system FFmpeg libraries
// (libavformat/libavcodec/libswresample): the PyTorch port's own copy of
// desta25_audio_tpu/native/audio_ffmpeg.cpp, the equivalent of the
// reference's soundfile -> pydub/ffmpeg decode stack
// (desta/utils/audio.py:245-361): DeSTA-AQA5M spans 50 source datasets, so
// FLAC/MP3/OGG/M4A inputs are a certainty, not an edge case.  The decoders
// are the JAX package's; the encoder also takes interleaved channels.
//
// C ABI (ctypes; GIL-free by construction):
//   ff_decode_mono(path, target_sr, &out)        -> mono f32 @ target_sr
//   ff_decode_raw(path, &out, &ch, &sr)          -> interleaved f32, native
//   ff_encode(path, x, frames, ch, sr, bitrate)  -> interleaved f32 [frames,
//        ch]; muxer picked from the file extension (.flac/.mp3/.wav/.ogg);
//        used for test fixtures and dataset export
//   ff_encode_mono(path, x, n, sr, bitrate)      -> ff_encode with ch = 1
//   ff_free(ptr)
//
// Build: at first use by desta25_audio_tpu_torch/native/build.py, where the
// libavformat dev headers exist (links -lavformat -lavcodec -lavutil
// -lswresample).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream = -1;

  ~DecodeCtx() {
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    const AVCodec* codec = nullptr;
    stream = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec,
                                 0);
    if (stream < 0 || !codec) return -3;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return -4;
    if (avcodec_parameters_to_context(dec, fmt->streams[stream]->codecpar)
        < 0)
      return -5;
    if (avcodec_open2(dec, codec, nullptr) < 0) return -6;
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    return (pkt && frame) ? 0 : -7;
  }
};

// Decode everything, push frames through an optional resampler into `out`.
// When `swr_out_rate` > 0, output is mono float32 at that rate; otherwise
// interleaved native-channel float32 at the native rate.
int decode_all(const char* path, int swr_out_rate, std::vector<float>& out,
               int32_t* out_channels, int32_t* out_sr) {
  DecodeCtx c;
  int rc = c.open(path);
  if (rc != 0) return rc;

  const int in_rate = c.dec->sample_rate;
  const int in_ch = c.dec->ch_layout.nb_channels;
  if (in_rate <= 0 || in_ch <= 0) return -8;
  const int out_rate = swr_out_rate > 0 ? swr_out_rate : in_rate;
  const int out_ch = swr_out_rate > 0 ? 1 : in_ch;
  *out_channels = out_ch;
  *out_sr = out_rate;

  AVChannelLayout out_layout;
  if (swr_out_rate > 0) {
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    out_layout = mono;
  } else {
    av_channel_layout_copy(&out_layout, &c.dec->ch_layout);
  }
  AVChannelLayout in_layout;
  av_channel_layout_copy(&in_layout, &c.dec->ch_layout);
  if (in_layout.order == AV_CHANNEL_ORDER_UNSPEC)
    av_channel_layout_default(&in_layout, in_ch);
  if (out_layout.order == AV_CHANNEL_ORDER_UNSPEC)
    av_channel_layout_default(&out_layout, out_ch);

  if (swr_alloc_set_opts2(&c.swr, &out_layout, AV_SAMPLE_FMT_FLT, out_rate,
                          &in_layout, c.dec->sample_fmt, in_rate, 0,
                          nullptr) < 0 ||
      swr_init(c.swr) < 0)
    return -9;

  std::vector<float> buf;
  auto drain = [&](const AVFrame* f) -> int {
    const int in_n = f ? f->nb_samples : 0;
    const int max_out = (int)av_rescale_rnd(
        swr_get_delay(c.swr, in_rate) + in_n, out_rate, in_rate,
        AV_ROUND_UP) + 64;
    buf.resize((size_t)max_out * out_ch);
    uint8_t* outp = reinterpret_cast<uint8_t*>(buf.data());
    const uint8_t** inp =
        f ? const_cast<const uint8_t**>(f->extended_data) : nullptr;
    int got = swr_convert(c.swr, &outp, max_out, inp, in_n);
    if (got < 0) return -10;
    out.insert(out.end(), buf.begin(), buf.begin() + (size_t)got * out_ch);
    return 0;
  };

  int ret;
  while ((ret = av_read_frame(c.fmt, c.pkt)) >= 0) {
    if (c.pkt->stream_index == c.stream) {
      if (avcodec_send_packet(c.dec, c.pkt) == 0) {
        while (avcodec_receive_frame(c.dec, c.frame) == 0) {
          if (drain(c.frame) != 0) {
            av_packet_unref(c.pkt);
            return -10;
          }
        }
      }
    }
    av_packet_unref(c.pkt);
  }
  // flush decoder
  avcodec_send_packet(c.dec, nullptr);
  while (avcodec_receive_frame(c.dec, c.frame) == 0)
    if (drain(c.frame) != 0) return -10;
  // flush resampler
  if (drain(nullptr) != 0) return -10;
  return out.empty() ? -11 : 0;
}

float* to_owned(const std::vector<float>& v) {
  float* p = static_cast<float*>(malloc(v.size() * sizeof(float)));
  if (p) memcpy(p, v.data(), v.size() * sizeof(float));
  return p;
}

}  // namespace

extern "C" {

void ff_free(float* p) { free(p); }

// Decode any container/codec to mono float32 at target_sr.
// Returns sample count, or negative error.
int64_t ff_decode_mono(const char* path, int32_t target_sr, float** out) {
  *out = nullptr;
  std::vector<float> data;
  int32_t ch = 0, sr = 0;
  int rc = decode_all(path, target_sr, data, &ch, &sr);
  if (rc != 0) return rc;
  *out = to_owned(data);
  if (!*out) return -12;
  return (int64_t)data.size();
}

// Decode to interleaved native-rate float32 [frames, channels].
int64_t ff_decode_raw(const char* path, float** out, int32_t* channels,
                      int32_t* sample_rate) {
  *out = nullptr;
  std::vector<float> data;
  int rc = decode_all(path, 0, data, channels, sample_rate);
  if (rc != 0) return rc;
  *out = to_owned(data);
  if (!*out) return -12;
  return (int64_t)(data.size() / *channels);
}

// Encode interleaved float32 [n, channels] to `path`; the muxer/codec
// follow the extension (.flac lossless, .mp3 via libmp3lame, .wav
// pcm_s16le, .ogg vorbis).
int ff_encode(const char* path, const float* x, int64_t n, int32_t channels,
              int32_t sr, int32_t bit_rate) {
  if (channels <= 0) return -15;
  AVFormatContext* oc = nullptr;
  if (avformat_alloc_output_context2(&oc, nullptr, nullptr, path) < 0 ||
      !oc)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(oc->oformat->audio_codec);
  if (!codec) {
    avformat_free_context(oc);
    return -2;
  }
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  AVStream* st = avformat_new_stream(oc, nullptr);
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = av_packet_alloc();
  int rc = 0;

  auto fail = [&](int code) {
    if (swr) swr_free(&swr);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (enc) avcodec_free_context(&enc);
    if (oc) {
      if (oc->pb) avio_closep(&oc->pb);
      avformat_free_context(oc);
    }
    return code;
  };
  if (!enc || !st || !pkt) return fail(-3);

  enc->sample_rate = sr;
  AVChannelLayout layout;
  av_channel_layout_default(&layout, channels);
  av_channel_layout_copy(&enc->ch_layout, &layout);
  enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                       : AV_SAMPLE_FMT_FLT;
  enc->bit_rate = bit_rate > 0 ? bit_rate : 128000;
  enc->time_base = AVRational{1, sr};
  if (oc->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) return fail(-4);
  if (avcodec_parameters_from_context(st->codecpar, enc) < 0)
    return fail(-5);
  st->time_base = enc->time_base;

  if (!(oc->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&oc->pb, path, AVIO_FLAG_WRITE) < 0)
    return fail(-6);
  if (avformat_write_header(oc, nullptr) < 0) return fail(-7);

  if (swr_alloc_set_opts2(&swr, &enc->ch_layout, enc->sample_fmt, sr,
                          &layout, AV_SAMPLE_FMT_FLT, sr, 0, nullptr) < 0
      || swr_init(swr) < 0)
    return fail(-8);

  const int chunk = enc->frame_size > 0 ? enc->frame_size : 4096;
  frame = av_frame_alloc();
  if (!frame) return fail(-9);
  int64_t pts = 0;

  auto pump = [&](AVFrame* f) -> int {
    if (avcodec_send_frame(enc, f) < 0) return -1;
    while (true) {
      int r = avcodec_receive_packet(enc, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
      if (r < 0) return -1;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      if (av_interleaved_write_frame(oc, pkt) < 0) return -1;
    }
    return 0;
  };

  for (int64_t off = 0; off < n; off += chunk) {
    const int this_n = (int)((n - off < chunk) ? (n - off) : chunk);
    av_frame_unref(frame);
    frame->nb_samples = this_n;
    av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
    frame->format = enc->sample_fmt;
    frame->sample_rate = sr;
    if (av_frame_get_buffer(frame, 0) < 0) return fail(-10);
    const uint8_t* inp =
        reinterpret_cast<const uint8_t*>(x + off * channels);
    if (swr_convert(swr, frame->extended_data, this_n, &inp, this_n) < 0)
      return fail(-11);
    frame->pts = pts;
    pts += this_n;
    if (pump(frame) != 0) return fail(-12);
  }
  if (pump(nullptr) != 0) return fail(-13);
  if (av_write_trailer(oc) < 0) return fail(-14);
  rc = fail(0);  // releases everything
  return rc;
}

int ff_encode_mono(const char* path, const float* x, int64_t n, int32_t sr,
                   int32_t bit_rate) {
  return ff_encode(path, x, n, 1, sr, bit_rate);
}

}  // extern "C"
