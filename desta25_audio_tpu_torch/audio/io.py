"""Host-side audio I/O: decode, channel selection, resampling.

Re-homed from ``desta25_audio_tpu/audio/io.py`` (reference
``AudioSegment``, desta/utils/audio.py:245-361): load -> float32 samples in
[-1, 1] -> channel select/average -> resample to 16 kHz.  The routing is the
JAX package's (``audio/io.py:145-183``): the port's native C++ library
(``native/``) decodes, mixes down and resamples a WAV in one call for the
loader's common case (offset 0, no duration, ``"average"``, a target rate);
otherwise, or for a WAV it refuses, WAV is decoded in Python (PCM 8/16/24/32
and IEEE float) and resampled by the polyphase filter
``scipy.signal.resample_poly``; a WAV the Python parser refuses and every
other container (FLAC, MP3, OGG, M4A, ...) go through the native FFmpeg
codec.
"""

from __future__ import annotations

import math
import os
import struct
import wave
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np


def _pcm24_to_f32(raw: bytes, n: int) -> np.ndarray:
    a = np.frombuffer(raw, dtype=np.uint8).reshape(n, 3)
    out = (a[:, 0].astype(np.int32)
           | (a[:, 1].astype(np.int32) << 8)
           | (a[:, 2].astype(np.int32) << 16))
    out = np.where(out >= (1 << 23), out - (1 << 24), out)
    return (out / float(1 << 23)).astype(np.float32)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file -> (samples [T, C] float32 in [-1,1], sr).

    PCM (8/16/24/32-bit) via the stdlib ``wave`` module; IEEE float and
    extensible WAVs via a manual chunk parse (``wave`` rejects format 3).
    """
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(n)
        if width == 1:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif width == 2:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif width == 3:
            x = _pcm24_to_f32(raw, n * ch)
        elif width == 4:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        return x.reshape(-1, ch), sr
    except wave.Error:
        return _read_wav_any(path)


def _read_wav_any(path: str) -> tuple[np.ndarray, int]:
    """Manual RIFF parse for float WAVs / extensible format."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, ch, sr, _, _, bits = fmt
    if audio_format == 3 and bits == 32:
        x = np.frombuffer(payload, "<f4").astype(np.float32)
    elif audio_format == 3 and bits == 64:
        x = np.frombuffer(payload, "<f8").astype(np.float32)
    elif audio_format in (1, 0xFFFE) and bits == 16:
        x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
    elif audio_format in (1, 0xFFFE) and bits == 32:
        x = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
    elif audio_format in (1, 0xFFFE) and bits == 24:
        x = _pcm24_to_f32(payload, len(payload) // 3)
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_format}/{bits}")
    return x.reshape(-1, ch), sr


def _decode_any(path: str) -> tuple[np.ndarray, int]:
    """Non-WAV (or non-RIFF) decode through the native FFmpeg codec ->
    (samples [T, C] float32, native sr)."""
    from .. import native
    if not native.ffmpeg_available():
        raise ValueError(
            f"{path}: not a decodable WAV and the native FFmpeg codec is "
            "unavailable (the libavformat headers are not installed)")
    return native.ff_decode_raw(path)


def select_channels(samples: np.ndarray,
                    channel_selector: Union[str, int, Sequence[int], None]
                    = "average") -> np.ndarray:
    """[T, C] -> [T] or [T, C'] (reference select_channels semantics,
    desta/utils/audio.py:60-118)."""
    if samples.ndim == 1:
        return samples
    n_ch = samples.shape[1]
    if channel_selector is None:
        return samples[:, 0] if n_ch == 1 else samples
    if channel_selector == "average":
        return samples.mean(axis=1)
    if isinstance(channel_selector, int):
        if channel_selector >= n_ch:
            raise ValueError(
                f"channel {channel_selector} out of range ({n_ch} channels)")
        return samples[:, channel_selector]
    return samples[:, list(channel_selector)]


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


@dataclass
class AudioSegment:
    """Decoded audio clip: float32 samples at ``sample_rate``."""

    samples: np.ndarray
    sample_rate: int

    @classmethod
    def from_file(cls, path: str, target_sr: Optional[int] = 16000,
                  channel_selector: Union[str, int, None] = "average",
                  offset: float = 0.0,
                  duration: Optional[float] = None) -> "AudioSegment":
        """Decode ``path``; ``offset`` and ``duration`` (seconds) cut the
        clip at its own rate, before any resampling."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        # the native fast path: decode + mixdown + resample in one call,
        # GIL-free, for the loader's common case
        if (offset == 0.0 and duration is None
                and channel_selector == "average" and target_sr is not None):
            from .. import native
            try:
                return cls(samples=native.load_audio(path, target_sr),
                           sample_rate=target_sr)
            except ValueError:
                pass  # not a WAV it decodes: the Python parser, then FFmpeg
        if path.lower().endswith(".wav"):
            try:
                samples, sr = read_wav(path)
            except ValueError:
                samples, sr = _decode_any(path)
        else:
            samples, sr = _decode_any(path)
        samples = select_channels(samples, channel_selector)
        if offset:
            samples = samples[int(offset * sr):]
        if duration is not None:
            samples = samples[:int(duration * sr)]
        if target_sr is not None and sr != target_sr:
            samples = resample(samples, sr, target_sr)
            sr = target_sr
        return cls(samples=np.ascontiguousarray(samples, np.float32),
                   sample_rate=sr)

    @property
    def num_samples(self) -> int:
        return int(self.samples.shape[0])

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate

    def rms_db(self) -> float:
        mean_sq = float(np.mean(self.samples ** 2)) + 1e-12
        return 10.0 * math.log10(mean_sq)

    def gain_db(self, gain: float) -> "AudioSegment":
        return AudioSegment(self.samples * (10.0 ** (gain / 20.0)),
                            self.sample_rate)

    def normalize_db(self, target_db: float = -20.0) -> "AudioSegment":
        return self.gain_db(target_db - self.rms_db())

    def pad(self, pad_size: int, symmetric: bool = False) -> "AudioSegment":
        widths = (pad_size, pad_size) if symmetric else (0, pad_size)
        return AudioSegment(np.pad(self.samples, widths), self.sample_rate)

    def subsegment(self, start_time: Optional[float] = None,
                   end_time: Optional[float] = None) -> "AudioSegment":
        start = 0 if start_time is None else int(start_time * self.sample_rate)
        end = (self.num_samples if end_time is None
               else int(end_time * self.sample_rate))
        if start < 0:
            start += self.num_samples
        if end < 0:
            end += self.num_samples
        return AudioSegment(self.samples[start:end], self.sample_rate)

    def trim_silence(self, threshold_db: float = -60.0,
                     frame: int = 512) -> "AudioSegment":
        """Trim leading/trailing silence below ``threshold_db`` relative to
        the clip's loudest frame (librosa.effects.trim semantics, the
        reference's trim option, desta/utils/audio.py:167-173)."""
        x = self.samples
        if x.size == 0:
            return self
        n = max(len(x) // frame, 1)
        frames = x[:n * frame].reshape(n, frame)
        rms_db = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-12)
        keep = np.where(rms_db > rms_db.max() + threshold_db)[0]
        if keep.size == 0:
            return AudioSegment(x[:0], self.sample_rate)
        start = keep[0] * frame
        end = min((keep[-1] + 1) * frame, len(x))
        return AudioSegment(x[start:end], self.sample_rate)

    @classmethod
    def from_file_list(cls, paths: Sequence[str],
                       target_sr: Optional[int] = 16000,
                       channel_selector: Union[str, int, None] = None
                       ) -> "AudioSegment":
        """Load several (mono) files and stack them as channels, cut to the
        shortest (reference from_file_list, desta/utils/audio.py:363-442)."""
        segs = [cls.from_file(p, target_sr=target_sr,
                              channel_selector=channel_selector or 0)
                for p in paths]
        srs = {s.sample_rate for s in segs}
        if len(srs) != 1:
            raise ValueError(f"sample rates differ across files: {srs}")
        n = min(s.num_samples for s in segs)
        stacked = np.stack([s.samples[:n] for s in segs], axis=1)
        return cls(stacked, segs[0].sample_rate)

    @classmethod
    def segment_from_file(cls, path: str, target_sr: int = 16000,
                          n_segments: int = 0, offset: Optional[float] = None,
                          channel_selector: Union[str, int, None] = "average",
                          rng: Optional[np.random.Generator] = None
                          ) -> "AudioSegment":
        """A fixed-length segment of ``n_segments`` samples at
        ``target_sr``: from ``offset`` seconds, or a random start when it is
        None; a short file is zero-padded (reference segment_from_file,
        desta/utils/audio.py:444-512)."""
        seg = cls.from_file(path, target_sr=target_sr,
                            channel_selector=channel_selector)
        if n_segments <= 0 or seg.num_samples == n_segments:
            return seg
        if seg.num_samples < n_segments:
            return seg.pad(n_segments - seg.num_samples)
        max_start = seg.num_samples - n_segments
        if offset is not None:
            start = min(int(offset * target_sr), max_start)
        else:
            start = int((rng or np.random.default_rng()
                         ).integers(0, max_start + 1))
        return cls(seg.samples[start:start + n_segments], seg.sample_rate)


def write_wav(path: str, samples: np.ndarray, sr: int = 16000,
              bits: int = 16):
    """Write mono/stereo float32 [-1,1] as PCM of ``bits`` 16, 24 or 32
    (test fixtures; 16 is the JAX package's ``write_wav``)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    if bits == 16:
        raw = np.clip(samples * 32767.0, -32768, 32767).astype("<i2").tobytes()
    elif bits in (24, 32):
        top = float(1 << (bits - 1))
        ints = np.clip(np.round(samples.astype(np.float64) * (top - 1)),
                       -top, top - 1).astype("<i4")
        if bits == 32:
            raw = ints.tobytes()
        else:
            raw = ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        raise ValueError(f"bits={bits} (16 | 24 | 32)")
    with wave.open(path, "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(bits // 8)
        w.setframerate(sr)
        w.writeframes(raw)
