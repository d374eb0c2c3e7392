"""Native (C++) audio runtime with ctypes bindings: the port's own copy of
the JAX package's ``native/`` (WAV decode, mixdown and polyphase resample;
universal decode and encode through FFmpeg).

The libraries are built by ``g++`` at first use (``native/build.py``); a
failed build raises with the compiler's output, so nothing falls back
silently to another decoder or resampler.  The FFmpeg codec exists only
where the libavformat headers do: :func:`ffmpeg_available` says whether it
does.  Every C buffer is copied into numpy and freed before a call returns.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from . import build as _build

_FP = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()
_libs = {}


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = _build.build_library(name)   # returns once the build lock is
        try:                                # released and the file is whole
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        if name == "audio":
            lib.wav_decode.restype = ctypes.c_int
            lib.wav_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_FP),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.audio_free.argtypes = [_FP]
            lib.load_audio_16k.restype = ctypes.c_int64
            lib.load_audio_16k.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                           ctypes.POINTER(_FP)]
            lib.resample_poly.restype = ctypes.c_int64
            lib.resample_poly.argtypes = [_FP, ctypes.c_int64,
                                          ctypes.c_int32, ctypes.c_int32,
                                          ctypes.POINTER(_FP)]
        else:
            lib.ff_decode_mono.restype = ctypes.c_int64
            lib.ff_decode_mono.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                           ctypes.POINTER(_FP)]
            lib.ff_decode_raw.restype = ctypes.c_int64
            lib.ff_decode_raw.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_FP),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.ff_encode.restype = ctypes.c_int
            lib.ff_encode.argtypes = [ctypes.c_char_p, _FP, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int32]
            lib.ff_free.argtypes = [_FP]
        _libs[name] = lib
        return lib


def load() -> ctypes.CDLL:
    """The WAV/resample library, built at first use (raises on failure)."""
    return _load("audio")


def available() -> bool:
    """True once the WAV/resample library is built and loaded; a failed
    build raises instead of answering False."""
    return load() is not None


def load_ffmpeg() -> Optional[ctypes.CDLL]:
    """The FFmpeg codec library, built at first use; None where the
    libavformat headers are missing.  A failed build raises."""
    if not _build.have_ffmpeg_headers():
        return None
    return _load("ffmpeg")


def ffmpeg_available() -> bool:
    return load_ffmpeg() is not None


def _ffmpeg() -> ctypes.CDLL:
    lib = load_ffmpeg()
    if lib is None:
        raise RuntimeError("the FFmpeg codec is unavailable: the libavformat "
                           "headers are not installed")
    return lib


def _owned(free, out, n: int) -> np.ndarray:
    """Copy n floats out of a C buffer, then free it."""
    try:
        if n == 0:
            return np.zeros(0, np.float32)
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        free(out)


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    """WAV decode + mixdown (average) + resample in native code -> mono
    float32 at ``target_sr``.  Raises ValueError on a file it cannot
    decode."""
    lib = load()
    out = _FP()
    n = lib.load_audio_16k(path.encode(), target_sr, ctypes.byref(out))
    if n < 0:
        raise ValueError(f"native decode failed ({n}): {path}")
    return _owned(lib.audio_free, out, n)


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    out = _FP()
    n = lib.resample_poly(x.ctypes.data_as(_FP), len(x), sr_in, sr_out,
                          ctypes.byref(out))
    if n < 0:
        raise ValueError(f"native resample failed ({n})")
    return _owned(lib.audio_free, out, n)


def ff_decode_mono(path: str, target_sr: int = 16000) -> np.ndarray:
    """Universal decode (flac/mp3/ogg/...) -> mono float32 @ target_sr."""
    lib = _ffmpeg()
    out = _FP()
    n = lib.ff_decode_mono(path.encode(), target_sr, ctypes.byref(out))
    if n < 0:
        raise ValueError(f"ffmpeg decode failed ({n}): {path}")
    return _owned(lib.ff_free, out, n)


def ff_decode_raw(path: str) -> Tuple[np.ndarray, int]:
    """Universal decode -> (interleaved [frames, ch] float32, sr)."""
    lib = _ffmpeg()
    out = _FP()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    n = lib.ff_decode_raw(path.encode(), ctypes.byref(out), ctypes.byref(ch),
                          ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"ffmpeg decode failed ({n}): {path}")
    arr = _owned(lib.ff_free, out, n * ch.value)
    return arr.reshape(n, ch.value), sr.value


def ff_encode(path: str, samples: np.ndarray, sr: int,
              bit_rate: int = 128000) -> None:
    """Encode float32 samples, mono [n] or interleaved [n, channels], to
    ``path`` (codec from the extension: .flac/.mp3/.wav/.ogg)."""
    lib = _ffmpeg()
    x = np.ascontiguousarray(samples, np.float32)
    ch = 1 if x.ndim == 1 else x.shape[1]
    rc = lib.ff_encode(path.encode(), x.ctypes.data_as(_FP), x.shape[0], ch,
                       sr, bit_rate)
    if rc != 0:
        raise ValueError(f"ffmpeg encode failed ({rc}): {path}")
