"""The Whisper log-mel frontend before its clip-wide clamp (port of
``desta25_audio_tpu/ops/mel_pallas.py::_mel_kernel``, K1).

Per frame f of a clip: the windowed real DFT of samples
``[160 f, 160 f + 400)`` of the reflect-padded audio (periodic Hann window,
201 bins), the power ``re^2 + im^2``, the slaney filterbank product and
``log10(max(mel, 1e-10))``, all in f32.  ``audio/mel.log_mel`` applies the
clip-wide ``max(x, max - 8)`` and ``(x + 4) / 4`` after it, as the JAX
wrapper does outside its kernel.

On a CUDA tensor :func:`log_mel_spec` launches ``csrc/mel.cu`` (counted as
``log_mel``), which computes the same function as a real FFT and a sparse
filterbank: the 400-point real transform as one 200-point complex FFT of
the even / odd sample pairs (radix 8, 5, 5) and the split into bins
0..200, then each mel's contiguous run of nonzero filterbank bins.  Its
operands are :func:`kernel_tables`: the window, the twiddles and the
sparse filterbank, all built on the host in float64 and rounded to f32.
On a CPU tensor it runs :func:`log_mel_spec_plain`, the JAX formula: the
port's three-product power spectrogram (``audio/mel.power_spectrogram``),
the dense filterbank product and log10.  Both take any frame count: the
TPU kernel's 600-frame block is a tiling rule, not part of the function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..audio.mel import (
    HOP_LENGTH,
    N_FFT,
    hann_window,
    mel_filter_bank,
    power_spectrogram,
)
from . import _build

N_BINS = N_FFT // 2 + 1        # 201
N_CPLX = N_FFT // 2            # 200: the complex FFT's length
MAX_MELS = 128                 # the kernel's contract
FB_WEIGHTS = 2 * N_BINS        # the kernel's weight table: two filters a bin


def log_mel_spec_plain(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, n] f32 audio -> [B, n // 160, n_mels] f32 log10 mel energies
    (before the clip-wide clamp)."""
    power = power_spectrogram(audio)
    fb = torch.as_tensor(mel_filter_bank(n_mels), device=audio.device)
    return torch.log10(torch.clamp(power @ fb, min=1e-10))


def sparse_filterbank(n_mels: int):
    """``mel_filter_bank(n_mels)`` by mel: int32 [n_mels, 3] (the first
    nonzero bin, the count of bins from there to the last nonzero one, the
    offset of the mel's weights) and those weights, f32 [sum of counts], mel
    by mel in ascending bin order.  A slaney filter's nonzero bins are
    contiguous, so every weight is the dense matrix's entry; and the
    filters overlap at most two a bin, so there are at most FB_WEIGHTS."""
    fb = mel_filter_bank(n_mels)
    index = np.zeros((n_mels, 3), np.int32)
    weights, off = [], 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])      # never empty at 1..128 mels
        first, count = int(nz[0]), int(nz[-1] - nz[0]) + 1
        index[m] = (first, count, off)
        weights.append(fb[first:first + count, m])
        off += count
    if off > FB_WEIGHTS:
        raise ValueError(f"{n_mels} mels: {off} filterbank weights")
    return index, np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=8)
def kernel_tables(n_mels: int, device: str):
    """csrc/mel.cu's operands on ``device``: the Hann window f32 [400]; the
    twiddles f32 [401, 2], (cos, sin) of 2 pi m / 200 for m = 0..199 (the
    FFT's stages and its radix-5 and radix-8 constants) then of
    2 pi k / 400 for k = 0..200 (the real split), computed in float64; and
    :func:`sparse_filterbank`'s index and weights, zero-padded to
    FB_WEIGHTS (the kernel stages that many)."""
    window = hann_window().astype(np.float32)
    ang = np.concatenate([2.0 * np.pi * np.arange(N_CPLX) / N_CPLX,
                          2.0 * np.pi * np.arange(N_BINS) / N_FFT])
    twiddles = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    index, weights = sparse_filterbank(n_mels)
    weights = np.pad(weights, (0, FB_WEIGHTS - weights.size))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (window, twiddles, index, weights))


def log_mel_spec(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, n] audio -> [B, n // 160, n_mels] f32 log10 mel energies before
    the clip-wide clamp.  The kernel reads the audio once and reflect-pads
    by index; it needs n > 200 samples (the reflect pad's own limit) and
    n_mels <= 128.  Audio whose first sample is not 16-byte aligned (a view
    into a larger buffer) is copied first."""
    if audio.device.type == "cpu":
        return log_mel_spec_plain(audio, n_mels)
    B, n = audio.shape
    if n <= N_FFT // 2 or not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"log_mel: {n} samples (needs > {N_FFT // 2}) and "
                         f"{n_mels} mels (kernel: 1..{MAX_MELS})")
    audio = audio.float().contiguous()
    if audio.data_ptr() % 16:            # a view into its storage
        audio = audio.clone()
    window, twiddles, index, weights = kernel_tables(n_mels,
                                                     str(audio.device))
    _build.require_cuda("log_mel", audio, window, twiddles, weights,
                        dtype=torch.float32)
    _build.require_cuda("log_mel", index, dtype=torch.int32)
    frames = n // HOP_LENGTH
    out = torch.empty(B, frames, n_mels, dtype=torch.float32,
                      device=audio.device)
    status = _build.library().desta_log_mel(
        audio.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
        index.data_ptr(), weights.data_ptr(), out.data_ptr(), B, n, frames,
        n_mels, _build.stream_ptr(audio.device))
    _build.check(status, "log_mel")
    _build.count_launch("log_mel")
    return out
