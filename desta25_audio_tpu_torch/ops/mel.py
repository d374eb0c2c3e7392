"""The Whisper log-mel frontend before its clip-wide clamp (port of
``desta25_audio_tpu/ops/mel_pallas.py::_mel_kernel``, K1).

Per frame f of a clip: the windowed real DFT of samples
``[160 f, 160 f + 400)`` of the reflect-padded audio (the Hann window
folded into the cos / -sin matrices, 201 bins), the power ``re^2 + im^2``,
the slaney filterbank product and ``log10(max(mel, 1e-10))``, all in f32.
``audio/mel.log_mel`` applies the clip-wide ``max(x, max - 8)`` and
``(x + 4) / 4`` after it, as the JAX wrapper does outside its kernel.

On a CUDA tensor :func:`log_mel_spec` launches ``csrc/mel.cu`` (counted as
``log_mel``); on a CPU tensor it runs :func:`log_mel_spec_plain`, the
port's three-product power spectrogram (``audio/mel.power_spectrogram``),
the filterbank product and log10.  Both take any frame count: the TPU
kernel's 600-frame block is a tiling rule, not part of the function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..audio.mel import (
    HOP_LENGTH,
    N_FFT,
    _dft_window_matrices,
    mel_filter_bank,
    power_spectrogram,
)
from . import _build

N_BINS = N_FFT // 2 + 1        # 201
BINS_PAD = 224                 # csrc/mel.cu: 7 tiles of 32 bins
MAX_MELS = 128                 # csrc/mel.cu: 4 filter columns a thread


def log_mel_spec_plain(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, n] f32 audio -> [B, n // 160, n_mels] f32 log10 mel energies
    (before the clip-wide clamp)."""
    power = power_spectrogram(audio)
    fb = torch.as_tensor(mel_filter_bank(n_mels), device=audio.device)
    return torch.log10(torch.clamp(power @ fb, min=1e-10))


@functools.lru_cache(maxsize=8)
def _padded_matrices(n_mels: int, device: str):
    """The kernel's operands: cos and -sin DFT matrices [400, 224] with the
    window folded in and bins 201..223 zero, and the filterbank [224,
    n_mels] with zero rows past bin 200 (built from the plain version's own
    matrices; the padding adds exact zeros)."""
    cos_m, sin_m = _dft_window_matrices()
    wc = np.zeros((N_FFT, BINS_PAD), np.float32)
    ws = np.zeros((N_FFT, BINS_PAD), np.float32)
    wc[:, :N_BINS], ws[:, :N_BINS] = cos_m, sin_m
    fb = np.zeros((BINS_PAD, n_mels), np.float32)
    fb[:N_BINS] = mel_filter_bank(n_mels)
    return tuple(torch.from_numpy(m).to(device) for m in (wc, ws, fb))


def log_mel_spec(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, n] audio -> [B, n // 160, n_mels] f32 log10 mel energies before
    the clip-wide clamp.  The kernel reads the audio once and reflect-pads
    by index; it needs n > 200 samples (the reflect pad's own limit) and
    n_mels <= 128."""
    if audio.device.type == "cpu":
        return log_mel_spec_plain(audio, n_mels)
    B, n = audio.shape
    if n <= N_FFT // 2 or not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"log_mel: {n} samples (needs > {N_FFT // 2}) and "
                         f"{n_mels} mels (kernel: 1..{MAX_MELS})")
    audio = audio.float().contiguous()
    wc, ws, fb = _padded_matrices(n_mels, str(audio.device))
    _build.require_cuda("log_mel", audio, wc, ws, fb, dtype=torch.float32)
    frames = n // HOP_LENGTH
    out = torch.empty(B, frames, n_mels, dtype=torch.float32,
                      device=audio.device)
    status = _build.library().desta_log_mel(
        audio.data_ptr(), wc.data_ptr(), ws.data_ptr(), fb.data_ptr(),
        out.data_ptr(), B, n, frames, n_mels,
        _build.stream_ptr(audio.device))
    _build.check(status, "log_mel")
    _build.count_launch("log_mel")
    return out
