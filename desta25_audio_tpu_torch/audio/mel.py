"""Whisper-compatible log-mel spectrogram frontend in torch.

Counterpart of the jnp ``log_mel`` of ``desta25_audio_tpu/audio/mel.py``
(the one ``generate()`` runs there; the JAX package's Pallas mel kernel K1
is reached only from its benchmarks).  The port runs K1 on every CUDA call
(``ops/mel.py``), so ``generate()``, the train step and evaluation take
it.  HF ``WhisperFeatureExtractor`` semantics:
16 kHz audio, n_fft=400, hop=160, periodic Hann window, center-reflect
padding, power spectrum, slaney mel filterbank (80 or 128 mels, fmax 8 kHz),
log10 with a 1e-10 clamp, per-clip clamp to max-8, then ``(x + 4) / 4``.

The plain version (:func:`power_spectrogram`) is GEMM-native as in the JAX
package: audio is reshaped to hop-sized rows; since n_fft = 2.5 * hop every
frame is three row slices, so ``frames @ DFT`` is three dense f32 products
with the window folded into the DFT matrices.  Plain torch in f32; TF32
must be off on the card (the model turns it off).
The filterbank and DFT functions are re-homed verbatim, and so is the f64
host path :func:`log_mel_np_precise`; :func:`log_mel_np` is the f32 host
wrapper.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz)
        * logstep,
        mels,
    )
    return mels


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(
        log_region, min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
        freq,
    )
    return freq


def mel_filter_bank(num_mel_bins: int, num_freq_bins: int = N_FFT // 2 + 1,
                    sample_rate: int = SAMPLE_RATE, fmin: float = 0.0,
                    fmax: float = 8000.0) -> np.ndarray:
    """Slaney-style triangular filterbank [num_freq_bins, num_mel_bins].

    Matches ``transformers.audio_utils.mel_filter_bank(norm="slaney",
    mel_scale="slaney", triangularize_in_mel_space=False)``.
    """
    fft_freqs = np.linspace(0, sample_rate / 2, num_freq_bins)
    mel_min = hz_to_mel_slaney(np.array(fmin))
    mel_max = hz_to_mel_slaney(np.array(fmax))
    mel_pts = np.linspace(mel_min, mel_max, num_mel_bins + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # [F, M+2]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))  # [F, M]

    # Slaney normalization: scale each filter to constant energy.
    enorm = 2.0 / (hz_pts[2:num_mel_bins + 2] - hz_pts[:num_mel_bins])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def hann_window(n_fft: int = N_FFT) -> np.ndarray:
    """The periodic Hann window [n_fft] in float64."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))


@functools.lru_cache(maxsize=4)
def _dft_window_matrices(n_fft: int = N_FFT) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT matrices (cos, -sin) of shape [n_fft, n_fft//2+1]."""
    n_bins = n_fft // 2 + 1
    window = hann_window(n_fft)
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_m = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


@functools.lru_cache(maxsize=4)
def mel_frontend_matrices(num_mel_bins: int) -> Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]:
    """(cos, sin, mel) matrices for the GEMM-native frontend."""
    cos_m, sin_m = _dft_window_matrices()
    mel = mel_filter_bank(num_mel_bins)
    return cos_m, sin_m, mel


def pad_or_trim(audio: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Zero-pad / truncate the last axis to ``length`` (feature extractor
    behavior: 30 s fixed window)."""
    t = audio.shape[-1]
    if t >= length:
        return audio[..., :length]
    return F.pad(audio, (0, length - t))


def _framed_rows(audio: torch.Tensor) -> torch.Tensor:
    """Reflect-pad and reshape to hop-sized rows [B, n_frames+3, HOP]."""
    B, n = audio.shape
    padded = F.pad(audio[:, None], (N_FFT // 2, N_FFT // 2),
                   mode="reflect")[:, 0]
    n_rows = n // HOP_LENGTH + 3
    padded = F.pad(padded, (0, n_rows * HOP_LENGTH - padded.shape[1]))
    return padded.reshape(B, n_rows, HOP_LENGTH)


def power_spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """[B, n_frames*160] f32 -> power spectrum [B, n_frames, 201] (the
    extra final frame is dropped, as WhisperFeatureExtractor's
    ``stft[..., :-1]``)."""
    rows = _framed_rows(audio.float())
    cos_m, sin_m = (torch.as_tensor(m, device=audio.device)
                    for m in _dft_window_matrices())
    Fr = audio.shape[1] // HOP_LENGTH
    h = HOP_LENGTH

    def third_matmul(mat):
        # frames[f] = concat(rows[f], rows[f+1], rows[f+2, :80])
        return (rows[:, 0:Fr] @ mat[:h]
                + rows[:, 1:Fr + 1] @ mat[h:2 * h]
                + rows[:, 2:Fr + 2, :N_FFT - 2 * h] @ mat[2 * h:])

    re = third_matmul(cos_m)
    im = third_matmul(sin_m)
    return re * re + im * im


def normalize_log_spec(log_spec: torch.Tensor) -> torch.Tensor:
    """[B, frames, n_mels] log10 mel energies -> Whisper features: each
    clip clamped to its max - 8, then ``(x + 4) / 4``."""
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log_spec, max_val - 8.0) + 4.0) / 4.0


def log_mel(audio: torch.Tensor, num_mel_bins: int,
            layout: str = "btm") -> torch.Tensor:
    """Whisper log-mel features in f32.

    audio: [B, 480000] in [-1, 1].
    layout "btm" -> [B, 3000, n_mels] (NWC, conv-ready);
    layout "bmt" -> [B, n_mels, 3000] (HF layout).

    The log10 mel energies come from ``ops/mel.log_mel_spec`` (the K1
    kernel on the card, its plain version on the CPU); the clip-wide clamp
    and the affine map stay here, as in the JAX wrapper.
    """
    from ..ops.mel import log_mel_spec  # ops/mel imports this module
    log_spec = normalize_log_spec(log_mel_spec(audio, num_mel_bins))
    if layout == "bmt":
        return log_spec.transpose(1, 2)
    return log_spec


def log_mel_np(audio: np.ndarray, num_mel_bins: int) -> np.ndarray:
    """Host/numpy convenience wrapper returning HF layout [B, n_mels, 3000]
    f32: :func:`log_mel` on CPU tensors (the plain version of K1)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    x = pad_or_trim(torch.from_numpy(np.ascontiguousarray(audio)))
    return log_mel(x, num_mel_bins, layout="bmt").numpy()


def log_mel_np_precise(audio: np.ndarray, num_mel_bins: int) -> np.ndarray:
    """Float64 host path, bit-comparable to HF WhisperFeatureExtractor.

    The f32 paths (the plain version and K1) part from the f64 reference by
    up to ~0.1 in normalized log-mel units at near-floor bins within 8
    decades of the clip's max (cancellation in the DFT); the mean
    divergence is below 5e-4.  Use this path where exact HF parity matters
    (golden fixtures, data-preparation checks)."""
    audio = np.asarray(audio, dtype=np.float64)
    if audio.ndim == 1:
        audio = audio[None]
    B = audio.shape[0]
    padded = np.zeros((B, N_SAMPLES), dtype=np.float64)
    t = min(audio.shape[1], N_SAMPLES)
    padded[:, :t] = audio[:, :t]
    refl = np.pad(padded, ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect")
    idx = (np.arange(N_FRAMES)[:, None] * HOP_LENGTH
           + np.arange(N_FFT)[None, :])
    frames = refl[:, idx] * hann_window()  # [B, F, 400]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [B, F, 201]
    mel_fb = mel_filter_bank(num_mel_bins).astype(np.float64)
    mel = spec @ mel_fb
    log_spec = np.log10(np.maximum(mel, 1e-10))
    max_val = log_spec.max(axis=(1, 2), keepdims=True)
    log_spec = np.maximum(log_spec, max_val - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return np.swapaxes(log_spec, 1, 2).astype(np.float32)
