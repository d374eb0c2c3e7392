"""Voice activity detection (host CPU).

The reference lazily loads silero-vad from torch.hub and uses it only as a
boolean gate: "does this clip contain speech?"  (modeling_desta25.py:
1484-1488, 1562-1568 — non-speech clips get transcription " "; speech
clips without user transcription go through ASR.)

Offline default here is an energy+spectral VAD with hangover smoothing; a
real silero model takes over when ``DESTA_SILERO_JIT`` names its
TorchScript export (staged by ``scripts/fetch_silero.py``) or, failing
that, when ``DESTA_SILERO_ONNX`` names its ONNX export and ``onnxruntime``
is importable: the JAX package's order (``desta25_audio_tpu/audio/vad.py``,
re-homed here for the PyTorch port).  VAD gates host control flow, not
device math, so it stays on the host.

Failure economics (why the heuristic is deliberately RECALL-biased, and
tested so on the reference's real clips — tests/test_vad_real_clips.py):
a false "speech" label costs one wasted ASR pass whose junk transcript
the LLM ignores; a false "non-speech" label silently replaces a real
transcription with " " (modeling_desta25.py:1567-1568) — data
corruption.  Real silero validation remains env-blocked here (no network
egress, no cached export on the image — searched); VAD day is de-risked
instead: ``scripts/fetch_silero.py`` is a one-command pinned
fetch-and-verify, and both backends' streaming loops are contract-tested
(tests/test_vad.py) with reference-matching 512-sample frames.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

FRAME = 512  # ~32 ms at 16 kHz (silero frame size)


def _frame_signal(x: np.ndarray, frame: int = FRAME) -> np.ndarray:
    n = len(x) // frame
    if n == 0:
        return np.zeros((0, frame), np.float32)
    return x[:n * frame].reshape(n, frame)


def energy_vad(audio: np.ndarray, sr: int = 16000,
               threshold_db: float = -40.0,
               min_speech_frames: int = 4,
               hangover: int = 3) -> List[Tuple[int, int]]:
    """Energy VAD with relative+absolute thresholds and hangover.

    Returns speech segments as (start_sample, end_sample) pairs.
    """
    frames = _frame_signal(audio.astype(np.float32))
    if frames.shape[0] == 0:
        return []
    energy_db = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-10)
    # threshold: max(absolute floor, noise floor + margin)
    noise_floor = np.percentile(energy_db, 10)
    thr = max(threshold_db, noise_floor + 6.0)
    active = energy_db > thr

    # spectral tilt check: speech has energy concentrated below ~4 kHz but
    # above ~100 Hz; reject constant hum / clicks
    spec = np.abs(np.fft.rfft(frames, axis=1))
    freqs = np.fft.rfftfreq(FRAME, 1.0 / sr)
    band = (freqs > 100) & (freqs < 4000)
    band_ratio = (spec[:, band].sum(axis=1)
                  / (spec.sum(axis=1) + 1e-9))
    active &= band_ratio > 0.35

    # hangover smoothing
    smoothed = np.zeros_like(active)
    run = 0
    for i, a in enumerate(active):
        run = hangover if a else max(run - 1, 0)
        smoothed[i] = run > 0

    segments: List[Tuple[int, int]] = []
    start = None
    for i, a in enumerate(smoothed):
        if a and start is None:
            start = i
        elif not a and start is not None:
            if i - start >= min_speech_frames:
                segments.append((start * FRAME, i * FRAME))
            start = None
    if start is not None and len(smoothed) - start >= min_speech_frames:
        segments.append((start * FRAME, len(smoothed) * FRAME))
    return segments


def _probs_to_segments(probs: np.ndarray, threshold: float = 0.5
                       ) -> List[Tuple[int, int]]:
    """Shared prob-stream -> (start_sample, end_sample) thresholding."""
    segs: List[Tuple[int, int]] = []
    start = None
    for i, p in enumerate(probs):
        if p >= threshold and start is None:
            start = i
        elif p < threshold and start is not None:
            segs.append((start * FRAME, i * FRAME))
            start = None
    if start is not None:
        segs.append((start * FRAME, len(probs) * FRAME))
    return segs


class SileroOnnxVAD:
    """silero-vad via its ONNX export and ``onnxruntime`` (CPU provider):
    512-sample frames, the model's recurrent state (2, 1, 128) f32 carried
    from frame to frame and reset per clip, ``sr`` as an int64 scalar."""

    def __init__(self, model_path: str):
        import onnxruntime as ort
        self.sess = ort.InferenceSession(
            model_path, providers=["CPUExecutionProvider"])

    def speech_probs(self, audio: np.ndarray, sr: int = 16000) -> np.ndarray:
        state = np.zeros((2, 1, 128), np.float32)
        probs = []
        for frame in _frame_signal(audio):
            out, state = self.sess.run(
                None, {"input": frame[None], "state": state,
                       "sr": np.array(sr, np.int64)})
            probs.append(float(np.asarray(out).reshape(-1)[0]))
        return np.asarray(probs)

    def get_speech_timestamps(self, audio, sr=16000, threshold=0.5):
        return _probs_to_segments(self.speech_probs(audio, sr), threshold)


class SileroJitVAD:
    """silero-vad via its published TorchScript export.

    ``scripts/fetch_silero.py`` stages the pinned ``silero_vad.jit`` and
    ``DESTA_SILERO_JIT`` points here.  The streaming contract matches the reference's torch.hub usage
    (modeling_desta25.py:1484-1488): 512-sample frames at 16 kHz, internal
    recurrent state reset per clip."""

    def __init__(self, model_path: str):
        import torch
        self._torch = torch
        self.model = torch.jit.load(model_path, map_location="cpu")
        self.model.eval()

    def speech_probs(self, audio: np.ndarray, sr: int = 16000) -> np.ndarray:
        torch = self._torch
        if hasattr(self.model, "reset_states"):
            self.model.reset_states()
        probs = []
        with torch.no_grad():
            for frame in _frame_signal(audio):
                out = self.model(torch.from_numpy(frame[None]), sr)
                probs.append(float(np.asarray(out).reshape(-1)[0]))
        return np.asarray(probs)

    def get_speech_timestamps(self, audio, sr=16000, threshold=0.5):
        return _probs_to_segments(self.speech_probs(audio, sr), threshold)


_silero = None


def _onnx_errors() -> tuple:
    """What a missing or broken onnxruntime raises: ImportError, OSError
    (its shared library), RuntimeError, and the runtime's own errors
    (``onnxruntime.capi.onnxruntime_pybind11_state.Fail`` and kin, where
    the runtime imports)."""
    errors = (ImportError, OSError, RuntimeError)
    try:
        from onnxruntime.capi import onnxruntime_pybind11_state as state
    except (ImportError, OSError, AttributeError):
        return errors
    own = tuple(e for e in vars(state).values()
                if isinstance(e, type) and issubclass(e, Exception))
    return errors + own


def _load_silero():
    """The configured silero VAD, or None (the energy VAD), in the JAX
    package's order: the TorchScript export (``DESTA_SILERO_JIT``), then the
    ONNX export (``DESTA_SILERO_ONNX``), then None.  A step that fails falls
    through to the next: the TorchScript load on RuntimeError or OSError
    (not a loadable file), the ONNX load on what :func:`_onnx_errors`
    names.  Any other exception is a fault and propagates."""
    jit_path = os.environ.get("DESTA_SILERO_JIT")
    if jit_path and os.path.exists(jit_path):
        try:
            return SileroJitVAD(jit_path)
        except (RuntimeError, OSError):
            pass
    onnx_path = os.environ.get("DESTA_SILERO_ONNX")
    if onnx_path and os.path.exists(onnx_path):
        try:
            return SileroOnnxVAD(onnx_path)
        except _onnx_errors():
            pass
    return None


def get_speech_timestamps(audio: np.ndarray, sr: int = 16000
                          ) -> List[Tuple[int, int]]:
    """Speech segments; real silero when configured, energy VAD otherwise."""
    global _silero
    if _silero is None:
        _silero = _load_silero()
    if _silero is not None:
        return _silero.get_speech_timestamps(audio, sr)
    return energy_vad(audio, sr)


def has_speech(audio: np.ndarray, sr: int = 16000) -> bool:
    return len(get_speech_timestamps(audio, sr)) > 0
