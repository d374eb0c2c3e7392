"""The port's silero loaders (``desta25_audio_tpu_torch/audio/vad.py``)
against the JAX package's (``desta25_audio_tpu/audio/vad.py``).

Neither machine has ``onnxruntime``, so the ONNX export runs through a
mocked runtime module, as ``tests/test_vad.py`` does: the session gates
speech in both packages alike, ``_load_silero`` tries the TorchScript
export, then the ONNX export, then none (the energy VAD), and a broken
runtime falls through while a fault of the calling code does not.
"""

import sys
import types

import numpy as np
import pytest
import torch

import desta25_audio_tpu.audio.vad as jvad
import desta25_audio_tpu_torch.audio.vad as tvad

FRAME = tvad.FRAME
SR = 16000


class _FakeSession:
    """onnxruntime.InferenceSession's stand-in: speech probability 1 where
    the frame is loud, the (2, 1, 128) f32 state carried, sr an int64."""

    def __init__(self, path, providers=None):
        assert providers == ["CPUExecutionProvider"]
        self.states = []

    def run(self, outputs, feeds):
        assert outputs is None
        state = feeds["state"]
        assert state.shape == (2, 1, 128) and state.dtype == np.float32
        assert feeds["sr"].dtype == np.int64 and int(feeds["sr"]) == SR
        assert feeds["input"].shape == (1, FRAME)
        self.states.append(float(state[0, 0, 0]))
        p = 1.0 if float(np.abs(feeds["input"]).mean()) > 0.01 else 0.0
        return np.asarray([[p]], np.float32), state + 1.0


def _runtime(monkeypatch, session=_FakeSession):
    fake = types.ModuleType("onnxruntime")
    fake.InferenceSession = session
    monkeypatch.setitem(sys.modules, "onnxruntime", fake)


def _clip():
    sig = np.zeros(SR, np.float32)
    sig[4 * FRAME:10 * FRAME] = 0.5          # speech in frames 4..9
    return sig


def _fresh(monkeypatch, **env):
    for name in ("DESTA_SILERO_JIT", "DESTA_SILERO_ONNX"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(tvad, "_silero", None)
    monkeypatch.setattr(jvad, "_silero", None)


def _jit_model(path):
    class Loud(torch.nn.Module):
        def forward(self, x: torch.Tensor, sr: int) -> torch.Tensor:
            return (x.abs().mean() > 0.01).float()
    torch.jit.save(torch.jit.script(Loud()), path)
    return path


def test_onnx_session_gates_speech_as_jax(monkeypatch, tmp_path):
    """With only DESTA_SILERO_ONNX set, both packages gate with the silero
    session: a clip of silence is no speech in either (where the energy
    VAD's verdict would not matter), a loud span the same segments."""
    _runtime(monkeypatch)
    model = tmp_path / "silero.onnx"
    model.write_bytes(b"onnx")
    sig = _clip()
    vad = tvad.SileroOnnxVAD(str(model))
    assert vad.get_speech_timestamps(sig, SR) == [(4 * FRAME, 10 * FRAME)]
    # the state is carried from frame to frame and reset per clip
    assert vad.sess.states[:3] == [0.0, 1.0, 2.0]
    vad.speech_probs(sig, SR)
    assert vad.sess.states[SR // FRAME] == 0.0
    _fresh(monkeypatch, DESTA_SILERO_ONNX=str(model))
    assert isinstance(tvad._load_silero(), tvad.SileroOnnxVAD)
    silent = np.zeros(SR, np.float32)
    for s in (sig, silent, 0.3 * np.sin(np.arange(SR) * 0.3).astype(
            np.float32)):
        assert tvad.get_speech_timestamps(s, SR) \
            == jvad.get_speech_timestamps(s, SR)
        assert tvad.has_speech(s) == jvad.has_speech(s)
    assert not tvad.has_speech(silent)


@pytest.mark.parametrize("case", ["jit_first", "broken_jit_then_onnx",
                                  "neither"])
def test_loader_order_jit_onnx_none(monkeypatch, tmp_path, case):
    _runtime(monkeypatch)
    onnx = tmp_path / "silero.onnx"
    onnx.write_bytes(b"onnx")
    jit = str(tmp_path / "silero.jit")
    if case == "jit_first":
        _fresh(monkeypatch, DESTA_SILERO_JIT=_jit_model(jit),
               DESTA_SILERO_ONNX=str(onnx))
        want = tvad.SileroJitVAD
    elif case == "broken_jit_then_onnx":
        with open(jit, "wb") as f:
            f.write(b"not a TorchScript archive")
        _fresh(monkeypatch, DESTA_SILERO_JIT=jit, DESTA_SILERO_ONNX=str(onnx))
        want = tvad.SileroOnnxVAD
    else:
        _fresh(monkeypatch)
        want = type(None)
    got = tvad._load_silero()
    assert isinstance(got, want)
    assert type(jvad._load_silero()).__name__ == want.__name__
    sig = _clip()
    assert tvad.get_speech_timestamps(sig, SR) == (
        tvad.energy_vad(sig, SR) if case == "neither"
        else [(4 * FRAME, 10 * FRAME)])


@pytest.mark.parametrize("error", [ImportError, OSError, RuntimeError])
def test_failing_onnx_load_falls_through_to_energy(monkeypatch, tmp_path,
                                                   error):
    def broken(path, providers=None):
        raise error("the runtime cannot load this model")
    _runtime(monkeypatch, broken)
    onnx = tmp_path / "silero.onnx"
    onnx.write_bytes(b"onnx")
    _fresh(monkeypatch, DESTA_SILERO_ONNX=str(onnx))
    assert tvad._load_silero() is None
    sig = _clip()
    assert tvad.get_speech_timestamps(sig, SR) == tvad.energy_vad(sig, SR)
    # no runtime at all: the import fails, and the energy VAD gates too
    monkeypatch.setitem(sys.modules, "onnxruntime", None)
    _fresh(monkeypatch, DESTA_SILERO_ONNX=str(onnx))
    assert tvad._load_silero() is None


def test_a_fault_of_the_caller_is_not_swallowed(monkeypatch, tmp_path):
    """Only a missing or broken runtime falls through: a TypeError (a
    fault of the code that calls the runtime) propagates."""
    def wrong(path, providers=None):
        raise TypeError("bad argument")
    _runtime(monkeypatch, wrong)
    onnx = tmp_path / "silero.onnx"
    onnx.write_bytes(b"onnx")
    _fresh(monkeypatch, DESTA_SILERO_ONNX=str(onnx))
    with pytest.raises(TypeError):
        tvad._load_silero()
