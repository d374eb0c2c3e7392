"""The port's host utilities against the JAX package on the CPU.

- ``utils/misc``: ``run`` and ``get_unique_filepath`` as JAX's;
  ``resolve_filepath`` returns an existing local path, raises
  FileNotFoundError for a missing one and NotImplementedError for a URL
  without any network call (the JAX package downloads it; a departure on
  the record), and the dataset and ``cli/evaluate.py`` resolve through it.
- ``utils/profiling``: ``StepTimer``'s EMA and throughput equal JAX's on a
  fixed sequence of clock readings; ``trace`` and ``annotate`` run on the
  CPU and write a Chrome trace holding the annotated region; ``trace``
  with no ``log_dir`` writes nothing.
- ``audio/mel``'s host paths: ``mel_frontend_matrices`` equal JAX's
  exactly; ``log_mel_np_precise`` equals JAX's to 1e-12 (JAX's is held to
  HF ``WhisperFeatureExtractor`` by ``tests/test_mel.py``), and matches
  the golden fixture of ``tests/test_mel_golden.py`` at that test's bounds
  where the reference clips are present; ``log_mel_np`` (the port's f32
  ``log_mel`` on CPU tensors) equals JAX's ``log_mel_np`` within 1e-4, the
  port's log-mel tolerance (``tests/test_torch_mel.py``).
"""

import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest
import torch

from desta25_audio_tpu.audio import mel as jmel
from desta25_audio_tpu.utils import misc as jmisc
from desta25_audio_tpu.utils import profiling as jprof
from desta25_audio_tpu_torch import DeSTA25Config
from desta25_audio_tpu_torch.audio import mel as tmel
from desta25_audio_tpu_torch.utils import misc as tmisc
from desta25_audio_tpu_torch.utils import profiling as tprof

URL = "https://example.invalid/data/items.jsonl"


# -- utils/misc ---------------------------------------------------------------

def test_run_matches_jax():
    for cmd in ("echo hello world", "printf 'a b'"):
        assert tmisc.run(cmd) == jmisc.run(cmd)
    for mod in (tmisc, jmisc):
        with pytest.raises(RuntimeError, match="command failed"):
            mod.run("false")
        assert mod.run("false", check=False) == ""


def test_get_unique_filepath_matches_jax(tmp_path):
    path = str(tmp_path / "report.json")
    seen = []
    for _ in range(4):
        got = tmisc.get_unique_filepath(path)
        assert got == jmisc.get_unique_filepath(path)
        seen.append(os.path.basename(got))
        open(got, "w").close()
    assert seen == ["report.json", "report-1.json", "report-2.json",
                    "report-3.json"]


@pytest.fixture
def no_network(monkeypatch):
    """Any attempt to open a connection fails the test."""
    def refuse(*a, **k):
        raise AssertionError("a network call was attempted")
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def test_resolve_filepath_local_missing_and_url(tmp_path, no_network):
    f = tmp_path / "a.wav"
    f.write_bytes(b"")
    assert tmisc.resolve_filepath(str(f)) == jmisc.resolve_filepath(str(f))
    missing = str(tmp_path / "missing.wav")
    for mod in (tmisc, jmisc):
        with pytest.raises(FileNotFoundError):
            mod.resolve_filepath(missing)
    for url in (URL, "http://example.invalid/a.wav"):
        with pytest.raises(NotImplementedError, match="remote"):
            tmisc.resolve_filepath(url)


def test_dataset_and_evaluate_refuse_urls_through_resolve_filepath(
        monkeypatch, no_network):
    from desta25_audio_tpu_torch.cli import evaluate
    from desta25_audio_tpu_torch.data import dataset
    calls = []
    real = tmisc.resolve_filepath

    def spy(path):
        calls.append(path)
        return real(path)
    monkeypatch.setattr(dataset, "resolve_filepath", spy)
    monkeypatch.setattr(evaluate, "resolve_filepath", spy)
    with pytest.raises(NotImplementedError, match="remote"):
        dataset._resolve_audio_filepath(URL)
    with pytest.raises(NotImplementedError, match="remote"):
        evaluate.load_items(URL)
    with pytest.raises(NotImplementedError, match="remote"):
        dataset.AudioTextDataset(
            DeSTA25Config(), dataset.DataConfig(manifest_filepaths=[URL]),
            None)
    assert calls == [URL] * 3


# -- utils/profiling ----------------------------------------------------------

def test_step_timer_matches_jax(monkeypatch):
    clock = iter([100.0, 100.5, 101.25, 101.5, 103.0, 103.1, 103.125])
    timers = (tprof.StepTimer(ema=0.8), jprof.StepTimer(ema=0.8))
    assert all(t.throughput(4) == {} for t in timers)
    for now in clock:
        monkeypatch.setattr(time, "time", lambda now=now: now)
        got, want = (t.tick() for t in timers)
        assert got == want
    # 0.5, then 0.8 s + 0.2 dt over dt = 0.75, 0.25, 1.5, 0.1, 0.025
    assert timers[0].step_time == pytest.approx(0.46388)
    assert timers[0].throughput(12) == timers[1].throughput(12)


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    log = str(tmp_path / "trace")

    @tprof.annotate("decorated_region")
    def work(x):
        return x @ x

    for _ in range(2):
        with tprof.trace(log) as prof:
            with tprof.annotate("train_step_region"):
                work(torch.ones(64, 64))
        names = {e.key for e in prof.key_averages()}
        assert {"train_step_region", "decorated_region"} <= names
    files = sorted(os.listdir(log))
    assert files == ["trace-1.json", "trace.json"]
    events = json.load(open(os.path.join(log, files[1])))["traceEvents"]
    assert any(e.get("name") == "train_step_region" for e in events)


def test_trace_without_a_log_dir_writes_nothing(tmp_path, monkeypatch):
    """The profiling scripts' form: the profiler's events, no file."""
    monkeypatch.chdir(tmp_path)
    with tprof.trace() as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert any(e.name == "aten::mm" for e in prof.events())
    assert os.listdir(tmp_path) == []


# -- audio/mel: the host paths ------------------------------------------------

def _clips():
    """Tone + noise (2 s) and noise (0.5 s, zero-padded to 2 s): the clips
    of tests/test_mel.py."""
    rng = np.random.default_rng(0)
    t = np.arange(32000) / 16000.0
    a1 = (0.5 * np.sin(2 * np.pi * 440 * t)
          + 0.1 * rng.standard_normal(32000)).astype(np.float32)
    a2 = (0.2 * rng.standard_normal(8000)).astype(np.float32)
    return a1, a2, np.stack([a1, np.pad(a2, (0, 24000))])


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_frontend_matrices_equal_jax(n_mels):
    for got, want in zip(tmel.mel_frontend_matrices(n_mels),
                         jmel.mel_frontend_matrices(n_mels)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_np_precise_matches_jax(n_mels):
    """(JAX's equals HF ``WhisperFeatureExtractor`` within 1e-5 on these
    clips: tests/test_mel.py.)"""
    a1, _, batch = _clips()
    got = tmel.log_mel_np_precise(batch, n_mels)
    want = jmel.log_mel_np_precise(batch, n_mels)
    assert got.shape == want.shape == (2, n_mels, 3000)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-12
    # a 1-D clip is one row
    np.testing.assert_array_equal(tmel.log_mel_np_precise(a1, n_mels),
                                  got[:1])


def test_log_mel_np_matches_jax():
    _, _, batch = _clips()
    got = tmel.log_mel_np(batch, 128)
    want = np.asarray(jmel.log_mel_np(batch, 128))
    assert got.shape == want.shape == (2, 128, 3000)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-4


def test_log_mel_np_precise_matches_golden_fixture():
    """tests/test_mel_golden.py's check through the port: its audio loader
    and ``log_mel_np_precise`` on the reference's clips, at its bounds."""
    from test_mel_golden import AUDIO_DIR, FIXTURE, _sketch
    if not os.path.isdir(AUDIO_DIR):
        pytest.skip("reference audio assets not present on this machine")
    from desta25_audio_tpu_torch.audio.io import AudioSegment
    ref = np.load(FIXTURE)
    checked = 0
    for key in sorted({k.split("/")[0] for k in ref.files}):
        name = key[::-1].replace("_", ".", 1)[::-1]
        path = os.path.join(AUDIO_DIR, name)
        if not os.path.exists(path):
            continue
        seg = AudioSegment.from_file(path, target_sr=16000)
        assert seg.num_samples == int(ref[f"{key}/n_samples"]), name
        audio = np.asarray(seg.samples, np.float32)
        n = 30 * 16000
        audio = (audio[:n] if audio.size >= n
                 else np.pad(audio, (0, n - audio.size)))
        mel = tmel.log_mel_np_precise(audio[None], 128)[0]
        want = ref[f"{key}/sketch"]
        scale = float(np.max(np.abs(want))) + 1e-6
        assert np.max(np.abs(_sketch(mel) - want)) / scale < 1e-3, name
        assert abs(float(mel.mean()) - float(ref[f"{key}/mean"])) < 1e-4
        assert abs(float(mel.std()) - float(ref[f"{key}/std"])) < 1e-4
        checked += 1
    assert checked == 9
