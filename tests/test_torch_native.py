"""The port's native audio libraries, ``AudioSegment`` and the prefetching
loader against the JAX package on the CPU.

- Decoding: ``AudioSegment.from_file`` equal to the JAX one bit for bit
  (WAV 16/24/32-bit, mono and stereo, 16 and 22.05 kHz, on the native fast
  path and, with offset / duration / a channel / no target rate, on the
  Python path; FLAC, MP3 and OGG through the FFmpeg codec), and the native
  entry points (``load_audio``, ``resample``, ``ff_decode_mono``) equal to
  the JAX ones: both libraries are compiled from the same sources with the
  same flags.  FLAC decodes to the input quantized to 16 bits (within one
  step, 2**-15); MP3 / OGG correlate with it above 0.95 at the best lag,
  as tests/test_audio_formats.py checks.
- The eight helpers (``rms_db`` ... ``segment_from_file``) equal JAX's.
- Garbage raises, on the native path and through ``AudioSegment``.
- The build: one compile for threads that start together (``fcntl`` lock,
  a temporary name replaced into place), a new name for an edited source,
  and a failing ``g++`` raises with its output.
- ``PrefetchLoader``: batches equal the serial loader's, in order; a
  raising collate raises in the consumer within seconds (the JAX loader
  would wait forever).
- A manifest of WAV, FLAC and MP3 clips collates every sample, with the
  audio JAX's collate gives.

The JAX package's libraries are built in a fixture, under the port's build
lock, to a temporary name replaced into place (its own fixture builds them
the same way, tests/test_native_and_prefetch.py:13-22); nothing is decided
at collection.
"""

import fcntl
import json
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest

from desta25_audio_tpu.audio import io as jio
from desta25_audio_tpu.data import dataset as jdata
from desta25_audio_tpu_torch import native as tnative
from desta25_audio_tpu_torch.audio import io as tio
from desta25_audio_tpu_torch.config import DeSTA25Config
from desta25_audio_tpu_torch.data import dataset as tdata
from desta25_audio_tpu_torch.data.prefetch import PrefetchLoader
from desta25_audio_tpu_torch.data.tokenizer import build_tokenizer
from desta25_audio_tpu_torch.native import build as tbuild

SR = 16000
NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32")


@pytest.fixture(scope="module")
def jnative():
    """The JAX package's native module with both of its libraries built
    (with the flags the port mirrors, ``native/build.LIBS``) and loaded."""
    from desta25_audio_tpu import native as jn
    here = os.path.dirname(jn.__file__)
    tbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(tbuild.LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for so, name in ((jn._SO_PATH, "audio"), (jn._FF_SO_PATH, "ffmpeg")):
            if os.path.exists(so) or (name == "ffmpeg"
                                      and not tbuild.have_ffmpeg_headers()):
                continue
            src, flags, libs = tbuild.LIBS[name]
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run([tbuild.gxx(), *flags, "-o", tmp,
                            os.path.join(here, src), *libs], check=True)
            os.replace(tmp, so)
        fcntl.flock(lock, fcntl.LOCK_UN)
    jn._lib_failed = jn._fflib_failed = False
    assert jn.available()
    return jn


def _need_ffmpeg():
    if not tnative.ffmpeg_available():
        pytest.skip("the libavformat headers are not installed: the FFmpeg "
                    "codec is not built")


def _stereo(n, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * 330 * t),
                  0.3 * np.sin(2 * np.pi * 523 * t)], 1)
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)


def _corr(a, b):
    n = min(len(a), len(b))
    a, b = a[:n] - a[:n].mean(), b[:n] - b[:n].mean()
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                 + 1e-12))


# -- decoding ------------------------------------------------------------------

WAVS = {  # name -> (bits, channels, rate)
    "pcm16_mono_16k": (16, 1, 16000),
    "pcm16_stereo_22k": (16, 2, 22050),
    "pcm24_stereo_22k": (24, 2, 22050),
    "pcm32_mono_48k": (32, 1, 48000),
}


@pytest.mark.parametrize("name", sorted(WAVS))
def test_wav_fast_path_matches_jax_bit_for_bit(jnative, tmp_path, name):
    bits, ch, sr = WAVS[name]
    x = _stereo(int(0.75 * sr), sr)[:, :ch]
    p = str(tmp_path / f"{name}.wav")
    tio.write_wav(p, x, sr, bits=bits)
    got = tio.AudioSegment.from_file(p)
    want = jio.AudioSegment.from_file(p)
    assert got.sample_rate == want.sample_rate == SR
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(tnative.load_audio(p, SR),
                                  jnative.load_audio(p, SR))
    mono = x.mean(1)
    np.testing.assert_array_equal(tnative.resample(mono, sr, SR),
                                  jnative.resample(mono, sr, SR))
    # the native resampler differs from scipy's by up to 5e-3
    # (tests/test_native_and_prefetch.py:36): the fast path was taken
    if sr != SR:
        slow = tio.AudioSegment.from_file(p, duration=10.0)
        assert not np.array_equal(slow.samples, got.samples)


@pytest.mark.parametrize("kw", [
    dict(offset=0.1, duration=0.4),
    dict(offset=0.25),
    dict(channel_selector=1),
    dict(channel_selector=None, target_sr=None),
], ids=["offset_duration", "offset", "channel_1", "raw"])
def test_python_path_matches_jax_bit_for_bit(jnative, tmp_path, kw):
    p = str(tmp_path / "s.wav")
    tio.write_wav(p, _stereo(22050, 22050), 22050, bits=24)
    got = tio.AudioSegment.from_file(p, **kw)
    want = jio.AudioSegment.from_file(p, **kw)
    assert got.sample_rate == want.sample_rate
    np.testing.assert_array_equal(got.samples, want.samples)
    if "duration" in kw:     # cut at 22.05 kHz, then resampled
        assert abs(got.num_samples - 0.4 * SR) <= 2


@pytest.mark.parametrize("fmt", ["flac", "mp3", "ogg"])
def test_ffmpeg_formats_match_jax_bit_for_bit(jnative, tmp_path, fmt):
    _need_ffmpeg()
    sr = 22050
    x = _stereo(sr, sr)[:, 0]
    p = str(tmp_path / f"clip.{fmt}")
    tnative.ff_encode(p, x, sr, bit_rate=64000 if fmt == "ogg" else 128000)
    got = tio.AudioSegment.from_file(p)
    want = jio.AudioSegment.from_file(p)
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(tnative.ff_decode_mono(p, SR),
                                  jnative.ff_decode_mono(p, SR))
    raw, rate = tnative.ff_decode_raw(p)
    assert rate == sr and raw.shape[1] == 1
    if fmt == "flac":
        # lossless up to the encoder's 16-bit quantization
        q = np.round(x * 32767.0) / 32768.0
        assert np.abs(raw[:len(x), 0] - q[:len(raw)]).max() <= 2 ** -15
    else:
        best = max(_corr(raw[lag:lag + sr // 2, 0], x[:sr // 2])
                   for lag in range(0, 2400, 24))
        assert best > 0.95, best


def test_stereo_flac_round_trip(tmp_path):
    """The port's encoder takes interleaved channels (the JAX one is mono
    only); FLAC keeps both channels to 16-bit quantization."""
    _need_ffmpeg()
    x = _stereo(11025, 22050)
    p = str(tmp_path / "st.flac")
    tnative.ff_encode(p, x, 22050)
    raw, rate = tnative.ff_decode_raw(p)
    assert rate == 22050 and raw.shape == x.shape
    assert np.abs(raw - np.round(x * 32767.0) / 32768.0).max() <= 2 ** -15
    seg = tio.AudioSegment.from_file(p, channel_selector="average")
    assert seg.sample_rate == SR and abs(seg.num_samples - 8000) <= 2


HELPERS = {
    "rms_db": lambda S, seg, p: seg.rms_db(),
    "gain_db": lambda S, seg, p: seg.gain_db(-6.5).samples,
    "normalize_db": lambda S, seg, p: seg.normalize_db(-23.0).samples,
    "pad": lambda S, seg, p: (seg.pad(100).samples,
                              seg.pad(37, symmetric=True).samples),
    "subsegment": lambda S, seg, p: (seg.subsegment(0.1, 0.3).samples,
                                     seg.subsegment(-0.2).samples),
    "trim_silence": lambda S, seg, p: seg.trim_silence(-30.0).samples,
    "from_file_list": lambda S, seg, p: S.from_file_list([p, p]).samples,
    "segment_from_file": lambda S, seg, p: (
        S.segment_from_file(p, n_segments=4000, offset=0.2).samples,
        S.segment_from_file(p, n_segments=40000).samples,
        S.segment_from_file(p, n_segments=4000,
                            rng=np.random.default_rng(3)).samples),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helpers_match_jax(jnative, tmp_path, name):
    sr = 16000
    x = np.zeros(sr, np.float32)
    x[4000:12000] = _stereo(8000, sr)[:, 0]
    p = str(tmp_path / "h.wav")
    tio.write_wav(p, x, sr)
    got = HELPERS[name](tio.AudioSegment, tio.AudioSegment.from_file(p), p)
    want = HELPERS[name](jio.AudioSegment, jio.AudioSegment.from_file(p), p)
    got, want = ((got, want) if isinstance(got, tuple)
                 else ((got,), (want,)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_garbage_raises(tmp_path):
    p = str(tmp_path / "junk.wav")
    with open(p, "wb") as f:
        f.write(b"not a wav file at all")
    with pytest.raises(ValueError):
        tnative.load_audio(p, SR)
    with pytest.raises(ValueError):
        tio.AudioSegment.from_file(p)
    with pytest.raises(FileNotFoundError):
        tio.AudioSegment.from_file(str(tmp_path / "missing.flac"))


# -- the build -----------------------------------------------------------------

def _tiny_build(monkeypatch, tmp_path, source: str):
    src = tmp_path / "tiny.cpp"
    src.write_text(source)
    monkeypatch.setattr(tbuild, "HERE", tmp_path)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tbuild, "LOCK", tmp_path / "build" / ".native.lock")
    monkeypatch.setitem(tbuild.LIBS, "tiny",
                        ("tiny.cpp", ("-O1", "-shared", "-fPIC"), ()))
    runs = []
    real = subprocess.run

    def counting(cmd, *a, **kw):
        runs.append(cmd)
        return real(cmd, *a, **kw)

    monkeypatch.setattr(tbuild.subprocess, "run", counting)
    return runs


def test_build_once_under_the_lock(monkeypatch, tmp_path):
    runs = _tiny_build(monkeypatch, tmp_path,
                       'extern "C" int tiny_one() { return 1; }\n')
    out, errs = [], []

    def go():
        try:
            out.append(tbuild.build_library("tiny"))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(set(out)) == 1 and len(runs) == 1
    assert out[0].exists() and "tiny_" in out[0].name
    assert not list(out[0].parent.glob("*.tmp"))
    # an edited source gets a new name
    (tmp_path / "tiny.cpp").write_text(
        'extern "C" int tiny_one() { return 2; }\n')
    assert tbuild.library_path("tiny") != out[0]


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    _tiny_build(monkeypatch, tmp_path, "this is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        tbuild.build_library("tiny")
    assert "error" in str(e.value)
    assert not tbuild.library_path("tiny").exists()


# -- the loader ----------------------------------------------------------------

def _corpus(root, formats=("wav",) * 10):
    os.makedirs(root / "clips", exist_ok=True)
    rows = []
    for i, fmt in enumerate(formats):
        t = np.arange(4000) / 16000.0
        sig = (0.3 * np.sin(2 * np.pi * (200 + 30 * i) * t)).astype(
            np.float32)
        rel = f"clips/{i}.{fmt}"
        if fmt == "wav":
            tio.write_wav(str(root / rel), sig)
        else:
            tnative.ff_encode(str(root / rel), sig, 16000)
        rows.append({"id": rel, "prompt": f"p{i} <|AUDIO|>",
                     "response": f"r{i}", "dataset": "syn"})
    manifest = root / "m.jsonl"
    with open(manifest, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(manifest)


def _loader_parts(tmp_path, formats=("wav",) * 10):
    cfg = DeSTA25Config(**NANO)
    manifest = _corpus(tmp_path / "d", formats)
    dcfg = tdata.DataConfig(manifest_filepaths=[manifest],
                            data_root=str(tmp_path / "d"), batch_size=2,
                            max_seq_length=64, num_audio_samples=8000,
                            trans_max_tokens=8, shuffle=False)
    tk = build_tokenizer(cfg.llm_model_id, cfg.placeholder_token)
    return (cfg, dcfg, tk, tdata.AudioTextDataset(cfg, dcfg, tk),
            tdata.CollateFn(cfg, dcfg, tk))


def test_prefetch_batches_equal_serial(tmp_path):
    _, _, _, ds, collate = _loader_parts(tmp_path)
    serial = list(tdata.data_loader(ds, collate, 2))
    for workers in (1, 3):
        pre = list(PrefetchLoader(ds, collate, 2, num_workers=workers,
                                  depth=2))
        assert len(pre) == len(serial) == 5
        for a, b in zip(serial, pre):
            assert sorted(a) == sorted(b)
            for k, v in a.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(v, b[k])
    # an early exit stops the threads
    it = iter(PrefetchLoader(ds, collate, 2, num_workers=2))
    next(it)
    it.close()


def test_raising_collate_raises_in_the_consumer(tmp_path):
    _, _, _, ds, collate = _loader_parts(tmp_path)
    calls = []

    def bad(items):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk went away")
        return collate(items)

    t0 = time.perf_counter()
    with pytest.raises(OSError, match="disk went away"):
        for _ in PrefetchLoader(ds, bad, 2, num_workers=2):
            pass
    assert time.perf_counter() - t0 < 10.0


def test_collate_keeps_non_wav_clips_as_jax(jnative, tmp_path):
    """FLAC and MP3 rows train: none is dropped, and the audio equals the
    JAX collate's."""
    _need_ffmpeg()
    cfg, dcfg, tk, ds, collate = _loader_parts(
        tmp_path, ("wav", "flac", "mp3", "flac"))
    batches = list(tdata.data_loader(ds, collate, 2))
    assert len(batches) == 2 and not any(b.get("_empty_batch")
                                         for b in batches)
    from desta25_audio_tpu import DeSTA25Config as JaxConfig
    jcfg = JaxConfig(**NANO)
    jdcfg = jdata.DataConfig(**{k: getattr(dcfg, k) for k in (
        "manifest_filepaths", "data_root", "batch_size", "max_seq_length",
        "num_audio_samples", "trans_max_tokens", "shuffle")})
    jds = jdata.AudioTextDataset(jcfg, jdcfg, tk, shard_by_process=False)
    want = list(jdata.data_loader(jds, jdata.CollateFn(jcfg, jdcfg, tk), 2))
    for a, b in zip(batches, want):
        assert a["audio"].shape[0] == 2
        np.testing.assert_array_equal(a["audio"], b["audio"])
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


def test_build_script_runs(tmp_path):
    out = subprocess.run([shutil.which("python3") or "python3", "-m",
                          "desta25_audio_tpu_torch.native.build"],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "built" in out.stdout and "g++" in out.stdout.lower()
