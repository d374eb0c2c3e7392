"""The PyTorch port stands alone: it imports no jax, its re-homed host
modules (config presets, tokenizer, WAV I/O, VAD, splice maps) stay equal to
the JAX package's, its native audio libraries build from its own C++
sources, and it refuses what the slices do not cover (other connectors)
while taking the Q-Former and ORCA configurations, with or without LoRA."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import desta25_audio_tpu.config as jcfg
import desta25_audio_tpu_torch.config as tcfg

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "desta25_audio_tpu_torch"


def test_import_leaves_jax_absent():
    code = (
        "import pkgutil, importlib, sys\n"
        "import desta25_audio_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'desta25_audio_tpu' or m.startswith('desta25_audio_tpu.')]"
        "\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_never_import_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|desta25_audio_tpu\b(?!_))",
                     re.M)
    offenders = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not pat.search(smoke)


def test_sources_never_import_safetensors():
    """The port reads and writes safetensors itself (ckpt/flat_io.py), so
    it runs where the safetensors package is not installed."""
    pat = re.compile(r"^\s*(import|from)\s+safetensors\b", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    assert not pat.search((REPO / "chip_smoke.py").read_text())


@pytest.mark.parametrize("name", ["_WHISPER_PRESETS", "_LLM_PRESETS",
                                  "TARGET_LAYER_IDS"])
def test_presets_equal_the_jax_package(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


def test_config_objects_equal_the_jax_package():
    for mid in jcfg._LLM_PRESETS:
        assert (dataclasses.asdict(tcfg.llm_config_for(mid))
                == dataclasses.asdict(jcfg.llm_config_for(mid)))
    for mid in jcfg._WHISPER_PRESETS:
        assert (dataclasses.asdict(tcfg.whisper_config_for(mid))
                == dataclasses.asdict(jcfg.whisper_config_for(mid)))
    assert (dataclasses.asdict(tcfg.DeSTA25Config())
            == dataclasses.asdict(jcfg.DeSTA25Config()))
    flagship = tcfg.config_from_yaml_file(
        str(REPO / "configs" / "desta25_llama31-8B_Qformer6L.yaml"))
    assert flagship.qformer_num_hidden_layers == 6
    assert flagship.target_layer_ids == (7, 15, 23, 31)
    assert flagship.resolved_encoder_quant(inference=False) == "none"


def test_tokenizer_rehomed_verbatim():
    from desta25_audio_tpu.data.tokenizer import CharTokenizer as J
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer as T
    msgs = [{"role": "system", "content": "Focus."},
            {"role": "user", "content": "Hear <|AUDIO|> now?"}]
    for tmpl in ("llama3", "qwen3"):
        j, t = J(tmpl), T(tmpl)
        text = j.apply_chat_template(msgs)
        assert t.apply_chat_template(msgs) == text
        assert t.encode(text) == j.encode(text)
        assert t([text, "hi"]) == j([text, "hi"])
        assert t.decode(j.encode(text), False) == j.decode(j.encode(text),
                                                          False)


def test_wav_io_vad_and_splice_maps_match(tmp_path):
    from desta25_audio_tpu.audio import io as jio
    from desta25_audio_tpu.audio import vad as jvad
    from desta25_audio_tpu.models import splice as jsp
    from desta25_audio_tpu_torch.audio import io as tio
    from desta25_audio_tpu_torch.audio import vad as tvad
    from desta25_audio_tpu_torch.models import splice as tsp
    rng = np.random.default_rng(0)
    t = np.arange(8000) / 8000.0
    sig = np.stack([np.sin(2 * np.pi * 300 * t) * (np.sin(6 * t) > 0),
                    0.01 * rng.standard_normal(t.size)], 1).astype(np.float32)
    path = str(tmp_path / "a.wav")
    tio.write_wav(path, sig, sr=8000)
    # the JAX package's python WAV path (its AudioSegment prefers a native
    # codec with another resampler when that library is built)
    raw, sr = jio.read_wav(path)
    got_raw, got_sr = tio.read_wav(path)
    np.testing.assert_array_equal(got_raw, raw)
    assert got_sr == sr == 8000
    want = jio.resample(jio.select_channels(raw, "average"), sr, 16000)
    # a duration takes the Python path (the native fast path's resampler is
    # not scipy's: tests/test_torch_native.py holds it against JAX's)
    b = tio.AudioSegment.from_file(path, target_sr=16000, duration=2.0)
    np.testing.assert_array_equal(b.samples, want)
    assert b.sample_rate == 16000
    assert jvad.energy_vad(want) == tvad.energy_vad(b.samples)
    assert tvad.has_speech(b.samples)
    # not audio: the WAV parsers refuse it, then the FFmpeg codec
    with pytest.raises(ValueError, match="decode"):
        tio.AudioSegment.from_file(__file__)
    entries = [jsp.SpliceEntry(0, 2, 0, 3, 2), jsp.SpliceEntry(1, 0, 1, 3, 1)]
    got = tsp.build_splice_maps(2, 8, [tsp.SpliceEntry(**vars(e))
                                       for e in entries])
    for g, w in zip(got, jsp.build_splice_maps(2, 8, entries)):
        np.testing.assert_array_equal(g, w)
    toks = ["a", "<|AUDIO|>", "b", "<|AUDIO|>", "c"]
    assert (tsp.expand_audio_placeholders(toks, "<|AUDIO|>", [3, 2], [2, 0],
                                          "<p>")
            == jsp.expand_audio_placeholders(toks, "<|AUDIO|>", [3, 2],
                                             [2, 0], "<p>"))


@pytest.mark.parametrize("override,match", [
    (dict(connector_mode="qformer_2"), "connector_mode"),
    (dict(connector_mode="perceiver", use_lora=True), "connector_mode"),
])
def test_outside_the_slice_raises(override, match):
    from desta25_audio_tpu_torch.models.desta import check_slice
    cfg = tcfg.DeSTA25Config(llm_model_id="test/llama-nano",
                             encoder_model_id="test/whisper-nano", **override)
    with pytest.raises(NotImplementedError, match=match):
        check_slice(cfg)


@pytest.mark.parametrize("module", ["native", "native.build", "audio.io",
                                    "data.prefetch", "ckpt.lora_io",
                                    "parallel.distributed",
                                    "parallel.sharding", "parallel.mesh",
                                    "train.step", "train.optimizer",
                                    "train.trainer", "ckpt.checkpoint",
                                    "data.dataset", "cli.train"])
def test_new_modules_import_neither_jax_nor_the_jax_package(module):
    path = PKG / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = PKG / module.replace(".", "/") / "__init__.py"
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|desta25_audio_tpu\b(?!_))",
                     re.M)
    assert not pat.search(path.read_text())


def test_native_sources_lie_in_the_port():
    """The C++ the port builds is its own copy under
    desta25_audio_tpu_torch/native/, and the builder writes under build/."""
    from desta25_audio_tpu_torch.native import build as tbuild
    for src, _, _ in tbuild.LIBS.values():
        path = (tbuild.HERE / src).resolve()
        assert path.is_file() and PKG in path.parents, path
    assert tbuild.BUILD_DIR == REPO / "build" / "desta25_audio_tpu_torch"
    for name in tbuild.LIBS:
        assert tbuild.library_path(name).parent == tbuild.BUILD_DIR


def test_the_slice_takes_orca():
    from desta25_audio_tpu_torch.models.desta import check_slice
    for path in ("desta25_llama31-8B_ORCAHybrid.yaml",
                 "desta25_qwen3-4b_ORCAHybrid.yaml",
                 "desta25_qwen3-0.6b_ORCAHybrid.yaml"):
        cfg = tcfg.config_from_yaml_file(str(REPO / "configs" / path))
        assert cfg.is_orca and cfg.orca_deep_injection_enabled
        check_slice(cfg)
        check_slice(tcfg.DeSTA25Config(**{**dataclasses.asdict(cfg),
                                          "use_lora": True}))
