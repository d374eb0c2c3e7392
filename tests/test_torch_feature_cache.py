"""The port's audio-feature cache (``models/feature_cache.py``), mirroring the
JAX package's tests/test_feature_cache.py on the nano f32 model: the cached
path equals the one-pass path, a hit skips file decode, VAD, ASR and
perception, a rewritten file misses, LRU eviction, ORCA's local tokens are
cached too, and a batch mixing hits and misses runs perception over the
misses padded to a power of two (float and int8 encoder).  Through the cache,
greedy ``generate()`` with ASR gives JAX's ids and transcripts."""

import jax
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import AudioSegment, write_wav
from desta25_audio_tpu_torch.ckpt.bridge import from_jax_params
from desta25_audio_tpu_torch.models import desta as tdesta
from desta25_audio_tpu_torch.models.feature_cache import AudioFeatureCache
from desta25_audio_tpu_torch.ops.quant import is_quantized

NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            prompt_size=8, qformer_num_hidden_layers=2, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ASR's eager decode loop runs thousands of tiny ops; with every test
    worker's torch on all cores they wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(freq, n=12000):
    """A tone switched on and off at 3 Hz: the energy VAD calls it
    speech (a steady tone is not)."""
    t = np.arange(n) / 16000.0
    return (0.5 * np.sin(2 * np.pi * freq * t)
            * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(JaxConfig(**NANO), seed=0)
    cfg = DeSTA25Config(**NANO)
    params = from_jax_params(jax.tree.map(np.asarray, jm.params), cfg, "cpu")
    return jm, DeSTA25AudioModel(cfg, device="cpu", params=params)


@pytest.fixture()
def model(models):
    m = models[1]
    m.audio_cache = None
    yield m
    m.audio_cache = None


@pytest.fixture()
def wav(tmp_path):
    p = str(tmp_path / "a.wav")
    write_wav(p, _tone(300))
    return p


def _msgs(path, text="a tone"):
    return [{"role": "user", "content": "Describe: <|AUDIO|>",
             "audios": [{"audio": path, "text": text}]}]


def _prep(model, convs):
    """(embeds, attention mask, aux, prompt ids) of the generation phases."""
    embeds, mask, aux, _, _, prompt_ids = model._run_generation_phases(
        convs, {}, return_prompt_ids=True)
    return embeds, mask, aux, prompt_ids


def test_cached_path_matches_fused_path(model, wav):
    e0, a0, _, p0 = _prep(model, [_msgs(wav)])
    model.enable_audio_cache(8)
    e1, a1, _, p1 = _prep(model, [_msgs(wav)])   # miss
    e2, _, _, _ = _prep(model, [_msgs(wav)])     # hit
    assert torch.equal(e0, e1) and torch.equal(e1, e2)
    assert np.array_equal(p0, p1)
    assert torch.equal(a0, a1)
    assert model.audio_cache.misses == 1 and model.audio_cache.hits == 1
    # the same capacity keeps the cache; another replaces it; 0 turns it off
    cache = model.audio_cache
    model.enable_audio_cache(8)
    assert model.audio_cache is cache
    model.enable_audio_cache(4)
    assert model.audio_cache is not cache and len(model.audio_cache) == 0
    model.enable_audio_cache(0)
    assert model.audio_cache is None


def test_hit_skips_decode_vad_asr(model, wav, monkeypatch):
    """On a hit the file is never opened and neither VAD nor ASR runs."""
    model.enable_audio_cache(8)
    timings = {}
    model._run_generation_phases([_msgs(wav, text=None)], timings)  # + ASR
    assert timings["asr_steps"] >= 1
    entry = model.audio_cache.get(AudioFeatureCache.key(wav))
    assert entry["speech"] and entry["asr_text"] is not None
    calls = {"decode": 0, "vad": 0, "asr": 0, "perception": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(AudioSegment, "from_file",
                        counting("decode", AudioSegment.from_file))
    monkeypatch.setattr(tdesta, "has_speech",
                        counting("vad", tdesta.has_speech))
    monkeypatch.setattr(tdesta, "perception_apply",
                        counting("perception", tdesta.perception_apply))
    monkeypatch.setattr(model, "_asr", counting("asr", model._asr))
    timings = {}
    e, _, _, _, trans = model._run_generation_phases(
        [_msgs(wav, text=None)], timings)
    assert calls == {"decode": 0, "vad": 0, "asr": 0, "perception": 0}
    assert e.shape[0] == 1 and "asr_ms" not in timings
    assert trans == [entry["asr_text"]]


def test_stat_key_invalidation(model, tmp_path):
    """Rewriting the file (new mtime/size) is a miss and refreshes the
    features."""
    p = str(tmp_path / "x.wav")
    write_wav(p, _tone(300))
    model.enable_audio_cache(8)
    e0, _, _, _ = _prep(model, [_msgs(p)])
    write_wav(p, _tone(900, n=12800))  # different audio, same path
    e1, _, _, _ = _prep(model, [_msgs(p)])
    assert model.audio_cache.misses == 2
    assert not torch.equal(e0, e1)


def test_lru_eviction(model, tmp_path):
    model.enable_audio_cache(2)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"e{i}.wav")
        write_wav(p, _tone(200 + 100 * i))
        paths.append(p)
        _prep(model, [_msgs(p)])
    assert len(model.audio_cache) == 2
    # the oldest entry was evicted -> a miss; the newest still hits
    h0 = model.audio_cache.hits
    _prep(model, [_msgs(paths[2])])
    assert model.audio_cache.hits == h0 + 1
    m0 = model.audio_cache.misses
    _prep(model, [_msgs(paths[0])])
    assert model.audio_cache.misses == m0 + 1


def test_orca_cache_parity(tmp_path):
    """An ORCA model caches its local tokens too: the injection tokens and
    the embeddings equal the one-pass path's."""
    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano", encoder_model_id="test/whisper-nano",
        connector_mode="orca_hybrid", qformer_num_hidden_layers=2,
        orca_global_num_tokens=4, orca_local_downsample=4,
        orca_local_kernel_size=5, orca_audio_position_scale=2.5,
        dtype="float32")
    m = DeSTA25AudioModel(cfg, device="cpu", seed=1)
    p = str(tmp_path / "o.wav")
    write_wav(p, _tone(440))
    e0, _, x0, _ = _prep(m, [_msgs(p)])
    i0 = m._orca_inject_tokens(x0)
    assert i0 is not None
    m.enable_audio_cache(4)
    e1, _, x1, _ = _prep(m, [_msgs(p)])   # miss
    e2, _, x2, _ = _prep(m, [_msgs(p)])   # hit
    assert m.audio_cache.hits == 1
    assert torch.equal(e0, e1) and torch.equal(e1, e2)
    i1, i2 = m._orca_inject_tokens(x1), m._orca_inject_tokens(x2)
    assert torch.equal(i0, i1) and torch.equal(i1, i2)


@pytest.mark.parametrize("encoder", ["float", "int8"])
def test_mixed_hit_miss_batch(tmp_path, monkeypatch, encoder):
    """One hit and three misses: perception runs once, over the misses
    padded to 4 clips, and the features land in the request's order."""
    cfg = DeSTA25Config(**NANO)
    m = DeSTA25AudioModel(cfg, device="cpu", seed=2)
    if encoder == "int8":
        m.apply_inference_encoder_quant()
        assert is_quantized(m.params["whisper"]["encoder"]["layers"]["fc1"])
    paths = []
    for i, f in enumerate((300, 700, 500, 900)):
        paths.append(str(tmp_path / f"c{i}.wav"))
        write_wav(paths[-1], _tone(f))
    convs = [_msgs(p) for p in paths]
    e_ref, _, _, _ = _prep(m, convs)
    m.enable_audio_cache(8)
    _prep(m, convs[:1])                    # the first clip is cached
    batches = []
    real = tdesta.perception_apply

    def recording(params, mel, config):
        batches.append(mel.shape[0])
        return real(params, mel, config)
    monkeypatch.setattr(tdesta, "perception_apply", recording)
    e_mix, _, _, _ = _prep(m, convs)       # 1 hit, 3 misses
    assert batches == [4]
    assert m.audio_cache.hits == 1 and m.audio_cache.misses == 4
    # perception at a clip batch of 4 against one over other clips:
    # summation order only
    assert torch.allclose(e_ref, e_mix, atol=1e-5)
    e_hit, _, _, _ = _prep(m, convs)       # every clip hits now
    assert batches == [4] and torch.equal(e_hit, e_mix)


def test_generate_with_asr_through_the_cache_matches_jax(models, wav):
    jm, tm = models
    msgs = [_msgs(wav, text=None)]
    want = jm.generate(msgs, max_new_tokens=4, do_sample=False)
    tm.enable_audio_cache(8)
    try:
        first = tm.generate(msgs, max_new_tokens=4, do_sample=False)
        assert tm.last_timings["asr_steps"] >= 1
        second = tm.generate(msgs, max_new_tokens=4, do_sample=False)
        assert "asr_steps" not in tm.last_timings     # a hit: no ASR
    finally:
        tm.audio_cache = None
    for got in (first, second):
        assert got.generated_ids == want.generated_ids
        assert got.text == want.text
        assert got.audios == want.audios
