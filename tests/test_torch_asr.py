"""Whisper ASR in the loop: the port against the JAX package on the CPU, in
f32 at nano size (``test/whisper-nano``: 2 decoder layers, d 64, vocab 256,
64 learned positions), the JAX weights carried across by ``ckpt/bridge.py``
and every input made with numpy from a seed.

- ``whisper_cross_kv`` and ``whisper_decoder_apply``, full and cached,
  within 1e-5 of the output scale;
- ``whisper_transcribe``: ids identical and average log-probabilities within
  1e-5, with the language detected or given, the suppression lists (one id
  beyond the vocab), a vocab whose end-of-text stops rows early, and every
  case at 128 new tokens, past the 64 learned positions (the clamp);
- the fallback cascade: the rows JAX retries are the rows the port retries,
  the same seed gives the same output, the sampled tier by shape;
- ``compression_ratio``, ``chunk_audio`` and ``expand_message_for_chunks``
  equal to JAX's over several lengths;
- ``generate()`` with ASR (ORCA; the Q-Former case is
  ``test_torch_generate.py::test_missing_transcription_needs_asr``) and with
  ``auto_chunk_long_audio=True``: greedy ids and transcripts equal JAX's.

One ``max_new_tokens`` (128, what ``generate()``'s ASR decodes) keeps the JAX
compiles few.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.audio import chunking as jchunk
from desta25_audio_tpu.config import whisper_config_for as j_whisper_cfg
from desta25_audio_tpu.generate import decode as jd
from desta25_audio_tpu.models import whisper as jw
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio import chunking as tchunk
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.config import whisper_config_for
from desta25_audio_tpu_torch.generate import decode as td
from desta25_audio_tpu_torch.models import desta as tdesta
from desta25_audio_tpu_torch.models import whisper as tw

MAX_NEW = 128
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's eager decode loop runs thousands of tiny ops; with every
    test worker's torch on all cores they wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _chars(ids):
    return ["".join(chr(i) for i in row if int(i) < 128)
            for row in np.asarray(ids)]


@pytest.fixture(scope="module")
def whisper():
    """(JAX cfg, port cfg, JAX params, port params, mel [3, 300, 80])."""
    jcfg = j_whisper_cfg("test/whisper-nano")
    cfg = whisper_config_for("test/whisper-nano")
    jp = jw.init_whisper(jax.random.PRNGKey(0), jcfg)
    tp = _port(jp)
    mel = np.random.default_rng(0).standard_normal(
        (3, cfg.expected_mel_frames, cfg.num_mel_bins)).astype(np.float32)
    return jcfg, cfg, jp, tp, mel


def _port(jp):
    npt = jax.tree.map(np.asarray, jp)
    return {"encoder": bridge.whisper_encoder_from_jax(npt["encoder"], "cpu"),
            "decoder": bridge.whisper_decoder_from_jax(npt["decoder"], "cpu")}


def test_decoder_full_and_cached_match_jax(whisper):
    jcfg, cfg, jp, tp, mel = whisper
    enc, _ = jw.whisper_encoder_apply(jp["encoder"], jnp.asarray(mel), jcfg)
    enc_t = torch.from_numpy(np.array(enc))
    jkv = jw.whisper_cross_kv(jp["decoder"], enc, jcfg)
    tkv = tw.whisper_cross_kv(tp["decoder"], enc_t, cfg)
    assert tkv[0].shape == (2, 3, 150, 2, 32)
    assert _rel(tkv[0], jkv[0]) < TOL and _rel(tkv[1], jkv[1]) < TOL
    tokens = np.random.default_rng(1).integers(0, 256, (3, 9))
    want, _ = jw.whisper_decoder_apply(jp["decoder"], jnp.asarray(tokens),
                                       jkv, jcfg)
    got, cache = tw.whisper_decoder_apply(tp["decoder"],
                                          torch.from_numpy(tokens), tkv, cfg)
    assert cache is None and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    # cached: a 4-token prefix, then one token a step, against JAX's
    # cached decoder and against the port's own full forward
    jc = jw.init_decoder_cache(jcfg, 3, 12, dtype=jnp.float32)
    tc = tw.init_decoder_cache(cfg, 3, 12, dtype=torch.float32)
    assert tc[0].shape == (2, 3, 12, 2, 32)
    for lo, hi in ((0, 4), (4, 5), (5, 6), (6, 9)):
        jl, jc = jw.whisper_decoder_apply(
            jp["decoder"], jnp.asarray(tokens[:, lo:hi]), jkv, jcfg,
            pos_offset=lo, cache=jc, cache_index=lo)
        tl, tc = tw.whisper_decoder_apply(
            tp["decoder"], torch.from_numpy(tokens[:, lo:hi]), tkv, cfg,
            pos_offset=lo, cache=tc, cache_index=lo)
        assert _rel(tl, jl) < TOL
        assert _rel(tl, got[:, lo:hi]) < TOL
    assert _rel(tc[0], jc[0]) < TOL and _rel(tc[1], jc[1]) < TOL


def _eos_heavy(jp, cfg):
    """The JAX tree with end-of-text's embedding row scaled up, so that
    some rows stop early and others do not."""
    dec = dict(jp["decoder"])
    dec["embed_tokens"] = dec["embed_tokens"].at[cfg.eos_token_id].multiply(
        8.0)
    return {**jp, "decoder": dec}


TRANSCRIBE_CASES = {
    "detect": dict(),
    "language": dict(language_token=252),
    # suppress_from = <|sot|>: ids 250-255 blanked but end-of-text; 300 is
    # beyond the vocab and dropped
    "suppress": dict(suppress_from=250, suppress_ids=(3, 5, 300),
                     begin_suppress_ids=(220, 7)),
    "eos": dict(),
}


@pytest.mark.parametrize("case", list(TRANSCRIBE_CASES))
def test_transcribe_matches_jax(whisper, case):
    jcfg, cfg, jp, tp, mel = whisper
    kw = TRANSCRIBE_CASES[case]
    if case == "eos":
        jp = _eos_heavy(jp, cfg)
        tp = _port(jp)
    want_ids, want_lp = jd.whisper_transcribe(
        jp, jcfg, jnp.asarray(mel), max_new_tokens=MAX_NEW, **kw)
    stats = {}
    ids, lp = td.whisper_transcribe(tp, cfg, torch.from_numpy(mel),
                                    max_new_tokens=MAX_NEW, stats=stats, **kw)
    want_ids = np.asarray(want_ids)
    assert ids.shape == (3, MAX_NEW) and ids.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert np.abs(lp.numpy() - np.asarray(want_lp)).max() < TOL
    eos = cfg.eos_token_id
    stopped = (want_ids == eos).any(1)
    if case == "eos":
        # one row stops at its first token, one mid-way, one decodes every
        # step
        assert stopped.any() and not stopped.all()
        assert stats["asr_steps"] == MAX_NEW - 1
    if case == "suppress":
        assert not np.isin(want_ids, (3, 5)).any()
        assert (want_ids[:, 0] != eos).all() and (want_ids[:, 0] != 7).all()
        assert not ((want_ids >= 250) & (want_ids != eos)).any()


def test_fallback_cascade_retries_the_rows_jax_retries(whisper):
    jcfg, cfg, jp, tp, mel = whisper
    mel_t = torch.from_numpy(mel)
    # JAX's greedy tier as the fallback runs it (the same compile)
    _, j_greedy_lp = jd.whisper_transcribe(
        jp, jcfg, jnp.asarray(mel), max_new_tokens=MAX_NEW,
        temperature=0.0, key=jax.random.fold_in(jax.random.PRNGKey(0), 0))
    j_greedy_lp = np.asarray(j_greedy_lp)
    lps = np.sort(j_greedy_lp)
    assert lps[1] - lps[0] > 1e-3      # a threshold between rows is clear
    kw = dict(temperatures=(0.0, 0.6), logprob_threshold=float(
        (lps[0] + lps[1]) / 2), compression_ratio_threshold=1e9,
        max_new_tokens=MAX_NEW)
    j_texts, j_ids, j_lp = jd.whisper_transcribe_with_fallback(
        jp, jcfg, jnp.asarray(mel), _chars, **kw)
    stats = {}
    texts, ids, lp = td.whisper_transcribe_with_fallback(
        tp, cfg, mel_t, _chars, stats=stats, **kw)
    # JAX's retried rows: those whose result is not the greedy tier's
    j_retried = np.flatnonzero(np.asarray(j_lp) != j_greedy_lp)
    assert stats["asr_retried"] == [j_retried.tolist()]
    assert j_retried.tolist() == np.flatnonzero(
        j_greedy_lp < kw["logprob_threshold"]).tolist() == [int(
            np.argmin(j_greedy_lp))]
    keep = [i for i in range(3) if i not in j_retried]
    np.testing.assert_array_equal(ids[keep], np.asarray(j_ids)[keep])
    assert [texts[i] for i in keep] == [j_texts[i] for i in keep]
    assert np.abs(lp[keep] - np.asarray(j_lp)[keep]).max() < TOL
    # the sampled tier: JAX's and the port's generators differ, so by shape
    assert ids.shape == np.asarray(j_ids).shape and lp.shape == (3,)
    assert ((ids >= 0) & (ids < cfg.vocab_size)).all()
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
    # the same seed (the default generator) gives the same output
    texts2, ids2, lp2 = td.whisper_transcribe_with_fallback(
        tp, cfg, mel_t, _chars, **kw)
    assert texts2 == texts
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(lp2, lp)
    with pytest.raises(ValueError, match="generator"):
        td.whisper_transcribe(tp, cfg, mel_t, max_new_tokens=4,
                              temperature=0.5)


@pytest.mark.parametrize("seconds", [0.5, 30.0, 30.5, 31.0, 59.0, 59.5, 65.0,
                                     89.03])
def test_chunking_and_compression_match_jax(seconds):
    n = int(round(seconds * 16000))
    samples = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = jchunk.chunk_audio(samples)
    got = tchunk.chunk_audio(samples)
    assert [len(c) for c in got] == [len(c) for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    counts = [len(got), 1, 2]
    content = "A <|AUDIO|> then <|AUDIO|>, last<|AUDIO|>."
    assert (tchunk.expand_message_for_chunks(content, "<|AUDIO|>", counts)
            == jchunk.expand_message_for_chunks(content, "<|AUDIO|>",
                                                counts))
    for text in ("", "a", "ab" * len(got) * 40,
                 "".join(chr(32 + (n * 7 + i * 13) % 90) for i in range(n
                                                                    % 300))):
        assert td.compression_ratio(text) == jd.compression_ratio(text)


# -- generate() with ASR -----------------------------------------------------

ORCA_NANO = dict(llm_model_id="test/llama-nano128",
                 encoder_model_id="test/whisper-nano",
                 connector_mode="orca_hybrid", qformer_num_hidden_layers=2,
                 orca_global_num_tokens=4, orca_local_downsample=4,
                 orca_local_kernel_size=5, orca_audio_position_scale=2.5,
                 dtype="float32")
QFORMER_NANO = dict(llm_model_id="test/llama-nano",
                    encoder_model_id="test/whisper-nano",
                    connector_mode="qformer_1", qformer_num_hidden_layers=2,
                    prompt_size=8, dtype="float32")


def _models(conf, seed):
    jm = JaxModel(JaxConfig(**conf), seed=seed)
    cfg = DeSTA25Config(**conf)
    tm = DeSTA25AudioModel(cfg, device="cpu", params=bridge.from_jax_params(
        jax.tree.map(np.asarray, jm.params), cfg, "cpu"))
    return jm, tm


def _tone(path, seconds, f0, seed):
    t = np.arange(int(seconds * 16000)) / 16000.0
    sig = (0.5 * np.sin(2 * np.pi * f0 * t)
           * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
    sig += 0.01 * np.random.default_rng(seed).standard_normal(
        t.size).astype(np.float32)
    write_wav(path, sig)
    return path


def test_orca_generate_with_asr_matches_jax(tmp_path):
    jm, tm = _models(ORCA_NANO, seed=2)
    wav = _tone(str(tmp_path / "o.wav"), 1.5, 520.0, 0)
    msgs = [[{"role": "user", "content": "What is said in <|AUDIO|>?",
              "audios": [{"audio": wav, "text": None}]}]]
    want = jm.generate(msgs, max_new_tokens=5, do_sample=False)
    got = tm.generate(msgs, max_new_tokens=5, do_sample=False)
    assert got.generated_ids == want.generated_ids
    assert got.text == want.text
    assert got.audios == want.audios
    assert got.audios[0][1] is not None
    assert tm.last_timings["asr_steps"] >= 1
    assert tm.last_timings["asr_ms"] > 0


def test_chunked_generate_matches_jax(tmp_path, monkeypatch):
    jm, tm = _models(QFORMER_NANO, seed=0)
    long = _tone(str(tmp_path / "long.wav"), 65.0, 300.0, 1)
    short = _tone(str(tmp_path / "short.wav"), 2.0, 440.0, 2)
    msgs = [[{"role": "user",
              "content": "Summarise <|AUDIO|> and compare <|AUDIO|>.",
              "audios": [{"audio": long, "text": None},
                         {"audio": short, "text": "a short tone"}]}]]
    want = jm.generate(msgs, max_new_tokens=4, do_sample=False,
                       auto_chunk_long_audio=True)
    made = []
    real_mkstemp = tdesta.tempfile.mkstemp

    def recording_mkstemp(*a, **k):
        fd, path = real_mkstemp(*a, **k)
        made.append(path)
        return fd, path
    monkeypatch.setattr(tdesta.tempfile, "mkstemp", recording_mkstemp)
    got = tm.generate(msgs, max_new_tokens=4, do_sample=False,
                      auto_chunk_long_audio=True)
    assert got.generated_ids == want.generated_ids
    assert got.text == want.text
    # 65 s: three 30 s windows with 1 s overlaps, then the supplied clip
    assert len(got.audios) == len(want.audios) == 4
    assert [t for _, t in got.audios] == [t for _, t in want.audios]
    assert got.audios[3] == (short, "a short tone")
    assert len(made) == 3 and not any(os.path.exists(p) for p in made)
    assert tm.last_timings["asr_steps"] >= 1
