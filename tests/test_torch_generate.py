"""The port's whole slice against the JAX package on the CPU: the nano
``DeSTA25AudioModel`` of tests/test_generate_e2e.py (f32), its params
bridged into the port, greedy ``generate()`` on the same WAVs with the
transcriptions supplied, or made by Whisper ASR in the loop.  The generated ids must be identical token for
token (wav -> VAD -> mel -> encoder -> Q-Former -> splice -> prefill ->
decode)."""

import jax
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt.bridge import from_jax_params

NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ASR's eager decode loop runs thousands of tiny ops; with every test
    worker's torch on all cores they wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(JaxConfig(**NANO), seed=0)
    cfg = DeSTA25Config(**NANO)
    params = from_jax_params(jax.tree.map(np.asarray, jm.params), cfg, "cpu")
    return jm, DeSTA25AudioModel(cfg, device="cpu", params=params)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("audio")
    paths = []
    for i, (n, f0) in enumerate(((16000, 440.0), (24000, 300.0))):
        t = np.arange(n) / 16000.0
        sig = (0.5 * np.sin(2 * np.pi * f0 * t)
               * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
        sig += 0.01 * rng.standard_normal(n).astype(np.float32)
        paths.append(str(d / f"tone{i}.wav"))
        write_wav(paths[-1], sig)
    return paths


def _conversations(wavs):
    one = [{"role": "system", "content": "Focus on the audio."},
           {"role": "user", "content": "What do you hear? <|AUDIO|>",
            "audios": [{"audio": wavs[0], "text": "a test tone"}]}]
    two = [{"role": "user", "content": "Compare <|AUDIO|> and <|AUDIO|>.",
            "audios": [{"audio": wavs[0], "text": "first"},
                       {"audio": wavs[1], "text": "the second one"}]}]
    return one, two


@pytest.mark.parametrize("case", ["single", "batch_left_padded",
                                  "text_only"])
def test_greedy_generate_matches_jax_token_for_token(models, wavs, case):
    jm, tm = models
    one, two = _conversations(wavs)
    messages = {"single": one, "batch_left_padded": [one, two],
                "text_only": [{"role": "user", "content": "Hello there!"}]
                }[case]
    want = jm.generate(messages, max_new_tokens=8, do_sample=False)
    got = tm.generate(messages, max_new_tokens=8, do_sample=False)
    assert got.generated_ids == want.generated_ids
    assert got.text == want.text
    assert got.audios == want.audios
    assert set(tm.last_timings) >= {"prefill_ms", "decode_ms"}


def test_sampled_generate_shapes_and_stop_padding(models, wavs):
    _, tm = models
    one, two = _conversations(wavs)
    out = tm.generate([one, two], max_new_tokens=6, do_sample=True,
                      temperature=0.8, top_p=0.9)
    ids = np.asarray(out.generated_ids)
    assert ids.shape == (2, 6)
    assert ((ids >= 0) & (ids < 512)).all()
    # after a stop token a row only holds pad
    stops = set(tm._terminators())
    pad = tm.tokenizer.pad_token_id
    for row in ids:
        hit = [i for i, t in enumerate(row) if t in stops]
        if hit:
            assert (row[hit[0] + 1:] == pad).all()


def test_missing_transcription_needs_asr(models, wavs, tmp_path):
    """A clip without a transcription is transcribed by Whisper ASR in the
    loop (a silent one takes " " without ASR), as JAX does: greedy ids,
    texts and transcripts identical.  A missing file still raises."""
    jm, tm = models
    silent = str(tmp_path / "silent.wav")
    write_wav(silent, np.zeros(8000, np.float32))
    msgs = [[{"role": "user", "content": "Describe <|AUDIO|>",
              "audios": [{"audio": wavs[0], "text": None}]}],
            [{"role": "user", "content": "Compare <|AUDIO|> with <|AUDIO|>",
              "audios": [{"audio": wavs[1], "text": None},
                         {"audio": silent, "text": None}]}]]
    want = jm.generate(msgs, max_new_tokens=4, do_sample=False)
    got = tm.generate(msgs, max_new_tokens=4, do_sample=False)
    assert got.generated_ids == want.generated_ids
    assert got.text == want.text
    assert got.audios == want.audios
    assert got.audios[2] == (silent, " ")
    assert tm.last_timings["asr_steps"] >= 1
    with pytest.raises(ValueError, match="does not exist"):
        tm.generate([{"role": "user", "content": "hi <|AUDIO|>",
                      "audios": [{"audio": "/nonexistent.wav",
                                  "text": "x"}]}], max_new_tokens=2)
