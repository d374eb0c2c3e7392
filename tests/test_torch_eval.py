"""The port's eval harness (``eval/judge.py``, ``eval/mmau.py``,
``eval/sakura.py``, ``eval/metrics.py``), mirroring by name the seven cases
of the JAX package's tests/test_eval_harness.py: the official MMAU
string_match semantics, answer extraction, prompt building, verdict
parsing, the ConsecutiveWordsAccuracy metric, and the MMAU and SAKURA loops
on a nano model with a stub judge.  The loops run the port's model with the
JAX nano model's params bridged in, and their reports and predictions equal
the JAX package's loops on the JAX model."""

import jax
import numpy as np
import pytest
import torch

from desta25_audio_tpu_torch.eval.judge import LLMJudge, parse_verdict
from desta25_audio_tpu_torch.eval.metrics import (
    ConsecutiveWordsAccuracyMetric,
    basic_normalize,
)
from desta25_audio_tpu_torch.eval.mmau import (
    build_prompt,
    evaluate_mmau,
    extract_final_answer,
    string_match,
)
from desta25_audio_tpu_torch.eval.sakura import evaluate_sakura


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_string_match_official_semantics():
    choices = ["a dog barking", "a cat meowing", "rain falling"]
    assert string_match("a dog barking", "The correct answer is: a dog "
                        "barking", choices)
    # a token unique to a wrong choice fails; a missing answer token fails
    assert not string_match("a dog barking", "a dog barking and a cat",
                            choices)
    assert not string_match("a dog barking", "a dog", choices)
    # tokens shared with wrong choices do not disqualify
    assert string_match("a dog barking", "i think a dog barking", choices)
    assert not string_match("a dog barking", "", choices)


def test_extract_final_answer():
    t = ('<think>hmm, sounds like rain</think>The correct answer is: '
         '"rain falling"')
    assert extract_final_answer(t) == "rain falling"
    assert extract_final_answer("just some text") == "just some text"
    assert extract_final_answer(
        "the correct answer is: a dog barking.") == "a dog barking"


def test_build_prompt_handles_json_choices():
    p = build_prompt({"question": "What is it?", "choices": '["a", "b"]'})
    assert '"a", "b"' in p and p.endswith("<|AUDIO|>")


def test_parse_verdict():
    assert parse_verdict("CORRECT") is True
    assert parse_verdict(" incorrect extra") is False
    assert parse_verdict("maybe?") is None


def test_consecutive_words_metric():
    m = ConsecutiveWordsAccuracyMetric()
    assert m.update("The answer is a Dog barking!", "dog barking")
    assert not m.update("a dog", "dog barking")
    assert m.compute() == 0.5
    assert basic_normalize("Hello, (aside) World! [noise]") == "hello world"


@pytest.fixture(scope="module")
def nano_models():
    from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
    from desta25_audio_tpu import DeSTA25Config as JaxConfig
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    from desta25_audio_tpu_torch.ckpt.bridge import from_jax_params
    kw = dict(llm_model_id="test/llama-nano",
              encoder_model_id="test/whisper-nano", prompt_size=8,
              qformer_num_hidden_layers=2, dtype="float32")
    jm = JaxModel(JaxConfig(**kw), seed=0)
    cfg = DeSTA25Config(**kw)
    return jm, DeSTA25AudioModel(cfg, "cpu", params=from_jax_params(
        jax.tree.map(np.asarray, jm.params), cfg, "cpu"))


def _items(n=3):
    t = np.arange(16000) / 16000.0
    return [{
        "question": f"What sound is this ({i})?",
        "choices": ["a dog barking", "a cat meowing"],
        "answer": "a dog barking",
        "task": ["sound", "music", "speech"][i % 3],
        "difficulty": "easy",
        "sub-category": "animals",
        "audio": {"array": 0.3 * np.sin(2 * np.pi * (300 + 100 * i) * t)
                  * (np.sin(2 * np.pi * 3 * t) > 0),
                  "sampling_rate": 16000},
    } for i in range(n)]


def test_mmau_loop_with_stub_judge(nano_models, tmp_path):
    """A judge that always says CORRECT: overall 100, every task reported;
    the clips are transcribed by the nano Whisper in the loop, and the
    predictions equal the JAX loop's."""
    import json
    from desta25_audio_tpu.eval.judge import LLMJudge as JaxJudge
    from desta25_audio_tpu.eval.mmau import evaluate_mmau as jax_mmau
    jm, tm = nano_models
    stub = lambda messages, max_new_tokens=4: "CORRECT"  # noqa: E731
    out = str(tmp_path / "mmau.json")
    report = evaluate_mmau(tm, _items(3), judge=LLMJudge(stub), out_path=out,
                           max_new_tokens=4)
    assert report["overall"] == 100.0
    assert set(report["task"]) == {"sound", "music", "speech"}
    data = json.load(open(out))
    assert len(data["results"]) == 3
    assert all("model_prediction" in r for r in data["results"])
    jout = str(tmp_path / "jax.json")
    assert jax_mmau(jm, _items(3), judge=JaxJudge(stub), out_path=jout,
                    max_new_tokens=4) == report
    assert json.load(open(jout))["results"] == data["results"]


def test_sakura_loop(nano_models, tmp_path):
    from desta25_audio_tpu.eval.judge import LLMJudge as JaxJudge
    from desta25_audio_tpu.eval.sakura import evaluate_sakura as jax_sakura
    jm, tm = nano_models
    stub = lambda messages, max_new_tokens=4: "INCORRECT"  # noqa: E731
    items = []
    t = np.arange(8000) / 16000.0
    for track in ("AnimalQA", "GenderQA"):
        for hop in ("single", "multi"):
            items.append({
                "question": "What animal?", "answer": "dog",
                "track": track, "hop": hop,
                "audio": {"array": 0.3 * np.sin(2 * np.pi * 500 * t),
                          "sampling_rate": 16000}})
    report = evaluate_sakura(tm, items, LLMJudge(stub),
                             out_path=str(tmp_path / "sak.json"),
                             max_new_tokens=4)
    assert report["n_items"] == 4
    assert report["per_track"]["AnimalQA/single"] == 0.0
    assert report["avg/single"] == 0.0
    assert jax_sakura(jm, items, JaxJudge(stub), max_new_tokens=4) == report
