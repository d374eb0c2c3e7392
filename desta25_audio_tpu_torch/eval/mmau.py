"""MMAU benchmark harness (re-homed from ``desta25_audio_tpu/eval/mmau.py``).

Reference: examples/evaluation/mmau_eval.py (386 LoC) + the vendored
official scorer MMAU-v05.15.25/mmau_evaluate.py:12-38.  Pipeline per item:
write the clip to wav, build the multiple-choice prompt, greedy
``generate``, strip ``<think>`` / extract the final answer, score with the
official string-match OR an LLM judge, and break accuracy down by
task / difficulty / sub-category.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..audio.io import write_wav
from .judge import LLMJudge

MMAU_SYSTEM_PROMPT = (
    'Focus on the audio clips and instructions. Provide your answer by '
    'first thinking in <think> tags if needed, and then ending with '
    '"The correct answer is: \\"___\\" " where ___ is the exact choice '
    'from the list.'
)


def string_match(answer: str, prediction: str,
                 choices: Sequence[str]) -> bool:
    """Official MMAU scorer (MMAU-v05.15.25/mmau_evaluate.py:12-38):
    every answer token must appear in the prediction, and the prediction
    must contain no token unique to an incorrect choice."""

    def tokenize(text) -> set:
        if not isinstance(text, str):
            text = str(text)
        return set(re.findall(r"\b\w+\b", text.lower()))

    pred_tokens = tokenize(prediction)
    ans_tokens = tokenize(answer)
    if not pred_tokens:
        return False
    wrong_tokens: set = set()
    for choice in choices:
        ct = tokenize(choice)
        if ct != ans_tokens:
            wrong_tokens.update(ct - ans_tokens)
    return ans_tokens.issubset(pred_tokens) and \
        pred_tokens.isdisjoint(wrong_tokens)


def extract_final_answer(text: str) -> str:
    """Strip <think> blocks and pull the choice after
    'The correct answer is:' (mmau_eval.py:162-178)."""
    text = re.sub(r"<think>.*?</think>", "", text, flags=re.DOTALL).strip()
    m = re.search(r"the correct answer is[:\s]*\"?([^\"\n]+)\"?", text,
                  flags=re.IGNORECASE)
    if m:
        return m.group(1).strip().strip('."')
    return text


def build_prompt(item: Dict[str, Any]) -> str:
    choices = item["choices"]
    if isinstance(choices, str):
        try:
            choices = json.loads(choices)
        except json.JSONDecodeError:
            choices = [choices]
    question = f"{item['question']} Choose from the following options: "
    question += ", ".join(f'"{c}"' for c in choices)
    return question + " <|AUDIO|>"


def _write_item_audio(item: Dict[str, Any], wav_path: str) -> str:
    """Item audio can be a dict {array, sampling_rate}, a path, or raw
    samples."""
    audio = item.get("audio")
    if isinstance(audio, str) and os.path.exists(audio):
        return audio
    if isinstance(audio, dict) and "array" in audio:
        write_wav(wav_path, np.asarray(audio["array"], np.float32),
                  int(audio.get("sampling_rate", 16000)))
        return wav_path
    if audio is not None:
        write_wav(wav_path, np.asarray(audio, np.float32))
        return wav_path
    raise ValueError(f"item has no usable audio: {list(item)}")


def evaluate_mmau(
    model,
    items: Iterable[Dict[str, Any]],
    judge: Optional[LLMJudge] = None,
    out_path: Optional[str] = None,
    max_new_tokens: int = 256,
) -> Dict[str, Any]:
    """Run the MMAU loop. ``items`` need keys question/choices/answer plus
    audio, and optionally task/difficulty/sub-category.

    Scoring = official string_match OR'd with the LLM judge when given
    (mmau_eval.py:316-322)."""
    results: List[Dict[str, Any]] = []
    task_metrics: Dict[str, List[int]] = {}
    diff_metrics: Dict[str, List[int]] = {}
    subcat_metrics: Dict[str, List[int]] = {}

    with tempfile.TemporaryDirectory() as td:
        wav_path = os.path.join(td, "tmp.wav")
        for item in items:
            audio_path = _write_item_audio(item, wav_path)
            messages = [
                {"role": "system", "content": MMAU_SYSTEM_PROMPT},
                {"role": "user", "content": build_prompt(item),
                 "audios": [{"audio": audio_path, "text": None}]},
            ]
            out = model.generate(messages, max_new_tokens=max_new_tokens,
                                 do_sample=False)
            raw_pred = out.text[0]
            pred = extract_final_answer(raw_pred)

            choices = item["choices"]
            if isinstance(choices, str):
                try:
                    choices = json.loads(choices)
                except json.JSONDecodeError:
                    choices = [choices]
            correct = string_match(item["answer"], pred, choices)
            judge_raw = None
            if not correct and judge is not None:
                verdict, judge_raw = judge.judge_multiple_choice(
                    item["question"], choices, item["answer"], raw_pred)
                correct = correct or bool(verdict)

            rec = {
                "question": item["question"],
                "choices": choices,
                "answer": item["answer"],
                "model_prediction": raw_pred,
                "extracted": pred,
                "correct": correct,
                "task": item.get("task", "unknown"),
                "difficulty": item.get("difficulty", "unknown"),
                "sub-category": item.get("sub-category", "unknown"),
                "judge_raw": judge_raw,
            }
            results.append(rec)
            for metrics, key in ((task_metrics, rec["task"]),
                                 (diff_metrics, rec["difficulty"]),
                                 (subcat_metrics, rec["sub-category"])):
                metrics.setdefault(key, [0, 0])
                metrics[key][0] += int(correct)
                metrics[key][1] += 1

    def pct(c, t):
        return 100.0 * c / t if t else 0.0

    report = {
        "overall": pct(sum(r["correct"] for r in results), len(results)),
        "n_items": len(results),
        "task": {k: pct(*v) for k, v in sorted(task_metrics.items())},
        "difficulty": {k: pct(*v) for k, v in sorted(diff_metrics.items())},
        "sub_category": {k: pct(*v)
                         for k, v in sorted(subcat_metrics.items())},
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"report": report, "results": results}, f, indent=2)
    return report
