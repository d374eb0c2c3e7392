"""SAKURA multi-hop benchmark harness (re-homed from
``desta25_audio_tpu/eval/sakura.py``).

Reference: examples/evaluation/sakura_eval.py (347 LoC) and
examples/eval/eval_sakura_qa.py: four tracks (AnimalQA / GenderQA /
EmotionQA / LanguageQA), each with single-hop and multi-hop questions; the
model answers from the audio and a binary LLM judge decides
CORRECT/INCORRECT; results aggregate per track x hop plus the harmonic
mean across tracks ("Expected Performance" table,
examples/evaluation/README.md).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from ..audio.io import write_wav
from .judge import LLMJudge

TRACKS = ("AnimalQA", "GenderQA", "EmotionQA", "LanguageQA")
HOPS = ("single", "multi")


def evaluate_sakura(
    model,
    items: Iterable[Dict[str, Any]],
    judge: LLMJudge,
    out_path: Optional[str] = None,
    max_new_tokens: int = 128,
) -> Dict[str, Any]:
    """items: dicts with keys audio (path | {array, sampling_rate}),
    question, answer, track, hop ("single" | "multi")."""
    results: List[Dict[str, Any]] = []
    agg: Dict[str, List[int]] = {}

    with tempfile.TemporaryDirectory() as td:
        wav_path = os.path.join(td, "tmp.wav")
        for item in items:
            audio = item["audio"]
            if isinstance(audio, str) and os.path.exists(audio):
                audio_path = audio
            elif isinstance(audio, dict) and "array" in audio:
                write_wav(wav_path, np.asarray(audio["array"], np.float32),
                          int(audio.get("sampling_rate", 16000)))
                audio_path = wav_path
            else:
                write_wav(wav_path, np.asarray(audio, np.float32))
                audio_path = wav_path

            messages = [
                {"role": "system",
                 "content": "Focus on the audio clips and instructions."},
                {"role": "user",
                 "content": f"{item['question']} <|AUDIO|>",
                 "audios": [{"audio": audio_path, "text": None}]},
            ]
            out = model.generate(messages, max_new_tokens=max_new_tokens,
                                 do_sample=False)
            pred = out.text[0]
            verdict, raw = judge.judge_binary(item["question"],
                                              item["answer"], pred)
            correct = bool(verdict)
            key = f"{item.get('track', 'unknown')}/{item.get('hop', '?')}"
            agg.setdefault(key, [0, 0])
            agg[key][0] += int(correct)
            agg[key][1] += 1
            results.append({**{k: item[k] for k in
                               ("question", "answer") if k in item},
                            "track": item.get("track"),
                            "hop": item.get("hop"),
                            "prediction": pred, "correct": correct,
                            "judge_raw": raw})

    def pct(c, t):
        return 100.0 * c / t if t else 0.0

    per_key = {k: pct(*v) for k, v in sorted(agg.items())}
    # harmonic mean over tracks (per hop), as in the reference's Hmean
    report: Dict[str, Any] = {"per_track": per_key,
                              "n_items": len(results)}
    for hop in HOPS:
        vals = [per_key[f"{t}/{hop}"] for t in TRACKS
                if f"{t}/{hop}" in per_key]
        if vals:
            report[f"avg/{hop}"] = float(np.mean(vals))
            nonzero = [v for v in vals if v > 0]
            report[f"hmean/{hop}"] = (
                len(vals) / sum(1.0 / v for v in vals)
                if len(nonzero) == len(vals) else 0.0)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"report": report, "results": results}, f, indent=2)
    return report
