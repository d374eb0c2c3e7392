"""LLM-as-judge scoring (re-homed from ``desta25_audio_tpu/eval/judge.py``;
reference: the Qwen3-4B judge in examples/evaluation/mmau_eval.py:184-256
and sakura_eval.py:123-204).

The judge runs on the port's own LLM stack (a text-only DeSTA25AudioModel,
or any ``generate_fn(messages, max_new_tokens) -> str`` callable), so no HF
inference path is needed.  Prompts keep the reference's contract: output
exactly "CORRECT" or "INCORRECT"; unparseable output returns None.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

MC_JUDGE_PROMPT = """You are a strict expert judge for an audio \
multiple-choice question answering task.

You receive:
1. A question about an audio clip.
2. A list of choices.
3. The ground truth answer.
4. The model's predicted answer (which may include reasoning in <think> \
tags).

Decide if the model's final answer choice is correct according to the \
ground truth.
Ignore the thinking process in <think> tags.
The model's answer is correct if it chooses the same meaning or option as \
the ground truth.

Question: {question}
Choices: {choices}
Ground truth answer: {gold}
Model answer: {pred}

Output "CORRECT" or "INCORRECT".
"""

BINARY_JUDGE_PROMPT = """You are a strict expert judge for an audio \
question answering task.

You receive:
1. A question about an audio clip.
2. The ground truth answer.
3. The model's predicted answer.

Decide if the model's answer is semantically correct.
Ignore small wording differences, punctuation, and synonyms.
Focus only on meaning.

Question: {question}
Ground truth answer: {gold}
Model answer: {pred}

If the model's answer is semantically correct or equivalent, output \
exactly:
CORRECT

Otherwise, output exactly:
INCORRECT
"""


def parse_verdict(raw_text: str) -> Optional[bool]:
    t = raw_text.strip().upper()
    if t.startswith("CORRECT"):
        return True
    if t.startswith("INCORRECT"):
        return False
    return None


class LLMJudge:
    """Binary / multiple-choice judge over a generate callable.

    generate_fn: ``(messages: list[dict], max_new_tokens: int) -> str``.
    Use :func:`make_desta_judge` to build one from a text-only
    DeSTA25AudioModel (e.g. a Qwen3 backbone, matching the reference's
    judge model choice).
    """

    def __init__(self, generate_fn: Callable):
        self.generate_fn = generate_fn

    def judge_multiple_choice(self, question: str, choices: Sequence[str],
                              gold: str, pred: str
                              ) -> Tuple[Optional[bool], str]:
        prompt = MC_JUDGE_PROMPT.format(question=question,
                                        choices=list(choices), gold=gold,
                                        pred=pred)
        raw = self.generate_fn(
            [{"role": "system",
              "content": "You are a careful judge for multiple-choice QA "
                         "outputs."},
             {"role": "user", "content": prompt}], max_new_tokens=4)
        return parse_verdict(raw), raw

    def judge_binary(self, question: str, gold: str, pred: str
                     ) -> Tuple[Optional[bool], str]:
        prompt = BINARY_JUDGE_PROMPT.format(question=question, gold=gold,
                                            pred=pred)
        raw = self.generate_fn(
            [{"role": "system",
              "content": "You are a careful binary judge for QA outputs."},
             {"role": "user", "content": prompt}], max_new_tokens=4)
        return parse_verdict(raw), raw


def make_desta_judge(model) -> LLMJudge:
    """Judge backed by a DeSTA25AudioModel's text-only generate path."""

    def generate_fn(messages, max_new_tokens=4):
        out = model.generate(messages, max_new_tokens=max_new_tokens,
                             do_sample=False)
        return out.text[0]

    return LLMJudge(generate_fn)
