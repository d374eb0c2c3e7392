"""Evaluation metrics (re-homed from ``desta25_audio_tpu/eval/metrics.py``).

``ConsecutiveWordsAccuracyMetric`` reproduces desta/utils/metrics.py:3-32:
normalize both strings (whisper EnglishTextNormalizer-style basic
normalization), correct iff the label's word sequence appears contiguously
in the prediction.  The normalizer is implemented in-repo (the
``whisper_normalizer`` pip package is tiny and pure-python; its
BasicTextNormalizer behavior is: lowercase, strip text in brackets/parens,
drop punctuation/symbol/mark characters, collapse whitespace).
"""

from __future__ import annotations

import re
import unicodedata
from typing import List


def basic_normalize(text: str, remove_diacritics: bool = False) -> str:
    text = text.lower()
    text = re.sub(r"[<\[][^>\]]*[>\]]", "", text)   # words between brackets
    text = re.sub(r"\(([^)]+?)\)", "", text)        # words between parens
    norm_form = "NFKD" if remove_diacritics else "NFKC"
    text = unicodedata.normalize(norm_form, text)
    out = []
    for c in text:
        cat = unicodedata.category(c)
        if cat.startswith("M"):
            continue
        if cat.startswith(("P", "S")):
            out.append(" ")
        else:
            out.append(c)
    text = "".join(out)
    return re.sub(r"\s+", " ", text).strip()


class ConsecutiveWordsAccuracyMetric:
    """Correct iff the normalized label word sequence occurs contiguously in
    the normalized prediction."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    @staticmethod
    def is_correct(pred: str, label: str) -> bool:
        pred_words = basic_normalize(pred).split()
        label_words = basic_normalize(label).split()
        if not label_words:
            return True
        n, m = len(pred_words), len(label_words)
        for i in range(n - m + 1):
            if pred_words[i:i + m] == label_words:
                return True
        return False

    def update(self, pred: str, label: str) -> bool:
        ok = self.is_correct(pred, label)
        self.correct += int(ok)
        self.total += 1
        return ok

    def compute(self) -> float:
        return self.correct / self.total if self.total else 0.0

    def reset(self):
        self.correct = 0
        self.total = 0
