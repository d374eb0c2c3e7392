"""Long-audio chunking (counterpart of ``desta25_audio_tpu/audio/chunking.py``;
an extension beyond the reference, which truncates audio at Whisper's 30 s
window).

A clip longer than the window is split into 30 s windows with a 1 s overlap,
spliced as consecutive ``<|AUDIO|>`` blocks of the same message
(``DeSTA25AudioModel.generate(..., auto_chunk_long_audio=True)``).
"""

from __future__ import annotations

from typing import List

import numpy as np

WINDOW = 30 * 16000
OVERLAP = 16000  # 1 s


def chunk_audio(samples: np.ndarray, window: int = WINDOW,
                overlap: int = OVERLAP) -> List[np.ndarray]:
    """Split a 16 kHz clip into windows of at most ``window`` samples that
    overlap by ``overlap``; a tail shorter than the overlap is dropped.  A
    clip of one window or less is returned whole, as the only chunk."""
    n = len(samples)
    if n <= window:
        return [samples]
    chunks: List[np.ndarray] = []
    step = window - overlap
    for start in range(0, n, step):
        chunk = samples[start:start + window]
        if len(chunk) >= overlap or not chunks:
            chunks.append(chunk)
    return chunks


def expand_message_for_chunks(content: str, audio_locator: str,
                              n_chunks_per_audio: List[int]) -> str:
    """Replace the i-th locator with ``n_chunks_per_audio[i]`` locators
    joined by spaces (one per chunk)."""
    parts = content.split(audio_locator)
    if len(parts) != len(n_chunks_per_audio) + 1:
        raise ValueError(f"{len(parts) - 1} locators in the message, "
                         f"{len(n_chunks_per_audio)} chunk counts")
    out = parts[0]
    for n, part in zip(n_chunks_per_audio, parts[1:]):
        out += " ".join([audio_locator] * n) + part
    return out
