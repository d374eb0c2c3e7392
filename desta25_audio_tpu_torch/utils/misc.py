"""Small utilities (port of ``desta25_audio_tpu/utils/misc.py``: ``run``,
``resolve_filepath`` and ``get_unique_filepath``).

``resolve_filepath`` takes local paths only.  The JAX package downloads a
URL to a local cache; the port refuses one before any network attempt, and
its dataset and ``cli/evaluate.py`` resolve their paths here, so that the
refusal lives in one place.
"""

from __future__ import annotations

import os
import shlex
import subprocess


def run(cmd: str, check: bool = True) -> str:
    """Run a shell command, return stdout (desta/utils/utils.py)."""
    proc = subprocess.run(shlex.split(cmd), capture_output=True, text=True)
    if check and proc.returncode != 0:
        raise RuntimeError(
            f"command failed ({proc.returncode}): {cmd}\n{proc.stderr}")
    return proc.stdout


def resolve_filepath(path: str) -> str:
    """``path`` if it names an existing local file.  Raises
    FileNotFoundError where it does not, and NotImplementedError for an
    http(s) URL, without contacting its host."""
    if path.startswith(("http://", "https://")):
        raise NotImplementedError(
            f"{path}: remote manifests and audio are not supported by the "
            "port; copy them to local files")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def get_unique_filepath(path: str) -> str:
    """Return ``path`` or, if it exists, ``stem-1.ext``, ``stem-2.ext``, ..."""
    if not os.path.exists(path):
        return path
    stem, ext = os.path.splitext(path)
    i = 1
    while os.path.exists(f"{stem}-{i}{ext}"):
        i += 1
    return f"{stem}-{i}{ext}"
