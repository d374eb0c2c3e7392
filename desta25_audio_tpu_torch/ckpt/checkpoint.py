"""Train-state checkpoints: trainable params, optimizer state and step
(port of ``desta25_audio_tpu/ckpt/checkpoint.py:30-80`` in the port's own
format).

- ``<exp_dir>/checkpoint-<step>/``: with a config, ``config.json``, the
  trainable params as the reference-format ``model.safetensors``
  (``ckpt/desta_io.py``; the directory loads with ``from_pretrained``, in
  the JAX package and in the reference) and ``state.pt``, one
  ``torch.save`` of ``{"opt_state", "step"}``; without a config
  ``state.pt`` also holds ``"trainable"``.  The trainable params are
  written once (an ORCA flagship's f32 stack is ~9 GB); the frozen towers
  are never written;
- ``<exp_dir>/checkpoint-latest`` is a symlink to the newest one, for
  resume;
- only the newest ``keep`` checkpoints are kept.

Under a mesh the trainable leaves and their optimizer state may be cut over
the data rows (``parallel/sharding.Shards``): a save gathers every shard to
its whole leaf, so a checkpoint does not depend on the layout, and only the
main process writes; a restore cuts the values again for the template's
layout, whatever mesh (or none) resumes.

Orbax checkpoints of the JAX package are not read or written.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from typing import Any, Dict, Tuple

import torch

from ..parallel.distributed import is_main_process
from ..parallel.sharding import Shards

logger = logging.getLogger(__name__)


def _to_cpu(tree: Any) -> Any:
    """Whole CPU tensors of a tree (shards gathered)."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return tree.gather("cpu")
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _lay_out(template: Any, loaded: Any) -> Any:
    """``loaded`` (whole tensors) in the template's layout: a tensor on its
    device, a Shards cut alike; other values as loaded."""
    if isinstance(template, dict):
        return {k: _lay_out(template[k], v) if k in template else v
                for k, v in loaded.items()}
    if isinstance(template, Shards):
        n = len(template.parts)
        return Shards([c.to(p.device).contiguous() for c, p in zip(
            torch.chunk(loaded, n, template.dim), template.parts)],
            template.dim)
    if isinstance(template, torch.Tensor):
        return loaded.to(template.device)
    return loaded


def save_train_state(exp_dir: str, step: int, trainable: Dict[str, Any],
                     opt_state: Any, config=None, keep: int = 3) -> str:
    """Write ``checkpoint-<step>`` (module docstring) on the main process;
    the others return its path without writing."""
    path = os.path.abspath(os.path.join(exp_dir, f"checkpoint-{step}"))
    state = os.path.join(path, "state.pt")
    if not is_main_process():
        return path
    if os.path.exists(state):
        logger.info("checkpoint-%d already exists; skipping save", step)
        return path
    os.makedirs(path, exist_ok=True)
    out = {"opt_state": _to_cpu(opt_state), "step": int(step)}
    if config is not None:
        from .desta_io import save_trainable_safetensors
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(config.to_json())
        save_trainable_safetensors(_to_cpu(trainable), config,
                                   os.path.join(path, "model.safetensors"))
    else:
        out["trainable"] = _to_cpu(trainable)
    tmp = state + ".tmp"
    torch.save(out, tmp)      # last: its presence marks a whole checkpoint
    os.replace(tmp, state)
    latest = os.path.join(exp_dir, "checkpoint-latest")
    if os.path.islink(latest) or os.path.exists(latest):
        os.unlink(latest)
    os.symlink(path, latest)
    _gc_checkpoints(exp_dir, keep)
    logger.info("saved checkpoint-%d", step)
    return path


def _gc_checkpoints(exp_dir: str, keep: int) -> None:
    ckpts = []
    for name in os.listdir(exp_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m:
            ckpts.append((int(m.group(1)), name))
    for _, name in sorted(ckpts)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(exp_dir, name), ignore_errors=True)


def _copy_into(template: Any, loaded: Any, what: str) -> None:
    if isinstance(template, dict):
        if set(template) != set(loaded):
            raise ValueError(f"checkpoint {what}: keys {sorted(loaded)} != "
                             f"{sorted(template)}")
        for k in template:
            _copy_into(template[k], loaded[k], f"{what}/{k}")
        return
    if template.shape != loaded.shape:
        raise ValueError(f"checkpoint {what}: shape {tuple(loaded.shape)} != "
                         f"{tuple(template.shape)}")
    with torch.no_grad():
        if isinstance(template, Shards):
            for p, c in zip(template.parts, torch.chunk(
                    loaded, len(template.parts), template.dim)):
                p.copy_(c)
        else:
            template.copy_(loaded)


def restore_train_state(path: str, trainable_template: Dict[str, Any],
                        opt_state_template: Any
                        ) -> Tuple[Dict[str, Any], Any, int]:
    """path: a ``checkpoint-*`` dir, or an exp_dir (its
    ``checkpoint-latest``).  The trainable values are copied into the
    template's tensors (which keep their device and ``requires_grad``; a
    Shards template gets its slices); the optimizer state takes the
    template's layout."""
    if not os.path.basename(os.path.normpath(path)).startswith("checkpoint-"):
        path = os.path.join(path, "checkpoint-latest")
    path = os.path.realpath(path)
    restored = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                          weights_only=True)
    loaded = restored.get("trainable")
    if loaded is None:
        from ..config import DeSTA25Config
        from .desta_io import load_trainable_safetensors
        with open(os.path.join(path, "config.json")) as f:
            config = DeSTA25Config.from_json(f.read())
        loaded = load_trainable_safetensors(
            trainable_template, config,
            os.path.join(path, "model.safetensors"))
    _copy_into(trainable_template, loaded, "trainable")
    opt_state = restored["opt_state"]
    if set(opt_state) != set(opt_state_template):
        raise ValueError(f"checkpoint opt_state: keys {sorted(opt_state)} "
                         f"!= {sorted(opt_state_template)}")
    return (trainable_template, _lay_out(opt_state_template, opt_state),
            int(restored["step"]))
