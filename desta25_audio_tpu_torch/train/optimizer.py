"""Optimizer and learning-rate schedule (port of
``desta25_audio_tpu/train/optimizer.py``).

The JAX package chains optax's ``clip_by_global_norm(gradient_clip_val)``
and ``adafactor(learning_rate=schedule, multiply_by_parameter_scale=False,
clipping_threshold=1.0)``, wrapped in ``optax.MultiSteps`` for gradient
accumulation.  The port carries its own implementation of that exact rule
(optax is not a dependency of the port, and ``torch.optim.Adafactor``'s
beta-2 schedule, epsilon and update clipping differ):

- ``clip_by_global_norm``: g * max_norm / ||g|| when ||g|| >= max_norm;
- factored second moments (``scale_by_factored_rms``) on leaves whose two
  largest dims are >= 128 (``min_dim_size_to_factor``), a full one on the
  others; decay 1 - (count + 1)^-0.8, eps 1e-30 added to g^2;
- ``clip_by_block_rms(1.0)``: u / max(1, rms(u));
- the schedule's learning rate at ``count`` (linear warm-up from 0, so the
  first update has lr 0), optional decayed weights, then the minus sign;
- ``MultiSteps(k)``: a running mean of the mini-step gradients (optax's
  Welford form); every k-th mini-step the inner rule runs on it, else the
  update is zero and the inner state is kept.

Gradients, updates and parameters are flat ``{path: tensor}`` dicts
(:func:`flatten_tree`); the state is a dict of ints and such dicts, so
``torch.save`` writes it as it is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Flat = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    warmup_steps: int = 5000
    total_steps: int = 100_000
    schedule: str = "linear"  # "linear" | "constant" | "cosine"
    gradient_clip_val: float = 1.0
    accumulate_grad_batches: int = 1
    weight_decay: float = 0.0


def flatten_tree(tree: Any, prefix: str = "") -> Flat:
    """Nested dict of tensors -> {"a/b/c": tensor} (the leaves themselves,
    not copies), in insertion order."""
    if isinstance(tree, dict):
        out: Flat = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule, in f32 as optax computes it."""
    def f(count: int) -> float:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1.0) - c / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))
    return f


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (alpha 0, exponent 1) in f32."""
    def f(count: int) -> float:
        c = np.float32(min(count, steps))
        cos = np.float32(0.5) * (np.float32(1.0) + np.cos(
            np.float32(math.pi) * c / np.float32(steps)))
        return float(np.float32(init) * cos)
    return f


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Linear warm-up from 0 to ``lr`` over ``warmup_steps``, then linear
    decay to 0, cosine decay or constant, joined at ``warmup_steps`` as
    ``optax.join_schedules`` joins them (the decay sees count - boundary)."""
    warmup = _linear(0.0, cfg.lr, max(cfg.warmup_steps, 1))
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "linear":
        decay = _linear(cfg.lr, 0.0, decay_steps)
    elif cfg.schedule == "cosine":
        decay = _cosine(cfg.lr, decay_steps)
    else:
        decay = lambda count: float(np.float32(cfg.lr))  # noqa: E731

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return warmup(count)
        return decay(count - cfg.warmup_steps)
    return schedule


def factored_dims(shape, min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second-largest and the
    largest dim, when the second-largest is >= the threshold."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def global_norm(tree: Flat) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


class Adafactor:
    """``clip_by_global_norm`` then optax's ``adafactor`` with the JAX
    package's settings, as one transformation: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``."""

    def __init__(self, cfg: OptimizerConfig, decay_rate: float = 0.8,
                 eps: float = 1e-30, min_dim_size_to_factor: int = 128,
                 clipping_threshold: float = 1.0):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.decay_rate = decay_rate
        self.eps = eps
        self.min_dim = min_dim_size_to_factor
        self.clipping_threshold = clipping_threshold

    def init(self, params: Flat) -> Dict[str, Any]:
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            fd = factored_dims(tuple(p.shape), self.min_dim)
            if fd is None:
                v[k] = torch.zeros_like(p, memory_format=torch.contiguous_format)
            else:
                d1, d0 = fd
                shape = list(p.shape)
                v_row[k] = torch.zeros(shape[:d0] + shape[d0 + 1:],
                                       dtype=p.dtype, device=p.device)
                v_col[k] = torch.zeros(shape[:d1] + shape[d1 + 1:],
                                       dtype=p.dtype, device=p.device)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def update(self, grads: Flat, state: Dict[str, Any], params: Flat
               ) -> Tuple[Flat, Dict[str, Any]]:
        count = state["count"]
        max_norm = self.cfg.gradient_clip_val
        g_norm = global_norm(grads)
        if not bool(g_norm < max_norm):
            grads = {k: (g / g_norm.to(g.dtype)) * max_norm
                     for k, g in grads.items()}
        dr = 1.0 - np.float32(count + 1) ** np.float32(-self.decay_rate)
        dr = float(np.float32(dr))
        lr = self.schedule(count)
        v_row, v_col, v = (dict(state[k]) for k in ("v_row", "v_col", "v"))
        updates: Flat = {}
        for k, g in grads.items():
            fd = factored_dims(tuple(g.shape), self.min_dim)
            g_sq = torch.square(g) + self.eps
            if fd is not None:
                d1, d0 = fd
                v_row[k] = dr * v_row[k] + (1.0 - dr) * g_sq.mean(d0)
                v_col[k] = dr * v_col[k] + (1.0 - dr) * g_sq.mean(d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row[k].mean(reduced_d1, keepdim=True)
                row_factor = torch.pow(v_row[k] / row_col_mean, -0.5)
                col_factor = torch.pow(v_col[k], -0.5)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            else:
                v[k] = dr * v[k] + (1.0 - dr) * g_sq
                u = g * torch.pow(v[k], -0.5)
            rms = torch.sqrt(torch.mean(torch.square(u)))
            u = u / torch.clamp(rms / self.clipping_threshold, min=1.0)
            u = lr * u
            if self.cfg.weight_decay:
                u = u + self.cfg.weight_decay * params[k]
            updates[k] = -u
        return updates, {"count": count + 1, "v_row": v_row, "v_col": v_col,
                         "v": v}


class MultiSteps:
    """``optax.MultiSteps(inner, k)`` with the mean of the mini-step
    gradients."""

    def __init__(self, inner: Adafactor, k: int):
        self.inner = inner
        self.k = k

    def init(self, params: Flat) -> Dict[str, Any]:
        return {"mini_step": 0, "gradient_step": 0,
                "acc": {k: torch.zeros_like(p) for k, p in params.items()},
                "inner": self.inner.init(params)}

    def update(self, grads: Flat, state: Dict[str, Any], params: Flat
               ) -> Tuple[Flat, Dict[str, Any]]:
        n = state["mini_step"]
        div = torch.tensor(float(n + 1))
        acc = {k: a + (grads[k] - a) / div.to(a.device)
               for k, a in state["acc"].items()}
        if n != self.k - 1:
            return ({k: torch.zeros_like(g) for k, g in grads.items()},
                    {**state, "mini_step": n + 1, "acc": acc})
        updates, inner = self.inner.update(acc, state["inner"], params)
        return updates, {"mini_step": 0,
                         "gradient_step": state["gradient_step"] + 1,
                         "acc": {k: torch.zeros_like(a)
                                 for k, a in acc.items()},
                         "inner": inner}


def make_optimizer(cfg: OptimizerConfig):
    tx = Adafactor(cfg)
    if cfg.accumulate_grad_batches > 1:
        tx = MultiSteps(tx, cfg.accumulate_grad_batches)
    return tx


@torch.no_grad()
def apply_updates(params: Flat, updates: Flat) -> None:
    """params += updates, in place on the parameter tensors (which the
    model's param tree holds), outside autograd."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
