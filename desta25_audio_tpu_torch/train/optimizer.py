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

A leaf of a lower precision (a bf16 ORCA stack) takes optax's dtypes: its
statistics and update are in its dtype, the decay's blend is computed in f32
and rounded once, the learning rate is rounded to the leaf's dtype before
it scales the update, and the global norm adds each leaf's sum of squares
rounded to that dtype.

Gradients, updates and parameters are flat ``{path: tensor}`` dicts
(:func:`flatten_tree`); the state is a dict of ints and such dicts, so
``torch.save`` writes it as it is.

Under ``fsdp`` a leaf may be a ``parallel/sharding.Shards`` (cut over a
mesh's data rows): its gradient, its unfactored second moment and its
MultiSteps mean are cut alike, a factored statistic is cut where it keeps
the cut dim and whole (on the first row's device) where it averaged that dim
away, and every quantity over the whole leaf or tree sums its parts: the
clip's global norm, the factored row and column means, ``row_col_mean`` and
the block RMS.  The rule's numbers are those of the whole leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.sharding import Shards

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


def unflatten_tree(flat: Flat) -> Dict[str, Any]:
    """:func:`flatten_tree` undone: {"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


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


def _ew(fn, *xs):
    """fn over tensors, and over :class:`Shards` part by part (a whole
    tensor meets each part on that part's device; it never holds the cut
    dim, so it broadcasts against the part as against the whole)."""
    sh = next((x for x in xs if isinstance(x, Shards)), None)
    if sh is None:
        return fn(*xs)
    out = []
    for i, p in enumerate(sh.parts):
        out.append(fn(*[x.parts[i] if isinstance(x, Shards)
                        else x.to(p.device) if isinstance(x, torch.Tensor)
                        else x for x in xs]))
    return Shards(out, sh.dim)


def _mean(x, dim: int, keepdim: bool = False):
    """``x.mean(dim)``; over a Shards' cut dim the parts' sums add in part
    order on the first part's device, whole."""
    if not isinstance(x, Shards):
        return x.mean(dim, keepdim=keepdim)
    if dim != x.dim:
        cut = x.dim if (keepdim or dim > x.dim) else x.dim - 1
        return Shards([p.mean(dim, keepdim=keepdim) for p in x.parts], cut)
    dev = x.parts[0].device
    tot = None
    for p in x.parts:
        s = p.sum(dim, keepdim=keepdim).to(dev)
        tot = s if tot is None else tot + s
    return tot / x.shape[dim]


def _unsqueeze(x, dim: int):
    if not isinstance(x, Shards):
        return x.unsqueeze(dim)
    return Shards([p.unsqueeze(dim) for p in x.parts],
                  x.dim + (dim <= x.dim))


def _sum_sq(x) -> torch.Tensor:
    """sum(x^2) over a tensor or every part of a Shards, as optax's
    ``global_norm`` takes it: the squares in x's dtype, summed in f32 and
    rounded to x's dtype (a bf16 leaf's sum is a bf16 number); returned in
    f32."""
    if not isinstance(x, Shards):
        tot = torch.sum(torch.square(x), dtype=torch.float32)
    else:
        dev = x.parts[0].device
        tot = sum(torch.sum(torch.square(p), dtype=torch.float32).to(dev)
                  for p in x.parts)
    return tot.to(x.dtype).float()


def _rms(u) -> torch.Tensor:
    if not isinstance(u, Shards):
        return torch.sqrt(torch.mean(torch.square(u)))
    dev = u.parts[0].device
    tot = sum(torch.sum(torch.square(p)).to(dev) for p in u.parts)
    return torch.sqrt(tot / u.numel())


def _as_dtype(x: np.float32, dtype: torch.dtype) -> float:
    """The f32 number ``x`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def zeros_like(x):
    return _ew(torch.zeros_like, x)


def _zeros_without(p, drop: int):
    """Zeros of p's shape without dim ``drop``: whole where ``drop`` is a
    Shards' cut dim, else cut as p is."""
    if isinstance(p, Shards) and drop != p.dim:
        return Shards([_zeros_without(q, drop) for q in p.parts],
                      p.dim - (drop < p.dim))
    shape = list(p.shape)
    return torch.zeros(shape[:drop] + shape[drop + 1:], dtype=p.dtype,
                       device=p.device)


def global_norm(tree: Flat) -> torch.Tensor:
    sums = [_sum_sq(g) for g in tree.values()]
    dev = sums[0].device
    return torch.sqrt(sum(s.to(dev) for s in sums))


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
                v[k] = _ew(lambda t: torch.zeros_like(
                    t, memory_format=torch.contiguous_format), p)
            else:
                d1, d0 = fd
                v_row[k] = _zeros_without(p, d0)
                v_col[k] = _zeros_without(p, d1)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def update(self, grads: Flat, state: Dict[str, Any], params: Flat
               ) -> Tuple[Flat, Dict[str, Any]]:
        count = state["count"]
        max_norm = self.cfg.gradient_clip_val
        g_norm = global_norm(grads)
        if not bool(g_norm < max_norm):
            grads = {k: _ew(lambda t, n: (t / n.to(t.dtype)) * max_norm,
                            g, g_norm) for k, g in grads.items()}
        dr = 1.0 - np.float32(count + 1) ** np.float32(-self.decay_rate)
        dr, dr1 = float(np.float32(dr)), float(np.float32(1) - np.float32(dr))
        lr = np.float32(self.schedule(count))
        thr = self.clipping_threshold
        v_row, v_col, v = (dict(state[k]) for k in ("v_row", "v_col", "v"))
        updates: Flat = {}

        def ema(old, new):
            # in f32, one rounding to the statistic's dtype (optax's
            # decay rate is an f32 array, which promotes a bf16 leaf's)
            return _ew(lambda a, b: (dr * a.float() + dr1 * b.float()
                                     ).to(a.dtype), old, new)

        for k, g in grads.items():
            fd = factored_dims(tuple(g.shape), self.min_dim)
            g_sq = _ew(lambda t: torch.square(t) + self.eps, g)
            if fd is not None:
                d1, d0 = fd
                v_row[k] = ema(v_row[k], _mean(g_sq, d0))
                v_col[k] = ema(v_col[k], _mean(g_sq, d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = _mean(v_row[k], reduced_d1, keepdim=True)
                row_factor = _ew(lambda a, b: torch.pow(a / b, -0.5),
                                 v_row[k], row_col_mean)
                col_factor = _ew(lambda a: torch.pow(a, -0.5), v_col[k])
                u = _ew(lambda a, b, c: a * b * c, g,
                        _unsqueeze(row_factor, d0),
                        _unsqueeze(col_factor, d1))
            else:
                v[k] = ema(v[k], g_sq)
                u = _ew(lambda a, b: a * torch.pow(b, -0.5), g, v[k])
            # two steps: one fused expression holds a third leaf-sized
            # temporary at once
            u = _ew(lambda a, r: a / torch.clamp(r / thr, min=1.0), u,
                    _rms(u))
            # the learning rate rounded to the leaf's dtype first, as
            # optax's scale_by_learning_rate casts it
            u = _ew(lambda a: _as_dtype(lr, a.dtype) * a, u)
            if self.cfg.weight_decay:
                u = _ew(lambda a, w: a + self.cfg.weight_decay * w, u,
                        params[k])
            updates[k] = _ew(torch.neg, u)
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
                "acc": {k: zeros_like(p) for k, p in params.items()},
                "inner": self.inner.init(params)}

    def update(self, grads: Flat, state: Dict[str, Any], params: Flat
               ) -> Tuple[Flat, Dict[str, Any]]:
        n = state["mini_step"]
        div = torch.tensor(float(n + 1))
        acc = {k: _ew(lambda a, g: a + (g - a) / div.to(a.device), a,
                      grads[k])
               for k, a in state["acc"].items()}
        if n != self.k - 1:
            return ({k: zeros_like(g) for k, g in grads.items()},
                    {**state, "mini_step": n + 1, "acc": acc})
        updates, inner = self.inner.update(acc, state["inner"], params)
        return updates, {"mini_step": 0,
                         "gradient_step": state["gradient_step"] + 1,
                         "acc": {k: zeros_like(a) for k, a in acc.items()},
                         "inner": inner}


def make_optimizer(cfg: OptimizerConfig):
    tx = Adafactor(cfg)
    if cfg.accumulate_grad_batches > 1:
        tx = MultiSteps(tx, cfg.accumulate_grad_batches)
    return tx


@torch.no_grad()
def apply_updates(params: Flat, updates: Flat) -> None:
    """params += updates, in place on the parameter tensors (which the
    model's param tree holds; a Shards part by part), outside autograd."""
    for k, p in params.items():
        _ew(lambda a, u: a.add_(u.to(a.dtype)), p, updates[k])
