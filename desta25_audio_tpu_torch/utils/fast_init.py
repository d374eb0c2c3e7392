"""Fast random parameter trees for benchmarks and dry runs (port of
``desta25_audio_tpu/utils/fast_init.py``).

``random_tree_like`` runs the real init on the ``meta`` device (the
counterpart of ``jax.eval_shape``: shapes and dtypes, nothing allocated),
then fills each leaf on the target device with one draw: weights that only
need plausible magnitudes (benchmarks, memory checks), built without a
transient copy of the tree in another dtype.  The draws come from a
``torch.Generator``, so they are not JAX's bits; their distributions are.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def random_tree_like(init_fn: Callable[[torch.device, torch.Generator], Any],
                     generator: torch.Generator, device,
                     scale: float = 0.02):
    """``init_fn(device, generator) -> param tree`` is called once on the
    meta device; returns a tree of its structure on ``device`` (which
    ``generator`` must be on), leaf by leaf in the tree's order:

    - a float leaf: N(0, 1) * ``scale`` drawn in f32, cast to its dtype;
    - an int8 leaf: integers uniform in [-127, 127];
    - any other leaf: zeros."""
    shapes = init_fn(torch.device("meta"), torch.Generator())

    def fill(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.dtype.is_floating_point:
            x = torch.empty(leaf.shape, dtype=torch.float32, device=device)
            x.normal_(generator=generator).mul_(scale)
            return x.to(leaf.dtype)
        if leaf.dtype == torch.int8:
            return torch.randint(-127, 128, leaf.shape, dtype=torch.int8,
                                 device=device, generator=generator)
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)

    return _map(fill, shapes)
