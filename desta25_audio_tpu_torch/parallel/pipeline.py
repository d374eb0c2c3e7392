"""GPipe pipelining of the decoder layer stack over a mesh's "pipe" axis
(counterpart of ``desta25_audio_tpu/parallel/pipeline.py:69-163``).

A pipe mesh (``parallel/mesh.make_mesh(n_pipe=P)``) cuts the LLM's stacked
layers into P stages (``parallel/sharding.pipe_stages``): stage s holds
layers ``s*L/P .. (s+1)*L/P - 1`` on its ``1 x n_model`` group, cut over
"model" there as without a pipe.  :func:`pipeline_decoder_hidden` runs one
data row's batch through them as the JAX package's schedule does: the rows
split into M microbatches, and over M + P - 1 ticks stage s runs microbatch
``t - s`` at tick t, its output moving one hop down the pipe to the next
stage's first device.  The JAX body computes its bubble ticks on clamped
garbage and discards them; here they are not run, which changes no number.
The last stage's outputs come back to the data row's first device in
microbatch order (where the JAX package psum-broadcasts them over "pipe"),
and the loss reads them there.  Autograd differentiates through the
schedule; under ``remat`` each (stage, microbatch, layer) runs under a
non-reentrant ``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps the
JAX stage's layer step.

On CUDA each stage issues its work on a stream of its own (its stage
mesh's first rank's, ``Mesh.streams()``), so stages on one card (virtual
ranks) can overlap.  A tensor handed from one stage's stream to another's
(:class:`_Hop`) makes the receiver wait for the sender and tells the
allocator about the use on the receiving stream (``record_stream``); its
gradient goes back alike.  Between virtual ranks of one card the hop copies
nothing.

The JAX package runs the pipeline for the training forward only, without a
cache, LoRA or a hook, and only when ``pipeline_microbatches`` is set on a
pipe mesh (``llm.py:458-473``); ``models/llm.llm_apply`` keeps that split
and otherwise runs the layers through the stages in order.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import current_mesh
from .sharding import PipeStage

__all__ = ["pipeline_enabled", "pipeline_decoder_hidden"]


def pipeline_enabled() -> bool:
    """True under a mesh with a "pipe" axis of more than one stage (the
    JAX package's ``pipeline_enabled``, ``parallel/pipeline.py:50``)."""
    mesh = current_mesh()
    return mesh is not None and mesh.n_pipe > 1


def _stream(device: torch.device, stage: Optional[PipeStage] = None):
    """A stage's stream (None: the caller's, ``device``'s current one); None
    on the CPU."""
    if device.type != "cuda":
        return None
    if stage is None:
        return torch.cuda.current_stream(device)
    return stage.mesh.streams()[0][0]


def _on(stream):
    return contextlib.nullcontext() if stream is None else \
        torch.cuda.stream(stream)


class _Hop(torch.autograd.Function):
    """``x`` handed from stream ``src`` to stream ``dst`` on ``device``:
    ``dst`` waits for ``src``; a copy to another card runs with both streams
    current, and on the same card (no copy) ``x`` is recorded as used on
    ``dst``.  The gradient goes back the same way."""

    @staticmethod
    def forward(ctx, x, device, src, dst):
        ctx.back = (x.device, src, dst)
        with torch.cuda.stream(src), torch.cuda.stream(dst):
            dst.wait_stream(src)
            y = x.to(device)
        if y is not x:
            return y
        x.record_stream(dst)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        device, src, dst = ctx.back
        with torch.cuda.stream(dst), torch.cuda.stream(src):
            src.wait_stream(dst)
            gx = g.to(device)
        if gx is g:
            g.record_stream(src)
        return gx, None, None, None


def _hop(x: torch.Tensor, device: torch.device, src, dst) -> torch.Tensor:
    if src is None or dst is None:
        return x.to(device)
    with torch.cuda.stream(dst):
        return _Hop.apply(x, device, src, dst)


def pipeline_decoder_hidden(stages: List[PipeStage], layer: Callable,
                            x: torch.Tensor, attention_mask: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor, *,
                            n_micro: int, remat: bool = True) -> torch.Tensor:
    """One data row's decoder stack, pipelined over its ``stages`` -> the
    hidden before the final norm [B, T, D] on x's device (the row's first).

    ``layer(tree, li, xs, cos, sin, attention_mask, parts_remat=)`` runs
    layer li of a stage's tree on the residual's slices ``xs``
    (``models/llm._decoder_layer``, bound by ``llm_apply`` to the config,
    ``w8a8`` and the int8 row regime: a microbatch's products read theirs
    on the rows of the global microbatch, as the JAX package's body's do).
    x [B, T, D] embeddings; attention_mask [B, T] 1/0 (left padding); cos /
    sin the RoPE tables [B, T, ...].  Each of the M = ``n_micro``
    microbatches of ``B / M`` rows carries its own rows of the mask and
    tables; B % M raises ValueError, as in the JAX package.  ``remat``: a
    checkpoint per (stage, microbatch, layer) (a stage whose group spans
    cards checkpoints each device's share alone, as ``llm_apply`` does).
    A checkpoint's recompute runs in the backward on the stream its
    forward's nodes were recorded on: the stage's.
    """
    B = x.shape[0]
    M = int(n_micro)
    if M < 1 or B % M:
        raise ValueError(f"batch {B} not divisible by n_micro {M}")
    Bm, P = B // M, len(stages)
    home = x.device
    ambient = _stream(home)
    streams = [_stream(st.device, st) for st in stages]
    parts = [remat and len(st.mesh.all_devices()) > 1 for st in stages]
    # each stage's copy of the tables and mask; stage 0's of x
    tables = []
    for st, sm in zip(stages, streams):
        tables.append(tuple(_hop(t, st.device, ambient, sm)
                            for t in (cos, sin, attention_mask)))
    x0 = _hop(x, stages[0].device, ambient, streams[0])

    def rows(t, m):
        return t[m * Bm:(m + 1) * Bm]

    acts = {}
    for tick in range(M + P - 1):
        for s in range(P):
            m = tick - s
            if not 0 <= m < M:
                continue
            st, sm = stages[s], streams[s]
            if s > 0:
                h = _hop(acts.pop((s - 1, m)), st.device, streams[s - 1], sm)
            with _on(sm):
                if s == 0:
                    h = rows(x0, m)
                co, si, am = (rows(t, m) for t in tables[s])
                for li in range(st.hi - st.lo):
                    args = (st.tree, li, (h,), co, si, am, parts[s])
                    h = (checkpoint(layer, *args, use_reentrant=False)
                         if remat and not parts[s] else layer(*args))[0]
            acts[s, m] = h
    outs = [_hop(acts.pop((P - 1, m)), home, streams[-1], ambient)
            for m in range(M)]
    return torch.cat(outs) if M > 1 else outs[0]
