"""The decode step as one CUDA graph per card (counterpart of the jitted body
of the JAX package's decode ``lax.while_loop``,
``desta25_audio_tpu/generate/decode.py:228-244``: one dispatch a step and no
host work in it).

``llm_generate`` builds one :class:`DecodeGraph` per call where the fused
decode step takes the request: K8, K8-int8, and K8i with its injection
inside, on one card; K9, the per-layer pair, with ORCA's injection in
PyTorch between its layers (the opt-in ``DESTA_FUSED_PERLAYER`` on the f32
stack); under a mesh (the LLM cut by
``parallel/sharding.apply_llm_sharding``) K10, the tensor-parallel step,
with K8i inside too.  The steps have one interface, ``fill`` / ``run`` /
``check``.  On one card the step is :class:`CardStep` (the fused layers,
the final norm, the head: ``models/llm.decode_step`` past its embedding
gather) or :class:`PerLayerStep` (K9's layers with the hook, then the
same norm and head) on static device inputs: the tokens' embeddings [B,
1, D], positions and cache indices, which :meth:`DecodeGraph.step`
gathers and fills before each step, and the call's mask, cache and
injection spec or hook (whose audio K/V stay put), which stay put for the
call; the step's RoPE tables and int32 cache indices are computed inside
the step from those buffers.  Under a mesh it is
``ops/fused_decode_mesh.MeshStep``: the same inputs kept on every card, each
rank's step built once per call, the all-reduce's epochs on the device
(the step fills each group's base word before it, so a replay never
reuses an epoch), the norm and head on each data row's first rank.

With ``capture`` on CUDA devices the first step runs eagerly on one side
stream per card (:class:`CardGraphs`), which finishes every first-use host
work (the kernels' shared-memory raise, the skinny GEMM's weight maps, the
SM count, cuBLAS's handle and workspace, the mesh's rank streams); the
second step is captured on those streams (the capture records, it does not
run) and then replayed, as is every later step.  One card's step is one
graph launch where the eager step makes about 7 launches a layer from
Python; the kernels of ``csrc/`` chain inside it by programmatic dependent
launch.  Under a mesh each card has its own graph, captured card by card
from the same step launching that card's ranks alone: a rank's kernels,
its stream forked from its card's capture stream and joined back, land in
its card's graph, so virtual ranks of one card share one graph of p
branches and ranks on distinct cards have one graph each; the ranks meet
only in their all-reduce kernels, through flags in device memory, as on
the eager path.  A step is then one graph launch a
card.  Without ``capture`` (the CPU, or ``llm_generate(decode_graph=False)``)
every step runs eagerly through the same function on the same buffers.

Launch counts: what the capture counted is taken back out of the counters
and added again at every replay, with one ``decode_graph`` launch a graph
launch, so that ``_build.launch_counts()`` and ``kernel_counts()`` read as
on the eager path.  Pointers and TMA maps enter the graph by value: the
weights, the cache, the mask, the injection's audio K/V and ``on`` flags
and the static inputs must not move while the graph lives.  For
``llm_generate`` that is one call, whose rows all write at one cache index
a step; the serving engine (``serve/engine.py``) keeps one graph (with
speculation a second, the verify step at ``kd``) for its whole life over
its own fixed buffers ([L, n_slots, t_max] cache, [n_slots,
t_max] mask, ORCA's Ta-padded audio K/V and per-slot ``on``), each row
writing at its own cache index (a [B] int32 device tensor), and changes
slots by writing into those buffers in place, so it captures once
(``captures``) however its slots come and go.  :meth:`DecodeGraph.close`
frees the graphs and their memory pools.  A failed capture or replay
raises; nothing falls back to the eager step.
Under a mesh the all-reduce's error words are read once, by
:meth:`DecodeGraph.check` at the end of the call (the serving engine copies
them to the host after each tick, :meth:`DecodeGraph.error_words`, and
reads them when it consumes the tick).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Sequence

import torch

from ..config import LLMConfig
from ..models import llm as tllm
from ..ops import _build
from ..ops.core import rms_norm
from ..ops.fused_decode import fused_decode_layers, fused_verify_layers
from ..ops.fused_decode_mesh import MeshStep
from ..ops.fused_decode_tp import step_scratch
from ..parallel.sharding import ShardedLLM


class CardGraphs:
    """One side stream and, once captured, one CUDA graph per card of
    ``devices``, for a step ``fn(only=None)`` that launches work on several
    cards (each card's launches on its current stream, or on streams forked
    from it and joined back) and, given ``only``, launches that card's work
    alone.  The cards are captured one after the other (a capture open on
    one card refuses the next card's capture to begin in the same
    thread)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self.streams = {d: torch.cuda.Stream(d) for d in self.devices}
        self.graphs: Dict[torch.device, torch.cuda.CUDAGraph] = {}

    @contextlib.contextmanager
    def _on_streams(self):
        """Every card's side stream current, ordered after and before the
        callers' streams."""
        callers = {d: torch.cuda.current_stream(d) for d in self.devices}
        for d, s in self.streams.items():
            s.wait_stream(callers[d])
        with contextlib.ExitStack() as stack:
            for s in self.streams.values():
                stack.enter_context(torch.cuda.stream(s))
            yield
        for d, s in self.streams.items():
            callers[d].wait_stream(s)

    def run(self, fn: Callable):
        """fn() eagerly on the side streams, every card's work."""
        with self._on_streams():
            return fn(only=None)

    def capture(self, fn: Callable):
        """Capture fn(only=card) into each card's graph (nothing runs);
        returns what the last call returned (a step keeps its outputs, the
        graphs' static buffers, where every call finds them)."""
        graphs, out = {}, None
        with self._on_streams():
            for d in self.devices:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.device(d):
                    # the capture's own stream context (not torch.cuda.graph,
                    # which would synchronise the card and empty the
                    # allocator's cache)
                    g.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = fn(only=d)
                    except BaseException:
                        try:
                            g.capture_end()
                        except RuntimeError:
                            pass  # already invalid: report its cause
                        raise
                    g.capture_end()
                graphs[d] = g
        self.graphs = graphs
        return out

    def replay(self) -> None:
        """Launch every card's graph on its current stream."""
        for d, g in self.graphs.items():
            with torch.cuda.device(d):
                g.replay()
            _build.count_launch("decode_graph")

    def reset(self) -> None:
        for g in self.graphs.values():
            g.reset()
        self.graphs = {}


class CardStep:
    """The one-card decode (``kd`` = 1) or verify (``kd`` > 1) step with
    :class:`ops.fused_decode_mesh.MeshStep`'s interface: static embeddings
    [B, kd, D], positions [B, kd] and cache indices [B] on the mask's
    device, which :meth:`fill` writes; :meth:`run` is
    ``ops/fused_decode.fused_decode_layers`` (K8, K8-int8, K8i) or, at kd >
    1, ``fused_verify_layers`` (K8v, with K8i inside) on them and ``head``
    on its hidden, the body of ``models/llm.decode_step``."""

    def __init__(self, params, cfg: LLMConfig, mask: torch.Tensor, cache,
                 inject, kd: int = 1):
        B, dev = mask.shape[0], mask.device
        self.params, self.cfg, self.mask, self.cache = params, cfg, mask, cache
        self.inject = inject
        self.cards = [dev]
        self.x = torch.zeros(B, kd, cfg.hidden_size,
                             dtype=params["embed"].dtype, device=dev)
        self.pos = torch.zeros(B, kd, dtype=torch.long, device=dev)
        self.ci = torch.zeros(B, dtype=torch.int32, device=dev)
        self.layers = fused_decode_layers if kd == 1 else fused_verify_layers

    def fill(self, x: torch.Tensor, pos: torch.Tensor, ci) -> None:
        """ci: every row's cache write position (an int) or each row's (a
        [B] int32 tensor on the device)."""
        self.x.copy_(x)
        self.pos.copy_(pos)
        if torch.is_tensor(ci):
            self.ci.copy_(ci)
        else:
            self.ci.fill_(ci)

    def run(self, head, only=None):
        hidden, _ = self.layers(self.params, self.cfg, self.x, self.mask,
                                self.pos, self.cache, self.ci,
                                inject=self.inject)
        return [head(self.params, hidden)]

    def check(self) -> None:
        pass

    def error_words(self):
        return []


class PerLayerStep(CardStep):
    """K9's decode step with :class:`CardStep`'s interface and buffers:
    :meth:`run` is ``ops/fused_decode_tp.fused_decode_layers_perlayer``
    with the call's ``extra_layer_fn`` between layers, on the launches'
    scratch allocated once here, then ``head`` on its hidden (the norm and
    head of ``models/llm.llm_apply``'s per-layer branch)."""

    def __init__(self, params, cfg: LLMConfig, mask: torch.Tensor, cache,
                 extra_layer_fn):
        super().__init__(params, cfg, mask, cache, None)
        self.extra_layer_fn = extra_layer_fn
        self.scratch = step_scratch(cfg, mask.shape[0], mask.device)

    def run(self, head, only=None):
        hidden, _ = tllm.fused_decode_layers_perlayer(
            self.params, self.cfg, self.x, self.mask, self.pos, self.cache,
            self.ci, extra_layer_fn=self.extra_layer_fn,
            scratch=self.scratch)
        return [head(self.params, hidden)]


class DecodeGraph:
    """The decode steps of one ``llm_generate`` call over fixed buffers:
    ``mask`` [B, S] int32 and ``cache`` are the call's (written in place by
    the caller and by the steps; under a mesh the ShardedCache),
    ``fused_injection`` the in-kernel ORCA spec or None, ``extra_layer_fn``
    the per-layer hook of K9's step or None.  The step is a
    :class:`CardStep`, with a hook a :class:`PerLayerStep`, or, for an LLM
    cut for a mesh, a ``MeshStep``; ``kd`` > 1 (without a hook) makes it
    the verify step of ``kd`` tokens a row (K8v, K10's verify).
    :meth:`step` returns the step's f32 logits [B, V] (at kd > 1 [B, kd,
    V]) on the mask's device; with ``capture`` they are the graph's static
    buffer, overwritten by the next step."""

    def __init__(self, params, cfg: LLMConfig, mask: torch.Tensor,
                 cache, fused_injection, capture: bool,
                 extra_layer_fn=None, kd: int = 1):
        self.params, self.cfg, self.mask, self.kd = params, cfg, mask, kd
        if extra_layer_fn is not None:
            self.stepper = PerLayerStep(params, cfg, mask, cache,
                                        extra_layer_fn)
        else:
            self.stepper = (MeshStep if isinstance(params, ShardedLLM)
                            else CardStep)(params, cfg, mask, cache,
                                           fused_injection, kd=kd)
        self.capture = capture and mask.device.type == "cuda"
        self.cards = CardGraphs(self.stepper.cards) if self.capture else None
        self.warm = False
        self.logits = None
        self.counts = None
        self.capture_ms = 0.0
        self.captures = 0

    def _head(self, tree, hidden):
        lg = tllm.head_logits(tree, rms_norm(tree["norm"], hidden,
                                             self.cfg.rms_norm_eps))
        return lg[:, 0] if self.kd == 1 else lg

    def _run(self, only=None):
        return self.stepper.run(self._head, only)

    def _logits(self, out) -> torch.Tensor:
        """The step's logits on the mask's device (a mesh's data rows
        gathered there, outside any graph)."""
        if len(out) == 1:
            return out[0]
        return torch.cat([o.to(self.mask.device) for o in out])

    def step(self, cur: torch.Tensor, pos: torch.Tensor,
             write_idx) -> torch.Tensor:
        """One decode step: tokens ``cur`` [B] at RoPE positions ``pos``
        [B] (at kd > 1 [B, kd] each: a row's last token and its drafts),
        the k/v written from cache position ``write_idx`` on: an int for
        every row, or a [B] int32 device tensor, a position a row (a
        position past the cache is not written)."""
        if self.kd == 1:
            cur, pos = cur[:, None], pos[:, None]
        self.stepper.fill(tllm.embed_tokens(self.params, cur), pos,
                          write_idx)
        if not self.capture:
            return self._logits(self._run())
        if not self.warm:
            self.warm = True
            out = self.cards.run(self._run)
            for o in out:
                # allocated on a side stream, read on the caller's
                o.record_stream(torch.cuda.current_stream(o.device))
            return self._logits(out)
        if not self.cards.graphs:
            self._capture()
        self.cards.replay()
        _build.add_counts(self.counts)
        return self._logits(self.logits)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = _build.count_snapshot()
        self.logits = self.cards.capture(self._run)
        self.counts = _build.take_counts(before)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.captures += 1

    def check(self) -> None:
        """Under a mesh, raise RuntimeError if an all-reduce of the call's
        steps timed out (reads the error words: one host sync)."""
        self.stepper.check()

    def error_words(self):
        """Under a mesh, the all-reduce's error words (int32 device tensors,
        nonzero after a timed-out round), for a caller that reads them
        without a sync of its own; none on one card."""
        return self.stepper.error_words()

    def close(self) -> None:
        """Free the graphs and their memory pools (the static logits with
        them)."""
        if self.cards is not None:
            self.cards.reset()
        self.logits = None
