"""The decode step as one CUDA graph (counterpart of the jitted body of the
JAX package's decode ``lax.while_loop``,
``desta25_audio_tpu/generate/decode.py:228-244``: one dispatch a step and no
host work in it).

``llm_generate`` builds one :class:`DecodeGraph` per call where the fused
decode step takes the request (K8, K8-int8, and K8i with its injection
inside; not under a mesh).  The step is ``models/llm.decode_step``
(embedding gather, the fused layers, the final norm, the head) on static
device inputs: ids, positions and cache indices [B], which
:meth:`DecodeGraph.step` fills before each step, and the call's mask,
cache and injection spec, which stay put for the call.

With ``capture`` on a CUDA device the first step runs eagerly on a side
stream, which finishes every first-use host work (the kernels'
shared-memory raise, the skinny GEMM's weight maps, the SM count, cuBLAS's
handle and workspace); the second step is captured on that stream (the
capture records, it does not run) and then replayed, as is every later
step.  A replay is one graph launch where the eager step makes about 7
launches a layer from Python; the kernels of ``csrc/`` chain inside it by
programmatic dependent launch.  Without ``capture`` (the CPU, or
``llm_generate(decode_graph=False)``) every step runs eagerly through the
same function on the same buffers.

Launch counts: what the capture counted is taken back out of the counters
and added again at every replay, with one ``decode_graph`` launch a
replay, so that ``_build.launch_counts()`` and ``kernel_counts()`` read as
on the eager path.  Pointers and TMA maps enter the graph by value: the
weights, the cache, the mask, the injection's audio K/V and the static
inputs must not move while the graph lives, which is one ``llm_generate``
call; :meth:`DecodeGraph.close` frees the graph and its memory pool.  A
failed capture or replay raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import time

import torch

from ..config import LLMConfig
from ..models import llm as tllm
from ..ops import _build
from ..ops.fused_decode import KVCache


class DecodeGraph:
    """The decode steps of one ``llm_generate`` call over fixed buffers:
    ``mask`` [B, S] int32 and ``cache`` are the call's (written in place by
    the caller and by the steps), ``fused_injection`` the in-kernel ORCA
    spec or None.  :meth:`step` returns the step's f32 logits [B, V]; with
    ``capture`` they are the graph's static buffer, overwritten by the next
    step."""

    def __init__(self, params, cfg: LLMConfig, mask: torch.Tensor,
                 cache: KVCache, fused_injection, capture: bool):
        B, dev = mask.shape[0], mask.device
        self.params, self.cfg, self.mask, self.cache = params, cfg, mask, cache
        self.inject = fused_injection
        self.ids = torch.zeros(B, dtype=torch.long, device=dev)
        self.pos = torch.zeros(B, dtype=torch.long, device=dev)
        self.ci = torch.zeros(B, dtype=torch.int32, device=dev)
        self.capture = capture and dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.capture else None
        self.warm = False
        self.graph = None
        self.logits = None
        self.counts = None
        self.capture_ms = 0.0

    def _run(self) -> torch.Tensor:
        return tllm.decode_step(self.params, self.cfg, self.ids, self.pos,
                                self.ci, self.mask, self.cache, self.inject)

    def step(self, cur: torch.Tensor, pos: torch.Tensor,
             write_idx: int) -> torch.Tensor:
        """One decode step: tokens ``cur`` [B] at RoPE positions ``pos``
        [B], every row's k/v written at cache position ``write_idx``."""
        self.ids.copy_(cur)
        self.pos.copy_(pos)
        self.ci.fill_(write_idx)
        if not self.capture:
            return self._run()
        if not self.warm:
            self.warm = True
            out = self._on_stream(self._run)
            # allocated on the capture stream, read on the caller's
            out.record_stream(torch.cuda.current_stream(self.mask.device))
            return out
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _build.add_counts(self.counts)
        _build.count_launch("decode_graph")
        return self.logits

    def _on_stream(self, fn):
        """fn() on the capture stream, ordered after and before the
        caller's stream."""
        caller = torch.cuda.current_stream(self.mask.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            out = fn()
        caller.wait_stream(self.stream)
        return out

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = _build.count_snapshot()
        graph = torch.cuda.CUDAGraph()

        def record():
            # the capture's own stream context (not torch.cuda.graph, which
            # would synchronise the card and empty the allocator's cache)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self._run()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the capture is already invalid: report its cause
                raise
            graph.capture_end()
            return out

        self.logits = self._on_stream(record)
        self.counts = _build.take_counts(before)
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def close(self) -> None:
        """Free the graph and its memory pool (the static logits with it)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.logits = None
