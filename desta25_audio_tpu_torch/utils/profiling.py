"""Tracing and profiling hooks (port of
``desta25_audio_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` context over the host and, where a
  CUDA device is present, the card, writing one Chrome trace under
  ``log_dir`` (the JAX package writes an xprof trace there); the port's
  profiling scripts open their profiler through it;
- :func:`annotate`: a named region on that timeline, also an NVTX range
  where CUDA is present;
- :class:`StepTimer`: a wall-clock EMA of the step time without device
  syncs, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

from .misc import get_unique_filepath


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the body; on exit write ``log_dir/trace.json`` (or
    ``trace-N.json`` beside earlier ones; view it in Perfetto or
    chrome://tracing), or nothing where ``log_dir`` is None.  Yields the
    profiler, whose ``events()`` and ``key_averages()`` hold the body's
    ops and kernels (``profile_generate.report`` reads them)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        prof.export_chrome_trace(
            get_unique_filepath(os.path.join(log_dir, "trace.json")))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up on the trace timeline (and, with CUDA,
    as an NVTX range).  Usable as a decorator too."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock EMA of step time + derived throughputs.

    Does NOT force device syncs; callers fetch metrics at their own
    logging cadence (the asynchronous launch queue hides host overhead)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._t = None
        self.step_time: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.time()
        if self._t is not None:
            dt = now - self._t
            self.step_time = (dt if self.step_time is None else
                              self.ema * self.step_time
                              + (1 - self.ema) * dt)
        self._t = now
        return self.step_time

    def throughput(self, items_per_step: float) -> Dict[str, float]:
        if not self.step_time:
            return {}
        return {
            "step_time_s": self.step_time,
            "items_per_sec": items_per_step / self.step_time,
        }
