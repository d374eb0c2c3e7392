"""Continuous-batching serving engine (counterpart of
``desta25_audio_tpu/serve/engine.py``).

A shared KV cache [L, n_slots, t_max, Hkv*Dh] holds ``n_slots`` independent
request contexts.  Each tick runs ``steps_per_tick`` decode steps for every
slot, each slot writing at its own cache position, so requests join and
leave the batch without stalling the others.  Admissions that share a
context bucket prefill together (the rows padded to a power of two) and are
copied into their slots.

Request flow:
  submit(messages) /   -> host phases A/B (audio decode, VAD/ASR,
  submit_many([...])      templating, splice maps) + perception and splice
                          (batched across requests, through the model's
                          feature cache) -> queued
  step()            -> one tick: ``steps_per_tick`` decode (or verify)
                       steps for every slot, admission of queued requests,
                       the tick's tokens read by the host once
  run_until_done()  -> drain everything, returning {request_id: text}

Streaming: ``on_token(rid, token_id)`` receives tokens as each tick's
results land.  ``cancel(rid)`` retires a queued or running request (tokens
so far are kept, finish_reason "cancelled"); ``submit(..., deadline_s=T)``
gives a request a wall budget that counts its queue wait (finish_reason
"deadline" at the next tick).

The decode step.  Where the fused step takes the engine's batch (K8, K8-int8
and, for ORCA with the int8 stack, K8i with its per-slot ``on`` flags) the
engine keeps one ``generate/graph.DecodeGraph`` for its life over buffers
that never move: the cache, the mask [n_slots, t_max], ORCA's Ta-padded
audio K/V [L, n_slots, Ta_pad, D] and the ``on`` flags [n_slots].  On the
card its first step runs eagerly, its second is captured, and every later
step of every tick replays that one graph (``DecodeGraph.captures`` stays
1 however the slots change).  Admission, finishes and each tick's host
state reach those buffers by in-place writes (``index_copy_``, ``copy_``),
never by a new tensor, and every engine launch goes to the engine's stream
(the caller's at construction; every public method makes it current, so
that another thread may call it), so a queued tick reads the buffers as
they were when it was queued.  Elsewhere (an f32 tower, ORCA's float
stack, LoRA adapters) each step is ``models/llm.llm_apply`` with the
injection between layers; under LoRA the adapters join every prefill and
step, no graph is kept, and ``speculative_k`` is refused with a warning
(plain ticks; JAX ``engine.py:272``).  A server folds the adapters in first
(``cli/serve.py``: ``merge_lora_for_serving``).  Sampling
(``generate/decode.sample_token_dynamic``), the mask bit of each step and
the stop flags run eagerly on the device between the steps, with no host
read until the tick's tokens are copied out.

Speculative ticks (``speculative_k`` = Kd >= 2, where the verify step takes
the engine: ``generate/speculative.spec_limits``): each of the tick's steps
drafts Kd - 1 tokens a slot by n-gram lookup over the slot's history on the
device ([context ids | generated], seeded at admission), verifies the Kd
tokens in one step of a second kept graph (K8v, with K8i inside for ORCA)
and accepts the longest draft prefix the model's own draws agree with
(:func:`spec_tick`, the JAX engine's ``_spec_steps``).  The adaptive
controller (``adaptive_spec``, the JAX engine's round-5 semantics) runs
plain ticks while the measured acceptance is below the cost-aware
break-even T_spec / T_plain, re-probes with one spec tick at a backed-off
cadence, and speculates only after ``spec_quiet_ticks`` ticks without a
queue or an admission.  Greedy trajectories are the same in either mode.

Pipelining (``pipeline_ticks=True``, the default): admissions run before
the next tick is queued, that tick chains on the device-resident last
tokens (a spec tick also on the cache indices and RoPE positions, whose
advance is data-dependent), the host advances its mirrors optimistically
(a spec tick's at consume), and the previous tick's tokens (copied to
pinned memory without blocking, behind an event) are consumed after the
next tick is queued.  A slot that finished runs one more "zombie" tick
whose tokens are discarded; an admission into it is queued after that tick
and overwrites the slot wholesale.  A switch between plain and spec ticks
drains the in-flight tick first.

Under a mesh (the model's LLM cut by ``apply_llm_sharding``; the engine is
built under ``use_mesh``): the cache is the ShardedCache, the slots split
over the mesh's data rows, each prefill runs the sharded layer loop and its
rows are copied into their slots' shards, and each decode (and verify) step
is K10's ``MeshStep``, replayed from one graph per card kept for the
engine's life; the all-reduce's error words are read once a tick.

ORCA deep injection: each slot holds its audio tokens' per-layer K/V,
computed once at admission; the gated cross-attention runs after every
layer in the prefill and in every decode step, per slot ``where(on > 0,
out, h)`` (``on`` = 0 for text-only requests).  ORCA requests carry exactly
one audio each.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..generate.decode import sample_token_dynamic
from ..generate.graph import DecodeGraph
from ..generate.speculative import ngram_propose, spec_limits
from ..models import llm as tllm
from ..models.orca import gated_cross_attention_apply, precompute_cross_kv
from ..ops import _build
from ..ops.core import index_tree
from ..ops.fused_decode import (
    fused_decode_supported,
    fused_inject_supported,
    tower_is_int8,
)
from ..ops.fused_decode_mesh import fused_mesh_takes
from ..ops.quant import is_quantized
from ..ops.rope import fractional_rope_apply
from ..parallel.mesh import current_mesh, use_mesh
from ..parallel.sharding import ShardedCache, ShardedLLM

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    rid: int
    embeds: Any          # [1, Tc, D] device
    ctx_len: int         # valid context length (right-aligned)
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    do_sample: bool = False
    inject: Any = None   # [1, Ta, D] RoPE'd ORCA tokens, or None
    prompt_ids: Any = None  # np [ctx_len] context ids (the n-gram seed)
    tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    truncated: bool = False   # context clipped or cache filled mid-run
    # "eos" | "stop" | "length" | "cache_full" | "cancelled" | "deadline"
    finish_reason: str = ""
    stop_strs: tuple = ()
    stop_token_ids: frozenset = frozenset()
    final_text: Optional[str] = None    # text trimmed at the stop match
    deadline_s: Optional[float] = None  # wall budget incl. queue wait
    t_submit: float = 0.0


class _ToHost:
    """A device tensor's copy on the host: on CUDA a non-blocking copy into
    pinned memory behind an event on the tensor's card, so that the wait
    for it (:meth:`numpy`) can come after more work is queued."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            with torch.cuda.device(t.device):
                self.host = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                self.host.copy_(t, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()
        else:
            self.host, self.event = t.clone(), None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and a non-blocking
    copy on CUDA (the pinned block is the array's own copy, so the caller
    may change ``a`` at once), a copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def decode_tick(step_logits: Callable, mask: torch.Tensor,
                toks: torch.Tensor, rope: torch.Tensor, wpos: torch.Tensor,
                generator: torch.Generator, temp: torch.Tensor,
                top_p: torch.Tensor, do_sample: torch.Tensor,
                eos: Optional[torch.Tensor], steps: int) -> torch.Tensor:
    """``steps`` decode steps for every row, on device tensors alone (the
    JAX engine's ``_decode_steps``, ``engine.py:450-500``): step s sets each
    row's mask bit at wpos + s in ``mask`` [B, S] in place (none past S),
    runs ``step_logits(cur, rope + s, wpos + s)`` -> f32 logits [B, V],
    samples every row (:func:`sample_token_dynamic`), and freezes rows that
    emitted a stop token (they repeat it).  toks [B] int64, rope [B] int64,
    wpos [B] int32, eos [n] int64 or None.  Returns the tokens [steps, B]."""
    t_idx = torch.arange(mask.shape[1], dtype=wpos.dtype, device=mask.device)
    cur = toks
    done = torch.zeros(toks.shape, dtype=torch.bool, device=toks.device)
    outs = []
    for s in range(steps):
        w = wpos + s
        mask.bitwise_or_((t_idx[None, :] == w[:, None]).to(mask.dtype))
        nxt = sample_token_dynamic(step_logits(cur, rope + s, w), generator,
                                   temp, top_p, do_sample)
        nxt = torch.where(done, cur, nxt)
        if eos is not None:
            done = done | (nxt[:, None] == eos[None, :]).any(-1)
        outs.append(nxt)
        cur = nxt
    return torch.stack(outs)


def spec_tick(verify_logits: Callable, vmask: torch.Tensor,
              mask: torch.Tensor, decode_start: torch.Tensor,
              toks: torch.Tensor, rope: torch.Tensor, ci: torch.Tensor,
              hist: torch.Tensor, hlen: torch.Tensor,
              generator: torch.Generator, temp: torch.Tensor,
              top_p: torch.Tensor, do_sample: torch.Tensor,
              eos: Optional[torch.Tensor], steps: int, kd: int,
              sample_positions: int = 1):
    """``steps`` speculative verify steps for every row, on device tensors
    alone (the JAX engine's ``_spec_steps``, ``engine.py:502-624``).

    First the verify mask: ``vmask`` [B, S] (the verify step's buffer) is
    set in place to ``mask | (t >= decode_start)`` (the step admits only the
    keys below each row's write index, so every position from a row's
    decode start can be marked).  Then each step drafts kd - 1 tokens a row
    (:func:`generate.speculative.ngram_propose` over ``hist`` [B, Th] and
    its lengths ``hlen`` [B]), runs ``verify_logits(tokens [B, kd],
    positions [B, kd], ci)`` -> f32 logits [B, kd, V], draws every row's
    token at each of the first ``sample_positions`` positions in one
    [B * n, V] pass of :func:`sample_token_dynamic` (greedy rows its exact
    argmax) and takes the argmax past them, accepts the longest draft
    prefix that matches (``m`` tokens, a sampled row at most
    ``sample_positions``), clips at the first stop token, writes all kd
    drawn tokens into ``hist`` at ``hlen`` in place (the ones past m are
    overwritten by the next step) and advances the row's token, cache
    index, position and history length by m.  A row freezes (m = 0) from
    the step after a stop token lands or its cache cannot take another
    kd-token block (ci > S - kd, the host's ``cache_full``).

    toks, rope, ci [B] int64 (the rows' last tokens, next RoPE positions
    and cache write indices), eos [n] int64 or None.  Returns (drawn tokens
    [steps, B, kd], accepted counts [steps, B], and the rows' last tokens,
    cache indices, positions and history lengths after the tick)."""
    S = mask.shape[1]
    dev = toks.device
    t_idx = torch.arange(S, device=dev)
    vmask.copy_(mask | (t_idx[None, :] >= decode_start[:, None]).to(
        mask.dtype))
    Th = hist.shape[1]
    jidx = torch.arange(kd, device=dev)[None, :]
    nsp = sample_positions
    cur, done = toks, ci > S - kd
    emits, ms = [], []
    for _ in range(steps):
        # a dead row's history may outgrow the buffer; a live row's never
        # does (the buffer's slack), and the lookup and the write clamp as
        # JAX's gather and dynamic_update_slice do
        draft = ngram_propose(hist, torch.clamp(hlen, max=Th), kd - 1)
        toks_k = torch.cat([cur[:, None], draft], dim=1)
        lg = verify_logits(toks_k, rope[:, None] + jidx, ci)
        g = torch.argmax(lg, dim=-1)
        B = g.shape[0]
        drawn = sample_token_dynamic(
            lg[:, :nsp].reshape(B * nsp, -1), generator,
            temp.repeat_interleave(nsp), top_p.repeat_interleave(nsp),
            do_sample.repeat_interleave(nsp)).reshape(B, nsp)
        g = torch.cat([drawn, g[:, nsp:]], dim=1)
        match = (toks_k[:, 1:] == g[:, :-1]).long()
        m = 1 + torch.cumprod(match, dim=1).sum(1)
        m = torch.where(do_sample, torch.clamp(m, max=nsp), m)
        hit = (torch.zeros_like(g, dtype=torch.bool) if eos is None
               else (g[..., None] == eos).any(-1))
        eos_pos = torch.where(hit & (jidx < m[:, None]), jidx,
                              torch.full_like(jidx, kd)).amin(1)
        m = torch.minimum(m, eos_pos + 1)
        m = torch.where(done, torch.zeros_like(m), m)
        hist.scatter_(1, torch.clamp(hlen, max=Th - kd)[:, None] + jidx, g)
        nxt = torch.gather(g, 1, torch.clamp(m - 1, min=0)[:, None])[:, 0]
        cur = torch.where(m > 0, nxt, cur)
        done = done | (eos_pos < m) | (ci + m > S - kd)
        ci, rope, hlen = ci + m, rope + m, hlen + m
        emits.append(g)
        ms.append(m)
    return torch.stack(emits), torch.stack(ms), cur, ci, rope, hlen


def _on_engine(fn):
    """Run an engine method with its device, stream and mesh current and
    without autograd (the engine may be driven from any thread)."""
    @functools.wraps(fn)
    def run(self, *args, **kw):
        with self._context():
            return fn(self, *args, **kw)
    return run


class ContinuousBatchingEngine:
    def __init__(self, model, n_slots: int = 16, max_ctx: int = 256,
                 max_new_tokens: int = 128, ctx_bucket: int = 64,
                 seed: int = 0, steps_per_tick: int = 8, on_token=None,
                 speculative_k: int = 0, adaptive_spec: bool = True,
                 spec_quiet_ticks: int = 4, on_overflow: str = "error",
                 pipeline_ticks: bool = True, audio_cache: int = 64,
                 decode_graph: bool = True):
        """The JAX engine's arguments (``engine.py:97-173``).  n_slots=16,
        steps_per_tick=8: the setting the JAX engine is documented for.

        speculative_k >= 2: speculative ticks (module docstring) where the
        verify step takes the engine (an int8 or bf16 tower; ORCA needs the
        int8 stack and the int8 tower; under a mesh K10's verify step);
        elsewhere a warning, one ``fused_verify_layers`` count in
        ``_build.fallback_counts()`` and plain ticks (``speculative_k``
        reads 0).  adaptive_spec (only with speculation): the cost-aware
        controller; False speculates on every tick.  spec_quiet_ticks: the
        controller's quiet gate (0: only the admission tick is plain).

        on_overflow: "error" (the default) rejects a context longer than
        ``max_ctx`` with ValueError; "truncate" clips its left side and
        flags the request ``truncated``.

        pipeline_ticks: one-tick-lookahead dispatch (module docstring);
        False runs each tick and reads its tokens before the next.

        audio_cache: the model's per-clip feature cache capacity
        (``enable_audio_cache``; 0 turns it off).

        decode_graph: False runs every decode and verify step eagerly
        through the same functions and buffers (the comparison of the
        card's tests)."""
        if on_overflow not in ("error", "truncate"):
            raise ValueError(f"on_overflow: {on_overflow!r} "
                             "(expected 'error' or 'truncate')")
        llm = model.params["llm"]
        self.mesh = llm.mesh if isinstance(llm, ShardedLLM) else None
        if current_mesh() is not self.mesh and current_mesh() is not None:
            raise ValueError("under a mesh the engine takes a model whose LLM "
                             "is cut for it (apply_llm_sharding)")
        self.model = model
        self.device = dev = torch.device(model.device)
        self.stream = None
        if dev.type == "cuda":
            # the card by its index: another thread's current card may differ
            self.device = dev = torch.device(
                "cuda", torch.cuda.current_device() if dev.index is None
                else dev.index)
            self.stream = torch.cuda.current_stream(dev)
        with self._context():
            self._build(model, n_slots, max_ctx, max_new_tokens, ctx_bucket,
                        seed, steps_per_tick, on_token, speculative_k,
                        adaptive_spec, spec_quiet_ticks, on_overflow,
                        pipeline_ticks, audio_cache, decode_graph)

    @contextlib.contextmanager
    def _context(self):
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.no_grad())
            if self.mesh is not None:
                stack.enter_context(use_mesh(self.mesh))
            if self.stream is not None:
                stack.enter_context(torch.cuda.device(self.device))
                stack.enter_context(torch.cuda.stream(self.stream))
            yield

    def _build(self, model, n_slots, max_ctx, max_new_tokens, ctx_bucket,
               seed, steps_per_tick, on_token, speculative_k, adaptive_spec,
               spec_quiet_ticks, on_overflow, pipeline_ticks, audio_cache,
               decode_graph):
        model.enable_audio_cache(audio_cache)
        self.on_token = on_token
        self.cfg = cfg = model.llm_cfg
        dev = self.device
        self.dtype = model.dtype
        self.n_slots = n_slots
        self.max_ctx = max_ctx
        self.max_new = max_new_tokens
        self.ctx_bucket = ctx_bucket
        self.t_max = max_ctx + max_new_tokens
        if speculative_k >= 2:
            # Kd positions of slack: a verify block writes ci .. ci + Kd - 1
            self.t_max += speculative_k
        # every fused decode kernel plans for a cache of 128-multiple length
        self.t_max = -(-self.t_max // 128) * 128
        self.steps_per_tick = max(1, steps_per_tick)
        self.on_overflow = on_overflow
        self.pipeline_ticks = bool(pipeline_ticks)

        # under a mesh the ShardedCache, its slots split over the data rows
        self.cache = tllm.init_kv_cache(cfg, n_slots, self.t_max,
                                        dtype=self.dtype, device=dev)
        # host-side slot state (the mirrors each tick's inputs come from)
        self.slot_req: List[Optional[_Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)      # next cache index
        self.slot_rope = np.zeros(n_slots, np.int32)     # next rope position
        self.slot_mask = np.zeros((n_slots, self.t_max), np.int32)
        self.cur_tok = np.zeros(n_slots, np.int64)
        self.slot_temp = np.zeros(n_slots, np.float32)
        self.slot_top_p = np.ones(n_slots, np.float32)
        self.slot_sample = np.zeros(n_slots, bool)
        self.slot_decode_start = np.zeros(n_slots, np.int32)
        self.queue: List[_Request] = []
        self.finished: Dict[int, List[int]] = {}
        self.finished_info: Dict[int, Dict[str, Any]] = {}
        # host seconds from submit to the first token's arrival, by request
        self.first_token_s: Dict[int, float] = {}
        self._ids = itertools.count()
        self._eos = set(model._terminators())
        self._eos_dev = (torch.tensor(sorted(self._eos), dtype=torch.long,
                                      device=dev) if self._eos else None)
        self.generator = torch.Generator(dev).manual_seed(seed)

        # ORCA deep injection: a fixed-length audio K/V buffer per slot
        mcfg = model.config
        self._inject_len = 0
        if (mcfg.is_orca and mcfg.orca_deep_injection_enabled
                and "orca_cross_attns" in model.params
                and mcfg.orca_local_enabled):
            t_enc = model.enc_cfg.expected_mel_frames // 2
            k, s = mcfg.orca_local_kernel_size, mcfg.orca_local_downsample
            self._inject_len = (t_enc + 2 * (k // 2) - k) // s + 1 + (
                mcfg.orca_global_num_tokens
                if mcfg.orca_global_cross_attn else 0)
        self._inject_params = (model.params["orca_cross_attns"]
                               if self._inject_len else None)
        D = cfg.hidden_size
        heads = cfg.num_attention_heads
        n_inj = (self._inject_params["layers"]["ln"]["scale"].shape[0]
                 if self._inject_len else 1)
        # Ta padded to a multiple of 8 (the JAX kernel's sublane blocks);
        # the padded rows stay zero and nothing attends them
        ta_pad = -(-max(self._inject_len, 1) // 8) * 8
        kv_bytes = 2 * n_inj * n_slots * ta_pad * D * self.dtype.itemsize
        if kv_bytes > 4 << 30:
            logger.warning(
                "ORCA injection K/V buffers: %.1f GB at n_slots=%d; lower "
                "n_slots if this does not fit beside the tower's weights",
                kv_bytes / 2**30, n_slots)
        self.inject_k = torch.zeros(n_inj, n_slots, ta_pad, D,
                                    dtype=self.dtype, device=dev)
        self.inject_v = torch.zeros_like(self.inject_k)
        self.inject_on = np.zeros(n_slots, np.float32)

        # the decode step's fixed device buffers (the mask is the verify
        # step's too: each tick writes its own into it)
        self._mask = torch.zeros(n_slots, self.t_max, dtype=torch.int32,
                                 device=dev)
        self._on = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        self._cur_dev = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self._extra = self._inject_fn(self.inject_k, self.inject_v, self._on)
        self._fspec = None
        llm = model.params["llm"]
        self._lora = dict(lora=model.params.get("lora"),
                          lora_scale=model.config.lora_scale)
        lora_on = self._lora["lora"] is not None
        if self._inject_len and not lora_on:
            if fused_inject_supported(llm, cfg, self._inject_params, heads,
                                      self._inject_len):
                self._fspec = dict(params=self._inject_params,
                                   k=self.inject_k, v=self.inject_v,
                                   ta_real=self._inject_len, heads=heads,
                                   on=self._on)
            elif (tower_is_int8(llm) and is_quantized(
                    self._inject_params["layers"].get("q"))):
                _build.count_fallback("fused_decode_inject")
        self.graph: Optional[DecodeGraph] = None
        if not lora_on and (self._extra is None or self._fspec is not None):
            if self.mesh is not None:        # K10, one graph per card
                fused = fused_mesh_takes(llm, cfg, self.cache, self._fspec)
            else:
                fused = fused_decode_supported(
                    llm, cfg, torch.zeros(n_slots, 1, D, dtype=self.dtype,
                                          device=dev), self.cache)
            if fused:
                self.graph = DecodeGraph(llm, cfg, self._mask, self.cache,
                                         self._fspec, capture=decode_graph)

        # speculative verify ticks: eligibility (``engine.py:260-295``)
        self.speculative_k = 0
        self.vgraph: Optional[DecodeGraph] = None
        if speculative_k >= 2 and lora_on:
            # a dispatch rule, not a kernel's refusal: no fallback count
            logger.warning(
                "speculative_k=%d requested under LoRA adapters, which no "
                "verify step takes; serving runs plain decode ticks "
                "(merge_lora_for_serving folds them in)", speculative_k)
        elif speculative_k >= 2:
            bad = spec_limits(
                llm, cfg, n_slots, self.t_max, speculative_k, self.dtype,
                inject_params=self._inject_params,
                inject_heads=heads if self._inject_len else 0,
                inject_len=self._inject_len)
            if self.graph is None:
                bad.append("the decode step's kernels do not take the engine")
            if bad:
                logger.warning(
                    "speculative_k=%d requested but the verify step cannot "
                    "take this engine (%s); serving falls back to plain "
                    "decode ticks", speculative_k, "; ".join(bad))
                _build.count_fallback("fused_verify_layers")
            else:
                self.speculative_k = speculative_k
                self.vgraph = DecodeGraph(llm, cfg, self._mask, self.cache,
                                          self._fspec, capture=decode_graph,
                                          kd=speculative_k)
        # the controller's state (``engine.py:296-361``): the quiet gate,
        # the one-tick optimistic probe with its exponential backoff, the
        # re-probe and calibration cadences, the cost-aware bars
        self.adaptive_spec = bool(adaptive_spec) and self.speculative_k >= 2
        self.spec_quiet_ticks = int(spec_quiet_ticks)
        self._spec_off = 1.12       # static bars until both durations exist
        self._spec_on = 1.35
        self._spec_reprobe = 24     # plain ticks between probes (x backoff)
        self._quiet_ticks = 0
        self._reprobe_backoff = 1
        self._spec_ema = self._spec_on
        self._spec_live = True      # an optimistic start, as a probe
        self._spec_probing = True
        self._hist_dirty = False    # plain ticks skip the n-gram upkeep
        self._ticks_since_probe = 0
        self._ticks_since_plain_probe = 0
        self._dur_ema: Dict[str, Optional[float]] = {"spec": None,
                                                     "plain": None}
        # the chained cache indices and positions of pipelined spec ticks
        self._ci_dev = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self._pos_dev = torch.zeros(n_slots, dtype=torch.long, device=dev)
        # per-slot n-gram history on the device; its slack covers the
        # device's overshoot within one tick
        hcap = self.t_max + self.steps_per_tick * max(speculative_k, 1) + 8
        self.hist = torch.zeros(n_slots, hcap, dtype=torch.long, device=dev)
        self.hlen = torch.zeros(n_slots, dtype=torch.long, device=dev)

        # (kind, tokens, [(slot, req)], write_pos, n_adm, error words)
        self._inflight = None
        # pipelined admissions whose first-token bookkeeping waits for the
        # consume phase: [(slots, reqs, first tokens on the host)]
        self._pending_admits: List[Tuple[List[int], List[_Request],
                                         _ToHost]] = []
        self._n_admissions = 0
        self._n_spec_ticks = 0   # the dispatched tick mix
        self._n_plain_ticks = 0
        self._closed = False

    # -- device work -------------------------------------------------------

    def _inject_fn(self, inj_k, inj_v, on):
        """ORCA's per-layer hook over the slots' (or a prefill's) audio K/V
        [L, B, Ta_pad, D] and on-flags [B]: the gated cross-attention over
        the real Ta rows, kept per row by ``where(on > 0, out, h)`` (the
        JAX engine's ``_inject_fn``), or None without injection."""
        if self._inject_len == 0:
            return None
        heads = self.cfg.num_attention_heads
        lay = self._inject_params["layers"]
        ta = self._inject_len

        def fn(l, h):
            out = gated_cross_attention_apply(
                index_tree(lay, l), h, None, heads,
                cached_kv=(inj_k[l, :, :ta], inj_v[l, :, :ta]))
            return torch.where(on[:, None, None] > 0, out, h)

        return fn

    def _prefill(self, embeds, mask_h: np.ndarray, inject_kv, on, temp,
                 top_p, do_sample):
        """R same-bucket requests in one prefill (R a power of two and a
        multiple of the mesh's data rows; padded rows carry all-zero
        masks): (first tokens [R], the temporary cache, the rows' audio K/V
        or None)."""
        R, Tb = mask_h.shape
        dev = self.device
        mask = _to_device(mask_h, dev)
        inj_k = inj_v = None
        if self._inject_len:
            inj_k, inj_v = precompute_cross_kv(self._inject_params,
                                               inject_kv)
            inj_k, inj_v = inj_k.to(self.dtype), inj_v.to(self.dtype)
        cache = tllm.init_kv_cache(self.cfg, R, self.t_max, dtype=self.dtype,
                                   device=dev)
        full = torch.zeros(R, self.t_max, dtype=torch.int32, device=dev)
        full[:, :Tb] = mask
        positions = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
        logits, cache = tllm.llm_apply(
            self.model.params["llm"], self.cfg, inputs_embeds=embeds,
            attention_mask=full, positions=positions, cache=cache,
            cache_index=0,
            extra_layer_fn=self._inject_fn(inj_k, inj_v, on), **self._lora)
        tok = sample_token_dynamic(logits[:, -1].float(), self.generator,
                                   temp, top_p, do_sample)
        return tok, cache, inj_k, inj_v

    def _step_logits(self, cur, pos, ci):
        """One decode step of every slot: the kept graph's step, else the
        layer loop with the injection hook -> f32 logits [n_slots, V]."""
        if self.graph is not None:
            return self.graph.step(cur, pos, ci)
        logits, _ = tllm.llm_apply(
            self.model.params["llm"], self.cfg, input_ids=cur[:, None],
            attention_mask=self._mask, positions=pos[:, None],
            cache=self.cache, cache_index=ci, extra_layer_fn=self._extra,
            fused_injection=self._fspec, **self._lora)
        return logits[:, -1]

    def _upload(self, write_pos: np.ndarray):
        """The host mirrors on the device in one copy each of the ints
        ([mask | write_pos, rope, sample, cur_tok, decode_start]) and the
        floats ([temp, top_p, on]), made before the mirrors change again;
        ``on`` copied into the graphs' buffer."""
        ints = np.concatenate(
            [self.slot_mask, write_pos[:, None], self.slot_rope[:, None],
             self.slot_sample[:, None], self.cur_tok[:, None],
             self.slot_decode_start[:, None]], axis=1).astype(np.int64)
        floats = np.stack([self.slot_temp, self.slot_top_p, self.inject_on],
                          axis=1).astype(np.float32)
        ints, floats = (_to_device(ints, self.device),
                        _to_device(floats, self.device))
        self._on.copy_(floats[:, 2])
        return ints, floats

    def _dispatch_tick(self, write_pos: np.ndarray) -> torch.Tensor:
        """Queue one plain tick for every slot from the host mirrors;
        pipelined engines chain on ``_cur_dev``.  Returns the tick's tokens
        [K, n_slots] on the device."""
        T = self.t_max
        ints, floats = self._upload(write_pos)
        self._mask.copy_(ints[:, :T])
        toks = self._cur_dev if self.pipeline_ticks else ints[:, T + 3]
        return decode_tick(self._step_logits, self._mask, toks,
                           ints[:, T + 1], ints[:, T].int(), self.generator,
                           floats[:, 0], floats[:, 1], ints[:, T + 2] > 0,
                           self._eos_dev, self.steps_per_tick)

    def _dispatch_spec_tick(self, write_pos: np.ndarray,
                            nsp: int) -> torch.Tensor:
        """Queue one spec tick for every slot (:func:`spec_tick` through the
        verify graph); pipelined engines read the device-chained tokens,
        cache indices and positions and chain the new ones.  Returns the
        tick's drawn tokens and accepted counts as one [K, n_slots * (Kd +
        1)] tensor on the device."""
        T, K, Kd = self.t_max, self.steps_per_tick, self.speculative_k
        ints, floats = self._upload(write_pos)
        pipe = self.pipeline_ticks
        emits, ms, cur, ci, pos, hlen = spec_tick(
            self.vgraph.step, self._mask, ints[:, :T], ints[:, T + 4],
            self._cur_dev if pipe else ints[:, T + 3],
            self._pos_dev if pipe else ints[:, T + 1],
            self._ci_dev if pipe else ints[:, T], self.hist, self.hlen,
            self.generator, floats[:, 0], floats[:, 1], ints[:, T + 2] > 0,
            self._eos_dev, K, Kd, nsp)
        self.hlen.copy_(hlen)
        if pipe:
            self._cur_dev.copy_(cur)
            self._ci_dev.copy_(ci)
            self._pos_dev.copy_(pos)
        return torch.cat([emits.reshape(K, -1), ms], dim=1)

    def _error_words(self) -> List[_ToHost]:
        """Under a mesh, the all-reduce's error words after the tick just
        queued, copied to the host without a wait (read at consume)."""
        return [_ToHost(e) for g in (self.graph, self.vgraph)
                if g is not None for e in g.error_words()]

    @staticmethod
    def _check_error_words(errs) -> None:
        bad = [i for i, e in enumerate(errs) if int(e.numpy().any())]
        if bad:
            raise RuntimeError(
                f"serving engine: the all-reduce of ranks {bad} timed out "
                "waiting for a peer's partial sum")

    # -- host API ------------------------------------------------------------

    def submit(self, messages, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               do_sample: bool = False,
               deadline_s: Optional[float] = None,
               stop: Optional[List[str]] = None,
               stop_token_ids: Optional[List[int]] = None) -> int:
        """Prepare a request (host phases + perception) and queue it."""
        return self.submit_many([messages], max_new_tokens=max_new_tokens,
                                temperature=temperature, top_p=top_p,
                                do_sample=do_sample, deadline_s=deadline_s,
                                stop=stop, stop_token_ids=stop_token_ids)[0]

    @_on_engine
    def submit_many(self, messages_list,
                    max_new_tokens: Optional[int] = None,
                    temperature: float = 0.0, top_p: float = 1.0,
                    do_sample: bool = False,
                    deadline_s: Optional[float] = None,
                    stop: Optional[List[str]] = None,
                    stop_token_ids: Optional[List[int]] = None
                    ) -> List[int]:
        """Queue several conversations with one batched host + perception
        pass."""
        embeds, attn_mask, inject, prompt_ids = \
            self.model._prepare_generation_inputs(messages_list)
        am = attn_mask.cpu().numpy()
        if self._inject_len and inject is not None:
            if (inject.shape[0] != len(messages_list)
                    or inject.shape[1] != self._inject_len):
                raise ValueError(
                    "ORCA serving requests must carry exactly one 30 s "
                    f"audio each (injection tokens {tuple(inject.shape)}, "
                    f"expected [{len(messages_list)}, {self._inject_len}, "
                    "d])")
            inject = fractional_rope_apply(
                inject, self.model.config.orca_audio_position_scale,
                self.cfg.rope_theta)
        rids: List[int] = []
        for r in range(embeds.shape[0]):
            e, ctx_len, truncated = self._bucket_row(embeds[r:r + 1], am[r])
            inj = (inject[r:r + 1]
                   if self._inject_len and inject is not None else None)
            valid_ids = (np.asarray(prompt_ids[r])[am[r] > 0][-ctx_len:]
                         if prompt_ids is not None else None)
            rid = next(self._ids)
            self.queue.append(_Request(
                rid=rid, embeds=e, ctx_len=ctx_len,
                max_new_tokens=min(max_new_tokens or self.max_new,
                                   self.max_new),
                temperature=temperature, top_p=top_p, do_sample=do_sample,
                inject=inj, prompt_ids=valid_ids, truncated=truncated,
                deadline_s=deadline_s, t_submit=time.monotonic(),
                stop_strs=tuple(stop or ()),
                stop_token_ids=frozenset(stop_token_ids or ())))
            rids.append(rid)
        return rids

    # -- cancellation / deadlines ------------------------------------------

    def _retire_unslotted(self, req: _Request, reason: str):
        """A terminal result for a request that holds no slot (any more)."""
        req.done = True
        req.finish_reason = reason
        self.finished[req.rid] = req.tokens
        self.finished_info[req.rid] = {
            "tokens": req.tokens,
            "finish_reason": reason,
            "truncated": req.truncated,
            "prompt_tokens": req.ctx_len,
        }
        if req.final_text is not None:
            self.finished_info[req.rid]["text"] = req.final_text

    @_on_engine
    def flush(self) -> List[int]:
        """Consume the in-flight pipelined tick, if any, without queueing a
        new one; returns the request ids it finished.  The chained device
        state is untouched, so a later step() resumes the same
        trajectory.  A no-op for sequential engines."""
        fin0 = self._drain_pending_admits()
        if self._inflight is None:
            return fin0
        kind, outs, slot_reqs, write_pos, _, errs = self._inflight
        self._inflight = None
        self._check_error_words(errs)
        if kind == "spec":
            return fin0 + self._consume_spec_tick(slot_reqs, outs,
                                                  self.slot_pos.copy())
        return fin0 + self._consume_tick(outs, slot_reqs, write_pos)

    @_on_engine
    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request (the in-flight tick is
        flushed first, so its tokens count); tokens so far are kept with
        finish_reason "cancelled".  False for an unknown or finished id."""
        self.flush()
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(i)
                self._retire_unslotted(r, "cancelled")
                return True
        for s in range(self.n_slots):
            req = self.slot_req[s]
            if req is not None and req.rid == rid:
                self._finish(s, "cancelled")
                return True
        return False

    def _expire_deadlines(self) -> List[int]:
        """Retire every queued or active request whose wall budget (queue
        wait included) ran out."""
        now = time.monotonic()
        expired: List[int] = []
        for s in range(self.n_slots):
            req = self.slot_req[s]
            if (req is not None and req.deadline_s is not None
                    and now - req.t_submit > req.deadline_s):
                expired.append(req.rid)
                self._finish(s, "deadline")
        still: List[_Request] = []
        for r in self.queue:
            if r.deadline_s is not None and now - r.t_submit > r.deadline_s:
                expired.append(r.rid)
                self._retire_unslotted(r, "deadline")
            else:
                still.append(r)
        self.queue = still
        return expired

    def _bucket_row(self, embeds, mask_row) -> Tuple[Any, int, bool]:
        """Left-pad or trim one [1, T, D] context to its bucket; a context
        longer than ``max_ctx`` is rejected or left-clipped and flagged
        (``on_overflow``)."""
        T = embeds.shape[1]
        ctx_len = int(mask_row.sum())
        truncated = False
        if ctx_len > self.max_ctx:
            if self.on_overflow == "error":
                raise ValueError(
                    f"request context is {ctx_len} tokens but the engine "
                    f"was built with max_ctx={self.max_ctx}; raise "
                    "max_ctx or pass on_overflow='truncate' to clip "
                    "(the clipped request is flagged truncated)")
            truncated = True
        Tr = min(-(-ctx_len // self.ctx_bucket) * self.ctx_bucket
                 if ctx_len else self.ctx_bucket, self.max_ctx)
        if T < Tr:
            embeds = F.pad(embeds, (0, 0, Tr - T, 0))
        elif T > Tr:
            embeds = embeds[:, -Tr:]
            ctx_len = min(ctx_len, Tr)
        return embeds.contiguous(), ctx_len, truncated

    def _admit(self, reqs: List[_Request], slots: List[int], Tb: int):
        """Prefill R same-bucket requests together and place them into
        ``slots``: their K/V (and audio K/V) copied into the engine's
        buffers in place; a spec engine seeds the slots' histories."""
        R = len(reqs)
        Rp = 1 << (R - 1).bit_length()
        if self.mesh is not None:     # the rows split over the data rows
            nd = self.mesh.n_data
            Rp = -(-Rp // nd) * nd
        dev, dt = self.device, reqs[0].embeds.dtype
        D = self.cfg.hidden_size
        pad = ([torch.zeros(Rp - R, Tb, D, dtype=dt, device=dev)]
               if Rp != R else [])
        embeds = torch.cat([r.embeds for r in reqs] + pad)
        mask = np.zeros((Rp, Tb), np.int32)
        for i, r in enumerate(reqs):
            mask[i, Tb - r.ctx_len:] = 1
        inject_kv = None
        if self._inject_len:
            Ta = self._inject_len
            zero = torch.zeros(1, Ta, D, dtype=dt, device=dev)
            inject_kv = torch.cat(
                [r.inject if r.inject is not None else zero for r in reqs]
                + ([torch.zeros(Rp - R, Ta, D, dtype=dt, device=dev)]
                   if Rp != R else []))
        on = np.zeros(Rp, np.float32)
        temp = np.zeros(Rp, np.float32)
        top_p = np.ones(Rp, np.float32)
        do_sample = np.zeros(Rp, bool)
        for i, r in enumerate(reqs):
            on[i] = 1.0 if r.inject is not None else 0.0
            temp[i], top_p[i], do_sample[i] = (r.temperature, r.top_p,
                                               r.do_sample)
        tok, pcache, inj_k, inj_v = self._prefill(
            embeds, mask, inject_kv, _to_device(on, dev),
            _to_device(temp, dev), _to_device(top_p, dev),
            _to_device(do_sample, dev))
        sl = _to_device(np.asarray(slots, np.int64), dev)
        if self.mesh is None:
            self._place(sl, pcache, inj_k, inj_v)
        else:
            self._place_sharded(slots, sl, pcache, inj_k, inj_v)
        # the post-prefill rope position is the host's (last real position
        # ctx_len - 1); the first token is the only device-only state
        last_pos = np.maximum(mask.sum(axis=1) - 1, 0).astype(np.int32)
        if self.speculative_k:
            # the n-gram history: [context ids] from the host, the first
            # token merged in on the device (no host read)
            hcap = self.hist.shape[1]
            seeds = np.zeros((R, hcap), np.int64)
            lens = np.zeros(R, np.int64)
            for i, req in enumerate(reqs):
                ids = (req.prompt_ids if req.prompt_ids is not None
                       else np.zeros(0, np.int64))
                seeds[i, :len(ids)] = ids
                lens[i] = len(ids)
            lens_d = _to_device(lens, dev)
            seeded = _to_device(seeds, dev) + (
                torch.arange(hcap, device=dev)[None, :] == lens_d[:, None]
            ) * tok[:R, None]
            self.hist.index_copy_(0, sl, seeded)
            self.hlen.index_copy_(0, sl, lens_d + 1)
        for i, (req, s) in enumerate(zip(reqs, slots)):
            req.slot = s
            self.slot_req[s] = req
            self.slot_mask[s] = 0
            self.slot_mask[s, :Tb] = mask[i]
            self.slot_pos[s] = Tb
            self.slot_decode_start[s] = Tb
            self.slot_rope[s] = int(last_pos[i]) + 1
            self.slot_temp[s] = req.temperature
            self.slot_top_p[s] = req.top_p
            self.slot_sample[s] = req.do_sample
            self.inject_on[s] = on[i]
        self._n_admissions += 1
        self._quiet_ticks = 0  # an admission: the engine is not quiet
        first = _ToHost(tok[:R])
        if self.pipeline_ticks:
            # the admitted slots' chained state; the host bookkeeping
            # waits for the consume phase
            self._cur_dev.index_copy_(0, sl, tok[:R])
            self._ci_dev.index_copy_(0, sl, torch.full_like(sl, Tb))
            self._pos_dev.index_copy_(0, sl, _to_device(
                last_pos[:R].astype(np.int64) + 1, dev))
            self._pending_admits.append((list(slots), list(reqs), first))
        else:
            self._apply_admit_tokens(slots, reqs, first.numpy())

    def _place(self, sl: torch.Tensor, pcache, inj_k, inj_v) -> None:
        """Copy a prefill's first len(sl) rows (K/V, and ORCA's audio K/V
        into the real Ta rows) into the slots ``sl`` of the engine's own
        buffers, in place: the kept graph reads those buffers."""
        R = sl.shape[0]
        self.cache.k.index_copy_(1, sl, pcache.k[:, :R])
        self.cache.v.index_copy_(1, sl, pcache.v[:, :R])
        self._place_inject(sl, inj_k, inj_v)

    def _place_inject(self, sl: torch.Tensor, inj_k, inj_v) -> None:
        if self._inject_len:
            R, Ta = sl.shape[0], self._inject_len
            self.inject_k[:, :, :Ta].index_copy_(1, sl, inj_k[:, :R])
            self.inject_v[:, :, :Ta].index_copy_(1, sl, inj_v[:, :R])

    def _place_sharded(self, slots: List[int], sl: torch.Tensor,
                       pcache: ShardedCache, inj_k, inj_v) -> None:
        """:meth:`_place` under a mesh: prefill row i lies in data row
        i // (Rp / n_data) of the prefill's ShardedCache, slot s in data row
        s // (n_slots / n_data) of the engine's; each rank's slice of row i
        is copied into the same rank's slice of slot s, in place (across
        cards where the two data rows lie on different ones).  The steps'
        copies of ORCA's audio K/V are taken anew."""
        nd = self.mesh.n_data
        b = self.n_slots // nd
        bp = pcache.shards[0][0].k.shape[1]
        for g in range(nd):
            pairs = [(i, s - g * b) for i, s in enumerate(slots)
                     if s // b == g]
            if not pairs:
                continue
            for m, dst in enumerate(self.cache.shards[g]):
                d = dst.k.device
                idx = _to_device(np.asarray([ls for _, ls in pairs],
                                            np.int64), d)
                for side in ("k", "v"):
                    src = torch.cat([
                        getattr(pcache.shards[i // bp][m], side)[
                            :, i % bp:i % bp + 1].to(d) for i, _ in pairs],
                        dim=1)
                    getattr(dst, side).index_copy_(1, idx, src)
        self._place_inject(sl, inj_k, inj_v)
        if self._fspec is not None:
            for g in (self.graph, self.vgraph):
                if g is not None:
                    g.stepper.sync_inject()

    def _apply_admit_tokens(self, slots, reqs, tokh) -> List[int]:
        """Record each admitted request's first token, stream it and check
        it for a stop; returns the request ids that finished."""
        finished: List[int] = []
        now = time.monotonic()
        for i, (req, s) in enumerate(zip(reqs, slots)):
            if req.done or self.slot_req[s] is not req:
                continue  # retired (deadline / cancel) before the drain
            t = int(tokh[i])
            req.tokens.append(t)
            self.first_token_s[req.rid] = now - req.t_submit
            if self.on_token is not None:
                self.on_token(req.rid, t)
            self.cur_tok[s] = t
            fin = self._check_stop(req, t)
            if fin:
                finished.append(req.rid)
                self._finish(s, fin)
        return finished

    def _drain_pending_admits(self) -> List[int]:
        """Apply the deferred first tokens of pipelined admissions."""
        finished: List[int] = []
        for slots, reqs, tok in self._pending_admits:
            finished += self._apply_admit_tokens(slots, reqs, tok.numpy())
        self._pending_admits = []
        return finished

    def _admit_queued(self):
        """Admit queued requests into free slots: those sharing the
        head-of-line request's bucket prefill together; the others keep
        their order for the next group."""
        while self.queue:
            free = [s for s in range(self.n_slots)
                    if self.slot_req[s] is None]
            if not free:
                break
            Tb = self.queue[0].embeds.shape[1]
            take: List[_Request] = []
            rest: List[_Request] = []
            for r in self.queue:
                if r.embeds.shape[1] == Tb and len(take) < len(free):
                    take.append(r)
                else:
                    rest.append(r)
            self.queue = rest
            self._admit(take, free[:len(take)], Tb)

    def _active(self) -> List[int]:
        return [s for s in range(self.n_slots) if self.slot_req[s] is not None]

    def _choose_spec(self, active: List[int]) -> bool:
        """This tick's kind (``engine.py:986-1010``): speculation unless the
        adaptive controller says plain: while the engine is not quiet
        (the controller's state untouched), while it is off between probes,
        or for a plain calibration tick while it is live."""
        use_spec = bool(self.speculative_k)
        if not (use_spec and self.adaptive_spec):
            return use_spec
        if self._quiet_ticks <= self.spec_quiet_ticks:
            return False
        if not self._spec_live:
            self._ticks_since_probe += 1
            if active and self._ticks_since_probe \
                    >= self._spec_reprobe * self._reprobe_backoff:
                self._spec_live = True
                self._spec_probing = True
                self._ticks_since_probe = 0
                return True
            return False
        self._ticks_since_plain_probe += 1
        cadence = (self._spec_reprobe if self._dur_ema["plain"] is None
                   else 4 * self._spec_reprobe)
        if active and self._ticks_since_plain_probe >= cadence:
            self._ticks_since_plain_probe = 0
            return False
        return True

    @_on_engine
    def step(self) -> List[int]:
        """One engine tick; returns request ids finished during it.
        Pipelined: admit the queue, choose the tick's kind (draining the
        in-flight tick on a switch), queue this tick chained on the
        device's state, advance the mirrors, admit what arrived meanwhile,
        then consume the previous tick.  Sequential: queue the tick, admit,
        consume it."""
        if self._closed:
            raise RuntimeError("the engine is closed")
        expired = self._expire_deadlines()
        # the quiet gate's count: a queue at dispatch (or an admission,
        # which resets it) makes the tick not quiet
        self._quiet_ticks = 0 if self.queue else self._quiet_ticks + 1
        if self.pipeline_ticks and self.queue:
            # a new request's first decode rides this tick, not the next
            self._admit_queued()
        active = self._active()
        use_spec = self._choose_spec(active)
        kind = "spec" if use_spec else "plain"
        if (self.pipeline_ticks and self._inflight is not None and active
                and self._inflight[0] != kind):
            # a mode switch: the mirrors must be current before this
            # tick's dispatch reads them
            expired += self.flush()
            active = self._active()
        if use_spec and self._hist_dirty and active:
            # the resync rebuilds the histories from req.tokens: deferred
            # first tokens land first (one may retire a slot)
            expired += self._drain_pending_admits()
            active = self._active()
            if active:
                self._resync_spec_state(active)
            self._hist_dirty = False
        K = self.steps_per_tick
        write_pos = self.slot_pos.copy()
        outs = errs = None
        if active:
            if use_spec:
                self._n_spec_ticks += 1
                nsp = (self.speculative_k
                       if any(self.slot_sample[s] for s in active) else 1)
                dev_outs = self._dispatch_spec_tick(write_pos, nsp)
            else:
                self._n_plain_ticks += 1
                if self.speculative_k:
                    # plain ticks skip the histories' upkeep
                    self._hist_dirty = True
                dev_outs = self._dispatch_tick(write_pos)
                if self.pipeline_ticks:
                    self._cur_dev.copy_(dev_outs[K - 1])
            outs = _ToHost(dev_outs)
            errs = self._error_words()

        if self.pipeline_ticks:
            new_inflight = None
            if outs is not None:
                if not use_spec:
                    # optimistic host advance (a retired slot's state is
                    # zeroed by _finish; admissions overwrite a slot
                    # wholesale); a spec tick's advance is data-dependent:
                    # its slots' cursors move at consume
                    for s in active:
                        self.slot_mask[s, write_pos[s]:write_pos[s] + K] = 1
                        self.slot_pos[s] = min(self.slot_pos[s] + K,
                                               self.t_max)
                        self.slot_rope[s] += K
                new_inflight = (kind, outs, [(s, self.slot_req[s])
                                             for s in active], write_pos,
                                self._n_admissions, errs)
            # admissions queued before this tick drain now; the ones below
            # queue behind it and drain at the next consume
            pending = self._pending_admits
            self._pending_admits = []
            self._admit_queued()
            finished: List[int] = []
            for p_slots, p_reqs, p_tok in pending:
                finished += self._apply_admit_tokens(p_slots, p_reqs,
                                                     p_tok.numpy())
            if self._inflight is not None:
                p_kind, p_outs, slot_reqs, p_wpos, n_adm0, p_errs = \
                    self._inflight
                t0 = time.monotonic()
                self._check_error_words(p_errs)
                if p_kind == "spec":
                    finished += self._consume_spec_tick(
                        slot_reqs, p_outs, self.slot_pos.copy())
                else:
                    finished += self._consume_tick(p_outs, slot_reqs, p_wpos)
                self._record_tick_dur(p_kind, time.monotonic() - t0,
                                      clean=self._n_admissions == n_adm0)
            self._inflight = new_inflight
            return expired + finished

        n_adm0 = self._n_admissions
        self._admit_queued()
        if outs is None:
            return expired
        t0 = time.monotonic()
        self._check_error_words(errs)
        slot_reqs = [(s, self.slot_req[s]) for s in active]
        if use_spec:
            fin = self._consume_spec_tick(slot_reqs, outs, write_pos)
        else:
            fin = self._consume_tick(outs, slot_reqs, write_pos,
                                     advance=True)
        self._record_tick_dur(kind, time.monotonic() - t0,
                              clean=self._n_admissions == n_adm0)
        return expired + fin

    def _check_stop(self, req: _Request, tok: int) -> Optional[str]:
        """Per-token finish check: eos > stop token > stop string > length
        budget.  A stop match trims the result text at the match (the stop
        excluded)."""
        if tok in self._eos:
            return "eos"
        tk = self.model.tokenizer
        if tok in req.stop_token_ids:
            req.final_text = tk.decode(req.tokens[:-1],
                                       skip_special_tokens=True)
            return "stop"
        if req.stop_strs:
            # a window of len(stop) + 4 tokens covers a just-completed match
            w = 4 + max(len(s_) for s_ in req.stop_strs)
            tail = tk.decode(req.tokens[-w:], skip_special_tokens=True)
            for s_ in req.stop_strs:
                if s_ in tail:
                    full = tk.decode(req.tokens, skip_special_tokens=True)
                    j = full.rfind(s_)
                    req.final_text = full[:j] if j >= 0 else full
                    return "stop"
        if len(req.tokens) >= req.max_new_tokens:
            return "length"
        return None

    def _consume_tick(self, outs, slot_reqs, write_pos,
                      advance: bool = False) -> List[int]:
        """Host bookkeeping of a plain tick (its one wait for the device);
        ``advance`` (sequential engines) also moves the slots' cursors.
        Only the steps whose cache writes landed count; a slot that runs out
        of cache mid-tick finishes with "cache_full"."""
        K = self.steps_per_tick
        outs = outs.numpy()  # [K, n_slots]
        finished = []
        for s, req in slot_reqs:
            if req.done or self.slot_req[s] is not req:
                continue  # zombie tick of an already-retired request
            fin = None
            steps_ok = min(K, self.t_max - int(write_pos[s]))
            for j in range(steps_ok):
                tok = int(outs[j, s])
                req.tokens.append(tok)
                if self.on_token is not None:
                    self.on_token(req.rid, tok)
                fin = self._check_stop(req, tok)
                if fin:
                    break
            if fin is None and steps_ok < K:
                fin = "cache_full"
            if fin:
                finished.append(req.rid)
                self._finish(s, fin)
            elif advance:
                self.slot_mask[s, write_pos[s]:write_pos[s] + K] = 1
                self.slot_pos[s] += K
                self.slot_rope[s] += K
                self.cur_tok[s] = int(outs[K - 1, s])
        return finished

    def _consume_spec_tick(self, slot_reqs, outs, write_pos) -> List[int]:
        """Host bookkeeping of a spec tick (``engine.py:1231-1279``): the
        accepted tokens of each step, stop checks, ``cache_full`` past
        t_max - Kd, the slots' cursors and mask mirror moved by what they
        accepted (a later plain tick reads the mirror), and the adaptive
        controller's verdict on the tick's tokens a step.  ``write_pos``:
        each slot's cursor before the tick (a pipelined engine's lagged
        ``slot_pos`` at consume is that)."""
        K, Kd = self.steps_per_tick, self.speculative_k
        packed = outs.numpy()
        B = self.n_slots
        emits = packed[:, :B * Kd].reshape(K, B, Kd)
        ms = packed[:, B * Kd:]
        finished = []
        tot_acc = tot_steps = 0
        for s, req in slot_reqs:
            if req.done or self.slot_req[s] is not req:
                continue  # zombie tick of an already-retired request
            fin = None
            advanced = 0
            for j in range(K):
                m = int(ms[j, s])
                for t in emits[j, s, :m]:
                    tok = int(t)
                    req.tokens.append(tok)
                    if self.on_token is not None:
                        self.on_token(req.rid, tok)
                    fin = self._check_stop(req, tok)
                    if fin:
                        break
                advanced += m
                tot_acc += m
                tot_steps += 1
                if fin:
                    break
            if fin is None and int(write_pos[s]) + advanced \
                    > self.t_max - Kd:
                fin = "cache_full"
            if fin:
                finished.append(req.rid)
                self._finish(s, fin)
            else:
                wp = int(write_pos[s])
                self.slot_mask[s, wp:wp + advanced] = 1
                self.slot_pos[s] += advanced
                self.slot_rope[s] += advanced
                if advanced:
                    self.cur_tok[s] = req.tokens[-1]
        if self.adaptive_spec and tot_steps:
            self._spec_controller_update(tot_acc / tot_steps)
        return finished

    def _spec_controller_update(self, rate: float) -> None:
        """The adaptive controller's verdict on one spec tick's acceptance
        (tokens a verify step; ``engine.py:1281-1305``).  The bars are
        cost-aware once both tick durations are measured (speculation pays
        when acceptance > T_spec / T_plain: off below 0.98 of it, on from
        1.10 of it), the static ones until then.  A probe stays live only
        past the on bar; a refused probe doubles the backoff (capped at
        16), a passed one or a live -> off switch resets it."""
        ds, dp = self._dur_ema["spec"], self._dur_ema["plain"]
        be = max(1.0, ds / dp) if (ds and dp) else None
        off_bar = be * 0.98 if be is not None else self._spec_off
        on_bar = be * 1.10 if be is not None else self._spec_on
        if self._spec_probing:
            self._spec_probing = False
            self._spec_live = rate >= on_bar
            self._spec_ema = max(rate, on_bar)
            self._reprobe_backoff = (1 if self._spec_live else
                                     min(self._reprobe_backoff * 2, 16))
        else:
            self._spec_ema = 0.7 * self._spec_ema + 0.3 * rate
            if self._spec_live and self._spec_ema < off_bar:
                self._spec_live = False
                self._ticks_since_probe = 0
                self._spec_ema = on_bar
                self._reprobe_backoff = 1

    def _record_tick_dur(self, kind: str, dt: float, clean: bool):
        """EMA of the consume phase's wait a tick, by tick kind: the signal
        of the adaptive controller's bars; kept only when that controller is
        on, for ticks without an admission and past the 2 ms host floor."""
        if not (self.adaptive_spec and clean) or dt < 2e-3:
            return
        cur = self._dur_ema[kind]
        self._dur_ema[kind] = dt if cur is None else 0.7 * cur + 0.3 * dt

    def _resync_spec_state(self, active: List[int]) -> None:
        """Rebuild the active slots' n-gram histories (and, pipelined, the
        chained tokens, cache indices and positions) from the host's state
        before a spec tick that follows plain ones (``engine.py:1319-
        1350``); plain ticks do not keep them."""
        hcap = self.hist.shape[1]
        rows = np.zeros((len(active), hcap), np.int64)
        lens = np.zeros(len(active), np.int64)
        for i, s in enumerate(active):
            req = self.slot_req[s]
            ids = (np.asarray(req.prompt_ids, np.int64)
                   if req.prompt_ids is not None else np.zeros(0, np.int64))
            seq = np.concatenate([ids, np.asarray(req.tokens, np.int64)])
            if len(seq) > hcap:
                seq = seq[-hcap:]
            rows[i, :len(seq)] = seq
            lens[i] = len(seq)
            # req.tokens holds the last token: pipelined plain ticks chain
            # it on the device and never refresh the host's mirror
            self.cur_tok[s] = req.tokens[-1]
        dev = self.device
        sl = _to_device(np.asarray(active, np.int64), dev)
        self.hist.index_copy_(0, sl, _to_device(rows, dev))
        self.hlen.index_copy_(0, sl, _to_device(lens, dev))
        if self.pipeline_ticks:
            state = _to_device(np.stack([self.cur_tok, self.slot_pos,
                                         self.slot_rope]).astype(np.int64),
                               dev)
            self._cur_dev.copy_(state[0])
            self._ci_dev.copy_(state[1])
            self._pos_dev.copy_(state[2])

    def _finish(self, slot: int, reason: str = "eos"):
        req = self.slot_req[slot]
        if reason == "cache_full":
            req.truncated = True
        self.slot_req[slot] = None
        self._retire_unslotted(req, reason)
        self.slot_mask[slot] = 0
        self.slot_pos[slot] = 0
        self.slot_rope[slot] = 0
        self.inject_on[slot] = 0.0

    def run_until_done(self, max_ticks: int = 100000) -> Dict[int, str]:
        tk = self.model.tokenizer
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return {rid: tk.decode(toks, skip_special_tokens=True)
                for rid, toks in self.finished.items()}

    def results(self) -> Dict[int, Dict[str, Any]]:
        """{rid: {"text", "tokens", "finish_reason" ("eos" | "stop" |
        "length" | "cache_full" | "cancelled" | "deadline"), "truncated",
        "prompt_tokens"}}; ``truncated`` when the context was clipped or the
        cache filled first; a stop match's text trimmed at the match.
        Flushes the in-flight tick first."""
        self.flush()
        tk = self.model.tokenizer
        return {
            rid: {**info,
                  "text": info.get("text") if "text" in info
                  else tk.decode(info["tokens"], skip_special_tokens=True)}
            for rid, info in self.finished_info.items()
        }

    def close(self) -> None:
        """Free the decode graphs and their memory pools; the engine takes
        no more ticks."""
        self._closed = True
        for g in (self.graph, self.vgraph):
            if g is not None:
                g.close()
