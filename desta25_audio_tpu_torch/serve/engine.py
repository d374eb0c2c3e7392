"""Continuous-batching serving engine (counterpart of
``desta25_audio_tpu/serve/engine.py``, plain ticks).

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
  step()            -> one tick: ``steps_per_tick`` decode steps for every
                       slot, admission of queued requests, the tick's
                       tokens [K, n_slots] read by the host once
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
never by a new tensor, and every engine launch goes to the caller's
stream, so a queued tick reads the buffers as they were when it was queued.
Elsewhere (an f32 tower, ORCA's float stack) each step is
``models/llm.llm_apply`` with the injection between layers.  Sampling
(``generate/decode.sample_token_dynamic``), the mask bit of each step and
the stop flags run eagerly on the device between the steps, with no host
read until the tick's tokens are copied out.

Pipelining (``pipeline_ticks=True``, the default): admissions run before
the next tick is queued, that tick chains on the device-resident last
tokens, the host advances its mirrors optimistically, and the previous
tick's tokens (copied to pinned memory without blocking, behind an event)
are consumed after the next tick is queued.  A slot that finished runs one
more "zombie" tick whose tokens are discarded; an admission into it is
queued after that tick and overwrites the slot wholesale.  Greedy
trajectories are the same either way.

ORCA deep injection: each slot holds its audio tokens' per-layer K/V,
computed once at admission; the gated cross-attention runs after every
layer in the prefill and in every decode step, per slot ``where(on > 0,
out, h)`` (``on`` = 0 for text-only requests).  ORCA requests carry exactly
one audio each.

Not ported yet (ROADMAP.md Queue 1 item 3b): speculative ticks
(``speculative_k >= 2``) and the engine under a mesh; both raise
NotImplementedError.
"""

from __future__ import annotations

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
from ..models import llm as tllm
from ..models.orca import gated_cross_attention_apply, precompute_cross_kv
from ..ops import _build
from ..ops.core import index_tree
from ..ops.fused_decode import (
    fused_decode_supported,
    fused_inject_supported,
    tower_is_int8,
)
from ..ops.quant import is_quantized
from ..ops.rope import fractional_rope_apply
from ..parallel.mesh import current_mesh
from ..parallel.sharding import ShardedLLM

logger = logging.getLogger(__name__)

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1 item 3b)"


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
    prompt_ids: Any = None  # np [ctx_len] context ids (item 3b's n-gram seed)
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
    pinned memory behind an event, so that the wait for it (:meth:`numpy`)
    can come after more work is queued."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
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

        speculative_k >= 2 (and with it ``adaptive_spec`` and
        ``spec_quiet_ticks``) raises NotImplementedError, as does a model
        whose LLM is cut for a mesh: ROADMAP.md Queue 1 item 3b.

        on_overflow: "error" (the default) rejects a context longer than
        ``max_ctx`` with ValueError; "truncate" clips its left side and
        flags the request ``truncated``.

        pipeline_ticks: one-tick-lookahead dispatch (module docstring);
        False runs each tick and reads its tokens before the next.

        audio_cache: the model's per-clip feature cache capacity
        (``enable_audio_cache``; 0 turns it off).

        decode_graph: False runs every decode step eagerly through the
        same function and buffers (the comparison of the card's tests)."""
        if speculative_k >= 2:
            raise NotImplementedError(
                f"speculative serving ticks (speculative_k={speculative_k}) "
                + _NOT_PORTED)
        if (isinstance(model.params["llm"], ShardedLLM)
                or current_mesh() is not None):
            raise NotImplementedError("the serving engine under a mesh "
                                      + _NOT_PORTED)
        if on_overflow not in ("error", "truncate"):
            raise ValueError(f"on_overflow: {on_overflow!r} "
                             "(expected 'error' or 'truncate')")
        self.model = model
        model.enable_audio_cache(audio_cache)
        self.on_token = on_token
        self.cfg = cfg = model.llm_cfg
        self.device = dev = model.device
        self.dtype = model.dtype
        self.n_slots = n_slots
        self.max_ctx = max_ctx
        self.max_new = max_new_tokens
        self.ctx_bucket = ctx_bucket
        # every fused decode kernel plans for a cache of 128-multiple length
        self.t_max = -(-(max_ctx + max_new_tokens) // 128) * 128
        self.steps_per_tick = max(1, steps_per_tick)
        self.on_overflow = on_overflow
        self.adaptive_spec = False      # item 3b's controller
        self.pipeline_ticks = bool(pipeline_ticks)

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

        # the decode step's fixed device buffers
        self._mask = torch.zeros(n_slots, self.t_max, dtype=torch.int32,
                                 device=dev)
        self._on = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        self._cur_dev = torch.zeros(n_slots, dtype=torch.long, device=dev)
        self._extra = self._inject_fn(self.inject_k, self.inject_v, self._on)
        self._fspec = None
        if self._inject_len:
            heads = cfg.num_attention_heads
            llm = model.params["llm"]
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
        if self._extra is None or self._fspec is not None:
            x = torch.zeros(n_slots, 1, D, dtype=self.dtype, device=dev)
            if fused_decode_supported(model.params["llm"], cfg, x,
                                      self.cache):
                self.graph = DecodeGraph(model.params["llm"], cfg,
                                         self._mask, self.cache, self._fspec,
                                         capture=decode_graph)

        self._inflight = None   # (outs, [(slot, req)], write_pos, n_adm)
        # pipelined admissions whose first-token bookkeeping waits for the
        # consume phase: [(slots, reqs, first tokens on the host)]
        self._pending_admits: List[Tuple[List[int], List[_Request],
                                         _ToHost]] = []
        self._n_admissions = 0
        self._n_plain_ticks = 0
        self._dur_ema: Dict[str, Optional[float]] = {"spec": None,
                                                     "plain": None}
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
        """R same-bucket requests in one prefill (R a power of two; padded
        rows carry all-zero masks): (first tokens [R], the temporary cache,
        the rows' audio K/V or None)."""
        R, Tb = mask_h.shape
        dev = self.device
        mask = torch.as_tensor(mask_h, device=dev)
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
            extra_layer_fn=self._inject_fn(inj_k, inj_v, on))
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
            fused_injection=self._fspec)
        return logits[:, -1]

    def _dispatch_tick(self, write_pos: np.ndarray) -> torch.Tensor:
        """Queue one plain tick for every slot from the host mirrors (one
        copy each of the ints and the floats, made before the mirrors
        change again); pipelined engines chain on ``_cur_dev``.  Returns
        the tick's tokens [K, n_slots] on the device."""
        T = self.t_max
        ints = np.concatenate(
            [self.slot_mask, write_pos[:, None], self.slot_rope[:, None],
             self.slot_sample[:, None], self.cur_tok[:, None]],
            axis=1).astype(np.int64)
        floats = np.stack([self.slot_temp, self.slot_top_p, self.inject_on],
                          axis=1).astype(np.float32)
        ints, floats = (_to_device(ints, self.device),
                        _to_device(floats, self.device))
        self._mask.copy_(ints[:, :T])
        self._on.copy_(floats[:, 2])
        toks = self._cur_dev if self.pipeline_ticks else ints[:, T + 3]
        return decode_tick(self._step_logits, self._mask, toks,
                           ints[:, T + 1], ints[:, T].int(), self.generator,
                           floats[:, 0], floats[:, 1], ints[:, T + 2] > 0,
                           self._eos_dev, self.steps_per_tick)

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

    @torch.no_grad()
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

    @torch.no_grad()
    def flush(self) -> List[int]:
        """Consume the in-flight pipelined tick, if any, without queueing a
        new one; returns the request ids it finished.  The chained device
        state is untouched, so a later step() resumes the same
        trajectory.  A no-op for sequential engines."""
        fin0 = self._drain_pending_admits()
        if self._inflight is None:
            return fin0
        outs, slot_reqs, write_pos, _ = self._inflight
        self._inflight = None
        return fin0 + self._consume_tick(outs, slot_reqs, write_pos)

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
        buffers in place."""
        R = len(reqs)
        Rp = 1 << (R - 1).bit_length()
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
        as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        tok, pcache, inj_k, inj_v = self._prefill(
            embeds, mask, inject_kv, as_dev(on), as_dev(temp), as_dev(top_p),
            as_dev(do_sample))
        sl = torch.as_tensor(slots, dtype=torch.long, device=dev)
        self._place(sl, pcache, inj_k, inj_v)
        # the post-prefill rope position is the host's (last real position
        # ctx_len - 1); the first token is the only device-only state
        last_pos = np.maximum(mask.sum(axis=1) - 1, 0).astype(np.int32)
        for i, (req, s) in enumerate(zip(reqs, slots)):
            req.slot = s
            self.slot_req[s] = req
            self.slot_mask[s] = 0
            self.slot_mask[s, :Tb] = mask[i]
            self.slot_pos[s] = Tb
            self.slot_rope[s] = int(last_pos[i]) + 1
            self.slot_temp[s] = req.temperature
            self.slot_top_p[s] = req.top_p
            self.slot_sample[s] = req.do_sample
            self.inject_on[s] = on[i]
        self._n_admissions += 1
        first = _ToHost(tok[:R])
        if self.pipeline_ticks:
            # the admitted slots' chained tokens; the host bookkeeping
            # waits for the consume phase
            self._cur_dev.index_copy_(0, sl, tok[:R])
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
        if self._inject_len:
            Ta = self._inject_len
            self.inject_k[:, :, :Ta].index_copy_(1, sl, inj_k[:, :R])
            self.inject_v[:, :, :Ta].index_copy_(1, sl, inj_v[:, :R])

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

    @torch.no_grad()
    def step(self) -> List[int]:
        """One engine tick; returns request ids finished during it.
        Pipelined: admit the queue, queue this tick chained on the device's
        last tokens, advance the mirrors, admit what arrived meanwhile,
        then consume the previous tick.  Sequential: queue the tick, admit,
        consume it."""
        if self._closed:
            raise RuntimeError("the engine is closed")
        expired = self._expire_deadlines()
        if self.pipeline_ticks and self.queue:
            # a new request's first decode rides this tick, not the next
            self._admit_queued()
        active = [s for s in range(self.n_slots)
                  if self.slot_req[s] is not None]
        K = self.steps_per_tick
        write_pos = self.slot_pos.copy()
        outs = None
        if active:
            self._n_plain_ticks += 1
            dev_outs = self._dispatch_tick(write_pos)
            if self.pipeline_ticks:
                self._cur_dev.copy_(dev_outs[K - 1])
            outs = _ToHost(dev_outs)

        if self.pipeline_ticks:
            new_inflight = None
            if outs is not None:
                # optimistic host advance (a retired slot's state is zeroed
                # by _finish; admissions overwrite a slot wholesale)
                for s in active:
                    self.slot_mask[s, write_pos[s]:write_pos[s] + K] = 1
                    self.slot_pos[s] = min(self.slot_pos[s] + K, self.t_max)
                    self.slot_rope[s] += K
                new_inflight = (outs, [(s, self.slot_req[s])
                                       for s in active], write_pos,
                                self._n_admissions)
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
                p_outs, slot_reqs, p_wpos, n_adm0 = self._inflight
                t0 = time.monotonic()
                finished += self._consume_tick(p_outs, slot_reqs, p_wpos)
                self._record_tick_dur("plain", time.monotonic() - t0,
                                      clean=self._n_admissions == n_adm0)
            self._inflight = new_inflight
            return expired + finished

        n_adm0 = self._n_admissions
        self._admit_queued()
        if outs is None:
            return expired
        t0 = time.monotonic()
        fin = self._consume_tick(outs, [(s, self.slot_req[s])
                                        for s in active], write_pos,
                                 advance=True)
        self._record_tick_dur("plain", time.monotonic() - t0,
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

    def _record_tick_dur(self, kind: str, dt: float, clean: bool):
        """EMA of the consume phase's wait a tick, by tick kind: the signal
        of the adaptive speculation controller (item 3b); kept only when
        that controller is on, for ticks without an admission and past the
        2 ms host floor."""
        if not (self.adaptive_spec and clean) or dt < 2e-3:
            return
        cur = self._dur_ema[kind]
        self._dur_ema[kind] = dt if cur is None else 0.7 * cur + 0.3 * dt

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
        """Free the decode graph and its memory pool; the engine takes no
        more ticks."""
        self._closed = True
        if self.graph is not None:
            self.graph.close()
