"""Speculative decoding (greedy and sampled): n-gram drafting plus a fused
multi-token verify step (counterpart of
``desta25_audio_tpu/generate/speculative.py``).

The decode step is bound by its weight stream, so verifying ``k`` tokens per
row in one stream costs little more than one token.  Each step drafts k-1
tokens per row by prompt lookup (the continuation of the most recent earlier
occurrence of the row's last trigram, else bigram, else a repeat of the last
token), verifies [last token, drafts] in one ``fused_verify_layers`` step,
and accepts the longest draft prefix that matches the model's own choices.
Under a mesh the verify step is the tensor-parallel one
(``ops/fused_decode_mesh.pick_verify_fn``); sampling and the acceptance run
on the first rank's device.

Acceptance semantics (``speculative.py:1-34`` of the JAX package): each
verify position j draws its token from the model's processed next-token
distribution at j (argmax when greedy, a temperature/top-p sample
otherwise), and the draft is accepted up to the first position where the
drawn token differs from it; the drawn token there is emitted.  With a
deterministic drafter this is exact speculative sampling, so the output
distribution is that of plain sampling.  Not bit-identical to the
sequential loop in general: a verified token attends its in-flight
predecessors through the verify step's f32 draft block, while the
sequential loop reads them back from the bf16 cache, so a near-tied argmax
can resolve differently.  Sampled draws come from the caller's
``torch.Generator``.

The loop keeps its state on the device and syncs with the host once per
verify step (whether every row has stopped), as the plain loop does once
per token (``generate/decode.py``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import LLMConfig
from ..models import llm as tllm
from ..ops import _build
from ..ops.core import rms_norm
from ..ops.fused_decode import (
    fused_decode_limits,
    fused_inject_limits,
    tower_is_int8,
)
from ..ops.fused_decode_mesh import fused_mesh_limits, pick_verify_fn
from ..parallel.sharding import ShardedLLM
from .decode import _sync, build_injection, sample_token


def ngram_propose(hist: torch.Tensor, hlen: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Draft ``k`` tokens per row by longest-suffix prompt lookup.

    hist [B, Th] emitted-token history (prompt ids + generated), anything
    past ``hlen`` is padding; hlen [B] valid lengths.  Finds the most recent
    earlier occurrence of the last trigram (``hist[hlen-3:hlen]``) and
    proposes the ``k`` tokens that followed it; backs off to the last
    bigram, and to repeating the last token when neither recurs.  A
    continuation that runs past the history repeats the last token there.
    """
    B, Th = hist.shape
    dev = hist.device
    n = hlen.long()[:, None]                                   # [B, 1]

    def at(i):
        return torch.gather(hist, 1, torch.clamp(i, min=0))     # [B, 1]

    cur, prev, prev2 = at(n - 1), at(n - 2), at(n - 3)
    i_idx = torch.arange(Th - 1, device=dev)[None, :]
    h0, nxt = hist[:, :-1], hist[:, 1:]                 # h[i], h[i+1]
    prv = torch.roll(hist, 1, dims=1)[:, :-1]           # h[i-1] (i=0 masked)
    match2 = ((h0 == prev) & (nxt == cur) & (i_idx + 1 < n - 1) & (n >= 2))
    match3 = match2 & (prv == prev2) & (i_idx >= 1) & (n >= 3)
    none = torch.full_like(i_idx, -1).expand(B, -1)
    best3 = torch.where(match3, i_idx, none).amax(1)
    best2 = torch.where(match2, i_idx, none).amax(1)
    best = torch.where(best3 >= 0, best3, best2)
    start = torch.clamp(best + 2, 0, Th - k)
    cpos = start[:, None] + torch.arange(k, device=dev)[None, :]
    cand = torch.gather(hist, 1, cpos)
    return torch.where((best >= 0)[:, None] & (cpos < n), cand, cur)


def spec_limits(params, cfg: LLMConfig, batch: int, cache_len: int,
                speculative_k: int, dtype, inject_params=None,
                inject_heads: int = 0, inject_len: int = 0) -> List[str]:
    """Why the verify kernel cannot run this request (empty: it can):
    the decode step's predicate (``ops/fused_decode.fused_decode_limits``:
    bf16 activations and cache, a bf16 or int8 tower, the shape limits of
    ``csrc/fused_decode.cu`` planned at the card's SM count) at
    ``speculative_k`` tokens per row and a cache of ``cache_len``
    positions, the cache in ``dtype``.  With ORCA injection
    (``inject_params``, ``inject_len`` audio tokens) the verify step runs
    it inside, which needs the int8 tower and a stack the injection kernels
    take (``fused_inject_limits``; ``desta.py:619-628`` of the JAX
    package).  For an LLM cut for a mesh, the tensor-parallel verify
    step's conditions (``ops/fused_decode_mesh.fused_mesh_limits``)."""
    bad = []
    if speculative_k < 2:
        bad.append(f"speculative_k={speculative_k} (needs >= 2)")
    if isinstance(params, ShardedLLM):
        # under a mesh: the tensor-parallel verify step's conditions
        if dtype != torch.bfloat16:
            bad.append(f"dtype {dtype} (the kernels take bfloat16)")
        return bad + fused_mesh_limits(
            params, cfg, batch, cache_len, speculative_k, inject_params,
            inject_len, inject_heads, dtype)
    int8 = tower_is_int8(params)
    if inject_params is not None:
        if not int8:
            bad.append("ORCA injection in the verify step needs the int8 "
                       "LLM (apply_llm_quant)")
        bad += fused_inject_limits(inject_params, cfg, inject_heads,
                                   inject_len, speculative_k)
    # the decode step's predicate at Kd tokens a row, on the tower's card
    return bad + fused_decode_limits(
        params, cfg, dtype, batch, speculative_k, cache_len, dtype,
        _build.sm_count(params["embed"].device))


def spec_generate_supported(params, cfg: LLMConfig, batch: int,
                            cache_len: int, speculative_k: int,
                            dtype=torch.bfloat16) -> bool:
    """Can the speculative loop run this request on the port's kernels?"""
    return not spec_limits(params, cfg, batch, cache_len, speculative_k,
                           dtype)


def left_aligned(ids: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Left-padded prompt ids [B, T] with ``lens`` [B] real tokens each ->
    the same rows left-aligned (the n-gram history's layout; the JAX
    package rolls each row by ``lens - T``)."""
    T = ids.shape[1]
    src = (np.arange(T)[None, :] + T - np.asarray(lens)[:, None]) % T
    return np.take_along_axis(ids, src, axis=1)


def spec_cache_len(T: int, max_new_tokens: int, speculative_k: int) -> int:
    """The loop's cache: prompt + budget + one verify block, rounded up to
    128 positions, so every write ci..ci+k-1 lands inside it."""
    return -(-(T + max_new_tokens + speculative_k) // 128) * 128


def llm_generate_spec(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                      attention_mask: torch.Tensor,
                      generator: torch.Generator, *, max_new_tokens: int,
                      eos_ids: Sequence[int] = (), pad_id: int = 0,
                      speculative_k: int = 4, temperature: float = 1.0,
                      top_p: float = 1.0, do_sample: bool = False,
                      prompt_ids: Optional[torch.Tensor] = None,
                      prompt_lens: Optional[torch.Tensor] = None,
                      timings: Optional[Dict[str, float]] = None,
                      return_stats: bool = False, inject_params=None,
                      inject_tokens=None, inject_scale: float = 2.5,
                      inject_heads: int = 0):
    """Prefill + speculative decode.  Same contract as ``llm_generate``:
    returns (tokens [B, max_new_tokens] int64, n_generated [B]); a stop
    token stays in the output and later positions hold ``pad_id``.

    prompt_ids [B, Tp] (left-aligned, ``prompt_lens`` [B] valid lengths)
    seed the n-gram history; generated tokens always extend it.  timings,
    if given, gets host-clock ``prefill_ms``, ``decode_ms``,
    ``decode_steps`` (verify steps) and ``spec_tokens`` (tokens the verify
    steps emitted), and with injection ``inject_kv_ms``.  return_stats
    appends (verify steps, tokens emitted by them) to the result.
    inject_*: ORCA deep injection as in ``llm_generate``; the prefill
    injects layer by layer, every verify step inside the kernel (the caller
    checks ``spec_limits``; the wrapper raises on what it cannot take).
    """
    Kd = speculative_k
    if Kd < 2:
        raise ValueError(f"speculative_k={Kd}: the spec loop needs >= 2")
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    extra_layer_fn = fspec = None
    if inject_params is not None:
        t0 = time.perf_counter()
        extra_layer_fn, fspec = build_injection(
            cfg, inject_params, inject_tokens, inject_scale, inject_heads)
        if timings is not None:
            _sync(dev)
            timings["inject_kv_ms"] = (time.perf_counter() - t0) * 1e3
    Tmax = spec_cache_len(T, max_new_tokens, Kd)
    cache = tllm.init_kv_cache(cfg, B, Tmax, dtype=inputs_embeds.dtype,
                               device=dev)
    mask = torch.zeros(B, Tmax, dtype=torch.int32, device=dev)
    mask[:, :T] = attention_mask.to(torch.int32)
    positions = torch.clamp(torch.cumsum(mask[:, :T], dim=1) - 1, min=0)

    t0 = time.perf_counter()
    logits, cache = tllm.llm_apply(params, cfg, inputs_embeds=inputs_embeds,
                                   attention_mask=mask, positions=positions,
                                   cache=cache, cache_index=0,
                                   extra_layer_fn=extra_layer_fn)
    tok0 = sample_token(logits[:, -1], generator, temperature, top_p,
                        do_sample)
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timings["prefill_ms"] = (t1 - t0) * 1e3
    eos = torch.tensor(list(eos_ids), dtype=torch.long, device=dev)

    def is_eos(t):
        return (t[..., None] == eos).any(-1)

    # every slot >= T is marked valid: the verify step admits only keys
    # below each row's write position anyway
    mask[:, T:] = 1

    # n-gram history [prompt ids | generated], Kd slack so writes at
    # hlen..hlen+Kd-1 stay in range
    Tp = 0 if prompt_ids is None else prompt_ids.shape[1]
    hist = torch.full((B, Tp + max_new_tokens + Kd), -1, dtype=torch.long,
                      device=dev)
    hlen = torch.zeros(B, dtype=torch.long, device=dev)
    if prompt_ids is not None:
        hist[:, :Tp] = prompt_ids.to(dev)
        hlen = (torch.full_like(hlen, Tp) if prompt_lens is None
                else prompt_lens.to(dev).long())
    rows = torch.arange(B, device=dev)
    hist[rows, hlen] = tok0
    hlen = hlen + 1
    out = torch.full((B, max_new_tokens + Kd), pad_id, dtype=torch.long,
                     device=dev)
    out[:, 0] = tok0

    t = torch.ones(B, dtype=torch.long, device=dev)   # emitted per row
    cur = tok0
    done = is_eos(tok0)
    ci = torch.full((B,), T, dtype=torch.long, device=dev)
    pos = positions[:, -1] + 1
    jidx = torch.arange(Kd, device=dev)[None, :]
    steps = 0
    accepted = torch.zeros((), dtype=torch.long, device=dev)
    verify = pick_verify_fn(
        params, cfg, cache, Kd, inject_params,
        0 if fspec is None else fspec["ta_real"], inject_heads)
    if verify is None:
        raise ValueError("llm_generate_spec: the verify kernels cannot take "
                         "this request under the mesh (spec_limits says why)")
    while not bool(done.all()):
        draft = ngram_propose(hist, hlen, Kd - 1)
        toks = torch.cat([cur[:, None], draft], dim=1)          # [B, Kd]
        hidden, cache = verify(
            params, cfg, tllm.embed_tokens(params, toks), mask,
            pos[:, None] + jidx, cache, ci, inject=fspec)
        lg = tllm.head_logits(params, rms_norm(params["norm"], hidden,
                                               cfg.rms_norm_eps))
        if do_sample:
            # one draw per verify position, all B*Kd in one sampler pass
            g = sample_token(lg.reshape(B * Kd, -1), generator, temperature,
                             top_p, True).reshape(B, Kd)
        else:
            g = torch.argmax(lg, dim=-1)
        match = (toks[:, 1:] == g[:, :-1]).long()
        m = 1 + torch.cumprod(match, dim=1).sum(1)
        # stop at the first accepted stop token; respect the budget
        eos_pos = torch.where(is_eos(g) & (jidx < m[:, None]), jidx,
                              torch.full_like(jidx, Kd)).amin(1)
        m = torch.minimum(m, eos_pos + 1)
        m = torch.minimum(m, max_new_tokens - t)
        m = torch.where(done, torch.zeros_like(m), torch.clamp(m, min=0))
        # all Kd candidates are written; those past m are pad_id and the
        # next step (starting at t + m) overwrites them
        emit = torch.where((jidx < m[:, None]) & ~done[:, None], g,
                           torch.full_like(g, pad_id))
        out.scatter_(1, t[:, None] + jidx, emit)
        hist.scatter_(1, hlen[:, None] + jidx, emit)
        nxt = torch.gather(g, 1, torch.clamp(m - 1, min=0)[:, None])[:, 0]
        cur = torch.where(done, cur, nxt)
        done = done | (eos_pos < m) | (t + m >= max_new_tokens)
        t, hlen, ci, pos = t + m, hlen + m, ci + m, pos + m
        accepted = accepted + m.sum()
        steps += 1
    out = out[:, :max_new_tokens]
    n_gen = (out != pad_id).sum(-1)
    if timings is not None:
        _sync(dev)
        timings["decode_ms"] = (time.perf_counter() - t1) * 1e3
        timings["decode_steps"] = steps
        timings["spec_tokens"] = int(accepted)
    if return_stats:
        return out, n_gen, steps, int(accepted)
    return out, n_gen
