"""KV-cached autoregressive decoding for the LLM (counterpart of
``desta25_audio_tpu/generate/decode.py:54-248``).

Prefill over the spliced context, then one token per step through the fused
decode step (on the card one CUDA graph replay a step, ``generate/graph.py``,
as the JAX package jits the body of its ``while_loop``), with greedy / temperature / nucleus (top-p) sampling and stop
tokens.  With ORCA deep injection (``inject_*`` arguments) the audio tokens
are RoPE'd and every layer's audio K/V projected once per request; the
prefill injects layer by layer in PyTorch, and the decode steps inject inside
the fused step when the LLM and the cross-attention stack hold int8 leaves
the kernels take, else layer by layer in PyTorch (``decode.py:151-198`` of
the JAX package): through the per-layer pair K9 with the opt-in (also one
CUDA graph a step on the card), else ``models/llm.py``'s layer loop.  The
loop keeps the JAX semantics: the cache is rounded up to a multiple of 128
positions, RoPE positions are ``cumsum(mask) - 1`` clamped
at 0 (left padding), every step writes its k/v at the same ``T + t`` for all
rows, rows that stopped emit ``pad_id``, and the loop ends early once every
row has stopped.  Under a mesh (``parallel/mesh.use_mesh`` with the LLM cut
for it) the cache is the ranks' slices and the steps run on every rank
(K10, also as one CUDA graph per card; else ``models/llm.py``'s layer
loop); the logits and sampling stay on the first rank's device.  Whisper
ASR decoding is not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..config import LLMConfig
from ..models import llm as tllm
from ..models.orca import gated_cross_attention_apply, precompute_cross_kv
from ..ops import _build
from ..ops.core import index_tree
from ..ops.fused_decode import (fused_decode_supported, fused_inject_supported,
                                tower_is_int8)
from ..ops.fused_decode_mesh import fused_mesh_takes
from ..ops.fused_decode_tp import fused_perlayer_supported
from ..ops.quant import is_quantized
from ..ops.rope import fractional_rope_apply
from ..parallel.mesh import current_mesh
from ..parallel.sharding import ShardedLLM
from .graph import DecodeGraph

# top-p runs on the 256 most likely candidates, normalised by the FULL-vocab
# logsumexp, so the nucleus cut is exact whenever it fits in 256 tokens
# (decode.py:44-54 of the JAX package; exact top-k here).
_TOP_P_CANDIDATES = 256


def _top_p_sample(scaled: torch.Tensor, generator: torch.Generator,
                  top_p: float) -> torch.Tensor:
    k = min(_TOP_P_CANDIDATES, scaled.shape[-1])
    topv, topi = torch.topk(scaled, k, dim=-1)
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(topv - lse)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p          # always keeps the first candidate
    masked = torch.where(keep, topv, torch.full_like(topv, float("-inf")))
    ch = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                           generator=generator)
    return torch.gather(topi, -1, ch)[:, 0]


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float, top_p: float,
                 do_sample: bool) -> torch.Tensor:
    """logits [B, V] f32 -> [B] int64."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(temperature, 1e-6)
    if top_p >= 1.0:  # pure temperature sampling over the full vocab
        return torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                 generator=generator)[:, 0]
    return _top_p_sample(scaled, generator, top_p)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_injection(cfg: LLMConfig, inject_params, inject_tokens,
                    inject_scale: float, inject_heads: int
                    ) -> Tuple[Callable, dict]:
    """ORCA deep injection for one request: RoPE the audio tokens
    [B, Ta, D] at positions ``i / inject_scale``, project every layer's
    audio K/V once, and return (extra_layer_fn(l, h) for ``llm_apply``, the
    ``inject`` spec of ``ops/fused_decode.py`` with bf16 K/V and
    ``on = ones(B)``)."""
    roped = fractional_rope_apply(inject_tokens, inject_scale,
                                  cfg.rope_theta)
    inj_k, inj_v = precompute_cross_kv(inject_params, roped)

    def extra_layer_fn(l, h):
        return gated_cross_attention_apply(
            index_tree(inject_params["layers"], l), h, None, inject_heads,
            cached_kv=(inj_k[l], inj_v[l]))

    B = inject_tokens.shape[0]
    spec = dict(params=inject_params, k=inj_k.to(torch.bfloat16),
                v=inj_v.to(torch.bfloat16), ta_real=inj_k.shape[2],
                heads=inject_heads,
                on=torch.ones(B, dtype=torch.float32,
                              device=inject_tokens.device))
    return extra_layer_fn, spec


def llm_generate(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                 attention_mask: torch.Tensor, generator: torch.Generator, *,
                 max_new_tokens: int, temperature: float = 1.0,
                 top_p: float = 1.0, do_sample: bool = False,
                 eos_ids: Sequence[int] = (), pad_id: int = 0,
                 timings: Optional[Dict[str, float]] = None,
                 inject_params=None, inject_tokens=None,
                 inject_scale: float = 2.5, inject_heads: int = 0,
                 decode_graph: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill + decode.  inputs_embeds [B, T, D] (left-padded context),
    attention_mask [B, T] 1/0.  Returns (tokens [B, max_new_tokens] int64,
    n_generated [B]); positions past a row's stop token hold ``pad_id``.

    inject_params / inject_tokens [B, Ta, D]: ORCA deep injection after
    every layer, in the prefill and every decode step (module docstring).

    timings: if given, filled with host-clock ``prefill_ms``, ``decode_ms``
    and ``decode_steps`` (synchronising the device at phase boundaries),
    with injection ``inject_kv_ms`` (RoPE + audio K/V projection), and
    with a captured decode step ``graph_capture_ms`` (inside ``decode_ms``).

    Where the fused decode step takes the request (``models/llm.
    decode_step``, or under a mesh K10 where ``fused_mesh_takes``
    holds; no per-layer hook without the in-kernel injection), and where
    the per-layer pair K9 takes a hooked step (the opt-in, ``ops/
    fused_decode_tp.fused_perlayer_supported``, one card), the steps run
    through a ``generate/graph.DecodeGraph``: on CUDA devices the first step
    eagerly, the rest as replays of one CUDA graph per card;
    ``decode_graph=False`` keeps every step eager (the comparison of the
    card tests and ``chip_smoke.py``).  Under a mesh the all-reduce's error
    words are read once, after the last step: a timed-out round raises
    RuntimeError there.
    """
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    extra_layer_fn = fused_spec = None
    if inject_params is not None:
        t0 = time.perf_counter()
        extra_layer_fn, spec = build_injection(
            cfg, inject_params, inject_tokens, inject_scale, inject_heads)
        if fused_inject_supported(params, cfg, inject_params, inject_heads,
                                  spec["ta_real"]):
            fused_spec = spec
        elif (tower_is_int8(params)
              and is_quantized(inject_params["layers"].get("q"))):
            # the int8 stack K8i takes, at a shape its limits refuse
            _build.count_fallback("fused_decode_inject")
        if timings is not None:
            _sync(dev)
            timings["inject_kv_ms"] = (time.perf_counter() - t0) * 1e3
    Tmax = -(-(T + max_new_tokens) // 128) * 128
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
    cur = sample_token(logits[:, -1], generator, temperature, top_p,
                       do_sample)
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timings["prefill_ms"] = (t1 - t0) * 1e3
    eos = torch.tensor(list(eos_ids), dtype=torch.long, device=dev)

    def is_eos(t):
        return (t[:, None] == eos[None, :]).any(-1)

    out = torch.full((B, max_new_tokens), pad_id, dtype=torch.long,
                     device=dev)
    out[:, 0] = cur
    done = is_eos(cur)
    pos = positions[:, -1] + 1
    steps = 0
    graph = None
    if extra_layer_fn is None or fused_spec is not None:
        if isinstance(params, ShardedLLM):      # under its mesh: K10
            fused = fused_mesh_takes(params, cfg, cache, fused_spec)
        else:
            fused = current_mesh() is None and fused_decode_supported(
                params, cfg, inputs_embeds[:, :1], cache)
        if fused:
            graph = DecodeGraph(params, cfg, mask, cache, fused_spec,
                                capture=decode_graph)
    elif (not isinstance(params, ShardedLLM) and current_mesh() is None
          and fused_perlayer_supported(params, cfg, cache)):
        # K9 (the opt-in) with the injection hook between its layers
        graph = DecodeGraph(params, cfg, mask, cache, None,
                            capture=decode_graph,
                            extra_layer_fn=extra_layer_fn)
    try:
        for t in range(max_new_tokens - 1):
            if bool(done.all()):
                break
            write_idx = T + t
            mask[:, write_idx] = 1
            if graph is not None:
                logits = graph.step(cur, pos, write_idx)
            else:
                logits, cache = tllm.llm_apply(
                    params, cfg, input_ids=cur[:, None], attention_mask=mask,
                    positions=pos[:, None], cache=cache,
                    cache_index=write_idx, extra_layer_fn=extra_layer_fn,
                    fused_injection=fused_spec)
                logits = logits[:, -1]
            nxt = sample_token(logits, generator, temperature, top_p,
                               do_sample)
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            out[:, t + 1] = nxt
            done = done | is_eos(nxt)
            pos = pos + 1
            cur = nxt
            steps += 1
        if graph is not None:
            graph.check()
        if timings is not None:
            _sync(dev)
            timings["decode_ms"] = (time.perf_counter() - t1) * 1e3
            timings["decode_steps"] = steps
            if graph is not None and graph.counts is not None:
                timings["graph_capture_ms"] = graph.capture_ms
    finally:
        if graph is not None:
            graph.close()
    n_gen = (out != pad_id).sum(-1)
    return out, n_gen
