"""KV-cached autoregressive decoding for the LLM and for Whisper ASR
(counterpart of ``desta25_audio_tpu/generate/decode.py``).

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
loop); the logits and sampling stay on the first rank's device.

Whisper ASR (``decode.py:251-446`` of the JAX package): the encoder, the
cross K/V once, the language detected from one step at ``<|sot|>``, the
4-token prefix, then one cached decoder step a token, greedy or sampled,
with the suppression lists of HF's generation config and the average
log-probability that gates the temperature-fallback cascade.  Its steps run
eagerly (plain torch products and ``ops/core.mha``, as the JAX package runs
XLA ops there); the loop ends once every row has emitted end-of-text, one
host check a step.
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LLMConfig, WhisperConfig
from ..models import llm as tllm
from ..models import whisper as tw
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

# OpenAI whisper's non-speech token ids (music and annotation symbols) of the
# multilingual BPE vocab: the text-range (< 50257) part of every HF whisper
# checkpoint's generation_config.suppress_tokens, the same from tiny to
# large-v3.  The special-token tail (>= 50257) is ``suppress_from``'s.
WHISPER_NON_SPEECH_TOKEN_IDS = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254,
)

# HF whisper generation_config.begin_suppress_tokens: the first sampled
# token may not be a bare space (220) or end-of-text.
WHISPER_BEGIN_SUPPRESS_TOKEN_IDS = (220,)

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


def _argmax_categorical(logits: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
    """One draw a row from softmax(logits) [B, n], -inf allowed: the argmax
    of logits - log(E), E ~ Exp(1) (the Gumbel-max rule), so that nothing
    reads a value back to the host (``torch.multinomial`` checks its input
    on the host)."""
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(
        1.0, generator=generator)
    return torch.argmax(logits.float() - torch.log(e), dim=-1)


def sample_token_dynamic(logits: torch.Tensor, generator: torch.Generator,
                         temperature: torch.Tensor, top_p: torch.Tensor,
                         do_sample: torch.Tensor) -> torch.Tensor:
    """Per-row sampling with the parameters as tensors (the JAX package's
    ``sample_token_dynamic``, ``decode.py:91-114``), so that one decode batch
    mixes greedy and sampled requests: logits [B, V] f32; temperature and
    top_p [B] f32, do_sample [B] bool on logits' device -> [B] int64.
    Greedy rows take the exact argmax; sampled rows with top_p < 1 the
    256-candidate nucleus normalised by the full-vocab logsumexp (as
    :func:`_top_p_sample`), those with top_p >= 1 the full-vocab categorical.
    Every row draws from ``generator`` (two draws a call), and no value
    reaches the host, so the call never blocks the stream."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    k = min(_TOP_P_CANDIDATES, scaled.shape[-1])
    topv, topi = torch.topk(scaled, k, dim=-1)
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(topv - lse)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p[:, None]
    masked = torch.where(keep, topv, torch.full_like(topv, float("-inf")))
    nucleus = torch.gather(topi, -1, _argmax_categorical(
        masked, generator)[:, None])[:, 0]
    full = _argmax_categorical(scaled, generator)
    sampled = torch.where(top_p >= 1.0, full, nucleus)
    return torch.where(do_sample, sampled, greedy)


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
                 decode_graph: bool = True, lora=None,
                 lora_scale: float = 1.0
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

    lora / lora_scale: LoRA adapters (``models/llm.init_lora``) on q, k
    and v; the prefill and every step then run ``models/llm.llm_apply``'s
    layer loop, eagerly, with the injection between layers
    (``decode.py:136-137,197,235`` of the JAX package).

    Without LoRA, where the fused decode step takes the request (``models/llm.
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
        # under LoRA the hook runs in the layer loop: no fused step takes it
        if lora is None and fused_inject_supported(
                params, cfg, inject_params, inject_heads, spec["ta_real"]):
            fused_spec = spec
        elif (lora is None and tower_is_int8(params)
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
                                   extra_layer_fn=extra_layer_fn, lora=lora,
                                   lora_scale=lora_scale)
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
    graph = None        # under LoRA every step runs the layer loop
    if lora is None and (extra_layer_fn is None or fused_spec is not None):
        if isinstance(params, ShardedLLM):      # under its mesh: K10
            fused = fused_mesh_takes(params, cfg, cache, fused_spec)
        else:
            fused = current_mesh() is None and fused_decode_supported(
                params, cfg, inputs_embeds[:, :1], cache)
        if fused:
            graph = DecodeGraph(params, cfg, mask, cache, fused_spec,
                                capture=decode_graph)
    elif (lora is None and not isinstance(params, ShardedLLM)
          and current_mesh() is None
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
                    fused_injection=fused_spec, lora=lora,
                    lora_scale=lora_scale)
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


def _blank(V: int, ids: Sequence[int], device,
           keep_below: Optional[int] = None, keep: int = -1) -> torch.Tensor:
    """An additive f32 mask [V]: -inf at ``ids``, and at every id from
    ``keep_below`` on except ``keep``; 0 elsewhere."""
    m = torch.zeros(V, dtype=torch.float32, device=device)
    if keep_below is not None:
        m[keep_below:] = float("-inf")
        if 0 <= keep < V:
            m[keep] = 0.0
    if ids:
        m[torch.as_tensor(list(ids), dtype=torch.long, device=device)] = \
            float("-inf")
    return m


def asr_decode(dec_params, cfg: WhisperConfig, enc_out: torch.Tensor, *,
               max_new_tokens: int = 128,
               language_token: Optional[int] = None,
               suppress_ids: Sequence[int] = (),
               suppress_from: Optional[int] = None,
               begin_suppress_ids: Sequence[int] = (),
               temperature: float = 0.0,
               generator: Optional[torch.Generator] = None,
               stats: Optional[dict] = None,
               step_logits: Optional[List[torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoding half of :func:`whisper_transcribe`, on the encoder's
    ``ln_post`` output [N, T_enc, D]; the cache takes its dtype.  stats, if
    given, gets ``asr_steps`` (cached steps after the prefix) and
    ``asr_decode_ms`` (host clock over those steps, device synchronised)
    added; step_logits, if given, gets each position's f32 logits [N, V] as
    the decoder gave them, before suppression (the prefix's last, then one a
    step)."""
    N, dev = enc_out.shape[0], enc_out.device
    ckv = tw.whisper_cross_kv(dec_params, enc_out, cfg)
    V, sot, eos = cfg.vocab_size, cfg.decoder_start_token_id, cfg.eos_token_id
    # ids beyond the vocab (the nano test vocabs) are dropped
    sup = _blank(V, [i for i in suppress_ids if i < V], dev, suppress_from,
                 eos)
    begin_ids = [i for i in begin_suppress_ids if i < V]
    begin = _blank(V, begin_ids + [eos], dev) if begin_ids else None
    if temperature > 0 and generator is None:
        raise ValueError("sampled ASR decode (temperature > 0) needs a "
                         "generator")

    if language_token is None:
        # one cache-less step from <|sot|>, argmax over the language block
        lg, _ = tw.whisper_decoder_apply(
            dec_params, torch.full((N, 1), sot, dtype=torch.long,
                                   device=dev), ckv, cfg)
        first = min(cfg.first_language_token_id, V - cfg.num_language_tokens)
        lang = first + lg[:, 0, first:first + cfg.num_language_tokens
                          ].argmax(-1)
    else:
        lang = torch.full((N,), language_token, dtype=torch.long, device=dev)
    col = lambda t: torch.full((N,), t, dtype=torch.long,  # noqa: E731
                               device=dev)
    prefix = torch.stack([col(sot), lang, col(cfg.transcribe_token_id),
                          col(cfg.no_timestamps_token_id)], 1)
    P = prefix.shape[1]
    cache = tw.init_decoder_cache(cfg, N, P + max_new_tokens,
                                  dtype=enc_out.dtype, device=dev)
    logits, cache = tw.whisper_decoder_apply(dec_params, prefix, ckv, cfg,
                                             pos_offset=0, cache=cache,
                                             cache_index=0)

    def pick(lg, first_token=False):
        """logits [N, V] f32 -> (token [N], its log-probability [N])."""
        if step_logits is not None:
            step_logits.append(lg)
        lg = lg + sup
        if first_token and begin is not None:
            lg = lg + begin
        if temperature > 0:
            tok = torch.multinomial(torch.softmax(lg / temperature, -1), 1,
                                    generator=generator)[:, 0]
        else:
            tok = lg.argmax(-1)
        return tok, torch.log_softmax(lg, -1).gather(-1, tok[:, None])[:, 0]

    cur, lp_sum = pick(logits[:, -1].float(), first_token=True)
    out = torch.full((N, max_new_tokens), eos, dtype=torch.long, device=dev)
    out[:, 0] = cur
    done = cur == eos
    n_tok = torch.ones(N, dtype=torch.float32, device=dev)
    if stats is not None:
        _sync(dev)
        t0 = time.perf_counter()
    t = 0
    while t < max_new_tokens - 1 and not bool(done.all()):
        lg, cache = tw.whisper_decoder_apply(
            dec_params, cur[:, None], ckv, cfg, pos_offset=P + t,
            cache=cache, cache_index=P + t)
        nxt, lp = pick(lg[:, -1].float())
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        live = (~done).float()
        done = done | (nxt == eos)
        out[:, t + 1] = nxt
        lp_sum = lp_sum + lp * live
        n_tok = n_tok + live
        cur = nxt
        t += 1
    if stats is not None:
        _sync(dev)
        stats["asr_decode_ms"] = (stats.get("asr_decode_ms", 0.0)
                                  + (time.perf_counter() - t0) * 1e3)
        stats["asr_steps"] = stats.get("asr_steps", 0) + t
    return out, lp_sum / n_tok


def whisper_transcribe(params, cfg: WhisperConfig, mel: torch.Tensor,
                       **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """ASR decode (the JAX package's ``whisper_transcribe``; the reference's
    ASR in the loop, modeling_desta25.py:1586-1594): greedy at temperature
    0, multinomial sampling from ``generator`` otherwise.

    params: the Whisper tree (``encoder`` and ``decoder``); mel
    [N, 3000, n_mels].  The prefix is <|sot|> <|lang|> <|transcribe|>
    <|notimestamps|>, the language detected from one decoder step when
    ``language_token`` is None.  ``suppress_from`` blanks every id from it
    on but end-of-text, ``suppress_ids`` an explicit list, and the first
    token may not be one of ``begin_suppress_ids`` or end-of-text (when that
    list is given).  Keyword arguments as :func:`asr_decode`.

    Returns (ids [N, max_new_tokens] int64 padded with end-of-text, the
    average log-probability [N] of the emitted tokens, end-of-text
    included)."""
    enc_out, _ = tw.whisper_encoder_apply(params["encoder"], mel, cfg)
    return asr_decode(params["decoder"], cfg, enc_out, **kwargs)


def compression_ratio(text: str) -> float:
    """Bytes over gzip'd bytes; above ~2.4 flags a degenerate repetition
    loop (OpenAI whisper's quality gate)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def whisper_transcribe_with_fallback(
        params, cfg: WhisperConfig, mel: torch.Tensor, detokenize,
        generator: Optional[torch.Generator] = None, *,
        temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        logprob_threshold: float = -1.0,
        compression_ratio_threshold: float = 2.4,
        stats: Optional[dict] = None, **kwargs):
    """Temperature-fallback ASR cascade (OpenAI whisper transcribe.py; the
    JAX package's ``whisper_transcribe_with_fallback``).

    Each tier decodes the whole mel batch at its temperature; the rows whose
    previous result failed the gate (average log-probability below
    ``logprob_threshold`` or compression ratio above
    ``compression_ratio_threshold``) take the new tier's.  The sampled tiers
    draw from ``generator``, one made on mel's device and seeded with 0 when
    None is given, so the same inputs give the same texts.
    ``detokenize(ids [N, T] numpy) -> list[str]``.  stats, if given, gets
    :func:`asr_decode`'s keys added and ``asr_retried``: for each tier
    after the first that ran, the rows it decoded again.  Returns (texts,
    ids [N, T] numpy, average log-probabilities [N] numpy)."""
    if generator is None:
        generator = torch.Generator(mel.device).manual_seed(0)
    n = mel.shape[0]
    texts: list = [None] * n
    best_ids = None
    best_lp = np.full((n,), -np.inf, np.float32)
    pending = np.arange(n)
    retried: List[List[int]] = []
    for ti, temp in enumerate(temperatures):
        if ti:
            retried.append(pending.tolist())
        ids, lp = whisper_transcribe(params, cfg, mel,
                                     temperature=float(temp),
                                     generator=generator, stats=stats,
                                     **kwargs)
        ids, lp = ids.cpu().numpy(), lp.float().cpu().numpy()
        tier_texts = detokenize(ids)
        if best_ids is None:
            best_ids = ids.copy()
        failed = []
        for i in pending:
            texts[i] = tier_texts[i]
            best_ids[i] = ids[i]
            best_lp[i] = lp[i]
            bad = (lp[i] < logprob_threshold
                   or compression_ratio(tier_texts[i])
                   > compression_ratio_threshold)
            if bad and ti + 1 < len(temperatures):
                failed.append(i)
        pending = np.asarray(failed, int)
        if pending.size == 0:
            break
    if stats is not None:
        stats["asr_retried"] = retried
    return texts, best_ids, best_lp
