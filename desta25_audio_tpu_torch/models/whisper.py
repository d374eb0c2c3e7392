"""Whisper encoder with layer taps and the decoder for ASR in the loop
(counterpart of ``desta25_audio_tpu/models/whisper.py``).

Encoder (``whisper.py:276-347`` of the JAX package): conv1 -> gelu -> conv2
(stride 2) -> gelu -> + sinusoidal positions -> pre-LN layers, each
``x + attn(ln1(x))`` then ``x + ffn(ln2(x))``, with the hidden state after
each target layer collected as a tap (pre final LN, what the connector
consumes).  Mel input is NWC ([B, frames, n_mels]) as in the JAX package.

Decoder (``whisper.py:350-456``): learned positions, pre-LN layers of causal
self-attention (written into a per-layer cache when one is given),
cross-attention on K/V precomputed once from the encoder's ``ln_post``
output (:func:`whisper_cross_kv`) and the GELU FFN, the final LayerNorm and
logits from the tied ``embed_tokens`` with f32 sums.  It reaches no Pallas
kernel in the JAX package (XLA products and ``ops/core.mha``), so here it is
plain torch products and the port's ``ops/core.mha``.  Positions past the
learned table read its last row, as JAX's clamped gather does.

Kernels, with the JAX package's dispatch (``whisper.py:167-273``):

- self-attention: K2 ``packed_encoder_attention`` between the projections.
  With int8 attention leaves (``ops/quant.quantize_encoder_params``) the
  projections are the W8A8 kernels K5 ``qkv_w8a8`` and K6 ``proj_w8a8``
  when the leaves have no bf16 ``w`` or the encoder batch is at most
  ``INT8_ATTN_MAXB`` (env ``DESTA_ENC_ATTN_INT8_MAXB``, default 2);
  otherwise ``linear`` on ``w``.
- FFN: K3 ``encoder_ffn`` when ``fc1`` has a bf16 ``w``, K4
  ``encoder_ffn_w8a8`` when it has int8 ``q``.

Each kernel runs only where its predicate holds, as in the JAX package:
``T >= ENC_KERNEL_MIN_T`` and the kernel's own limits
(``enc_attention_supported``, ``w8a8_proj_supported``,
``enc_ffn_supported``, ``enc_ffn_w8a8_supported``: Dh = 64, widths that
are whole tiles, bf16).  Elsewhere (the nano towers, float32 models) the
JAX package's XLA path runs in torch: ``linear`` (an int8 leaf by
``int8_act_matmul``'s formula) around ``ops/attention.mha``, and
``linear(fc2, gelu(linear(fc1, h)))`` (int8 weights dequantized first),
each such call counted by ``_build.count_fallback`` under the kernel's
name.  The decision reads shapes and dtypes only; a kernel that is chosen
and fails still raises.

Parameters: stacked layers (leading layer axis), linear weights
``[out, in]``, conv weights ``[out, in, 3]``.
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import WhisperConfig
from ..ops import _build
from ..ops.attention import mha
from ..ops import core
from ..ops.core import (Params, conv1d, gelu, index_tree, layer_norm, linear,
                        matmul_f32)
from ..ops.enc_attention import (
    enc_attention_supported,
    packed_encoder_attention,
)
from ..ops.enc_ffn import (
    enc_ffn_supported,
    enc_ffn_w8a8_supported,
    encoder_ffn,
    encoder_ffn_w8a8,
)
from ..ops.quant import dequantize_weight, int8_act_linear, is_quantized
from ..ops.w8a8_proj import proj_w8a8, qkv_w8a8, w8a8_proj_supported


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper sinusoid table (matches openai/HF ``sinusoids``)."""
    log_timescale = math.log(10000.0) / (dim // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


def _uniform(shape, bound, dtype, device, generator):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        -bound, bound, generator=generator)


def init_linear_stack(L: int, d_in: int, d_out: int, dtype, device,
                      generator, bias: bool = True) -> Params:
    """The JAX package's init bounds: sqrt(3/fan_in) for weights,
    1/sqrt(fan_in) for biases (ops/core.py kaiming_uniform, uniform_bias);
    leading layer axis L (0 = no layer axis)."""
    lead = (L,) if L else ()
    p = {"w": _uniform(lead + (d_out, d_in), math.sqrt(3.0 / d_in), dtype,
                       device, generator)}
    if bias:
        p["b"] = _uniform(lead + (d_out,), 1.0 / math.sqrt(d_in), dtype,
                          device, generator)
    return p


def init_layer_norm_stack(L: int, d: int, dtype, device) -> Params:
    return {"scale": torch.ones(L, d, dtype=dtype, device=device),
            "bias": torch.zeros(L, d, dtype=dtype, device=device)}


def init_whisper_encoder(cfg: WhisperConfig, dtype, device,
                         generator: torch.Generator) -> Params:
    L, d, Fd = cfg.encoder_layers, cfg.d_model, cfg.encoder_ffn_dim
    lin = lambda i, o, bias=True: init_linear_stack(  # noqa: E731
        L, i, o, dtype, device, generator, bias)

    def conv(c_in, c_out):
        fan_in = c_in * 3
        return {"w": _uniform((c_out, c_in, 3), math.sqrt(3.0 / fan_in),
                              dtype, device, generator),
                "b": _uniform((c_out,), 1.0 / math.sqrt(fan_in), dtype,
                              device, generator)}

    ln1 = init_layer_norm_stack(L, d, dtype, device)
    ln2 = init_layer_norm_stack(L, d, dtype, device)
    return {
        "conv1": conv(cfg.num_mel_bins, d),
        "conv2": conv(d, d),
        "embed_positions": torch.as_tensor(
            sinusoidal_positions(cfg.max_source_positions, d)).to(
                device=device, dtype=dtype),
        "layers": {
            "ln1": ln1,
            "attn": {"q": lin(d, d), "k": lin(d, d, bias=False),
                     "v": lin(d, d), "o": lin(d, d)},
            "ln2": ln2,
            "fc1": lin(d, Fd),
            "fc2": lin(Fd, d),
        },
        "ln_post": {"scale": torch.ones(d, dtype=dtype, device=device),
                    "bias": torch.zeros(d, dtype=dtype, device=device)},
    }


def init_whisper_decoder(cfg: WhisperConfig, dtype, device,
                         generator: torch.Generator) -> Params:
    """Random decoder (the JAX package's ``init_whisper_decoder``):
    N(0, 0.02) token and position embeddings, the linear init bounds of
    :func:`init_linear_stack`, unit LayerNorms; stacked layers."""
    L, d, Fd = cfg.decoder_layers, cfg.d_model, cfg.decoder_ffn_dim
    lin = lambda i, o, bias=True: init_linear_stack(  # noqa: E731
        L, i, o, dtype, device, generator, bias)

    def normal(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=generator)

    def attn():
        return {"q": lin(d, d), "k": lin(d, d, bias=False), "v": lin(d, d),
                "o": lin(d, d)}

    return {
        "embed_tokens": normal(cfg.vocab_size, d),
        "embed_positions": normal(cfg.max_target_positions, d),
        "layers": {
            "ln1": init_layer_norm_stack(L, d, dtype, device),
            "self_attn": attn(),
            "ln_x": init_layer_norm_stack(L, d, dtype, device),
            "cross_attn": attn(),
            "ln2": init_layer_norm_stack(L, d, dtype, device),
            "fc1": lin(d, Fd),
            "fc2": lin(Fd, d),
        },
        "ln": {"scale": torch.ones(d, dtype=dtype, device=device),
               "bias": torch.zeros(d, dtype=dtype, device=device)},
    }


def init_whisper(cfg: WhisperConfig, dtype, device,
                 generator: torch.Generator) -> Params:
    """Encoder and decoder, drawn in that order from ``generator``."""
    return {"encoder": init_whisper_encoder(cfg, dtype, device, generator),
            "decoder": init_whisper_decoder(cfg, dtype, device, generator)}


# The largest encoder batch at which "dual" attention leaves take the W8A8
# arm: the JAX package's DESTA_ENC_ATTN_INT8_MAXB (default 2), read once
# here as JAX reads it once per traced shape.
INT8_ATTN_MAXB = int(os.environ.get("DESTA_ENC_ATTN_INT8_MAXB", "2"))


def int8_attention(a: Params, batch: int) -> bool:
    """The JAX package's per-batch arm choice (``whisper.py:190-193``):
    int8 leaves without a bf16 ``w`` always take the W8A8 arm; "dual"
    leaves take it up to :data:`INT8_ATTN_MAXB`."""
    return is_quantized(a["q"]) and ("w" not in a["q"]
                                     or batch <= INT8_ATTN_MAXB)


# The encoder's kernels run from this many frames (the JAX dispatch's
# ``x.shape[1] >= 512``, whisper.py:177 and :253)
ENC_KERNEL_MIN_T = 512


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``core.linear``: a float leaf, or an int8 leaf
    without ``w`` by ``int8_act_matmul``'s formula."""
    return linear(p, x) if "w" in p else int8_act_linear(p, x)


def _attn(a: Params, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The JAX package's torch-side attention (``whisper.py:148-157``):
    projections, then ``ops/attention.mha`` on [B, T, H, Dh]."""
    B, T, D = h.shape
    q, k, v = (_linear(a[n], h).reshape(B, T, n_heads, D // n_heads)
               for n in ("q", "k", "v"))
    return _linear(a["o"], mha(q, k, v).reshape(B, T, D))


def _enc_self_attn(a: Params, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, D = h.shape
    if not (T >= ENC_KERNEL_MIN_T
            and enc_attention_supported(n_heads, D, h.dtype)):
        _build.count_fallback("packed_encoder_attention")
        return _attn(a, h, n_heads)
    if int8_attention(a, B):
        if not w8a8_proj_supported(D, a["q"]["q"].shape[0], h.dtype):
            _build.count_fallback("qkv_w8a8")
            return _attn(a, h, n_heads)
        q, k, v = qkv_w8a8(h, a["q"], a["k"], a["v"])
        return proj_w8a8(packed_encoder_attention(q, k, v, n_heads), a["o"])
    q, k, v = linear(a["q"], h), linear(a["k"], h), linear(a["v"], h)
    return linear(a["o"], packed_encoder_attention(q, k, v, n_heads))


def _enc_ffn(p: Params, h: torch.Tensor) -> torch.Tensor:
    fc1, fc2 = p["fc1"], p["fc2"]
    D, T = h.shape[-1], h.shape[1]
    if "w" in fc1:
        if T >= ENC_KERNEL_MIN_T and enc_ffn_supported(D, fc1["w"].shape[0],
                                                       h.dtype):
            return encoder_ffn(h, fc1["w"], fc1["b"], fc2["w"], fc2["b"])
        _build.count_fallback("encoder_ffn")
    else:
        if T >= ENC_KERNEL_MIN_T and enc_ffn_w8a8_supported(
                D, fc1["q"].shape[0], h.dtype):
            return encoder_ffn_w8a8(h, fc1["q"], fc1["s"], fc1["b"],
                                    fc2["q"], fc2["s"], fc2["b"])
        # the JAX package's _xla_ffn_w8a8: dequantized weights, XLA's FFN
        _build.count_fallback("encoder_ffn_w8a8")
        fc1 = {"w": dequantize_weight(fc1, h.dtype), "b": fc1["b"]}
        fc2 = {"w": dequantize_weight(fc2, h.dtype), "b": fc2["b"]}
    return linear(fc2, gelu(linear(fc1, h)))


def _enc_layer_apply(p: Params, x: torch.Tensor, n_heads: int
                     ) -> torch.Tensor:
    x = x + _enc_self_attn(p["attn"], layer_norm(p["ln1"], x), n_heads)
    return x + _enc_ffn(p, layer_norm(p["ln2"], x))


def encoder_stem(params: Params, mel: torch.Tensor, cfg: WhisperConfig
                 ) -> torch.Tensor:
    """mel [B, 3000, n_mels] -> the first layer's input [B, 1500, D]:
    conv1 -> gelu -> conv2 (stride 2) -> gelu -> + positions."""
    if mel.shape[1] != cfg.expected_mel_frames:
        raise ValueError(
            f"Whisper expects mel length {cfg.expected_mel_frames}, got "
            f"{mel.shape[1]}; pad/truncate the features first.")
    x = gelu(conv1d(params["conv1"], mel, stride=1, padding=1))
    x = gelu(conv1d(params["conv2"], x, stride=2, padding=1))
    return x + params["embed_positions"][None, :x.shape[1]].to(x.dtype)


def whisper_encoder_apply(params: Params, mel: torch.Tensor,
                          cfg: WhisperConfig,
                          target_layer_ids: Sequence[int] = ()
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel [B, 3000, n_mels] -> (final hidden [B, 1500, D] after ln_post,
    taps [n_taps, B, 1500, D]: the hidden state after each target layer)."""
    x = encoder_stem(params, mel, cfg)
    taps = []
    wanted = set(target_layer_ids)
    for i in range(cfg.encoder_layers):
        x = _enc_layer_apply(index_tree(params["layers"], i), x,
                             cfg.encoder_attention_heads)
        if i in wanted:
            taps.append(x)
    final = layer_norm(params["ln_post"], x)
    taps = torch.stack(taps) if taps else torch.zeros((1,) + x.shape,
                                                       dtype=x.dtype,
                                                       device=x.device)
    return final, taps


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads)


def _dec_layer_apply(p: Params, x: torch.Tensor, enc_kv, n_heads: int,
                     self_mask: torch.Tensor, cache=None,
                     cache_index: int = 0) -> torch.Tensor:
    """One decoder layer (``whisper.py:350-383`` of the JAX package).
    enc_kv: this layer's cross (k, v), each [B, T_enc, H, Dh].  cache: this
    layer's self-attention (k, v), each [B, Tmax, H, Dh]; the new keys and
    values of x [B, T, D] are written in place at ``cache_index`` and the
    attention reads the whole cache under ``self_mask``."""
    B, T, D = x.shape
    a = p["self_attn"]
    h = layer_norm(p["ln1"], x)
    q, k, v = (_heads(linear(a[n], h), n_heads) for n in ("q", "k", "v"))
    if cache is not None:
        ck, cv = cache
        ck[:, cache_index:cache_index + T] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + T] = v.to(cv.dtype)
        k, v = ck, cv
    attn = core.mha(q, k, v, self_mask)
    x = x + linear(a["o"], attn.reshape(B, T, D))

    c = p["cross_attn"]
    h = layer_norm(p["ln_x"], x)
    attn = core.mha(_heads(linear(c["q"], h), n_heads), *enc_kv)
    x = x + linear(c["o"], attn.reshape(B, T, D))

    h = layer_norm(p["ln2"], x)
    return x + linear(p["fc2"], gelu(linear(p["fc1"], h)))


def whisper_cross_kv(params: Params, enc_out: torch.Tensor,
                     cfg: WhisperConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V of the encoder output [B, T_enc, D]:
    (k, v), each [L, B, T_enc, H, Dh] in the encoder output's dtype."""
    H = cfg.decoder_attention_heads
    cross = params["layers"]["cross_attn"]
    ks, vs = [], []
    for i in range(cfg.decoder_layers):
        ks.append(_heads(linear(index_tree(cross["k"], i), enc_out), H))
        vs.append(_heads(linear(index_tree(cross["v"], i), enc_out), H))
    return torch.stack(ks), torch.stack(vs)


def whisper_decoder_apply(params: Params, tokens: torch.Tensor, cross_kv,
                          cfg: WhisperConfig, pos_offset: int = 0,
                          cache=None, cache_index: int = 0):
    """tokens [B, T] -> (logits [B, T, V] f32, cache).

    Without a cache: causal self-attention over ``tokens``.  With
    ``cache=(k, v)`` (each [L, B, Tmax, H, Dh], :func:`init_decoder_cache`):
    the tokens' keys and values are written in place at ``cache_index`` and
    each attends to every cached position up to its own; the same cache is
    returned.  Positions ``pos_offset + t`` past the learned table take its
    last row (the JAX gather clamps)."""
    H = cfg.decoder_attention_heads
    B, T = tokens.shape
    dev = tokens.device
    x = params["embed_tokens"][tokens]
    table = params["embed_positions"]
    positions = torch.clamp(torch.arange(T, device=dev) + pos_offset,
                            max=table.shape[0] - 1)
    x = x + table[positions][None].to(x.dtype)
    if cache is None:
        mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    else:
        Tmax = cache[0].shape[2]
        key_pos = torch.arange(Tmax, device=dev)[None, :]
        q_pos = (torch.arange(T, device=dev) + cache_index)[:, None]
        mask = key_pos <= q_pos  # causal within the appended tokens too
    for i in range(cfg.decoder_layers):
        layer_cache = None if cache is None else (cache[0][i], cache[1][i])
        x = _dec_layer_apply(index_tree(params["layers"], i), x,
                             (cross_kv[0][i], cross_kv[1][i]), H,
                             mask[None, None], layer_cache, cache_index)
    x = layer_norm(params["ln"], x)
    return matmul_f32(x, params["embed_tokens"].t()), cache


def init_decoder_cache(cfg: WhisperConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device=None):
    """Zeroed self-attention cache: (k, v), each [L, batch, max_len, H, Dh]."""
    H = cfg.decoder_attention_heads
    shape = (cfg.decoder_layers, batch, max_len, H, cfg.d_model // H)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
