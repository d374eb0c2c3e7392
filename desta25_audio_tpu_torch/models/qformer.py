"""Q-Former audio-text connector (counterpart of
``desta25_audio_tpu/models/qformer.py:153-239``).

BERT-style post-LN layers (bidirectional self-attention over the prompt
queries, cross-attention to one tapped encoder layer, GELU FFN with BERT's
3072 intermediate size, LayerNorm eps 1e-12), one learnable prompt of
``prompt_size`` queries per tap, a per-(query, tap) softmax fusion, then
LayerNorm + Linear to the LLM width.  The cross-attention runs through
``ops/enc_attention.packed_encoder_attention`` (the hand-written kernel on
the card) where the JAX package's ``_use_packed`` would take its kernel:
at least ``CROSS_KERNEL_MIN_T`` encoder frames and a shape and dtype the
kernel takes (``enc_attention_supported``); elsewhere (the nano towers,
float32 models) through ``ops/core.mha``, counted by
``_build.count_fallback``.  The 64-query self-attention is plain torch, as
the JAX package leaves it to XLA.  All taps go through the layers as one batch
[n_taps * B, ...] (the JAX package vmaps over the tap axis).

The connector params are f32 while the taps are bf16: every linear then
takes an f32 product and rounds to the activation dtype, as ``jnp.dot``'s
promotion does.  The shared-quant int8 K/V branch of the JAX package is not
ported (TPU-gated and off in ``generate()``).

The connector trains: with grad mode on, each BERT layer runs under
``torch.utils.checkpoint`` (non-reentrant), as ``qformer.py:171-189`` wraps
its layer in ``jax.checkpoint``, so the cross K/V of every layer (tap-sized)
is recomputed in the backward instead of kept.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import DeSTA25Config, QFormerConfig
from ..ops import _build
from ..ops.core import Params, gelu, index_tree, layer_norm, linear, mha
from ..ops.enc_attention import (
    enc_attention_supported,
    packed_encoder_attention,
)
from .whisper import init_layer_norm_stack, init_linear_stack

_BERT_EPS = 1e-12


def init_bert_encoder(qcfg: QFormerConfig, dtype, device,
                      generator: torch.Generator) -> Params:
    """The stacked BERT layers of a Q-Former (``qformer.py`` of the JAX
    package, ``init_bert_encoder``)."""
    d = qcfg.hidden_size
    L, Fi = qcfg.num_hidden_layers, qcfg.intermediate_size

    def attn():
        return {**{n: init_linear_stack(L, d, d, dtype, device, generator)
                   for n in ("q", "k", "v", "o")},
                "ln": init_layer_norm_stack(L, d, dtype, device)}

    return {"layers": {
        "self": attn(),
        "cross": attn(),
        "inter": init_linear_stack(L, d, Fi, dtype, device, generator),
        "out": init_linear_stack(L, Fi, d, dtype, device, generator),
        "out_ln": init_layer_norm_stack(L, d, dtype, device),
    }}


def init_qformer_connector(cfg: DeSTA25Config, dtype, device,
                           generator: torch.Generator) -> Params:
    n_taps = len(cfg.target_layer_ids)
    d = cfg.encoder_config.d_model
    d_llm = cfg.llm_config.hidden_size
    return {
        # torch.randn init (std 1.0) -- modeling_desta25.py:148-150
        "layer_prompts": torch.empty(n_taps, cfg.prompt_size, d, dtype=dtype,
                                     device=device).normal_(
                                         generator=generator),
        "layer_weights": torch.zeros(cfg.prompt_size, n_taps,
                                     dtype=torch.float32, device=device),
        "qformer": init_bert_encoder(cfg.qformer_config, dtype, device,
                                     generator),
        "proj_ln": {"scale": torch.ones(d, dtype=dtype, device=device),
                    "bias": torch.zeros(d, dtype=dtype, device=device)},
        "proj": init_linear_stack(0, d, d_llm, dtype, device, generator),
    }


def _self_attn(p: Params, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, D = h.shape
    dh = D // n_heads
    q = linear(p["q"], h).reshape(B, T, n_heads, dh)
    k = linear(p["k"], h).reshape(B, T, n_heads, dh)
    v = linear(p["v"], h).reshape(B, T, n_heads, dh)
    out = linear(p["o"], mha(q, k, v).reshape(B, T, D))
    return layer_norm(p["ln"], out + h, _BERT_EPS)


# the JAX package's _use_packed threshold (qformer.py:149)
CROSS_KERNEL_MIN_T = 512


def _cross_attn(p: Params, h: torch.Tensor, enc: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    B, T, D = h.shape
    t_kv = enc.shape[1]
    q = linear(p["q"], h)
    k = linear(p["k"], enc)
    v = linear(p["v"], enc)
    if t_kv >= CROSS_KERNEL_MIN_T and enc_attention_supported(n_heads, D,
                                                              q.dtype):
        out = packed_encoder_attention(q, k, v, n_heads)
    else:
        _build.count_fallback("packed_encoder_attention")
        dh = D // n_heads
        out = mha(q.reshape(B, T, n_heads, dh),
                  k.reshape(B, t_kv, n_heads, dh),
                  v.reshape(B, t_kv, n_heads, dh)).reshape(B, T, D)
    out = linear(p["o"], out)
    return layer_norm(p["ln"], out + h, _BERT_EPS)


def _bert_layer(p: Params, h: torch.Tensor, encoder_hidden: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    h = _self_attn(p["self"], h, n_heads)
    h = _cross_attn(p["cross"], h, encoder_hidden, n_heads)
    out = linear(p["out"], gelu(linear(p["inter"], h)))
    return layer_norm(p["out_ln"], out + h, _BERT_EPS)


def bert_encoder_apply(params: Params, hidden: torch.Tensor,
                       encoder_hidden: torch.Tensor,
                       cfg: QFormerConfig) -> torch.Tensor:
    """hidden [B, K, D] queries; encoder_hidden [B, T, D] cross source."""
    H = cfg.num_attention_heads
    h = hidden
    for i in range(cfg.num_hidden_layers):
        p = index_tree(params["layers"], i)
        if torch.is_grad_enabled():
            h = checkpoint(_bert_layer, p, h, encoder_hidden, H,
                           use_reentrant=False)
        else:
            h = _bert_layer(p, h, encoder_hidden, H)
    return h


def qformer_connector_apply(params: Params, taps: torch.Tensor,
                            cfg: DeSTA25Config) -> torch.Tensor:
    """taps [n_taps, B, T_enc, d_enc] -> audio tokens [B, prompt_size,
    d_llm]."""
    n_taps, B, T, d = taps.shape
    K = cfg.prompt_size
    prompts = params["layer_prompts"].to(taps.dtype)            # [n, K, d]
    queries = prompts[:, None].expand(n_taps, B, K, d).reshape(n_taps * B,
                                                              K, d)
    outs = bert_encoder_apply(params["qformer"], queries,
                              taps.reshape(n_taps * B, T, d),
                              cfg.qformer_config).reshape(n_taps, B, K, d)
    w = torch.softmax(params["layer_weights"].float(), dim=-1)    # [K, n]
    fused = torch.einsum("nbkd,kn->bkd", outs.float(), w).to(taps.dtype)
    fused = layer_norm(params["proj_ln"], fused, eps=1e-5)
    return linear(params["proj"], fused)
