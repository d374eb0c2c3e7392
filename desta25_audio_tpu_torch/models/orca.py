"""ORCA hybrid connector and gated cross-attention deep injection
(counterpart of ``desta25_audio_tpu/models/orca.py:49-197``; reference
``ORCAHybridConnector`` and ``ORCAGatedCrossAttention``,
modeling_desta25.py:208-490).

- Global branch: one set of learnable queries per tapped encoder layer
  through a shared Q-Former (``models/qformer.bert_encoder_apply``, whose
  cross-attention runs K2 on the card), a per-(query, tap) softmax fusion,
  LayerNorm + Linear to the LLM width.
- Local branch: softmax fusion over the taps -> Linear(d_enc -> d_llm) ->
  Conv1d(kernel ``orca_local_kernel_size``, stride ``orca_local_downsample``,
  padding kernel // 2) -> LayerNorm: whisper-large-v3's 1500 frames become
  375 local tokens.
- Deep injection: after every LLM decoder layer,
  ``h + sigmoid(g2(gelu(g1 h))) * LN(Wo MHA(Wq h, K, V))`` with K/V the
  projections of the RoPE'd local tokens (fractional positions
  ``i / orca_audio_position_scale``), computed once per request
  (:func:`precompute_cross_kv`).  In PyTorch here (prefill, and decode with
  a float stack), as the JAX package leaves it to XLA; with an int8 stack
  and an int8 LLM the decode and verify steps run it in their kernels
  (``ops/fused_decode.py``, ``inject=``).

Parameters follow the JAX trees in the port's layout (linear ``[out, in]``,
conv ``[out, in, kernel]``, layers stacked on a leading axis).  The stack
may hold int8 ``{q, s, b}`` leaves (``ops/quant.quantize_orca_cross_attns``),
which go through ``ops/qmm.quant_matmul``.  Training builds the injection
and its per-layer alignment term with :func:`make_deep_injection_fn`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..config import DeSTA25Config
from ..ops.core import (
    Params,
    conv1d,
    gelu,
    index_tree,
    layer_norm,
    linear,
    mha,
)
from ..ops.qmm import quant_matmul
from ..ops.rope import fractional_rope_apply
from ..parallel.sharding import Shards
from .qformer import bert_encoder_apply, init_bert_encoder
from .whisper import _uniform, init_layer_norm_stack, init_linear_stack


def _init_layer_norm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def init_orca_connector(cfg: DeSTA25Config, dtype, device,
                        generator: torch.Generator) -> Params:
    """Random ORCA connector on ``device`` (the JAX package's init
    distributions: N(0, 1) queries, zero fusion logits, kaiming-uniform
    linears and conv)."""
    n_taps = len(cfg.target_layer_ids)
    d_enc = cfg.encoder_config.d_model
    d_llm = cfg.llm_config.hidden_size
    K = cfg.orca_global_num_tokens
    p: Params = {
        "global_queries": torch.empty(n_taps, K, d_enc, dtype=dtype,
                                      device=device).normal_(
                                          generator=generator),
        "global_layer_weights": torch.zeros(K, n_taps, dtype=torch.float32,
                                            device=device),
        "global_qformer": init_bert_encoder(cfg.qformer_config, dtype,
                                            device, generator),
        "global_proj_ln": _init_layer_norm(d_enc, dtype, device),
        "global_proj": init_linear_stack(0, d_enc, d_llm, dtype, device,
                                         generator),
    }
    if cfg.orca_local_enabled:
        k = cfg.orca_local_kernel_size
        fan_in = d_llm * k
        p["local_layer_weights"] = torch.zeros(n_taps, dtype=torch.float32,
                                               device=device)
        p["local_proj_in"] = init_linear_stack(0, d_enc, d_llm, dtype, device,
                                               generator)
        p["local_conv"] = {
            "w": _uniform((d_llm, d_llm, k), math.sqrt(3.0 / fan_in), dtype,
                          device, generator),
            "b": _uniform((d_llm,), 1.0 / math.sqrt(fan_in), dtype, device,
                          generator)}
        p["local_ln"] = _init_layer_norm(d_llm, dtype, device)
    return p


def orca_connector_apply(params: Params, taps: torch.Tensor,
                         cfg: DeSTA25Config
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """taps [n_taps, B, T_enc, d_enc] -> (global tokens [B, K, d_llm],
    local tokens [B, T', d_llm] or None).  All taps go through the Q-Former
    as one batch [n_taps * B, ...] (the JAX package vmaps over the taps)."""
    n_taps, B, T, d = taps.shape
    queries = params["global_queries"].to(taps.dtype)            # [n, K, d]
    K = queries.shape[1]
    q = queries[:, None].expand(n_taps, B, K, d).reshape(n_taps * B, K, d)
    outs = bert_encoder_apply(params["global_qformer"], q,
                              taps.reshape(n_taps * B, T, d),
                              cfg.qformer_config).reshape(n_taps, B, K, d)
    w = torch.softmax(params["global_layer_weights"].float(), dim=-1)
    fused = torch.einsum("nbkd,kn->bkd", outs.float(), w).to(taps.dtype)
    fused = layer_norm(params["global_proj_ln"], fused, eps=1e-5)
    global_tokens = linear(params["global_proj"], fused)
    if not cfg.orca_local_enabled:
        return global_tokens, None

    lw = torch.softmax(params["local_layer_weights"].float(), dim=-1)
    local = torch.einsum("nbtd,n->btd", taps.float(), lw).to(taps.dtype)
    local = linear(params["local_proj_in"], local)
    local = conv1d(params["local_conv"], local,
                   stride=cfg.orca_local_downsample,
                   padding=cfg.orca_local_kernel_size // 2)
    return global_tokens, layer_norm(params["local_ln"], local, eps=1e-5)


def init_orca_cross_attns(cfg: DeSTA25Config, dtype, device,
                          generator: torch.Generator) -> Params:
    """One gated cross-attention block per LLM layer, stacked: q/k/v/o
    [L, D, D], gate1 [L, D/4, D] (with biases), gate2 with a zero weight
    [L, 1, D/4] and bias ``orca_gate_init`` [L, 1] (the reference's stable
    start, modeling_desta25.py:381-384), LayerNorm [L, D]."""
    L = cfg.llm_config.num_hidden_layers
    d = cfg.llm_config.hidden_size
    lin = lambda o: init_linear_stack(L, d, o, dtype, device,  # noqa: E731
                                      generator)
    layers = {k: lin(d) for k in ("q", "k", "v", "o")}
    layers["gate1"] = lin(d // 4)
    layers["gate2"] = {
        "w": torch.zeros(L, 1, d // 4, dtype=dtype, device=device),
        "b": torch.full((L, 1), cfg.orca_gate_init, dtype=dtype,
                        device=device)}
    layers["ln"] = init_layer_norm_stack(L, d, dtype, device)
    return {"layers": layers}


def _xattn_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A float linear, or an int8 leaf through quant_matmul (K7 below 128
    rows, W8A8 from 128 up) with its bias added in f32 and one rounding to
    x's dtype (``orca.py:137-150`` of the JAX package)."""
    if "w" in p:
        return linear(p, x)
    y = quant_matmul(x, p)
    if "b" in p:
        y = (y.float() + p["b"].float()).to(y.dtype)
    return y


def gated_cross_attention_apply(p: Params, hidden: torch.Tensor,
                                audio_roped: Optional[torch.Tensor],
                                n_heads: int, cached_kv=None) -> torch.Tensor:
    """One layer's injection.  hidden [B, T, D]; audio_roped [B, Ta, D]
    (RoPE'd local tokens), or ``cached_kv`` = (k, v) [B, Ta, D] from
    :func:`precompute_cross_kv`.  p: one layer of the stack."""
    B, T, D = hidden.shape
    dh = D // n_heads
    q = _xattn_linear(p["q"], hidden).reshape(B, T, n_heads, dh)
    if cached_kv is None:
        k = _xattn_linear(p["k"], audio_roped)
        v = _xattn_linear(p["v"], audio_roped)
    else:
        k, v = (t.to(hidden.dtype) for t in cached_kv)
    Ta = k.shape[1]
    attn = mha(q, k.reshape(B, Ta, n_heads, dh),
               v.reshape(B, Ta, n_heads, dh)).reshape(B, T, D)
    attn = layer_norm(p["ln"], _xattn_linear(p["o"], attn), eps=1e-5)
    gate = torch.sigmoid(_xattn_linear(
        p["gate2"], gelu(_xattn_linear(p["gate1"], hidden))).float())
    return hidden + (gate * attn.float()).to(hidden.dtype)


def precompute_cross_kv(orca_params: Params, audio_roped: torch.Tensor):
    """Every layer's audio K/V, two [L, B, Ta, D] tensors in audio_roped's
    dtype: the audio tokens are constant over a request, so their
    projections are computed once, not at every step."""
    lay = orca_params["layers"]
    L = lay["ln"]["scale"].shape[0]
    ks, vs = [], []
    for l in range(L):
        ks.append(_xattn_linear(index_tree(lay["k"], l), audio_roped))
        vs.append(_xattn_linear(index_tree(lay["v"], l), audio_roped))
    return torch.stack(ks), torch.stack(vs)


def orca_inject_tokens(config: DeSTA25Config, params: Params,
                       audio_feats: Optional[torch.Tensor],
                       local_tokens: Optional[torch.Tensor]
                       ) -> Optional[torch.Tensor]:
    """The deep-injection tokens [N, Ta, D]: the local tokens (with
    ``orca_global_cross_attn``, the global tokens before them), or None when
    the model does not deep-inject (``desta.py:415-427`` and
    ``train/step.py:77-91`` of the JAX package)."""
    if not (config.is_orca and config.orca_deep_injection_enabled
            and "orca_cross_attns" in params and local_tokens is not None):
        return None
    if config.orca_global_cross_attn and audio_feats is not None:
        return torch.cat([audio_feats, local_tokens], dim=1)
    return local_tokens


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(sum(x^2) + 1e-12) over the last axis: finite gradient at a
    zero row, where ``x / (norm + eps)`` has a NaN one (a row without
    transcription positions pools to exactly zero)."""
    return x * torch.rsqrt(torch.sum(torch.square(x), dim=-1, keepdim=True)
                           + 1e-12)


def layer_trees(tree: Any, n: int) -> List[Any]:
    """A stacked tree split into its ``n`` layers by ``torch.unbind(0)``
    once: the backward stacks the layers' gradients in one pass, where
    ``tree[l]`` for each layer would add a zero-filled gradient of the whole
    stack per layer and leaf.  A ``Shards`` leaf (fsdp: the stack cut over
    a mesh's data rows) is unbound part by part: each layer a Shards of its
    parts' slices (or, cut along the layers, its one part's slice), gathered
    where it is used (:func:`gather_layer`)."""
    if isinstance(tree, dict):
        parts = {k: layer_trees(v, n) for k, v in tree.items()}
        return [{k: v[l] for k, v in parts.items()} for l in range(n)]
    if isinstance(tree, Shards):
        per = [torch.unbind(p, 0) for p in tree.parts]
        if tree.dim == 0:
            return [v for u in per for v in u]
        return [Shards([u[l] for u in per], tree.dim - 1) for l in range(n)]
    return list(torch.unbind(tree, 0))


def gather_layer(tree: Any, device) -> Any:
    """A layer tree of :func:`layer_trees` whole on ``device``: a Shards
    leaf's parts moved there and joined, differentiably (its gradient goes
    back to each part on its own device)."""
    if isinstance(tree, dict):
        return {k: gather_layer(v, device) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return torch.cat([p.to(device) for p in tree.parts], tree.dim)
    return tree.to(device)


def make_deep_injection_fn(orca_params: Params, cfg: DeSTA25Config,
                           audio_local: torch.Tensor,
                           trans_pos_mask: Optional[torch.Tensor] = None,
                           training: bool = False,
                           n_has: Optional[int] = None
                           ) -> Tuple[Callable, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """The ``extra_layer_fn`` of the cache-less forward and its aux init
    (``models/orca.py:200-245`` of the JAX package).

    ``fn(l, hidden, aux) -> (hidden, aux)`` injects the RoPE'd
    ``audio_local`` [B, Ta, D] into layer l's output.  With ``training`` and
    ``trans_pos_mask`` [B, T] (1 where transcription embeddings sit) it adds
    the layer's alignment term, the mean over rows with such positions of
    1 - cos(pooled audio, pooled hidden), the hidden being the layer's
    output before the injection; ``aux = (sum, count)`` counts the layers
    with any such row, so a batch without transcription positions leaves
    (0, 0).  ``n_has``: the number of such rows in the whole batch when
    these rows are a part of it (a split over devices or processes); the
    parts' sums then add up to the whole batch's and every part counts the
    same layers."""
    n_heads = cfg.llm_config.num_attention_heads
    roped = fractional_rope_apply(audio_local, cfg.orca_audio_position_scale,
                                  cfg.llm_config.rope_theta)
    with torch.no_grad():
        audio_pooled = _l2norm(roped.float().mean(1))             # [B, D]
    lay = orca_params["layers"]
    layers = layer_trees(lay, lay["ln"]["scale"].shape[0])
    have_trans = trans_pos_mask is not None and training
    if have_trans:
        m = trans_pos_mask.float()[..., None]                    # [B, T, 1]
        counts = m.sum(1)                                        # [B, 1]
        has = (counts[:, 0] > 0).float()
        n_has = (has.sum() if n_has is None else
                 torch.tensor(float(n_has), device=has.device))
        valid = (n_has > 0).float()

    def fn(l: int, hidden: torch.Tensor, aux):
        new_hidden = gated_cross_attention_apply(
            gather_layer(layers[l], hidden.device), hidden, roped, n_heads)
        if have_trans:
            pooled = _l2norm((hidden.float() * m).sum(1)
                             / torch.clamp(counts, min=1.0))
            cos = torch.sum(audio_pooled * pooled, dim=-1)
            per_layer = (torch.sum((1.0 - cos) * has)
                         / torch.clamp(n_has, min=1.0))
            aux = (aux[0] + per_layer * valid, aux[1] + valid)
        return new_hidden, aux

    zero = torch.zeros((), dtype=torch.float32, device=audio_local.device)
    return fn, (zero, zero)
