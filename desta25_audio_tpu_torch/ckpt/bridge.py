"""JAX param pytree (as numpy arrays) -> the port's param tree.

The JAX package stores linear weights ``[in, out]``, conv weights
``[kernel, in, out]`` and stacks layers on a leading axis.  The port keeps
the stacking and stores weights in the layout its kernels read: linear
``[out, in]``, conv ``[out, in, kernel]``; the LLM's q/k/v weights fused
into ``wqkv`` and its gate/up weights row-interleaved into ``w_gu`` (see
``ops/fused_decode.py``).  Every subtree the port runs is converted
(Whisper encoder and decoder, Q-Former or ORCA connector, ORCA
cross-attention stack, LLM, LoRA adapters).

Leaves may be numpy arrays (``jax.tree.map(np.asarray, params)``; bf16 as
ml_dtypes) or torch tensors (the JAX package's staged files read by the
port's codec, ``ckpt/flat_io.py``).  Each leaf goes to ``device`` first, in
its own dtype, and is transposed or joined there: nothing is upcast.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import DeSTA25Config
from .flat_io import as_tensor


def _tensor(a, device) -> torch.Tensor:
    """A numpy or torch leaf -> a tensor on ``device`` in its own dtype (a
    numpy leaf is copied: the tree never aliases the caller's arrays)."""
    if not isinstance(a, torch.Tensor):
        a = as_tensor(np.array(a))
    return a.to(device)


def _swap(a, device) -> torch.Tensor:
    return _tensor(a, device).transpose(-1, -2).contiguous()


def _linear(p: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A linear leaf, bf16/f32 ``{"w", "b"?}`` or int8 ``{"q", "s", "b"?}``
    (with the "dual" leaves' ``w`` beside ``q``): ``w`` and ``q`` go from
    ``[in, out]`` to ``[out, in]``; the per-output-channel scale ``s`` stays
    f32 and ``b`` as it is."""
    out = {}
    for k in ("w", "q"):
        if k in p:
            out[k] = _swap(p[k], device)
    if "s" in p:
        out["s"] = _tensor(p["s"], device).float()
    if "b" in p:
        out["b"] = _tensor(p["b"], device)
    return out


def _norm(p: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: _tensor(v, device) for k, v in p.items()}


def _attn(p, device):
    return {k: (_norm(v, device) if k == "ln" else _linear(v, device))
            for k, v in p.items()}


def whisper_encoder_from_jax(p, device):
    """JAX Whisper encoder subtree -> port layout."""
    lay = p["layers"]
    return {
        "conv1": _conv(p["conv1"], device),
        "conv2": _conv(p["conv2"], device),
        "embed_positions": _tensor(p["embed_positions"], device),
        "layers": {
            "ln1": _norm(lay["ln1"], device),
            "attn": _attn(lay["attn"], device),
            "ln2": _norm(lay["ln2"], device),
            "fc1": _linear(lay["fc1"], device),
            "fc2": _linear(lay["fc2"], device),
        },
        "ln_post": _norm(p["ln_post"], device),
    }


def whisper_decoder_from_jax(p, device):
    """JAX Whisper decoder subtree -> port layout: the linears go to
    ``[L, out, in]``; ``embed_tokens`` [V, D] (the tied head) and the
    learned ``embed_positions`` [max_target_positions, D] stay as they
    are."""
    lay = p["layers"]
    return {
        "embed_tokens": _tensor(p["embed_tokens"], device),
        "embed_positions": _tensor(p["embed_positions"], device),
        "layers": {
            "ln1": _norm(lay["ln1"], device),
            "self_attn": _attn(lay["self_attn"], device),
            "ln_x": _norm(lay["ln_x"], device),
            "cross_attn": _attn(lay["cross_attn"], device),
            "ln2": _norm(lay["ln2"], device),
            "fc1": _linear(lay["fc1"], device),
            "fc2": _linear(lay["fc2"], device),
        },
        "ln": _norm(p["ln"], device),
    }


def _bert_encoder(p, device):
    lay = p["layers"]
    return {"layers": {
        "self": _attn(lay["self"], device),
        "cross": _attn(lay["cross"], device),
        "inter": _linear(lay["inter"], device),
        "out": _linear(lay["out"], device),
        "out_ln": _norm(lay["out_ln"], device),
    }}


def _conv(p, device):
    """Conv1d leaf: JAX ``[kernel, in, out]`` -> ``[out, in, kernel]``."""
    return {"w": _tensor(p["w"], device).permute(2, 1, 0).contiguous(),
            "b": _tensor(p["b"], device)}


def connector_from_jax(p, device):
    """JAX Q-Former connector subtree -> port layout."""
    return {
        "layer_prompts": _tensor(p["layer_prompts"], device),
        "layer_weights": _tensor(p["layer_weights"], device),
        "qformer": _bert_encoder(p["qformer"], device),
        "proj_ln": _norm(p["proj_ln"], device),
        "proj": _linear(p["proj"], device),
    }


def orca_connector_from_jax(p, device):
    """JAX ORCA hybrid connector subtree -> port layout (the local branch
    only where the checkpoint has it)."""
    out = {
        "global_queries": _tensor(p["global_queries"], device),
        "global_layer_weights": _tensor(p["global_layer_weights"], device),
        "global_qformer": _bert_encoder(p["global_qformer"], device),
        "global_proj_ln": _norm(p["global_proj_ln"], device),
        "global_proj": _linear(p["global_proj"], device),
    }
    if "local_conv" in p:
        out.update(local_layer_weights=_tensor(p["local_layer_weights"],
                                               device),
                   local_proj_in=_linear(p["local_proj_in"], device),
                   local_conv=_conv(p["local_conv"], device),
                   local_ln=_norm(p["local_ln"], device))
    return out


def orca_cross_attns_from_jax(p, device):
    """JAX ORCA cross-attention stack -> port layout: float ``{w, b}`` or
    int8 ``{q, s, b}`` (``quantize_orca_cross_attns``) linears go to
    ``[L, out, in]``; gate2's weight ``[L, D/4, 1]`` becomes
    ``[L, 1, D/4]``; the LayerNorm is carried as it is."""
    lay = p["layers"]
    layers = {k: _linear(lay[k], device)
              for k in ("q", "k", "v", "o", "gate1", "gate2")}
    layers["ln"] = _norm(lay["ln"], device)
    return {"layers": layers}


def _fused_weight(leaves, how: str, device):
    """JAX per-projection weights -> one port weight: bf16 ``[L, in, out]``
    arrays, or int8 leaves ``{"q" [L, in, out], "s" [L, out]}``, joined
    along ``out`` (``how="concat"``: q, k, v) or row-interleaved
    (``how="interleave"``: gate, up), then stored ``[L, out, in]``."""
    def join(arrs):
        arrs = [_tensor(a, device) for a in arrs]
        if how == "concat":
            return torch.cat(arrs, dim=-1)
        return torch.stack(arrs, dim=-1).reshape(*arrs[0].shape[:-1], -1)
    if isinstance(leaves[0], dict):
        return _linear({"q": join([l["q"] for l in leaves]),
                        "s": join([l["s"] for l in leaves])}, device)
    return _linear({"w": join(leaves)}, device)["w"]


def _weight(p, device):
    """One JAX weight (bf16 [.., in, out] or an int8 leaf) -> port layout."""
    if isinstance(p, dict):
        return _linear(p, device)
    return _linear({"w": p}, device)["w"]


def llm_from_jax(p, device):
    """JAX LLM subtree -> port layout (fused wqkv, interleaved w_gu), bf16
    or int8 (``quantize_llm_params``: ``{q, s}`` leaves and a padded int8
    ``lm_head``)."""
    lay = p["layers"]
    layers = {
        "ln1": _norm(lay["ln1"], device),
        "wqkv": _fused_weight([lay[k] for k in ("wq", "wk", "wv")],
                              "concat", device),
        "wo": _weight(lay["wo"], device),
        "ln2": _norm(lay["ln2"], device),
        "w_gu": _fused_weight([lay["w_gate"], lay["w_up"]], "interleave",
                              device),
        "w_down": _weight(lay["w_down"], device),
    }
    for k in ("q_norm", "k_norm"):
        if k in lay:
            layers[k] = _norm(lay[k], device)
    out = {"embed": _tensor(p["embed"], device), "layers": layers,
           "norm": _norm(p["norm"], device)}
    if "lm_head" in p:
        out["lm_head"] = _weight(p["lm_head"], device)
    return out


def from_jax_params(np_tree: Dict[str, Any], config: DeSTA25Config,
                    device) -> Dict[str, Any]:
    """Convert a ``desta25_audio_tpu`` DeSTA param tree (leaves as numpy
    arrays, e.g. ``jax.tree.map(np.asarray, model.params)``) into the
    port's tree on ``device``.  A quantized encoder
    (``quantize_encoder_params``), a quantized LLM
    (``quantize_llm_params``) and a quantized ORCA stack
    (``quantize_orca_cross_attns``) are carried across; so are the Whisper
    decoder and the LoRA adapters where the tree has them."""
    if config.connector_mode == "qformer_1":
        connector = connector_from_jax(np_tree["connector"], device)
    elif config.connector_mode == "orca_hybrid":
        connector = orca_connector_from_jax(np_tree["connector"], device)
    else:
        raise NotImplementedError(
            f"connector_mode {config.connector_mode!r}")
    whisper = {"encoder": whisper_encoder_from_jax(
        np_tree["whisper"]["encoder"], device)}
    if "decoder" in np_tree["whisper"]:
        whisper["decoder"] = whisper_decoder_from_jax(
            np_tree["whisper"]["decoder"], device)
    out = {
        "whisper": whisper,
        "connector": connector,
        "llm": llm_from_jax(np_tree["llm"], device),
    }
    if "orca_cross_attns" in np_tree:
        out["orca_cross_attns"] = orca_cross_attns_from_jax(
            np_tree["orca_cross_attns"], device)
    if "lora" in np_tree:
        out["lora"] = lora_from_jax(np_tree["lora"], device)
    return out


def lora_from_jax(p: Dict[str, Any], device) -> Dict[str, Any]:
    """JAX LoRA adapters (``init_lora``: ``a`` [L, in, r], ``b`` [L, r,
    out] for q, k and v) -> the port's, which keep that layout."""
    return {"layers": {t: {ab: _tensor(p["layers"][t][ab], device)
                           for ab in ("a", "b")}
                       for t in ("q", "k", "v")}}
