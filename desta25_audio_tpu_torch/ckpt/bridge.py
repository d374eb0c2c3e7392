"""JAX param pytree (as numpy arrays) -> the port's param tree.

The JAX package stores linear weights ``[in, out]``, conv weights
``[kernel, in, out]`` and stacks layers on a leading axis.  The port keeps
the stacking and stores weights in the layout its kernels read: linear
``[out, in]``, conv ``[out, in, kernel]``; the LLM's q/k/v weights fused
into ``wqkv`` and its gate/up weights row-interleaved into ``w_gu`` (see
``ops/fused_decode.py``).  Only the subtrees the port runs are converted
(Whisper encoder, Q-Former connector, LLM); the Whisper decoder is skipped.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import DeSTA25Config


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from jax
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _linear(p: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A linear leaf, bf16/f32 ``{"w", "b"?}`` or int8 ``{"q", "s", "b"?}``
    (with the "dual" leaves' ``w`` beside ``q``): ``w`` and ``q`` go from
    ``[in, out]`` to ``[out, in]``; the per-output-channel scale ``s`` stays
    f32 and ``b`` as it is."""
    out = {}
    for k in ("w", "q"):
        if k in p:
            out[k] = _tensor(np.swapaxes(np.asarray(p[k]), -1, -2), device)
    if "s" in p:
        out["s"] = _tensor(np.asarray(p["s"], np.float32), device)
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
    conv = lambda c: {"w": _tensor(np.transpose(np.asarray(c["w"]),  # noqa
                                                (2, 1, 0)), device),
                      "b": _tensor(c["b"], device)}
    return {
        "conv1": conv(p["conv1"]),
        "conv2": conv(p["conv2"]),
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


def connector_from_jax(p, device):
    """JAX Q-Former connector subtree -> port layout."""
    lay = p["qformer"]["layers"]
    return {
        "layer_prompts": _tensor(p["layer_prompts"], device),
        "layer_weights": _tensor(p["layer_weights"], device),
        "qformer": {"layers": {
            "self": _attn(lay["self"], device),
            "cross": _attn(lay["cross"], device),
            "inter": _linear(lay["inter"], device),
            "out": _linear(lay["out"], device),
            "out_ln": _norm(lay["out_ln"], device),
        }},
        "proj_ln": _norm(p["proj_ln"], device),
        "proj": _linear(p["proj"], device),
    }


def _fused_weight(leaves, how: str, device):
    """JAX per-projection weights -> one port weight: bf16 ``[L, in, out]``
    arrays, or int8 leaves ``{"q" [L, in, out], "s" [L, out]}``, joined
    along ``out`` (``how="concat"``: q, k, v) or row-interleaved
    (``how="interleave"``: gate, up), then stored ``[L, out, in]``."""
    def join(arrs):
        arrs = [np.asarray(a) for a in arrs]
        if how == "concat":
            return np.concatenate(arrs, axis=-1)
        return np.stack(arrs, axis=-1).reshape(*arrs[0].shape[:-1], -1)
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
    (``quantize_encoder_params``) and a quantized LLM
    (``quantize_llm_params``) are carried across."""
    if config.connector_mode != "qformer_1":
        raise NotImplementedError("only the Q-Former connector is ported")
    return {
        "whisper": {"encoder": whisper_encoder_from_jax(
            np_tree["whisper"]["encoder"], device)},
        "connector": connector_from_jax(np_tree["connector"], device),
        "llm": llm_from_jax(np_tree["llm"], device),
    }
