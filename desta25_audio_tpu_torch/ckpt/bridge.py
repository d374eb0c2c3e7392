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


def llm_from_jax(p, device):
    """JAX LLM subtree -> port layout (fused wqkv, interleaved w_gu)."""
    lay = p["layers"]
    T = lambda a: np.swapaxes(np.asarray(a), -1, -2)  # noqa: E731
    wqkv = np.concatenate([np.asarray(lay[k]) for k in ("wq", "wk", "wv")],
                          axis=-1)                       # [L, D, HD+2KVD]
    gate, up = np.asarray(lay["w_gate"]), np.asarray(lay["w_up"])
    w_gu = np.stack([gate, up], axis=-1).reshape(
        gate.shape[0], gate.shape[1], -1)                # [L, D, 2I]
    layers = {
        "ln1": _norm(lay["ln1"], device),
        "wqkv": _tensor(T(wqkv), device),
        "wo": _tensor(T(lay["wo"]), device),
        "ln2": _norm(lay["ln2"], device),
        "w_gu": _tensor(T(w_gu), device),
        "w_down": _tensor(T(lay["w_down"]), device),
    }
    for k in ("q_norm", "k_norm"):
        if k in lay:
            layers[k] = _norm(lay[k], device)
    out = {"embed": _tensor(p["embed"], device), "layers": layers,
           "norm": _norm(p["norm"], device)}
    if "lm_head" in p:
        out["lm_head"] = _tensor(T(p["lm_head"]), device)
    return out


def from_jax_params(np_tree: Dict[str, Any], config: DeSTA25Config,
                    device) -> Dict[str, Any]:
    """Convert a ``desta25_audio_tpu`` DeSTA param tree (leaves as numpy
    arrays, e.g. ``jax.tree.map(np.asarray, model.params)``) into the
    port's tree on ``device``.  A quantized encoder
    (``quantize_encoder_params``) is carried across; int8 LLM leaves are
    not ported yet (ROADMAP.md Queue 1: int8 LLM)."""
    if config.connector_mode != "qformer_1":
        raise NotImplementedError("only the Q-Former connector is ported")
    if isinstance(np_tree["llm"]["layers"]["wq"], dict):
        raise NotImplementedError(
            "int8 LLM leaves are not ported yet (ROADMAP.md Queue 1: int8 "
            "LLM)")
    return {
        "whisper": {"encoder": whisper_encoder_from_jax(
            np_tree["whisper"]["encoder"], device)},
        "connector": connector_from_jax(np_tree["connector"], device),
        "llm": llm_from_jax(np_tree["llm"], device),
    }
