"""LoRA adapters <-> peft's checkpoint keys (counterpart of
``desta25_audio_tpu/ckpt/lora_io.py``).

The reference wraps q/k/v_proj with peft LoRA and unwraps to the base model
(modeling_desta25.py:720-729), so its trainable keys read
``llm_model.model.layers.{i}.self_attn.q_proj.lora_A.default.weight``
([r, in], torch layout) and ``...lora_B.default.weight`` ([out, r]).  The
port keeps the JAX package's adapter layout (``a`` [L, in, r], ``b``
[L, r, out]), so each layer's matrices are transposed both ways.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import DeSTA25Config

_TARGETS = ("q", "k", "v")


def _key(i: int, t: str, ab: str) -> str:
    return (f"llm_model.model.layers.{i}.self_attn.{t}_proj."
            f"lora_{ab}.default.weight")


def lora_to_ref(lora: Dict[str, Any],
                config: DeSTA25Config) -> Dict[str, torch.Tensor]:
    """The port's adapters -> peft-named f32 tensors, on their device."""
    del config
    layers = lora["layers"]
    out: Dict[str, torch.Tensor] = {}
    for i in range(layers["q"]["a"].shape[0]):
        for t in _TARGETS:
            out[_key(i, t, "A")] = layers[t]["a"][i].float().t().contiguous()
            out[_key(i, t, "B")] = layers[t]["b"][i].float().t().contiguous()
    return out


def lora_from_ref(lora_template: Dict[str, Any],
                  sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """peft-keyed tensors -> a new adapter tree on the template's device,
    in the template's dtype (its layer count and rank)."""
    tmpl = lora_template["layers"]
    n = tmpl["q"]["a"].shape[0]
    layers = {}
    for t in _TARGETS:
        like = tmpl[t]["a"]
        layers[t] = {ab: torch.stack([
            sd[_key(i, t, ab.upper())].t() for i in range(n)]).to(
                device=like.device, dtype=like.dtype).contiguous()
            for ab in ("a", "b")}
    return {"layers": layers}
