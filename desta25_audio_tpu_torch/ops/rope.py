"""Rotary position embeddings (counterpart of ``desta25_audio_tpu/ops/rope.py``).

LLM attention RoPE: Llama-3.1 with NTK "llama3" frequency scaling, or plain
theta (Qwen3); half-split rotation matching HF Llama/Qwen.  ORCA's audio
tokens take the same rotation at fractional positions over the full width.
All trig in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import LLMConfig, RopeScalingConfig


def rope_inv_freq(dim: int, theta: float,
                  scaling: Optional[RopeScalingConfig] = None,
                  device=None) -> torch.Tensor:
    """Inverse frequencies [dim/2], optionally llama3-NTK scaled."""
    half = dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=device) / half))
    if scaling is not None and scaling.rope_type == "llama3":
        # HF Llama3RotaryEmbedding frequency warping.
        low_freq_wavelen = (scaling.original_max_position_embeddings
                            / scaling.low_freq_factor)
        high_freq_wavelen = (scaling.original_max_position_embeddings
                             / scaling.high_freq_factor)
        wavelen = 2.0 * math.pi / inv_freq
        inv_freq_llama = torch.where(
            wavelen > low_freq_wavelen, inv_freq / scaling.factor, inv_freq)
        smooth = ((scaling.original_max_position_embeddings / wavelen
                   - scaling.low_freq_factor)
                  / (scaling.high_freq_factor - scaling.low_freq_factor))
        smoothed = ((1.0 - smooth) * inv_freq_llama / scaling.factor
                    + smooth * inv_freq_llama)
        is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
        inv_freq = torch.where(is_medium, smoothed, inv_freq_llama)
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float,
                 scaling: Optional[RopeScalingConfig] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., dim] for half-split rotation (last dim is
    [freqs, freqs], the HF convention); positions [...] int or float."""
    inv_freq = rope_inv_freq(dim, theta, scaling, device=positions.device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, T, H, D]; cos/sin: [B, T, D] or [T, D] (broadcast over
    heads).  f32 math, x's dtype out."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def llm_rope_cos_sin(cfg: LLMConfig, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                        cfg.rope_scaling)


def fractional_rope_apply(x: torch.Tensor, scale: float, theta: float
                          ) -> torch.Tensor:
    """ORCA audio-token RoPE at fractional positions ``i / scale`` over the
    whole hidden width (not per head), as the reference rotates it
    (``rope.py:95-107`` of the JAX package).  x [B, T, D]; f32 math, x's
    dtype out."""
    T, D = x.shape[1], x.shape[2]
    positions = torch.arange(T, dtype=torch.float32, device=x.device) / scale
    cos, sin = rope_cos_sin(positions, D, theta)
    xf = x.float()
    return (xf * cos[None] + rotate_half(xf) * sin[None]).to(x.dtype)
