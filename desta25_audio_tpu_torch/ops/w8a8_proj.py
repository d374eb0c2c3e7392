"""W8A8 projections of the int8 Whisper encoder's attention (port of
``desta25_audio_tpu/ops/w8a8_proj.py``: K5 ``qkv_w8a8``, K6 ``proj_w8a8``).

A leaf is ``{"q": int8 [N, D], "s": f32 [N], "b"?: [N]}`` (``ops/quant.py``,
the port's ``[out, in]`` layout); x is quantized per row at run time and
``y = f32(x_q . q) * (s_x[row] * s[col]) + b[col]``, rounded to x's dtype.
Whisper's ``k`` projection has no bias: it adds zeros, as in the JAX
package (``_bias_f32``).

On a CUDA tensor each wrapper launches ``csrc/w8a8.cu`` twice: the row
quantisation of x, then one int8 GEMM launch that writes all its outputs
(K5: q, k and v from one quantized x, three contiguous tensors that K2 takes
without copies).  On a CPU tensor it runs its ``*_plain`` version; it never
falls back from the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .gemm import EPI_PROJ
from .quant import (
    int_dot,
    launch_gemm_s8,
    launch_quant_rows,
    quant_rows,
    require_int8_leaf,
    w8a8_shape_limits,
)

Leaf = Dict[str, torch.Tensor]


def _dequant_dot(xq, sx, leaf: Leaf, dtype) -> torch.Tensor:
    y = int_dot(xq, leaf["q"]) * (sx * leaf["s"].float())
    if "b" in leaf:
        y = y + leaf["b"].float()
    return y.to(dtype)


def _plain(x: torch.Tensor, leaves) -> Tuple[torch.Tensor, ...]:
    B, T, D = x.shape
    xq, sx = quant_rows(x.reshape(-1, D).float())
    return tuple(_dequant_dot(xq, sx, l, x.dtype).reshape(B, T, -1)
                 for l in leaves)


def qkv_w8a8_plain(x, lq: Leaf, lk: Leaf, lv: Leaf):
    """Reference math of the TPU kernel K5: one row quantisation of x
    shared by three exact integer products."""
    return _plain(x, (lq, lk, lv))


def proj_w8a8_plain(x, leaf: Leaf) -> torch.Tensor:
    """Reference math of the TPU kernel K6."""
    return _plain(x, (leaf,))[0]


def w8a8_proj_supported(D: int, N: int, dtype) -> bool:
    """The encoder's predicate for K5 / K6: the W8A8 GEMM's shape rules of
    an [N, D] leaf and bf16 activations (the wrappers' refusals)."""
    return dtype == torch.bfloat16 and not w8a8_shape_limits(N, D)


def _launch(name: str, x: torch.Tensor, leaves):
    B, T, D = x.shape
    N = leaves[0]["q"].shape[0]
    for l in leaves:
        require_int8_leaf(name, l["q"], l["s"], l.get("b"), N, D)
    x2 = x.reshape(B * T, D)
    _build.require_cuda(name, x2, dtype=torch.bfloat16)
    lib = _build.library()
    xq, sx = launch_quant_rows(lib, x2, D, name)
    outs = [torch.empty(B, T, N, dtype=x.dtype, device=x.device)
            for _ in leaves]
    launch_gemm_s8(lib, EPI_PROJ, xq, sx,
                   [(l["q"], l["s"], l.get("b"), o)
                    for l, o in zip(leaves, outs)], N, D, name)
    return tuple(outs)


def qkv_w8a8(x: torch.Tensor, lq: Leaf, lk: Leaf, lv: Leaf
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (q, k, v), each [B, T, N]."""
    if x.device.type == "cpu":
        return qkv_w8a8_plain(x, lq, lk, lv)
    return _launch("qkv_w8a8", x, (lq, lk, lv))


def proj_w8a8(x: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    """x [B, T, D] -> [B, T, N]."""
    if x.device.type == "cpu":
        return proj_w8a8_plain(x, leaf)
    return _launch("proj_w8a8", x, (leaf,))[0]
