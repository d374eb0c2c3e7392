"""Whisper encoder FFN: fc2(gelu(fc1(x))) (port of
``desta25_audio_tpu/ops/enc_ffn.py``: the bf16 kernel K3 and the W8A8
kernel K4).

Weights in the port's ``[out, in]`` layout: w1 [F, D], b1 [F], w2 [D, F],
b2 [D]; the int8 ones likewise (q1 [F, D], q2 [D, F], one f32 scale per
output channel, ``ops/quant.py``).

- :func:`encoder_ffn` (bf16): on a CUDA tensor the Hopper GEMM of
  ``csrc/gemm_sm90.cuh`` twice through ``csrc/enc_ffn.cu`` (fc1 with the
  bias + erf-GELU epilogue, fc2 with the bias epilogue), each launch as
  ``ops/gemm.plan_gemm`` plans it.
- :func:`encoder_ffn_w8a8` (int8 weights): on a CUDA tensor three launches
  of ``csrc/w8a8.cu``: per-row int8 quantisation of x, the int8 fc1 GEMM
  (the same Hopper GEMM) whose epilogue adds the f32 bias, applies GELU and
  quantizes the result per row and 1280-column chunk across the cluster of
  CTAs that spans the chunk (the hidden reaches device memory as int8
  only), and the segmented int8 fc2 GEMM.

On a CPU tensor each runs its ``*_plain`` version; neither falls back from
the card: the encoder asks :func:`enc_ffn_supported` /
:func:`enc_ffn_w8a8_supported` (the wrappers' refusal rules) first.  The
row quantiser and the launches of ``csrc/w8a8.cu`` live in
``ops/quant.py``, shared with ``ops/w8a8_proj.py``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from . import _build
from .gemm import (
    EPI_BIAS,
    EPI_BIAS_GELU,
    EPI_GELU_Q8,
    EPI_SEG,
    Q8_CHUNK,
    plan_gemm,
)
from .quant import (
    int_dot,
    launch_gemm_s8,
    launch_quant_rows,
    quant_rows,
    require_int8_leaf,
    w8a8_shape_limits,
)

# K4 quantizes the GELU output per row and per chunk of this many columns
# (desta25_audio_tpu/ops/enc_ffn.py:174-185), not over the whole row
CHUNK_F = Q8_CHUNK


def enc_ffn_limits(D: int, F: int, dtype) -> List[str]:
    """What K3 cannot take (empty: it takes it), the wrapper's refusals."""
    bad = []
    if D % 128 or F % 128:
        bad.append(f"kernel needs D and F multiples of 128, got D={D} F={F}")
    if dtype != torch.bfloat16:
        bad.append(f"dtype {dtype}, kernel takes torch.bfloat16")
    return bad


def enc_ffn_supported(D: int, F: int, dtype) -> bool:
    """The encoder's predicate for K3 (``ffn_supported`` of the JAX
    package, at this kernel's limits)."""
    return not enc_ffn_limits(D, F, dtype)


def enc_ffn_w8a8_limits(D: int, F: int, dtype) -> List[str]:
    """What K4 cannot take (empty: it takes it), the wrapper's refusals:
    both int8 GEMMs' shape rules (fc1 [F, D], fc2 [D, F]), whole 1280-column
    chunks (fc1's clusters quantize a chunk together; the JAX predicate
    ``ffn_w8a8_supported``'s own rule) and bf16."""
    bad = w8a8_shape_limits(F, D) + w8a8_shape_limits(D, F)
    if F % CHUNK_F:
        bad.append(f"kernel needs F % {CHUNK_F} == 0, got F={F}")
    if dtype != torch.bfloat16:
        bad.append(f"dtype {dtype}, kernel takes torch.bfloat16")
    return bad


def enc_ffn_w8a8_supported(D: int, F: int, dtype) -> bool:
    """The encoder's predicate for K4."""
    return not enc_ffn_w8a8_limits(D, F, dtype)


def encoder_ffn_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Reference math of the TPU kernel: fc1 accumulated in f32 feeds the
    GELU unrounded; the GELU output is rounded to x's dtype before fc2.
    (Exact erf here; the TPU kernel's A&S 7.1.26 erf is within 1.5e-7.)"""
    h = x.float() @ w1.float().t() + b1.float()
    g = F.gelu(h).to(x.dtype)
    y = g.float() @ w2.float().t() + b2.float()
    return y.to(x.dtype)


def _gemm(lib, a, w, bias, out, gelu: bool) -> None:
    M, K = a.shape
    N = w.shape[0]
    p = plan_gemm(M, N, K, EPI_BIAS_GELU if gelu else EPI_BIAS,
                  n_sm=_build.sm_count(a.device))
    _build.check(lib.desta_gemm_bias(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), M, N, K,
        int(gelu), p.bm, p.bn, p.cluster, _build.stream_ptr(a.device)),
        "encoder_ffn")
    _build.count_launch("encoder_ffn")


def encoder_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D]."""
    if x.device.type == "cpu":
        return encoder_ffn_plain(x, w1, b1, w2, b2)
    name = "encoder_ffn"
    B, T, D = x.shape
    Fd = w1.shape[0]
    if (w1.shape != (Fd, D) or b1.shape != (Fd,) or w2.shape != (D, Fd)
            or b2.shape != (D,)):
        raise ValueError(f"{name}: weight shapes {tuple(w1.shape)} "
                         f"{tuple(b1.shape)} {tuple(w2.shape)} "
                         f"{tuple(b2.shape)} for D={D}")
    bad = enc_ffn_limits(D, Fd, x.dtype)
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
    x2 = x.reshape(B * T, D)
    _build.require_cuda(name, x2, w1, b1, w2, b2, dtype=torch.bfloat16)
    lib = _build.library()
    hidden = torch.empty(B * T, Fd, dtype=x.dtype, device=x.device)
    out = torch.empty(B * T, D, dtype=x.dtype, device=x.device)
    _gemm(lib, x2, w1, b1, hidden, gelu=True)
    _gemm(lib, hidden, w2, b2, out, gelu=False)
    return out.reshape(B, T, D)


# -- W8A8 (K4) ----------------------------------------------------------------

def encoder_ffn_w8a8_plain(x, q1, s1, b1, q2, s2, b2) -> torch.Tensor:
    """Reference math of the TPU kernel K4, at its f32 rounding points.
    (Exact erf here; the TPU kernel's A&S 7.1.26 erf is within 1.5e-7.)"""
    B, T, D = x.shape
    xq, sx = quant_rows(x.reshape(-1, D).float())
    h = int_dot(xq, q1) * (sx * s1.float()) + b1.float()
    g = F.gelu(h)
    acc = None
    for c0 in range(0, g.shape[1], CHUNK_F):
        gq, sg = quant_rows(g[:, c0:c0 + CHUNK_F])
        p = int_dot(gq, q2[:, c0:c0 + CHUNK_F]) * sg * s2.float()
        acc = p if acc is None else acc + p
    return (acc + b2.float()).to(x.dtype).reshape(B, T, D)


def encoder_ffn_w8a8(x: torch.Tensor, q1, s1, b1, q2, s2, b2
                     ) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D] through int8 fc1 (q1 [F, D]) and fc2
    (q2 [D, F]) with per-output-channel scales s1 [F], s2 [D]."""
    if x.device.type == "cpu":
        return encoder_ffn_w8a8_plain(x, q1, s1, b1, q2, s2, b2)
    name = "encoder_ffn_w8a8"
    B, T, D = x.shape
    Fd = q1.shape[0]
    M = B * T
    bad = enc_ffn_w8a8_limits(D, Fd, x.dtype)
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
    require_int8_leaf(name, q1, s1, b1, Fd, D)
    require_int8_leaf(name, q2, s2, b2, D, Fd)
    x2 = x.reshape(M, D)
    _build.require_cuda(name, x2, dtype=torch.bfloat16)
    lib = _build.library()
    xq, sx = launch_quant_rows(lib, x2, D, name)
    gq = torch.empty(M, Fd, dtype=torch.int8, device=x.device)
    sg = torch.empty(M, Fd // CHUNK_F, dtype=torch.float32, device=x.device)
    launch_gemm_s8(lib, EPI_GELU_Q8, xq, sx, [(q1, s1, b1, gq)], Fd, D, name,
                   out_scale=sg)
    out = torch.empty(M, D, dtype=x.dtype, device=x.device)
    launch_gemm_s8(lib, EPI_SEG, gq, sg, [(q2, s2, b2, out)], D, CHUNK_F,
                   name)
    return out.reshape(B, T, D)
