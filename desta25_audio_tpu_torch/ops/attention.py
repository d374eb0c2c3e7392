"""Attention dispatch for the cache-less LLM forward, and K11: causal flash
attention with segment ids, forward and backward (port of
``desta25_audio_tpu/ops/attention.py``).

:func:`mha` takes the JAX package's dispatch: with no arbitrary ``mask``,
equal query and key lengths and T >= 512 it calls :func:`flash_attention`;
otherwise the plain masked path, :func:`.core.mha` (the JAX package's
``ops/core.mha``: f32 scores, the unnormalised weights rounded to v's dtype
for the PV product, division by the f32 sum).

The flash path's semantics are those of the library kernel the JAX package
calls on the TPU (``jax.experimental.pallas.ops.tpu.flash_attention``):
``attention_mask`` becomes the segment ids (real tokens 1, padding 0) and a
query attends to a key only inside its own segment (and causally), so pad
queries attend to pad keys.  The JAX package pads T to a multiple of 256 for
the TPU's blocks; the port masks by bounds instead, which gives the same
values on every row.

On a CUDA tensor :func:`flash_attention` runs the hand-written Hopper kernels
of ``csrc/flash_attention.cu`` through an autograd function: the forward
saves the f32 log-sum-exp, the backward computes D = rowsum(dO * O), then dK
and dV (summed over each kv head's query heads without atomics), then dQ.
On a CPU tensor it runs :func:`flash_attention_plain`, the same function in
plain torch at the library kernel's rounding points, and autograd through it
is the backward.  It never falls back from the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, core

# the library kernel's additive mask (flash_attention.py DEFAULT_MASK_VALUE)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_MIN_T = 512          # the JAX dispatch's threshold (attention.py:78)
KERNEL_DH = (64, 128)      # head dims the kernels are built for


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segment_ids: torch.Tensor, causal: bool,
                          scale: float) -> torch.Tensor:
    """K11's function in plain torch at the library kernel's rounding points
    (its single-block path, which the JAX dispatch takes up to T = 1536):
    f32 scores times ``scale``, the additive mask ``MASK_VALUE`` outside
    the segment (and above the diagonal), f32 softmax normalised before P is
    rounded to v's dtype, f32 PV sums, one rounding to q's dtype.

    q [B, T, H, D], k/v [B, T, Hkv, D], segment_ids [B, T] int ->
    [B, T, H, D]."""
    B, T, H, _ = q.shape
    G = H // k.shape[2]
    qt = q.transpose(1, 2).float()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).float()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    s = (qt @ kt.transpose(-1, -2)) * scale
    seg = segment_ids
    allowed = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones(T, T, dtype=torch.bool,
                                       device=q.device).tril()
    s = s + torch.where(allowed, 0.0, MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    p = p / p.sum(-1, keepdim=True)
    o = p.to(v.dtype).float() @ vt.float()
    return o.to(q.dtype).transpose(1, 2)


def flash_limits(H: int, Hkv: int, D: int, dtype) -> list:
    """What K11 cannot take (empty: it takes it), the wrapper's refusals."""
    bad = []
    if D not in KERNEL_DH or Hkv < 1 or H % Hkv:
        bad.append(f"kernel takes Dh in {KERNEL_DH} and H a multiple of "
                   f"Hkv, got Dh={D} H={H} Hkv={Hkv}")
    if dtype != torch.bfloat16:
        bad.append(f"dtype {dtype}, kernel takes torch.bfloat16")
    return bad


def _check(name: str, q, k, v, seg) -> None:
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    bad = flash_limits(H, Hkv, D, torch.bfloat16)
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape \
            or seg.shape != (B, T):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} segment_ids "
                         f"{tuple(seg.shape)}")
    _build.require_cuda(name, q, k, v, dtype=torch.bfloat16)
    _build.require_cuda(name, seg, dtype=torch.int32)


def _flash_fwd(q, k, v, seg, causal: bool, scale: float):
    """K11 forward on the card -> (o [B, T, H, D] bf16, lse [B, H, T] f32)."""
    name = "flash_attention"
    _check(name, q, k, v, seg)
    B, T, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    lib = _build.library()
    _build.check(lib.desta_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, T, H, k.shape[2], D, int(causal),
        scale, _build.stream_ptr(q.device)), name)
    _build.count_launch(name)
    return o, lse


def _flash_bwd(q, k, v, seg, o, lse, do, causal: bool, scale: float):
    """K11 backward on the card: D = rowsum(dO * O), then dK/dV, then dQ
    (three launches) -> (dq, dk, dv) in bf16."""
    name = "flash_attention_bwd"
    _check(name, q, k, v, seg)
    _build.require_cuda(name, o, do, dtype=torch.bfloat16)
    _build.require_cuda(name, lse, dtype=torch.float32)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = _build.library()
    stream = _build.stream_ptr(q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    launches = (
        lambda: lib.desta_flash_bwd_delta(o.data_ptr(), do.data_ptr(),
                                          delta.data_ptr(), B, T, H, D,
                                          stream),
        lambda: lib.desta_flash_bwd_dkdv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                         B, T, H, Hkv, D, int(causal), scale,
                                         stream),
        lambda: lib.desta_flash_bwd_dq(*ptrs, dq.data_ptr(), B, T, H, Hkv, D,
                                       int(causal), scale, stream))
    for launch in launches:
        _build.check(launch(), name)
        _build.count_launch(name)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K11 with its backward kernels.  Under ``torch.utils.checkpoint`` the
    forward runs again before the backward, and the log-sum-exp saved then
    is the one the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, scale):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = _flash_fwd(q, k, v, seg, causal, scale)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, seg, o, lse, do.contiguous(),
                                ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention with segment ids.  q [B, T, H, D], k/v [B, T, Hkv, D]
    (GQA: query head h reads kv head h // (H / Hkv)), segment_ids [B, T]
    int32 -> [B, T, H, D] in q's dtype; differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, segment_ids, causal, scale)
    return _FlashAttention.apply(q, k, v, segment_ids.to(torch.int32)
                                 .contiguous(), causal, scale)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's ``ops/attention.mha`` dispatch.  q [B, T, H, D],
    k/v [B, S, Hkv, D]; ``mask`` broadcastable to [B, H, T, S] (True
    attends); ``attention_mask`` [B, T] 1/0 per token.  Flash path when
    there is no ``mask``, S == T and T >= 512 (the JAX rule: its TPU
    library kernel takes any head size and dtype, and so does the plain
    version on the CPU); on the card also only where K11 takes the heads
    and the dtype (:func:`flash_limits`; else counted by
    ``_build.count_fallback``).  Otherwise the masked path with ``mask``,
    or with the causal and per-token masks combined."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if mask is None and k.shape[1] == T and T >= FLASH_MIN_T:
        if not (q.is_cuda and flash_limits(H, k.shape[2], D, q.dtype)):
            seg = (attention_mask if attention_mask is not None
                   else torch.ones(B, T, dtype=torch.int32, device=q.device))
            return flash_attention(q, k, v, seg.to(torch.int32), causal,
                                   scale)
        _build.count_fallback("flash_attention")
    full = mask
    if full is None and (causal or attention_mask is not None):
        full = torch.ones(1, 1, T, k.shape[1], dtype=torch.bool,
                          device=q.device)
        if causal:
            full = full.tril()
        if attention_mask is not None:
            full = full & (attention_mask[:, None, None, :] > 0)
    return core.mha(q, k, v, full, scale)
