"""Packed bidirectional attention for the Whisper encoder and the Q-Former
cross-attention (port of ``desta25_audio_tpu/ops/enc_attention.py``).

q [B, Tq, H*Dh], k/v [B, Tkv, H*Dh] with the heads packed in the last dim,
as the projections emit them.  On a CUDA tensor this launches the
hand-written Hopper kernel in ``csrc/enc_attention.cu`` (bf16, Dh = 64, the
head size of every Whisper and Q-Former configuration); on a CPU tensor it
runs :func:`packed_encoder_attention_plain`, the same function in plain
torch at the same rounding points.  It never falls back from the card: the
models ask :func:`enc_attention_supported` (the wrapper's own refusal
rules) first and take their torch path where it is false.

Queries of at most 64 rows (the Q-Former's cross-attention) fill a quarter
of a kernel block's rows, so :func:`plan_key_splits` cuts the keys into
ranges of whole tiles when that covers the card better: the kernel writes
each range's f32 partial sums to scratch and a second launch combines them.

On the card the kernel runs inside an autograd function (the Q-Former's
cross-attention trains through it): its backward recomputes through the
plain version under autograd, as the JAX package's custom VJP recomputes
through XLA (``enc_attention.py:165-182``).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from . import _build

KERNEL_DH = 64
KEY_TILE = 128        # keys per kernel tile
SPLIT_MAX_TQ = 64     # queries of one consumer warpgroup: the cross shape


def _scale(dh: int):
    scale = 1.0 / math.sqrt(dh)
    # fold the scale into q when it is a power of two (exact in bf16)
    folded = math.log2(scale) == round(math.log2(scale))
    return scale, folded


def enc_attention_limits(n_heads: int, d_model: int, dtype) -> List[str]:
    """What the kernel cannot take (empty: it takes it): Dh = KERNEL_DH and
    bf16, the wrapper's refusals."""
    bad = []
    if n_heads < 1 or d_model % n_heads or d_model // n_heads != KERNEL_DH:
        bad.append(f"kernel takes Dh={KERNEL_DH}, got {d_model}/{n_heads}")
    if dtype != torch.bfloat16:
        bad.append(f"dtype {dtype}, kernel takes torch.bfloat16")
    return bad


def enc_attention_supported(n_heads: int, d_model: int, dtype) -> bool:
    """The models' predicate for K2 (``packed_supported`` of the JAX
    package, at this kernel's limits)."""
    return not enc_attention_limits(n_heads, d_model, dtype)


def plan_key_splits(B: int, H: int, Tq: int, Tkv: int, n_sm: int = 132
                    ) -> Tuple[int, ...]:
    """Key boundaries (0, ..., Tkv) of the ranges the kernel attends
    separately; one range unless Tq <= SPLIT_MAX_TQ.  Each range but the
    last is a whole number of KEY_TILE tiles, none is empty.  A block takes
    two ranges (one per consumer warpgroup) and one block runs on an SM at
    a time, so the planner takes the count of ranges that minimises
    waves x (tiles per range + 1), the 1 standing for a block's fixed cost
    (its q load and epilogue); ties go to fewer ranges."""
    if Tq > SPLIT_MAX_TQ:
        return (0, Tkv)
    nt = -(-Tkv // KEY_TILE)
    best = None
    for p in range(1, nt + 1):
        tps = -(-nt // p)
        if -(-nt // tps) != p:   # a range would be empty
            continue
        waves = -(-(B * H * -(-p // 2)) // n_sm)
        cost = waves * (tps + 1)
        if best is None or cost < best[0]:
            best = (cost, p, tps)
    _, p, tps = best
    return tuple(i * tps * KEY_TILE for i in range(p)) + (Tkv,)


def packed_encoder_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, n_heads: int
                                   ) -> torch.Tensor:
    """Reference math of the TPU kernel: scale folded into q in q's dtype
    when exact, f32 scores over all kv rows, P rounded to v's dtype for the
    PV product, division by the f32 denominator at the end."""
    B, Tq, DM = q.shape
    Tkv = k.shape[1]
    dh = DM // n_heads
    scale, folded = _scale(dh)
    qh = q.reshape(B, Tq, n_heads, dh).transpose(1, 2)
    kh = k.reshape(B, Tkv, n_heads, dh).transpose(1, 2).float()
    vh = v.reshape(B, Tkv, n_heads, dh).transpose(1, 2).float()
    if folded:
        qh = (qh.float() * scale).to(q.dtype)
    s = qh.float() @ kh.transpose(-1, -2)
    if not folded:
        s = s * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    o = (e.to(v.dtype).float() @ vh) / den
    return o.transpose(1, 2).reshape(B, Tq, DM).to(q.dtype)


def packed_encoder_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Bidirectional MHA on packed [B, T, H*Dh] tensors -> [B, Tq, H*Dh];
    differentiable in q, k and v."""
    if q.device.type == "cpu":
        return packed_encoder_attention_plain(q, k, v, n_heads)
    return _PackedAttention.apply(q, k, v, n_heads)


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_heads):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads = n_heads
        return _launch(q, k, v, n_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = packed_encoder_attention_plain(q, k, v, ctx.n_heads)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            n_heads: int) -> torch.Tensor:
    name = "packed_encoder_attention"
    B, Tq, DM = q.shape
    Tkv = k.shape[1]
    bad = enc_attention_limits(n_heads, DM, q.dtype)
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
    if k.shape != (B, Tkv, DM) or v.shape != k.shape or Tkv < 1 or Tq < 1:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    _build.require_cuda(name, q, k, v, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    bounds = plan_key_splits(B, n_heads, Tq, Tkv, _build.sm_count(q.device))
    splits = len(bounds) - 1
    part = part_ml = None
    if splits > 1:   # f32 (acc, m, l) of each key range
        part = torch.empty(splits, B, n_heads, Tq, KERNEL_DH,
                           dtype=torch.float32, device=q.device)
        part_ml = torch.empty(splits, B, n_heads, Tq, 2, dtype=torch.float32,
                              device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    scale, _ = _scale(KERNEL_DH)
    lib = _build.library()
    stream = _build.stream_ptr(q.device)
    _build.check(lib.desta_enc_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr(part),
        ptr(part_ml), B, Tq, Tkv, n_heads, scale, splits,
        bounds[1] // KEY_TILE, stream), name)
    _build.count_launch(name)
    if splits > 1:
        _build.check(lib.desta_enc_attention_combine(
            part.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, Tq,
            n_heads, splits, stream), name)
        _build.count_launch(name)
    return out

