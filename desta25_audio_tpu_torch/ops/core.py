"""Core building blocks on tensors: linear, norms, GELU, conv1d, attention.

Counterpart of ``desta25_audio_tpu/ops/core.py``.  Parameters are plain
nested dicts of tensors, as in the JAX package, with one layout change:
linear weights are stored ``[out, in]`` (PyTorch's ``nn.Linear`` order, the
order the port's kernels read) and conv weights ``[out, in, kernel]``;
``ckpt/bridge.py`` transposes the JAX ``[in, out]`` / ``[kernel, in, out]``
leaves.

Numerics follow the JAX package: products accumulate in f32 and round once to
the activation dtype; a bf16 activation against an f32 weight (the Q-Former's
f32 connector params) promotes the product to f32, as ``jnp.dot`` does.
Normalisation statistics and softmax are f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one IEEE division on every device.  PyTorch's
    CUDA kernel multiplies by ``1 / d`` when the divisor is a Python
    number, which rounds differently (by one ulp in a few per cent of
    elements) from the JAX package's division; a tensor divisor divides."""
    return x / torch.full_like(x, d)


class _MatmulBf16F32(torch.autograd.Function):
    """bf16 x bf16 -> f32 on the card, differentiable.  The backward's two
    products are bf16 cuBLAS products with f32 sums, the incoming f32
    gradient rounded to bf16 first (exact where the caller rounded the
    product to bf16, as every projection does); each gradient is returned in
    its input's dtype, as JAX's transpose of a dot does."""

    @staticmethod
    def forward(ctx, a2, b):
        ctx.save_for_backward(a2, b)
        return torch.mm(a2, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a2, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, b.t(), out_dtype=torch.float32).to(a2.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a2.t(), g, out_dtype=torch.float32).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result (JAX's
    ``preferred_element_type=float32``).  a: [..., K]; b: [K, N].

    bf16 x bf16 on the card asks cuBLAS for an f32 output directly (through
    :class:`_MatmulBf16F32`, so gradients flow); every other case multiplies
    f32 copies (exact for bf16 inputs)."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a2.is_cuda and a2.dtype == b.dtype == torch.bfloat16:
        out = _MatmulBf16F32.apply(a2, b)
    else:
        out = torch.mm(a2.float(), b.float())
    return out.reshape(*lead, b.shape[-1])


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T + b, f32 accumulation, x's dtype out."""
    y = matmul_f32(x, p["w"].t())
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Erf GELU (Whisper and BERT), computed in f32."""
    return F.gelu(x.float()).to(x.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention in plain torch (the Q-Former's attention and the
    LLM's masked path).  q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D] with
    H % Hkv == 0 (GQA: kv heads repeated); mask broadcastable to
    [B, H, Tq, Tk], True attends -> [B, Tq, H, D].

    f32 scores times ``scale`` (default 1/sqrt(D)) and f32 softmax; the
    unnormalised weights are rounded to v's dtype for the PV product and the
    output is divided by the f32 sum (``ops/core.py:156-198`` of the JAX
    package).
    """
    H, Hkv = q.shape[2], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    logits = (qt @ kt.transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), -1e30, device=q.device))
    # the output does not depend on m, so its gradient is zero in exact
    # arithmetic: detached, autograd skips the amax backward over [Tq, Tk]
    m = logits.amax(-1, keepdim=True).detach()
    e = torch.exp(logits - m)
    den = e.sum(-1, keepdim=True)
    out = (e.to(v.dtype).float() @ vt) / den
    return out.transpose(1, 2).to(q.dtype)


def conv1d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x: [B, T, C_in] (NWC, as the JAX package) -> [B, T', C_out].

    f32 convolution of the (exactly upcast) operands, bias in f32, one
    rounding to x's dtype -- the JAX conv's f32 accumulation.  TF32 must be
    off on the card (cuDNN allows it by default); the model turns it off."""
    y = F.conv1d(x.transpose(1, 2).float(), p["w"].float(), None,
                 stride=stride, padding=padding)
    y = y + p["b"].float()[None, :, None]
    return y.transpose(1, 2).to(x.dtype).contiguous()


def index_tree(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked parameter tree (leading layer axis)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]
