"""Symmetric int8 quantisation for the Whisper encoder, the LLM and the ORCA
cross-attention stack
(counterpart of ``desta25_audio_tpu/ops/quant.py:30-53, 262-377`` and of the
row quantiser ``desta25_audio_tpu/ops/enc_ffn.py:161-166``).

A quantized leaf is ``{"q": int8 [..., out, in], "s": float32 [..., out]}``
(plus the linear's ``"b"``): one scale per output channel, in the port's
``[out, in]`` layout, so the max runs over the last (``in``) axis.  Leading
axes (the stacked layer axis) are carried through, which is what the JAX
package's ``jax.vmap(quantize_weight)`` over layers computes.

Activations are quantized per row at run time (:func:`quant_rows`).  This
module also owns the launch interface of ``csrc/w8a8.cu`` (the row
quantiser and the int8 GEMM of ``csrc/gemm_sm90.cuh``, planned by
``ops/gemm.plan_gemm``), which the W8A8 kernels K4 (``ops/enc_ffn.py``) and
K5/K6 (``ops/w8a8_proj.py``) and the int8 LLM's W8A8 prefill
(``ops/qmm.py``) share.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from . import _build
from .core import div_exact
from .gemm import plan_gemm

QuantLeaf = Dict[str, torch.Tensor]

# the LLM's quantized head is zero-padded to a multiple of this many output
# rows, padded scales 1.0 (desta25_audio_tpu/ops/quant.py:352-355)
HEAD_PAD = 2560
# the matmul weights of a port LLM layer stack ([L, out, in])
LLM_QUANT_KEYS = ("wqkv", "wo", "w_gu", "w_down")


def quantize_weight(w: torch.Tensor) -> QuantLeaf:
    """[..., out, in] float -> {"q": int8, "s": f32 [..., out]}.

    ``s = max(max|w| / 127, 1e-8)`` and ``q = clip(round_half_even(w / s),
    -127, 127)``, all in f32.  Both are IEEE divisions, as in the JAX
    package, on every device (``ops/core.div_exact``): a weight quantized on
    the card gets the bits it gets on the CPU."""
    wf = w.float()
    s = torch.clamp(div_exact(wf.abs().amax(-1), 127.0), min=1e-8)
    q = torch.clamp(torch.round(wf / s[..., None]), -127, 127)
    return {"q": q.to(torch.int8), "s": s}


def dequantize_weight(leaf: QuantLeaf, dtype=torch.bfloat16) -> torch.Tensor:
    return (leaf["q"].float() * leaf["s"][..., None]).to(dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


def quantize_linear(p: Dict[str, Any]) -> Dict[str, Any]:
    """{"w", "b"?} -> {"q", "s", "b"?}; works on stacked weights too."""
    out: Dict[str, Any] = dict(quantize_weight(p["w"]))
    if "b" in p:
        out["b"] = p["b"]
    return out


def _quantize_stacked(w: torch.Tensor) -> QuantLeaf:
    """quantize_weight over a stacked [L, out, in] weight, one layer at a
    time (identical results; bounds the f32 temporaries to one layer)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-1], dtype=torch.float32, device=w.device)
    for l in range(w.shape[0]):
        leaf = quantize_weight(w[l])
        q[l], s[l] = leaf["q"], leaf["s"]
    return {"q": q, "s": s}


def _quantize_head(w: torch.Tensor) -> QuantLeaf:
    """[V, D] head (or embedding) -> int8 leaf with V zero-padded to a
    multiple of HEAD_PAD rows (padded scales 1.0), quantized in row blocks
    of HEAD_PAD."""
    V, D = w.shape
    Vp = -(-V // HEAD_PAD) * HEAD_PAD
    q = torch.zeros(Vp, D, dtype=torch.int8, device=w.device)
    s = torch.ones(Vp, dtype=torch.float32, device=w.device)
    for v0 in range(0, V, HEAD_PAD):
        v1 = min(V, v0 + HEAD_PAD)
        leaf = quantize_weight(w[v0:v1])
        q[v0:v1], s[v0:v1] = leaf["q"], leaf["s"]
    return {"q": q, "s": s}


def quantize_llm_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The LLM's matmul weights to int8 (``quantize_llm_params`` of the JAX
    package): every ``LLM_QUANT_KEYS`` stack per layer and output row, plus
    an int8 ``lm_head`` padded to a multiple of HEAD_PAD rows -- built from
    ``embed`` for a tied model.  Scales are per output row, so quantizing
    the fused ``wqkv`` and the row-interleaved ``w_gu`` equals quantizing
    q/k/v and gate/up apart (the scales concatenate or interleave with the
    rows).  ``embed`` and the norms stay as they are.  Returns a new tree;
    the input is not modified."""
    layers = dict(params["layers"])
    for key in LLM_QUANT_KEYS:
        layers[key] = _quantize_stacked(layers[key])
    return {**params, "layers": layers,
            "lm_head": _quantize_head(params.get("lm_head", params["embed"]))}


def quantize_orca_cross_attns(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8 for the ORCA gated cross-attention stack
    (``quantize_orca_cross_attns`` of the JAX package, an inference-time
    transform): the stacked q, k, v, o and gate1 linears become ``{q, s,
    b}`` leaves, per layer and output channel; gate2 (it feeds the sigmoid
    directly) and the LayerNorm stay full precision.  Returns a new tree;
    the input is not modified."""
    layers = dict(params["layers"])
    for k in ("q", "k", "v", "o", "gate1"):
        leaf = _quantize_stacked(layers[k]["w"])
        if "b" in layers[k]:
            leaf["b"] = layers[k]["b"]
        layers[k] = leaf
    return {**params, "layers": layers}


def quantize_encoder_params(params: Dict[str, Any],
                            attention: str = "dual") -> Dict[str, Any]:
    """Quantize the Whisper encoder's stacked FFN (fc1, fc2) and, unless
    ``attention="none"``, its q/k/v/o projections.

    ``"dual"`` (the inference default) keeps each attention leaf's bf16
    ``w`` beside ``q``/``s``, so ``models/whisper._enc_self_attn`` can pick
    the int8 arm at small batch and the bf16 arm above
    ``models/whisper.INT8_ATTN_MAXB``; ``"int8"`` drops ``w``.  The FFN
    leaves become ``{q, s, b}``.  Conv stem, positions and LayerNorms are
    kept as they are."""
    if attention not in ("dual", "int8", "none"):
        raise ValueError(f"attention={attention!r}")
    layers = dict(params["layers"])
    if attention != "none":
        attn = dict(layers["attn"])
        for k in ("q", "k", "v", "o"):
            leaf = quantize_linear(attn[k])
            if attention == "dual":
                leaf["w"] = attn[k]["w"]
            attn[k] = leaf
        layers["attn"] = attn
    for k in ("fc1", "fc2"):
        layers[k] = quantize_linear(layers[k])
    return {**params, "layers": layers}


# -- activations: plain math -----------------------------------------------

def quant_rows(x: torch.Tensor):
    """f32 [m, k] -> (int8 [m, k], f32 [m, 1] scale); symmetric per row:
    ``s = max(max|x|, 1e-8) * (1/127)`` (a multiplication, unlike the
    weight scale), ``q = clip(round_half_even(x / s), -127, 127)``."""
    s = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def quant_rows_llm(x: torch.Tensor, amax=None):
    """The LLM's W8A8 row quantiser (desta25_audio_tpu/ops/quant.py:123-126):
    f32 [m, k] -> (int8, f32 [m, 1]); ``s = max(max|x|, 1e-8) / 127`` (a
    division, unlike :func:`quant_rows`), ``q = round_half_even(x / s)``
    (|x / s| <= 127, so no clip is needed).  The divisor is a tensor: a
    Python-number divisor makes PyTorch's CUDA kernel multiply by its
    reciprocal, which rounds differently.  ``amax`` [m, 1]: each row's
    max|x| taken over more columns than x holds (a tensor-parallel shard of
    the row; it bounds x's own)."""
    if amax is None:
        amax = x.abs().amax(-1, keepdim=True)
    amax = torch.clamp(amax, min=1e-8)
    s = amax / torch.full_like(amax, 127.0)
    return torch.round(x / s).to(torch.int8), s


def int_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product int8 a [m, k] . int8 w [n, k]^T -> f32 [m, n].
    The sums stay below 2**53, so float64 is exact (f32 is not, for
    127*127*1280-sized sums); one rounding to f32, as int32 -> f32."""
    return (a.double() @ w.double().t()).float()


def int8_act_linear(leaf: QuantLeaf, x: torch.Tensor) -> torch.Tensor:
    """An int8 linear leaf [N, K] on x [..., K] by the JAX package's
    ``int8_act_matmul`` (``quant.py:239-259``, what its ``core.linear``
    does with an int8 leaf): x quantized per row by the LLM's rule, an
    exact integer product, ``f32(acc) * a * s + b``, rounded to x's dtype.
    The torch path of the encoder's int8 leaves where no kernel takes the
    shape."""
    K = x.shape[-1]
    xq, a = quant_rows_llm(x.reshape(-1, K).float())
    y = int_dot(xq, leaf["q"]) * a * leaf["s"].float()
    if "b" in leaf:
        y = y + leaf["b"].float()
    return y.to(x.dtype).reshape(*x.shape[:-1], -1)


# -- csrc/w8a8.cu launches ---------------------------------------------------

def launch_quant_rows(lib, x: torch.Tensor, seg: int, name: str,
                      div127: bool = False):
    """quant_rows_kernel: x [M, K] bf16 -> (int8 [M, K], f32 scales
    [M, ceil(K / seg)]); counts one launch of ``name``.  ``div127`` takes
    the LLM's scale ``max(max|x|, 1e-8) / 127`` (``quant_rows_llm``)."""
    M, K = x.shape
    q = torch.empty(M, K, dtype=torch.int8, device=x.device)
    s = torch.empty(M, -(-K // seg), dtype=torch.float32, device=x.device)
    _build.check(lib.desta_quant_rows(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), M, K, seg, int(div127),
        _build.stream_ptr(x.device)), name)
    _build.count_launch(name)
    return q, s


def launch_gemm_s8(lib, epi: int, a, sa, operands, N: int, seg: int,
                   name: str, out_scale=None) -> None:
    """The int8 GEMM: a int8 [M, K] with row scales sa, against up to three
    (w int8 [N, K], s f32 [N], bias bf16 [N] or None, out [M, N]) sets in
    one launch, as ``plan_gemm`` plans it at the device's SM count; counts
    one launch of ``name``.  ``out_scale``: GELU_Q8's f32 [M, N / 1280]
    row scales of its int8 out."""
    M, K = a.shape
    ptrs = []
    for w, s, b, out in operands:
        ptrs += [w.data_ptr(), s.data_ptr(),
                 None if b is None else b.data_ptr(), out.data_ptr()]
    ptrs += [None] * (12 - len(ptrs))
    p = plan_gemm(M, N, K, epi, len(operands), _build.sm_count(a.device))
    _build.check(lib.desta_gemm_s8(
        epi, a.data_ptr(), sa.data_ptr(), len(operands), *ptrs,
        None if out_scale is None else out_scale.data_ptr(), M, N, K, seg,
        p.bm, p.bn, p.splits, p.cluster, _build.stream_ptr(a.device)), name)
    _build.count_launch(name)


def w8a8_shape_limits(n: int, k: int) -> List[str]:
    """What the W8A8 GEMM of csrc/w8a8.cu cannot take of an [n, k] weight
    (empty: it takes it): its tiles are 128 columns wide at the least, and
    the predicates keep the 64-byte K rule of the kernel it replaced."""
    if n % 128 or k % 64:
        return [f"kernel needs N % 128 == 0 and K % 64 == 0, got N={n} K={k}"]
    return []


def require_int8_leaf(name: str, q, s, b, n: int, k: int) -> None:
    """Shapes, types and placement of one int8 linear (bias optional) as
    the W8A8 kernels take it: q [n, k] int8, s [n] f32, b [n] bf16."""
    if q.shape != (n, k) or s.shape != (n,) or (
            b is not None and b.shape != (n,)):
        raise ValueError(f"{name}: int8 leaf shapes {tuple(q.shape)} "
                         f"{tuple(s.shape)} for [{n}, {k}]")
    bad = w8a8_shape_limits(n, k)
    if bad:
        raise ValueError(f"{name}: " + bad[0])
    _build.require_cuda(name, q, dtype=torch.int8)
    _build.require_cuda(name, s, dtype=torch.float32)
    if b is not None:
        _build.require_cuda(name, b, dtype=torch.bfloat16)
