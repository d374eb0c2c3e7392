"""One LLM decode step through all layers, and the speculative verify step
(port of ``desta25_audio_tpu/ops/fused_decode.py::fused_decode_layers`` and
``fused_verify_layers``, with the optional in-kernel ORCA injection).

Per layer, for R = B*Kd token rows (Kd = 1 decodes, Kd = 2..8 verifies a
draft): RMSNorm -> fused q/k/v projection -> qk-norm (Qwen3) + RoPE -> GQA
attention over the packed cache [L, B, S, Hkv*Dh] plus the row's own draft
block, writing the Kd new k/v rows at ci..ci+Kd-1 (ci = each row's cache
index) -> o-proj + bf16 residual -> RMSNorm -> SwiGLU -> down-proj + bf16
residual.  Draft token j attends the cached keys below ci that the mask
allows plus draft tokens 0..j; the draft block is computed in f32 from the
post-RoPE k rounded to bf16 and is never read back from the cache
(``fused_decode.py:581-660`` of the JAX package).

Layer weights (``models/llm.py``, stacked on a leading layer axis, ``[out,
in]``): ``wqkv`` [L, (H+2*Hkv)*Dh, D] (q, k, v rows concatenated), ``wo``
[L, D, H*Dh], ``w_gu`` [L, 2*I, D] with gate and up rows interleaved (row
2n = gate n, row 2n+1 = up n), ``w_down`` [L, D, I], norms ``ln1``/``ln2``
(and ``q_norm``/``k_norm``) ``{"scale": [L, .]}``.  The four weight stacks
are all bf16 tensors (the bf16 stream) or all int8 leaves ``{"q": int8
[L, out, in], "s": f32 [L, out]}`` (``ops/quant.quantize_llm_params``; the
int8 stream, scale applied to the f32 sum, ``fused_decode.py:423-443``).

ORCA deep injection (``inject=``, K8i; ``fused_decode.py:731-823`` of the
JAX package): after each layer's down-projection residual, every token row
gets the gated cross-attention of ``models/orca.gated_cross_attention_apply``
over its batch row's precomputed audio K/V, at the TPU kernel's rounding
points (``csrc/fused_inject.cu`` lists them).  ``inject`` is a dict:
``params`` (the int8 cross-attention stack of
``ops/quant.quantize_orca_cross_attns``), ``k``/``v`` ([L, B, Ta, D] audio
K/V, keys past ``ta_real`` unused), ``ta_real``, ``heads`` (injection
heads; head dim D/heads) and ``on`` ([B] float, 1 = inject this row; every
draft token of a row shares it).  It needs the int8 tower, as the TPU
kernel does.

On CUDA tensors this launches the kernels of ``csrc/fused_decode.cu`` (7 per
layer, counted as ``fused_decode_layers`` for the bf16 decode step,
``fused_decode_layers_int8`` for the int8 one and ``fused_verify_layers``
for a verify step on either tower) and, with ``inject``, those of
``csrc/fused_inject.cu`` (5 more per layer, counted as
``fused_decode_inject``); on CPU tensors it runs
:func:`fused_decode_layers_plain`, the same function at the same rounding
points in the activation dtype.  The cache is updated IN PLACE on both paths
and also returned, so callers keep the JAX API shape.  :class:`FusedStep`
holds one step's launches; the tensor-parallel step
(``ops/fused_decode_mesh.py``, K10) runs one per rank.

The step's norm is one launch a row block of ``csrc/fused_decode.cu``
(16-byte loads, the row kept in registers), also launched alone by
:func:`decode_rms_norm` (counted as ``rms_norm``; each step launch in
``_build.kernel_counts()``), plain version :func:`rms_plain`.  The norm,
the GEMMs and the attention are launched with programmatic dependent launch
(``csrc/common.cuh``), so each may start while the one before drains; the
step as a whole is captured as one CUDA graph by ``generate/graph.py``.

The step's attention launch (``csrc/decode_attention.cuh``, shared with
K9) splits each (row, kv head, draft token)'s cached keys across a
thread-block cluster by :func:`plan_decode_splits`; it is also launched
alone by :func:`decode_attention`, whose plain version
:func:`decode_attention_plain` is the middle of :func:`attention_plain`.
Each step launch of it is counted in ``_build.kernel_counts()`` as
``decode_attention``, and each launch of the step's weight-streaming GEMM
(``csrc/skinny_gemm.cuh``, ``ops/skinny_gemm.py``) as ``skinny_gemm``,
beside the step's own launch counts.  :func:`fused_decode_supported` is the
models' predicate: where it is false they run their layer loop instead.

The injection's attention (its keys split across a thread-block cluster
by :func:`plan_inject_splits`) and its gate are launched alone by
:func:`inject_attention` and :func:`inject_gate`, whose plain versions
:func:`inject_attention_plain` and :func:`inject_gate_plain` are the
middle and the end of :func:`_inject_plain`; each step launch of them is
counted in ``_build.kernel_counts()`` as ``inject_attention`` and
``inject_gate``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .core import matmul_f32
from .quant import LLM_QUANT_KEYS, is_quantized
from .rope import llm_rope_cos_sin
from .skinny_gemm import (
    EPI_BIAS,
    EPI_BIAS_GELU,
    EPI_RESID,
    EPI_STORE,
    EPI_SWIGLU,
    passes,
)
KERNEL_DH = 128
KERNEL_GROUPS = (1, 2, 4, 8)
KD_MAX = 8                          # draft tokens per row (the JAX kd <= 8)
VERIFY_SCORES_BUDGET = 6 * 1024 * 1024   # B*Kd*H*S*4 (JAX _SCORES_BUDGET)
INJECT_DH_MAX = 256                 # injection head dims the kernel takes
INJECT_LN_EPS = 1e-5
# csrc/fused_inject.cu: keys per tile of a range, the most CTAs of a
# cluster, the bytes of K and V a range keeps in shared memory, TMA's most
# box rows, slots of partial outputs, floats of softmax statistics
INJECT_KEY_TILE = 8
INJECT_SPLITS_MAX = 8
INJECT_KV_BUDGET = 160 * 1024
INJECT_BOX_MAX = 256
INJECT_SLOTS = 4
INJECT_STATS = 280
_SMEM_LIMIT = 227 * 1024
# csrc/decode_attention.cuh: keys per TMA tile, ring stages, the most CTAs
# of a cluster (the portable cluster size)
DECODE_KEY_TILE = 32
DECODE_STAGES = 4
DECODE_SPLITS_MAX = 8
RMS_D_MAX = 32768    # csrc/fused_decode.cu: 512 threads x 8 loads of 8


class KVCache(NamedTuple):
    """Packed KV cache, heads folded into the last axis:
    k, v [L, B, S, Hkv*Dh] (the layout of the JAX package)."""
    k: torch.Tensor
    v: torch.Tensor


def _row_indices(cache_index, B: int, device) -> torch.Tensor:
    """Each row's cache write position, int32 [B] on ``device``, from an
    int or a [B] tensor.  An int reaches the card by a host-to-device copy,
    which a CUDA graph capture cannot hold: a captured step passes its
    static int32 device tensor (``generate/graph.py``)."""
    if (not torch.is_tensor(cache_index)
            and torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        raise ValueError("a Python cache index inside a CUDA graph capture: "
                         "pass the rows' int32 cache indices on the device")
    ci = torch.as_tensor(cache_index, device=device)
    if ci.dim() == 0:
        ci = ci.expand(B)
    return ci.to(torch.int32).contiguous()


def tower_is_int8(params) -> bool:
    """True for int8 layer weights, False for bf16; raises on a mix."""
    kinds = {is_quantized(params["layers"][k]) for k in LLM_QUANT_KEYS}
    if len(kinds) != 1:
        raise ValueError("layer weights mix int8 leaves and bf16 tensors")
    return kinds.pop()


def plan_decode_splits(B: int, Hkv: int, S: int, n_sm: int = 132
                       ) -> Tuple[int, ...]:
    """Key boundaries (0, ..., S) of the ranges that the CTAs of one
    cluster of the decode attention (``csrc/decode_attention.cuh``, which
    applies the same rule with the card's SM count) attend apart.  A draft
    token has B*Hkv clusters; the planner gives each as many ranges as fill
    the card (at most DECODE_SPLITS_MAX, at least 1, one when the clusters
    alone fill it), then evens them out: every range but the last is a whole
    number of DECODE_KEY_TILE tiles, and none is empty.  It reads the cache
    capacity S, never the cache index, which lives on the device.  The
    verify step (Kd > 1 draft tokens) takes the decode step's plan, so that
    its token 0 is summed as the decode step sums it, bit for bit."""
    if S < 1:
        raise ValueError(f"cache length {S}")
    nt = -(-S // DECODE_KEY_TILE)
    ns = max(1, min(DECODE_SPLITS_MAX, n_sm // (B * Hkv), nt))
    tps = -(-nt // ns)
    ns = -(-nt // tps)
    return tuple(i * tps * DECODE_KEY_TILE for i in range(ns)) + (S,)


def decode_attention_smem(G: int, kd: int, range_len: int) -> int:
    """Dynamic shared memory of one CTA of the decode attention
    (``csrc/decode_attention.cuh`` decode_smem): 1024 bytes of alignment,
    the ring of DECODE_STAGES tiles of 32 keys x 128 dims in bf16 and its
    barriers, then in f32: q and the CTA's partial output [G, 128] each, the
    draft keys [Kdm, 128], the draft scores [G, Kdm], 64 floats of
    reductions and the range's scores [G, keys] (whole tiles).  Kdm is 1 at
    kd = 1, else KD_MAX."""
    kdm = 1 if kd == 1 else KD_MAX
    keys = -(-range_len // DECODE_KEY_TILE) * DECODE_KEY_TILE
    return (1024 + DECODE_STAGES * (DECODE_KEY_TILE * KERNEL_DH * 2 + 8)
            + 4 * (2 * G * KERNEL_DH + kdm * KERNEL_DH + G * kdm + 64
                   + G * keys))


def kernel_limits(cfg, batch: int, kd: int, cache_len: int,
                  int8: bool, n_sm: int = 132) -> List[str]:
    """What the kernels of ``csrc/fused_decode.cu`` cannot take at this
    shape, one message per broken limit (empty: the kernels take it).  The
    decode attention's key ranges are planned for a card of ``n_sm`` SMs
    (``_build.sm_count`` of the step's device), as the C side plans them."""
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    D, I = cfg.hidden_size, cfg.intermediate_size
    bad = []
    if Dh != KERNEL_DH:
        bad.append(f"head_dim {Dh} (kernel: {KERNEL_DH})")
    if H % Hkv or H // Hkv not in KERNEL_GROUPS:
        bad.append(f"H/Hkv = {H}/{Hkv} (kernel: {KERNEL_GROUPS})")
        return bad
    if not 1 <= kd <= KD_MAX:
        bad.append(f"{kd} tokens per row (kernel: 1..{KD_MAX})")
    vec = 16 if int8 else 8          # weight values per 16-byte load
    if D % vec or I % vec or (H * Dh) % vec:
        bad.append(f"D={D}, I={I}, H*Dh={H * Dh} must be multiples of {vec}")
    if D > RMS_D_MAX:
        bad.append(f"D={D} (the norm kernel: up to {RMS_D_MAX})")
    G = H // Hkv
    if cache_len < 1:
        return bad + [f"cache length {cache_len}"]
    bounds = plan_decode_splits(batch, Hkv, cache_len, n_sm)
    smem = decode_attention_smem(G, kd, bounds[1] - bounds[0])
    if smem > _SMEM_LIMIT:
        bad.append(f"cache length {cache_len} needs {smem} bytes of shared "
                   f"memory for the scores of one key range of "
                   f"{bounds[1] - bounds[0]} keys (limit {_SMEM_LIMIT})")
    if kd > 1 and batch * kd * H * cache_len * 4 > VERIFY_SCORES_BUDGET:
        bad.append(f"B*Kd*H*S*4 = {batch * kd * H * cache_len * 4} bytes "
                   f"(limit {VERIFY_SCORES_BUDGET}, as the JAX verify step)")
    return bad


def fused_decode_limits(params, cfg, dtype, batch: int, kd: int,
                        cache_len: int, cache_dtype=torch.bfloat16,
                        n_sm: int = 132) -> List[str]:
    """What the decode (kd = 1) or verify step's kernels cannot take (empty:
    they take it): activations, cache and norms in bf16, a tower of bf16 or
    int8 weights, and :func:`kernel_limits` for a card of ``n_sm`` SMs.
    The wrapper's refusals, asked before any launch."""
    bad = []
    lay = params["layers"]
    if dtype != torch.bfloat16:
        bad.append(f"activations in {dtype} (the kernels take bfloat16)")
    if cache_dtype != torch.bfloat16:
        bad.append(f"a {cache_dtype} cache (the kernels take bfloat16)")
    if lay["ln1"]["scale"].dtype != torch.bfloat16:
        bad.append(f"{lay['ln1']['scale'].dtype} norms (the kernels take "
                   "bfloat16)")
    try:
        int8 = tower_is_int8(params)
    except ValueError as e:
        return bad + [str(e)]
    if not int8 and any(lay[k].dtype != torch.bfloat16
                        for k in LLM_QUANT_KEYS):
        bad.append("layer weights neither int8 leaves nor bfloat16")
    return bad + kernel_limits(cfg, batch, kd, cache_len, int8, n_sm)


def fused_decode_supported(params, cfg, inputs_embeds: torch.Tensor,
                           cache: KVCache) -> bool:
    """The models' predicate for the decode step's kernels (the JAX
    package's ``fused_supported``, at these kernels' limits and the SM
    count of the step's card)."""
    B, kd, _ = inputs_embeds.shape
    return not fused_decode_limits(
        params, cfg, inputs_embeds.dtype, B, kd, cache.k.shape[2],
        cache.k.dtype, _build.sm_count(inputs_embeds.device))


def _inject_cap_keys(dh: int) -> int:
    """The most keys a range of the injection attention keeps in shared
    memory (``csrc/fused_inject.cu`` ia_cap_keys): its K and V within
    INJECT_KV_BUDGET, one TMA box of rows, whole tiles."""
    c = INJECT_KV_BUDGET // (4 * dh) // INJECT_KEY_TILE * INJECT_KEY_TILE
    return max(INJECT_KEY_TILE, min(c, INJECT_BOX_MAX))


def plan_inject_splits(B: int, heads: int, Ta: int, dh: int,
                       n_sm: int = 132) -> Tuple[int, ...]:
    """Key boundaries (0, ..., Ta) of the ranges that the CTAs of one
    cluster of the injection attention (``csrc/fused_inject.cu``, which
    applies the same rule with the card's SM count) attend apart, for each
    of the B*heads (batch row, injection head) pairs.  The planner asks for
    as many ranges as bring the grid to ``n_sm`` CTAs, and at least as many
    as keep each range's K and V within INJECT_KV_BUDGET; it takes at most
    INJECT_SPLITS_MAX (and at most one a tile), then evens them out: every
    range but the last is a whole number of INJECT_KEY_TILE keys, and none
    is empty.  It reads shapes only, never the number of draft tokens Kd:
    the verify step sums its token 0 as the decode step does, bit for
    bit."""
    if Ta < 1 or B < 1 or heads < 1 or dh < 4:
        raise ValueError(f"B={B}, heads={heads}, Ta={Ta}, dh={dh}")
    nt = -(-Ta // INJECT_KEY_TILE)
    cap = _inject_cap_keys(dh) // INJECT_KEY_TILE
    want = max(-(-n_sm // (B * heads)), -(-nt // cap))
    top = min(INJECT_SPLITS_MAX, nt)
    ns = max(1, min(want, top))
    while True:
        tps = -(-nt // ns)
        eff = -(-nt // tps)
        if eff >= want or ns >= top:
            break
        ns += 1
    return tuple(i * tps * INJECT_KEY_TILE for i in range(eff)) + (Ta,)


def inject_attention_smem(kd: int, dh: int, keys: int,
                          resident: bool) -> int:
    """Dynamic shared memory of one CTA of the injection attention
    (``csrc/fused_inject.cu`` ia_smem) for ranges of ``keys`` keys: 128
    bytes of alignment; resident (the range's K and V in shared memory): K,
    which then holds the partial outputs [4 slots, kd, dh] in f32, V and
    two barriers, each region rounded up to 128 bytes; else the partials
    alone; then q [kd, dh] in bf16 (rounded up to 16 bytes) and in f32 the
    scores [kd, keys], the inbox of the ranks' partial outputs (at most
    kd * (dh + 8)) and INJECT_STATS floats."""
    up = lambda n, a: -(-n // a) * a  # noqa: E731
    kv, red = keys * dh * 2, 4 * INJECT_SLOTS * kd * dh
    b = 128 + (up(max(kv, red), 128) + up(kv, 128) + 16 if resident
               else red)
    return (b + up(kd * dh * 2, 16)
            + 4 * (kd * keys + kd * (dh + 8) + INJECT_STATS))


def fused_inject_limits(inject_params, cfg, heads: int, ta: int,
                        kd: int = 1) -> List[str]:
    """What the injection kernels of ``csrc/fused_inject.cu`` cannot take
    (the port's ``fused_inject_supported``, ``fused_decode.py:1115-1145`` of
    the JAX package), one message per broken limit (empty: they take it).
    The stack must hold int8 q/o/gate1 leaves with biases and the
    full-precision gate2 and LayerNorm leaves; ``ta`` audio tokens at ``kd``
    tokens per row must fit the attention's shared memory at any batch and
    SM count: its scores, the longest range being all ``ta`` keys read from
    global memory (one range: a grid that fills the card alone)."""
    layers = (inject_params or {}).get("layers", {})
    bad = [f"{k} is not an int8 leaf with a bias (apply_orca_xattn_quant)"
           for k in ("q", "o", "gate1")
           if not (is_quantized(layers.get(k)) and "b" in layers[k])]
    g2, ln = layers.get("gate2"), layers.get("ln")
    if not (isinstance(g2, dict) and {"w", "b"} <= set(g2)):
        bad.append("gate2 needs its float w and b")
    if not (isinstance(ln, dict) and {"scale", "bias"} <= set(ln)):
        bad.append("ln needs scale and bias")
    D = cfg.hidden_size
    if heads <= 0 or D % heads:
        return bad + [f"D={D} is not a multiple of {heads} heads"]
    dh = D // heads
    if dh % 4 or dh > INJECT_DH_MAX:
        return bad + [f"injection head dim {dh} (kernel: a multiple of 4 "
                      f"up to {INJECT_DH_MAX})"]
    if D % 16:
        bad.append(f"D={D} must be a multiple of 16 (int8 weight loads)")
    if not 1 <= kd <= KD_MAX:
        bad.append(f"{kd} tokens per row (kernel: 1..{KD_MAX})")
        return bad
    if ta < 1:
        return bad + [f"{ta} audio tokens"]
    keys = -(-ta // INJECT_KEY_TILE) * INJECT_KEY_TILE
    smem = inject_attention_smem(kd, dh, keys, False)
    if smem > _SMEM_LIMIT:
        bad.append(f"{ta} audio tokens at {kd} tokens per row need {smem} "
                   f"bytes of shared memory (limit {_SMEM_LIMIT})")
    return bad


def fused_inject_supported(params, cfg, inject_params, heads: int, ta: int,
                           kd: int = 1) -> bool:
    """Does the ORCA injection run inside the decode / verify step?  It
    needs the int8 tower and a stack the injection kernels take (the JAX
    dispatch, ``models/llm.py:377-381`` of the JAX package)."""
    return (tower_is_int8(params)
            and not fused_inject_limits(inject_params, cfg, heads, ta, kd))


def _weight(w, l: int):
    """(weight [out, in], scale [out] or None) of layer l."""
    if is_quantized(w):
        return w["q"][l], w["s"][l]
    return w[l], None


def _proj(x: torch.Tensor, w, l: int) -> torch.Tensor:
    """x [R, in] through layer l's weight: the f32 sum, times the int8
    scale after the sum."""
    wl, s = _weight(w, l)
    y = matmul_f32(x, wl.t())
    return y if s is None else y * s.float()


def inject_attention_plain(iq: torch.Tensor, ka: torch.Tensor,
                           va: torch.Tensor, heads: int, Kd: int
                           ) -> torch.Tensor:
    """The injection's cross-attention at the TPU kernel's rounding points
    (``fused_decode.py:755-788`` of the JAX package), in iq's dtype: iq
    [B*Kd, D] (row b*Kd + j) against its batch row's keys and values ka,
    va [B, ta, D] (the attended ones); the k (.) q products rounded before
    the per-head f32 sum, an f32 softmax, P rounded after normalising, the
    f32 sum of P v rounded."""
    dt = iq.dtype
    R, D = iq.shape
    B, ta, _ = ka.shape
    dh = D // heads
    prod = (ka.float()[:, None] * iq.float().reshape(B, Kd, 1, D)
            ).to(dt).float()
    sc = prod.reshape(B, Kd, ta, heads, dh).sum(-1) * dh ** -0.5
    e = torch.exp(sc - sc.amax(2, keepdim=True))             # [B,Kd,ta,H]
    p = (e / e.sum(2, keepdim=True)).to(dt).float()
    return torch.einsum("bjth,bthd->bjhd", p,
                        va.float().reshape(B, ta, heads, dh)
                        ).reshape(R, D).to(dt)


def inject_gate_plain(h, ig, iao, wg2, bg2, lns, lnb, on, Kd: int
                      ) -> torch.Tensor:
    """The injection's gated residual at the TPU kernel's rounding points
    (``fused_decode.py:805-823``), in h's dtype: gate = sigmoid(ig . wg2 +
    bg2) and LN(iao) (eps 1e-5, two-pass variance) in f32, h + bf16(on) *
    bf16(gate * LN) with ``on`` [B] shared by a row's Kd tokens.  h, iao
    [R, D]; ig [R, Dg]; wg2 [Dg]; bg2 [1]; lns, lnb [D]."""
    dt = h.dtype
    gate = torch.sigmoid((ig.float() * wg2.float().reshape(1, -1)
                          ).sum(-1, keepdim=True)
                         + bg2.float().reshape(1, 1))          # [R, 1]
    xo = iao.float()
    mu = xo.mean(-1, keepdim=True)
    var = (xo - mu).square().mean(-1, keepdim=True)
    lno = ((xo - mu) * torch.rsqrt(var + INJECT_LN_EPS) * lns.float()
           + lnb.float())
    contrib = (gate * lno).to(dt)
    on = torch.as_tensor(on, device=h.device).float()
    on = on.repeat_interleave(Kd).to(dt)[:, None]
    return h + on * contrib


def _inject_plain(h: torch.Tensor, inject, l: int, B: int, Kd: int):
    """Layer l's gated cross-attention on the residual h [R, D] at the TPU
    kernel's rounding points (``fused_decode.py:747-823`` of the JAX
    package), in h's dtype: the q and gate1 projections, then
    :func:`inject_attention_plain`, the o projection and
    :func:`inject_gate_plain`; GELU is the exact erf."""
    dt = h.dtype
    il = inject["params"]["layers"]
    Hi, ta = int(inject["heads"]), int(inject["ta_real"])

    def lin(x, key):
        return _proj(x, il[key], l) + il[key]["b"][l].float()

    iq = lin(h, "q").to(dt)
    iat = inject_attention_plain(iq, inject["k"][l, :, :ta],
                                 inject["v"][l, :, :ta], Hi, Kd)
    iao = lin(iat, "o").to(dt)
    ig = F.gelu(lin(h, "gate1").to(dt).float()).to(dt)
    g2 = il["gate2"]
    return inject_gate_plain(h, ig, iao, g2["w"][l], g2["b"][l],
                             il["ln"]["scale"][l], il["ln"]["bias"][l],
                             inject["on"], Kd)


def inject_attention(iq: torch.Tensor, ka: torch.Tensor, va: torch.Tensor,
                     ta_real: int, heads: int) -> torch.Tensor:
    """:func:`inject_attention_plain`'s function over the first ``ta_real``
    keys of one layer's audio K/V ka, va [B, Ta, D], for iq [B*Kd, D]: one
    launch of the attention kernel of ``csrc/fused_inject.cu`` on CUDA
    tensors (bf16; counted as ``inject_attention``), the plain version on
    CPU tensors.  The decode and verify steps launch the same kernel from
    :class:`FusedStep`."""
    B, Ta, D = ka.shape
    R = iq.shape[0]
    if iq.device.type == "cpu":
        return inject_attention_plain(iq, ka[:, :ta_real], va[:, :ta_real],
                                      heads, R // B)
    name = "inject_attention"
    if (R % B or not 1 <= R // B <= KD_MAX or tuple(iq.shape) != (R, D)
            or va.shape != ka.shape or not 1 <= ta_real <= Ta
            or heads <= 0 or D % heads or (D // heads) % 4
            or D // heads > INJECT_DH_MAX or D % 8):
        raise ValueError(f"{name}: iq {tuple(iq.shape)}, audio K/V "
                         f"{tuple(ka.shape)} / {tuple(va.shape)}, ta_real "
                         f"{ta_real}, {heads} heads")
    _build.require_cuda(name, iq, ka, va, dtype=torch.bfloat16)
    out = torch.empty_like(iq)
    _build.check(_build.library().desta_inject_attention(
        iq.data_ptr(), ka.data_ptr(), va.data_ptr(), out.data_ptr(), B,
        R // B, Ta, ta_real, D, heads, (D // heads) ** -0.5,
        _build.stream_ptr(iq.device)), name)
    _build.count_launch(name)
    return out


def inject_gate(h, ig, iao, wg2, bg2, lns, lnb, on,
                Kd: int) -> torch.Tensor:
    """:func:`inject_gate_plain`'s function: one launch of the gate kernel
    of ``csrc/fused_inject.cu`` on CUDA tensors (bf16 h, ig, iao; f32 wg2,
    bg2, lns, lnb, on; counted as ``inject_gate``) into a copy of h, the
    plain version on CPU tensors."""
    if h.device.type == "cpu":
        return inject_gate_plain(h, ig, iao, wg2, bg2, lns, lnb, on, Kd)
    name = "inject_gate"
    R, D = h.shape
    Dg = ig.shape[-1]
    if (iao.shape != h.shape or tuple(ig.shape) != (R, Dg) or R % Kd
            or tuple(wg2.shape) != (Dg,) or bg2.numel() != 1
            or tuple(lns.shape) != (D,) or lnb.shape != lns.shape
            or tuple(on.shape) != (R // Kd,)):
        raise ValueError(f"{name}: h {tuple(h.shape)}, ig {tuple(ig.shape)},"
                         f" iao {tuple(iao.shape)}, on {tuple(on.shape)}")
    _build.require_cuda(name, h, ig, iao, dtype=torch.bfloat16)
    _build.require_cuda(name, wg2, bg2, lns, lnb, on, dtype=torch.float32)
    out = h.clone()
    _build.check(_build.library().desta_inject_gate(
        out.data_ptr(), ig.data_ptr(), iao.data_ptr(), wg2.data_ptr(),
        bg2.data_ptr(), lns.data_ptr(), lnb.data_ptr(), on.data_ptr(), R,
        Kd, D, Dg, _build.stream_ptr(h.device)), name)
    _build.count_launch(name)
    return out


class PlainStep(NamedTuple):
    """What every layer of one plain decode / verify step shares: the RoPE
    tables [R, Dh], the keys each row attends ([B, S]: below its ci and
    allowed by the mask), the draft block's causal rule [Kd, Kd], the
    cache rows the step writes (row, position), positions past S dropped,
    and the step's own mask [B, >=S] and cache indices ci [B]."""
    B: int
    Kd: int
    cos: torch.Tensor
    sin: torch.Tensor
    valid: torch.Tensor
    causal: torch.Tensor
    wok: torch.Tensor
    wrow: torch.Tensor
    wpos: torch.Tensor
    mask: torch.Tensor
    ci: torch.Tensor


def plain_step(cos, sin, attention_mask, cache_index, B: int, Kd: int,
               S: int) -> PlainStep:
    dev = cos.device
    ci = _row_indices(cache_index, B, dev).long()
    valid = ((attention_mask[:, :S] > 0)
             & (torch.arange(S, device=dev)[None, :] < ci[:, None]))
    jj = torch.arange(Kd, device=dev)
    causal = jj[None, :] <= jj[:, None]          # [j, j2]: j sees j2 <= j
    wpos = ci[:, None] + jj[None, :]             # [B, Kd] cache write rows
    wok = wpos < S
    wrow = torch.arange(B, device=dev)[:, None].expand(B, Kd)[wok]
    return PlainStep(B, Kd, cos, sin, valid, causal, wok, wrow, wpos[wok],
                     attention_mask, ci)


def rms_plain(x: torch.Tensor, w: torch.Tensor, eps: float, dt):
    """RMSNorm in f32, rounded to dt (the kernels' ln1 / ln2)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * w.float()).to(dt)


def decode_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float
                    ) -> torch.Tensor:
    """:func:`rms_plain`'s function on rows x [R, D] with weight w [D], out
    in bf16: one launch of the step's norm kernel (``csrc/fused_decode.cu``,
    counted as ``rms_norm``) on CUDA tensors (D a multiple of 8 up to
    RMS_D_MAX), the plain version on CPU tensors.  x is bf16, or the f32
    residual of the per-layer pair K9 (``ops/fused_decode_tp.py``), each
    value rounded to bf16 first (the TPU kernels' input cast), so that f32
    rows give the bits of their bf16 cast.  The decode and verify steps and
    K9 launch the same kernel from C."""
    f32 = x.dtype == torch.float32
    if x.device.type == "cpu":
        if f32:
            x = x.to(torch.bfloat16)
        return rms_plain(x, w, eps, x.dtype)
    name = "rms_norm"
    R, D = x.shape
    if tuple(w.shape) != (D,) or D % 8 or D > RMS_D_MAX:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"(D a multiple of 8 up to {RMS_D_MAX})")
    _build.require_cuda(name, x, w)
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != \
            torch.bfloat16:
        raise ValueError(f"{name}: x {x.dtype}, w {w.dtype} (x bfloat16 or "
                         "float32, w bfloat16)")
    out = torch.empty(R, D, dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    _build.check((lib.desta_rms_norm_f32 if f32 else lib.desta_rms_norm)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), R, D, float(eps),
        _build.stream_ptr(x.device)), name)
    _build.count_launch(name)
    return out


def decode_attention_plain(qkv, k_cache, v_cache, cos, sin, mask, ci,
                           q_norm, k_norm, H: int, Hkv: int, eps: float,
                           scale: float, step: PlainStep = None
                           ) -> torch.Tensor:
    """Reference math of the decode / verify attention launch
    (``csrc/decode_attention.cuh``, the TPU kernel's attention,
    ``fused_decode.py:504-665`` of the JAX package), in its layouts: qkv
    [B*Kd, (H+2*Hkv)*Dh] in the activation dtype dt (rows r = b*Kd + j),
    one layer's cache k/v [B, S, Hkv*Dh], cos/sin [B*Kd, Dh], mask [B, >=S]
    (1 = attend), ci [B], the qk-norm weights [Dh] or None.  qk-norm and
    RoPE in f32, q and k rounded to dt, token j's k/v rows written into the
    cache at ci + j in place (positions past S dropped), f32 scores over the
    cached keys < ci that the mask allows and the draft tokens 0..j, one f32
    softmax over both, P rounded to dt for the cached keys and kept in f32
    for the draft block, P.V in f32.  Returns [B*Kd, H*Dh] in dt.  ``step``
    (:func:`plain_step` of these inputs) may be passed in when the caller
    holds it."""
    dt = qkv.dtype
    B, S, KVD = k_cache.shape
    R = qkv.shape[0]
    Kd = R // B
    Dh = KVD // Hkv
    G, HD = H // Hkv, H * Dh
    st = step if step is not None else plain_step(cos, sin, mask, ci, B, Kd,
                                                  S)
    ninf = torch.full((), float("-inf"), device=qkv.device)

    def rope(t):                                               # [R, n, Dh]
        c, s = st.cos[:, None, :], st.sin[:, None, :]
        rot = torch.cat([-t[..., Dh // 2:], t[..., :Dh // 2]], -1)
        return t * c + rot * s

    def head_norm(t, w):  # qk-norm in f32, unrounded (as the TPU kernel)
        return (t * torch.rsqrt(t.square().mean(-1, keepdim=True) + eps)
                * w.float())

    q = qkv[:, :HD].float().reshape(R, H, Dh)
    k = qkv[:, HD:HD + KVD].float().reshape(R, Hkv, Dh)
    v = qkv[:, HD + KVD:]
    if q_norm is not None:
        q = head_norm(q, q_norm)
        k = head_norm(k, k_norm)
    qb = rope(q).to(dt).float().reshape(B, Kd, Hkv, G, Dh)
    kb = rope(k).to(dt)
    k_cache[st.wrow, st.wpos] = kb.reshape(B, Kd, KVD)[st.wok]
    v_cache[st.wrow, st.wpos] = v.reshape(B, Kd, KVD)[st.wok]
    kc = k_cache.float().reshape(B, S, Hkv, Dh)
    vc = v_cache.float().reshape(B, S, Hkv, Dh)
    s = torch.einsum("bjkgd,bskd->bjkgs", qb, kc) * scale
    s = torch.where(st.valid[:, None, None, None, :], s, ninf)
    kd_ = kb.float().reshape(B, Kd, Hkv, Dh)
    sd = torch.einsum("bjkgd,bikd->bjkgi", qb, kd_) * scale
    sd = torch.where(st.causal[None, :, None, None, :], sd, ninf)
    mx = torch.maximum(s.amax(-1), sd.amax(-1))
    e = torch.exp(s - mx[..., None])
    ed = torch.exp(sd - mx[..., None])
    inv = 1.0 / (e.sum(-1) + ed.sum(-1))
    p = (e * inv[..., None]).to(dt).float()
    vd = v.float().reshape(B, Kd, Hkv, Dh)
    o = (torch.einsum("bjkgs,bskd->bjkgd", p, vc)
         + torch.einsum("bjkgi,bikd->bjkgd", ed * inv[..., None], vd))
    return o.reshape(R, HD).to(dt)


def decode_attention(qkv, k_cache, v_cache, cos, sin, mask, ci, q_norm,
                     k_norm, H: int, Hkv: int, eps: float, scale: float
                     ) -> torch.Tensor:
    """:func:`decode_attention_plain`'s function, one launch of the kernel
    of ``csrc/decode_attention.cuh`` on CUDA tensors (bf16 qkv and cache,
    f32 cos/sin, int32 mask and ci, bf16 norms; counted as
    ``decode_attention``), the plain version on CPU tensors.  The decode and
    verify steps launch the same kernel from :class:`FusedStep`."""
    if qkv.device.type == "cpu":
        return decode_attention_plain(qkv, k_cache, v_cache, cos, sin, mask,
                                      ci, q_norm, k_norm, H, Hkv, eps, scale)
    name = "decode_attention"
    B, S, KVD = k_cache.shape
    R = qkv.shape[0]
    Dh = KVD // max(Hkv, 1)
    if (R % B or Hkv * Dh != KVD or v_cache.shape != k_cache.shape
            or tuple(qkv.shape) != (R, (H + 2 * Hkv) * Dh)
            or tuple(cos.shape) != (R, Dh) or sin.shape != cos.shape
            or mask.dim() != 2 or mask.shape[0] != B or mask.shape[1] < S
            or tuple(ci.shape) != (B,) or (q_norm is None) != (k_norm is None)):
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)}, cache "
                         f"{tuple(k_cache.shape)}, cos {tuple(cos.shape)}, "
                         f"mask {tuple(mask.shape)}, ci {tuple(ci.shape)} "
                         f"for H={H}, Hkv={Hkv}")
    norms = () if q_norm is None else (q_norm, k_norm)
    _build.require_cuda(name, qkv, k_cache, v_cache, *norms,
                        dtype=torch.bfloat16)
    _build.require_cuda(name, cos, sin, dtype=torch.float32)
    _build.require_cuda(name, mask, ci, dtype=torch.int32)
    out = torch.empty(R, H * Dh, dtype=torch.bfloat16, device=qkv.device)
    _build.check(_build.library().desta_decode_attention(
        qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), mask.data_ptr(), mask.shape[1],
        ci.data_ptr(), None if q_norm is None else q_norm.data_ptr(),
        None if k_norm is None else k_norm.data_ptr(), out.data_ptr(), B,
        R // B, S, H, Hkv, Dh, float(eps), float(scale),
        _build.stream_ptr(qkv.device)), name)
    _build.count_launch(name)
    return out


def attention_plain(lay, cfg, st: PlainStep, cache: KVCache, l: int,
                    xn: torch.Tensor) -> torch.Tensor:
    """Layer l's attention on the normalised rows xn [R, D] (dtype dt): the
    q/k/v projection rounded to dt, :func:`decode_attention_plain` (which
    writes the new k/v rows into the cache), then wo; returns the wo
    product's f32 sum [R, D] (scaled, unrounded)."""
    qkv = _proj(xn, lay["wqkv"], l).to(xn.dtype)
    norms = ((lay["q_norm"]["scale"][l], lay["k_norm"]["scale"][l])
             if cfg.qk_norm else (None, None))
    o = decode_attention_plain(
        qkv, cache.k[l], cache.v[l], st.cos, st.sin, st.mask, st.ci, *norms,
        cfg.num_attention_heads, cfg.num_key_value_heads, cfg.rms_norm_eps,
        cfg.head_dim ** -0.5, step=st)
    return _proj(o, lay["wo"], l)


def mlp_plain(lay, l: int, xn: torch.Tensor) -> torch.Tensor:
    """Layer l's SwiGLU MLP on the normalised rows xn [R, D]: gate and up
    rounded to xn's dtype apart, SiLU in f32 rounded, their product
    rounded; returns the down product's f32 sum (scaled, unrounded)."""
    dt = xn.dtype
    gu = _proj(xn, lay["w_gu"], l)
    gate = gu[:, 0::2].to(dt).float()
    up = gu[:, 1::2].to(dt).float()
    mid = (F.silu(gate).to(dt).float() * up).to(dt)
    return _proj(mid, lay["w_down"], l)


def fused_decode_layers_plain(params, cfg, inputs_embeds, attention_mask,
                              positions, cache: KVCache, cache_index,
                              inject=None):
    """Reference math of the TPU kernel (bf16 or int8 stream, Kd >= 1
    tokens per row, optionally with the in-kernel ORCA injection), with
    every rounding point taken in the activation dtype (a no-op in f32):
    the residual is rounded after each half.  Cache positions past S are
    not written."""
    B, Kd, D = inputs_embeds.shape
    dt = inputs_embeds.dtype
    L, _, S, _ = cache.k.shape
    eps = cfg.rms_norm_eps
    lay = params["layers"]
    cos, sin = llm_rope_cos_sin(cfg, positions.reshape(B * Kd))  # [R, Dh]
    st = plain_step(cos, sin, attention_mask, cache_index, B, Kd, S)
    h = inputs_embeds.reshape(B * Kd, D)
    for l in range(L):
        o = attention_plain(lay, cfg, st, cache, l,
                            rms_plain(h, lay["ln1"]["scale"][l], eps, dt))
        h = (h.float() + o.to(dt).float()).to(dt)
        o = mlp_plain(lay, l, rms_plain(h, lay["ln2"]["scale"][l], eps, dt))
        h = (h.float() + o.to(dt).float()).to(dt)
        if inject is not None:
            h = _inject_plain(h, inject, l, B, Kd)
    return h.reshape(B, Kd, D), cache


def _inject_operands(inject, cfg, name: str, L: int, B: int, Kd: int):
    """Checked kernel operands of the injection: the int8 weights with
    their scales and f32 biases, the f32 gate2 and LayerNorm vectors, the
    audio K/V and the per-row flags.  Raises on what the kernels cannot
    take."""
    D = cfg.hidden_size
    heads, ta = int(inject["heads"]), int(inject["ta_real"])
    ka, va = inject["k"], inject["v"]
    bad = fused_inject_limits(inject["params"], cfg, heads, ta, Kd)
    if (ka.dim() != 4 or tuple(ka.shape[:2]) != (L, B) or ka.shape[3] != D
            or va.shape != ka.shape or ta > ka.shape[2]):
        bad.append(f"audio K/V {tuple(ka.shape)} / {tuple(va.shape)} for "
                   f"[{L}, {B}, >={ta}, {D}]")
    if bad:
        raise ValueError(f"{name}: injection: " + "; ".join(bad))
    il = inject["params"]["layers"]
    Dg = il["gate1"]["q"].shape[1]
    shapes = {"q": (L, D, D), "o": (L, D, D), "gate1": (L, Dg, D)}
    for key, shp in shapes.items():
        leaf = il[key]
        if (tuple(leaf["q"].shape) != shp or tuple(leaf["s"].shape) != shp[:2]
                or tuple(leaf["b"].shape) != shp[:2]):
            raise ValueError(f"{name}: injection {key} {tuple(leaf['q'].shape)}"
                             f", expected {shp}")
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    op = {
        "w": [il[k]["q"] for k in shapes], "s": [il[k]["s"] for k in shapes],
        "b": [f32(il[k]["b"]) for k in shapes],
        "wg2": f32(il["gate2"]["w"]).reshape(L, Dg),
        "bg2": f32(il["gate2"]["b"]).reshape(L, 1),
        "lns": f32(il["ln"]["scale"]), "lnb": f32(il["ln"]["bias"]),
        "on": torch.as_tensor(inject["on"], device=ka.device
                              ).float().contiguous(),
        "k": ka, "v": va, "heads": heads, "ta": ta, "Dg": Dg,
    }
    if op["on"].shape != (B,) or tuple(op["lns"].shape) != (L, D):
        raise ValueError(f"{name}: injection on {tuple(op['on'].shape)} / ln "
                         f"{tuple(op['lns'].shape)}")
    _build.require_cuda(name, ka, va, dtype=torch.bfloat16)
    _build.require_cuda(name, *op["w"], dtype=torch.int8)
    _build.require_cuda(name, *op["s"], *op["b"], op["wg2"], op["bg2"],
                        op["lns"], op["lnb"], op["on"], dtype=torch.float32)
    return op


class FusedStep:
    """The checked operands and scratch of one decode (Kd = 1) or verify
    (Kd > 1) step on one device, and the kernel launches of its layers, on
    the device's current stream at construction.  Built from device tensors
    alone (``cache_index`` the rows' int32 [B] on the device) it does no
    host-to-device copy, so it can be built and run inside a CUDA graph
    capture (``generate/graph.py``): its scratch is then the graph's, and
    its launches go to the capture stream.  :meth:`run` is the step:
    per layer :meth:`attention`, :meth:`mlp` and, with ``inject``,
    :meth:`inject`.  Each of the two halves ends in the wo / down GEMM,
    which adds into the bf16 residual ``h`` (EPI_RESID) or, given a
    ``store(x, w, scale, name, stream)``, hands it the product's operands:
    the tensor-parallel driver (``ops/fused_decode_mesh.py``) stores the
    rank's partial sum for its all-reduce there, and that all-reduce writes
    the next half's norm into ``xn``, so the half after it runs with
    ``normed=True`` (no norm launch of its own).  :meth:`load` takes a new
    step's embeddings and positions into the same buffers, so one FusedStep
    serves every step of a call (the mesh's per-call state, which also sets
    ``stream``, the stream the launches go to, to each run's)."""

    def __init__(self, params, cfg, inputs_embeds, attention_mask, positions,
                 cache: KVCache, cache_index, name: str, inject=None):
        B, Kd, D = inputs_embeds.shape
        R = B * Kd
        L, Bc, S, KVD = cache.k.shape
        H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        HD, I = H * Dh, cfg.intermediate_size
        int8 = tower_is_int8(params)
        if Bc != B or KVD != Hkv * Dh or cache.v.shape != cache.k.shape:
            raise ValueError(f"{name}: x {tuple(inputs_embeds.shape)} vs "
                             f"cache {tuple(cache.k.shape)}")
        bad = kernel_limits(cfg, B, Kd, S, int8,
                            _build.sm_count(inputs_embeds.device))
        if bad:
            raise ValueError(f"{name}: " + "; ".join(bad))
        if inject is not None:
            if not int8:
                raise ValueError(f"{name}: in-kernel injection needs the int8 "
                                 "tower (the TPU kernel's int8 weight ring)")
            self.inj = _inject_operands(inject, cfg, name, L, B, Kd)
        lay = params["layers"]
        norms = [lay["ln1"]["scale"], lay["ln2"]["scale"]]
        if cfg.qk_norm:
            norms += [lay["q_norm"]["scale"], lay["k_norm"]["scale"]]
        shapes = [(L, HD + 2 * KVD, D), (L, D, HD), (L, 2 * I, D), (L, D, I)]
        ws, ss = [], []
        for key, shp in zip(LLM_QUANT_KEYS, shapes):
            w = lay[key]
            wt, st = (w["q"], w["s"]) if int8 else (w, None)
            if tuple(wt.shape) != shp or (st is not None
                                          and tuple(st.shape) != shp[:2]):
                raise ValueError(f"{name}: {key} {tuple(wt.shape)}, expected "
                                 f"{shp}")
            ws.append(wt)
            if st is not None:
                ss.append(st)
        dev = inputs_embeds.device
        mask = attention_mask.to(torch.int32).contiguous()
        if mask.shape[0] != B or mask.shape[1] < S:
            raise ValueError(f"{name}: mask {tuple(mask.shape)} must cover "
                             f"[{B}, {S}]")
        ci = _row_indices(cache_index, B, dev)
        cos, sin = (t.float().contiguous()
                    for t in llm_rope_cos_sin(cfg, positions.reshape(R)))
        h = inputs_embeds.reshape(R, D).contiguous().clone()
        _build.require_cuda(name, h, cache.k, cache.v, *norms,
                            dtype=torch.bfloat16)
        _build.require_cuda(name, *ws, dtype=torch.int8 if int8 else
                            torch.bfloat16)
        if ss:
            _build.require_cuda(name, *ss, dtype=torch.float32)
        _build.require_cuda(name, mask, ci)
        _build.require_cuda(name, cos, sin)
        self.cfg, self.lay, self.cache, self.name = cfg, lay, cache, name
        self.B, self.Kd, self.R, self.D, self.L = B, Kd, R, D, L
        self.gemm_passes = passes(R)
        self.int8, self.norms, self.mask, self.ci = int8, norms, mask, ci
        self.cos, self.sin, self.h = cos, sin, h
        self.lib = _build.library()
        self.stream = _build.stream_ptr(dev)
        bf = dict(dtype=torch.bfloat16, device=dev)
        self.xn = torch.empty(R, D, **bf)
        self.qkv = torch.empty(R, HD + 2 * KVD, **bf)
        self.attn = torch.empty(R, HD, **bf)
        self.mid = torch.empty(R, I, **bf)
        if inject is not None:
            self.iq, self.iat, self.iao = (torch.empty(R, D, **bf)
                                           for _ in range(3))
            self.ig = torch.empty(R, self.inj["Dg"], **bf)

    def load(self, inputs_embeds, positions) -> None:
        """A new step's rows into this step's buffers, on the current
        stream: the residual h from inputs_embeds [B, Kd, D] and the RoPE
        tables from positions [B, Kd] (device tensors: a CUDA graph can
        capture it)."""
        cos, sin = llm_rope_cos_sin(self.cfg, positions.reshape(self.R))
        self.cos.copy_(cos)
        self.sin.copy_(sin)
        self.h.copy_(inputs_embeds.reshape(self.R, self.D))

    def _launch(self, status, what=None):
        what = what or self.name
        _build.check(status, what)
        _build.count_launch(what)

    def _gemm(self, x, key, l, out, N, K, epi):
        w, s = _weight(self.lay[key], l)
        self._launch(self.lib.desta_skinny_gemm(
            x.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(),
            None, out.data_ptr(), self.R, N, K, epi, int(self.int8),
            self.stream))
        _build.count_kernel("skinny_gemm", self.gemm_passes)

    def _out_gemm(self, x, key, l, K, store):
        """wo / down: into h, or through ``store``."""
        if store is None:
            self._gemm(x, key, l, self.h, self.D, K, EPI_RESID)
        else:
            w, s = _weight(self.lay[key], l)
            store(x, w, s, self.name, self.stream)

    def _norm(self, l, which):
        self._launch(self.lib.desta_rms_norm(
            self.h.data_ptr(), self.norms[which][l].data_ptr(),
            self.xn.data_ptr(), self.R, self.D, float(self.cfg.rms_norm_eps),
            self.stream))
        _build.count_kernel("rms_norm")

    def attention(self, l, store=None, normed=False):
        """Layer l's norm (unless ``normed``: ``xn`` holds it), q/k/v,
        attention with the cache write, wo."""
        cfg, c = self.cfg, self.cache
        H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        if not normed:
            self._norm(l, 0)
        self._gemm(self.xn, "wqkv", l, self.qkv, (H + 2 * Hkv) * Dh, self.D,
                   EPI_STORE)
        self._launch(self.lib.desta_decode_attention(
            self.qkv.data_ptr(), c.k[l].data_ptr(), c.v[l].data_ptr(),
            self.cos.data_ptr(), self.sin.data_ptr(), self.mask.data_ptr(),
            self.mask.shape[1], self.ci.data_ptr(),
            self.norms[2][l].data_ptr() if cfg.qk_norm else None,
            self.norms[3][l].data_ptr() if cfg.qk_norm else None,
            self.attn.data_ptr(), self.B, self.Kd, c.k.shape[2], H, Hkv, Dh,
            float(cfg.rms_norm_eps), Dh ** -0.5, self.stream))
        _build.count_kernel("decode_attention")
        self._out_gemm(self.attn, "wo", l, H * Dh, store)

    def mlp(self, l, store=None, normed=False):
        """Layer l's norm (unless ``normed``), gate/up with SwiGLU, down."""
        I = self.cfg.intermediate_size
        if not normed:
            self._norm(l, 1)
        self._gemm(self.xn, "w_gu", l, self.mid, I, self.D, EPI_SWIGLU)
        self._out_gemm(self.mid, "w_down", l, I, store)

    def inject(self, l):
        """The 5 injection launches of layer l (q, gate1, attention, o,
        gate), counted as fused_decode_inject."""
        what, inj, R, D = "fused_decode_inject", self.inj, self.R, self.D
        (wq, wo, wg), (sq, so, sg), (bq, bo, bg) = inj["w"], inj["s"], inj["b"]

        def proj(x, w, s, b, out, epi):
            N, K = w.shape[1:]
            self._launch(self.lib.desta_skinny_gemm(
                x.data_ptr(), w[l].data_ptr(), s[l].data_ptr(),
                b[l].data_ptr(), out.data_ptr(), R, N, K, epi, 1,
                self.stream), what)
            _build.count_kernel("skinny_gemm", self.gemm_passes)
        proj(self.h, wq, sq, bq, self.iq, EPI_BIAS)
        proj(self.h, wg, sg, bg, self.ig, EPI_BIAS_GELU)
        self._launch(self.lib.desta_inject_attention(
            self.iq.data_ptr(), inj["k"][l].data_ptr(),
            inj["v"][l].data_ptr(), self.iat.data_ptr(), self.B, self.Kd,
            inj["k"].shape[2], inj["ta"], D, inj["heads"],
            (D // inj["heads"]) ** -0.5, self.stream), what)
        _build.count_kernel("inject_attention")
        proj(self.iat, wo, so, bo, self.iao, EPI_BIAS)
        self._launch(self.lib.desta_inject_gate(
            self.h.data_ptr(), self.ig.data_ptr(), self.iao.data_ptr(),
            inj["wg2"][l].data_ptr(), inj["bg2"][l].data_ptr(),
            inj["lns"][l].data_ptr(), inj["lnb"][l].data_ptr(),
            inj["on"].data_ptr(), R, self.Kd, D, inj["Dg"], self.stream),
            what)
        _build.count_kernel("inject_gate")

    def run(self, inject: bool):
        for l in range(self.L):
            self.attention(l)
            self.mlp(l)
            if inject:
                self.inject(l)
        return self.h.reshape(self.B, self.Kd, self.D), self.cache


def _run_fused(params, cfg, inputs_embeds, attention_mask, positions,
               cache: KVCache, cache_index, name: str, inject=None):
    """The kernels of one decode (Kd = 1) or verify (Kd > 1) step, with the
    injection kernels after each layer when ``inject`` is given."""
    return FusedStep(params, cfg, inputs_embeds, attention_mask, positions,
                     cache, cache_index, name, inject).run(inject is not None)


def fused_decode_layers(params, cfg, inputs_embeds, attention_mask,
                        positions, cache: KVCache, cache_index, inject=None):
    """One decode step through all layers.

    inputs_embeds [B, 1, D]; attention_mask [B, >=S] (1 = attend);
    positions [B, 1]; cache: KVCache [L, B, S, Hkv*Dh], written in place at
    ``cache_index`` (int or [B]).  Attends, per row, the cached keys below
    its cache index that the mask allows, plus the current token.  inject:
    the optional in-kernel ORCA injection (module docstring).  Returns
    (hidden [B, 1, D] before the final norm, cache).
    """
    if inputs_embeds.shape[1] != 1:
        raise ValueError("fused_decode_layers takes one token per row")
    if inputs_embeds.device.type == "cpu":
        return fused_decode_layers_plain(params, cfg, inputs_embeds,
                                         attention_mask, positions, cache,
                                         cache_index, inject)
    name = ("fused_decode_layers_int8" if tower_is_int8(params)
            else "fused_decode_layers")
    return _run_fused(params, cfg, inputs_embeds, attention_mask, positions,
                      cache, cache_index, name, inject)


def fused_verify_layers(params, cfg, inputs_embeds, attention_mask,
                        positions, cache: KVCache, cache_index, inject=None):
    """Speculative-verify step: Kd = 2..8 tokens per row in one weight
    stream.

    inputs_embeds [B, Kd, D] = the last accepted token + Kd-1 draft
    tokens; positions [B, Kd]; cache_index int or [B] = each row's first
    write position ci.  Token j attends the cached keys < ci that the mask
    allows plus draft tokens 0..j; all Kd (k, v) rows land at
    ci..ci+Kd-1, which needs ci <= S - Kd (rows past the accepted count are
    dead until overwritten).  With ``inject`` every draft token of a row
    attends the row's audio K/V.  Returns (hidden [B, Kd, D], cache).
    """
    if inputs_embeds.shape[1] < 2:
        raise ValueError("fused_verify_layers takes 2 or more tokens per row")
    if inputs_embeds.device.type == "cpu":
        return fused_decode_layers_plain(params, cfg, inputs_embeds,
                                         attention_mask, positions, cache,
                                         cache_index, inject)
    return _run_fused(params, cfg, inputs_embeds, attention_mask, positions,
                      cache, cache_index, "fused_verify_layers", inject)
