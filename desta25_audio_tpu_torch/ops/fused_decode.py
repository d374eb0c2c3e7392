"""One LLM decode step through all layers, and the speculative verify step
(port of ``desta25_audio_tpu/ops/fused_decode.py::fused_decode_layers`` and
``fused_verify_layers``, without ORCA injection).

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

On CUDA tensors this launches the kernels of ``csrc/fused_decode.cu`` (7 per
layer, counted as ``fused_decode_layers`` for the bf16 decode step,
``fused_decode_layers_int8`` for the int8 one and ``fused_verify_layers``
for a verify step on either tower); on CPU tensors it runs
:func:`fused_decode_layers_plain`, the same function at the same rounding
points in the activation dtype.  The cache is updated IN PLACE on both paths
and also returned, so callers keep the JAX API shape.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .core import matmul_f32
from .quant import LLM_QUANT_KEYS, is_quantized
from .rope import llm_rope_cos_sin

EPI_STORE, EPI_RESID, EPI_SWIGLU = 0, 1, 2
KERNEL_DH = 128
KERNEL_GROUPS = (1, 2, 4, 8)
KD_MAX = 8                          # draft tokens per row (the JAX kd <= 8)
VERIFY_SCORES_BUDGET = 6 * 1024 * 1024   # B*Kd*H*S*4 (JAX _SCORES_BUDGET)
_SMEM_LIMIT = 227 * 1024


class KVCache(NamedTuple):
    """Packed KV cache, heads folded into the last axis:
    k, v [L, B, S, Hkv*Dh] (the layout of the JAX package)."""
    k: torch.Tensor
    v: torch.Tensor


def _row_indices(cache_index, B: int, device) -> torch.Tensor:
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


def kernel_limits(cfg, batch: int, kd: int, cache_len: int,
                  int8: bool) -> List[str]:
    """What the kernels of ``csrc/fused_decode.cu`` cannot take at this
    shape, one message per broken limit (empty: the kernels take it)."""
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
    G = H // Hkv
    smem = 4 * (G * Dh + Dh + 32 + G * cache_len)
    if smem > _SMEM_LIMIT:
        bad.append(f"cache length {cache_len} needs {smem} bytes of shared "
                   f"memory for the scores (limit {_SMEM_LIMIT})")
    if kd > 1 and batch * kd * H * cache_len * 4 > VERIFY_SCORES_BUDGET:
        bad.append(f"B*Kd*H*S*4 = {batch * kd * H * cache_len * 4} bytes "
                   f"(limit {VERIFY_SCORES_BUDGET}, as the JAX verify step)")
    return bad


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


def fused_decode_layers_plain(params, cfg, inputs_embeds, attention_mask,
                              positions, cache: KVCache, cache_index):
    """Reference math of the TPU kernel (bf16 or int8 stream, Kd >= 1
    tokens per row), with every rounding point taken in the activation
    dtype (a no-op in f32).  Cache positions past S are not written."""
    B, Kd, D = inputs_embeds.shape
    R = B * Kd
    dt = inputs_embeds.dtype
    L, _, S, KVD = cache.k.shape
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    G, HD, eps = H // Hkv, H * Dh, cfg.rms_norm_eps
    scale = Dh ** -0.5
    lay = params["layers"]
    dev = inputs_embeds.device
    ci = _row_indices(cache_index, B, dev).long()
    cos, sin = llm_rope_cos_sin(cfg, positions.reshape(R))       # [R, Dh]
    valid = ((attention_mask[:, :S] > 0)
             & (torch.arange(S, device=dev)[None, :] < ci[:, None]))
    jj = torch.arange(Kd, device=dev)
    causal = jj[None, :] <= jj[:, None]          # [j, j2]: j sees j2 <= j
    wpos = ci[:, None] + jj[None, :]             # [B, Kd] cache write rows
    wok = wpos < S
    wrow = torch.arange(B, device=dev)[:, None].expand(B, Kd)[wok]
    wpos = wpos[wok]
    ninf = torch.full((), float("-inf"), device=dev)

    def rms(x, w):
        xf = x.float()
        return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
                * w.float()).to(dt)

    def rope(t):                                               # [R, n, Dh]
        c, s = cos[:, None, :], sin[:, None, :]
        rot = torch.cat([-t[..., Dh // 2:], t[..., :Dh // 2]], -1)
        return t * c + rot * s

    def head_norm(t, w):  # qk-norm in f32, unrounded (as the TPU kernel)
        return (t * torch.rsqrt(t.square().mean(-1, keepdim=True) + eps)
                * w.float())

    h = inputs_embeds.reshape(R, D)
    for l in range(L):
        xn = rms(h, lay["ln1"]["scale"][l])
        qkv = _proj(xn, lay["wqkv"], l).to(dt)
        q = qkv[:, :HD].float().reshape(R, H, Dh)
        k = qkv[:, HD:HD + KVD].float().reshape(R, Hkv, Dh)
        v = qkv[:, HD + KVD:]
        if cfg.qk_norm:
            q = head_norm(q, lay["q_norm"]["scale"][l])
            k = head_norm(k, lay["k_norm"]["scale"][l])
        qb = rope(q).to(dt).float().reshape(B, Kd, Hkv, G, Dh)
        kb = rope(k).to(dt)
        cache.k[l, wrow, wpos] = kb.reshape(B, Kd, KVD)[wok]
        cache.v[l, wrow, wpos] = v.reshape(B, Kd, KVD)[wok]
        kc = cache.k[l].float().reshape(B, S, Hkv, Dh)
        vc = cache.v[l].float().reshape(B, S, Hkv, Dh)
        s = torch.einsum("bjkgd,bskd->bjkgs", qb, kc) * scale
        s = torch.where(valid[:, None, None, None, :], s, ninf)
        kd_ = kb.float().reshape(B, Kd, Hkv, Dh)
        sd = torch.einsum("bjkgd,bikd->bjkgi", qb, kd_) * scale
        sd = torch.where(causal[None, :, None, None, :], sd, ninf)
        mx = torch.maximum(s.amax(-1), sd.amax(-1))
        e = torch.exp(s - mx[..., None])
        ed = torch.exp(sd - mx[..., None])
        inv = 1.0 / (e.sum(-1) + ed.sum(-1))
        p = (e * inv[..., None]).to(dt).float()
        vd = v.float().reshape(B, Kd, Hkv, Dh)
        o = (torch.einsum("bjkgs,bskd->bjkgd", p, vc)
             + torch.einsum("bjkgi,bikd->bjkgd", ed * inv[..., None], vd))
        attn = o.reshape(R, HD).to(dt)
        h = (h.float() + _proj(attn, lay["wo"], l).to(dt).float()).to(dt)
        xn = rms(h, lay["ln2"]["scale"][l])
        gu = _proj(xn, lay["w_gu"], l)
        gate = gu[:, 0::2].to(dt).float()
        up = gu[:, 1::2].to(dt).float()
        mid = (F.silu(gate).to(dt).float() * up).to(dt)
        h = (h.float() + _proj(mid, lay["w_down"], l).to(dt).float()
             ).to(dt)
    return h.reshape(B, Kd, D), cache


def _run_fused(params, cfg, inputs_embeds, attention_mask, positions,
               cache: KVCache, cache_index, name: str):
    """The kernels of one decode (Kd = 1) or verify (Kd > 1) step."""
    B, Kd, D = inputs_embeds.shape
    R = B * Kd
    L, Bc, S, KVD = cache.k.shape
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    G, HD, I = H // Hkv, H * Dh, cfg.intermediate_size
    int8 = tower_is_int8(params)
    if Bc != B or KVD != Hkv * Dh or cache.v.shape != cache.k.shape:
        raise ValueError(f"{name}: x {tuple(inputs_embeds.shape)} vs cache "
                         f"{tuple(cache.k.shape)}")
    bad = kernel_limits(cfg, B, Kd, S, int8)
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
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

    lib = _build.library()
    stream = _build.stream_ptr(dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    xn = torch.empty(R, D, **bf)
    qkv = torch.empty(R, HD + 2 * KVD, **bf)
    attn = torch.empty(R, HD, **bf)
    mid = torch.empty(R, I, **bf)
    eps = float(cfg.rms_norm_eps)

    def launch(status):
        _build.check(status, name)
        _build.count_launch(name)

    def gemm(x, key, l, out, N, K, epi):
        w, s = _weight(lay[key], l)
        launch(lib.desta_skinny_gemm(x.data_ptr(), w.data_ptr(),
                                     None if s is None else s.data_ptr(),
                                     out.data_ptr(), R, N, K, epi, int(int8),
                                     stream))

    for l in range(L):
        launch(lib.desta_rms_norm(h.data_ptr(), norms[0][l].data_ptr(),
                                  xn.data_ptr(), R, D, eps, stream))
        gemm(xn, "wqkv", l, qkv, HD + 2 * KVD, D, EPI_STORE)
        launch(lib.desta_decode_attention(
            qkv.data_ptr(), cache.k[l].data_ptr(), cache.v[l].data_ptr(),
            cos.data_ptr(), sin.data_ptr(), mask.data_ptr(), mask.shape[1],
            ci.data_ptr(),
            norms[2][l].data_ptr() if cfg.qk_norm else None,
            norms[3][l].data_ptr() if cfg.qk_norm else None,
            attn.data_ptr(), B, Kd, S, H, Hkv, Dh, eps, Dh ** -0.5, stream))
        gemm(attn, "wo", l, h, D, HD, EPI_RESID)
        launch(lib.desta_rms_norm(h.data_ptr(), norms[1][l].data_ptr(),
                                  xn.data_ptr(), R, D, eps, stream))
        gemm(xn, "w_gu", l, mid, I, D, EPI_SWIGLU)
        gemm(mid, "w_down", l, h, D, I, EPI_RESID)
    return h.reshape(B, Kd, D), cache


def fused_decode_layers(params, cfg, inputs_embeds, attention_mask,
                        positions, cache: KVCache, cache_index):
    """One decode step through all layers.

    inputs_embeds [B, 1, D]; attention_mask [B, >=S] (1 = attend);
    positions [B, 1]; cache: KVCache [L, B, S, Hkv*Dh], written in place at
    ``cache_index`` (int or [B]).  Attends, per row, the cached keys below
    its cache index that the mask allows, plus the current token.  Returns
    (hidden [B, 1, D] before the final norm, cache).
    """
    if inputs_embeds.shape[1] != 1:
        raise ValueError("fused_decode_layers takes one token per row")
    if inputs_embeds.device.type == "cpu":
        return fused_decode_layers_plain(params, cfg, inputs_embeds,
                                         attention_mask, positions, cache,
                                         cache_index)
    name = ("fused_decode_layers_int8" if tower_is_int8(params)
            else "fused_decode_layers")
    return _run_fused(params, cfg, inputs_embeds, attention_mask, positions,
                      cache, cache_index, name)


def fused_verify_layers(params, cfg, inputs_embeds, attention_mask,
                        positions, cache: KVCache, cache_index):
    """Speculative-verify step: Kd = 2..8 tokens per row in one weight
    stream.

    inputs_embeds [B, Kd, D] = the last accepted token + Kd-1 draft
    tokens; positions [B, Kd]; cache_index int or [B] = each row's first
    write position ci.  Token j attends the cached keys < ci that the mask
    allows plus draft tokens 0..j; all Kd (k, v) rows land at
    ci..ci+Kd-1, which needs ci <= S - Kd (rows past the accepted count are
    dead until overwritten).  Returns (hidden [B, Kd, D], cache).
    """
    if inputs_embeds.shape[1] < 2:
        raise ValueError("fused_verify_layers takes 2 or more tokens per row")
    if inputs_embeds.device.type == "cpu":
        return fused_decode_layers_plain(params, cfg, inputs_embeds,
                                         attention_mask, positions, cache,
                                         cache_index)
    return _run_fused(params, cfg, inputs_embeds, attention_mask, positions,
                      cache, cache_index, "fused_verify_layers")
