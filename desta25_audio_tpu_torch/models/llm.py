"""Decoder-only LLM (Llama-3.x / Qwen3 family) in PyTorch.

Counterpart of ``desta25_audio_tpu/models/llm.py``: RMSNorm, RoPE (llama3
NTK scaling or plain theta), GQA attention, SwiGLU MLP, optional Qwen3
per-head q/k RMSNorm, tied or untied head, and a packed KV cache
[L, B, S, Hkv*Dh].  Accepts ``inputs_embeds`` so the DeSTA audio splice can
feed it.

Prefill (and any cached call with T > 1) is plain torch around the
projections, mirroring ``llm.py:174-257``.  The cache-less forward (the
training step and the eval loss) routes its attention through
``ops/attention.mha`` with the causal and per-token masks, as
``llm.py:234-238`` does: K11 (the hand-written flash attention) at T >= 512,
the masked path below; with ``remat`` each decoder layer runs under
``torch.utils.checkpoint``, and ``skip_head``/``return_hidden`` hand the
final hidden state to the chunked loss.  Nothing is updated in place on
that path.  A cached call with T == 1 goes
to ``ops/fused_decode.fused_decode_layers`` (the hand-written decode kernels
on the card), with ORCA's injection inside it or, for a per-layer hook,
layer by layer in torch; with the opt-in ``DESTA_FUSED_PERLAYER`` and an
int8 tower a hooked step runs the per-layer kernel pair K9
(``ops/fused_decode_tp.py``) with the hook between layers.  With bf16
weights the projections and heads are ``torch.mm`` products with f32
accumulation, as the JAX package leaves them to XLA; with
int8 leaves (``ops/quant.quantize_llm_params``, ``llm_quant="int8"``) every
projection and the head go through ``ops/qmm.quant_matmul`` (K7 below 128
rows, W8A8 above), as ``llm.py:136-156`` does.

LoRA (``lora``, :func:`init_lora`; ``llm.py:113-197`` of the JAX package):
the adapters' deltas ``scale * dropout(x) @ A @ B`` (peft's semantics, f32
sums) are added to q, k and v before RoPE in every layer of the layer loop:
prefill, cached decode and the cache-less training forward under ``remat``.
Under LoRA no fused step takes a call (the JAX package's dispatch): that is
a dispatch rule, not a kernel's refusal, so it is not counted as a fallback.
:func:`merge_lora` folds the adapters into ``wqkv`` for serving.

Under a mesh (``parallel/mesh.use_mesh``, the LLM cut by
``parallel/sharding.apply_llm_sharding``, the cache a ``ShardedCache``) a
cached T == 1 step takes the tensor-parallel kernels (K10, whose predicate
takes every step K9's pair under a mesh could: the port has no VMEM
budgets; ``llm.py:363-434`` of the JAX package), and every other cached
call a
per-rank layer loop whose wo / down partials are summed in f32 across the
ranks and rounded once, as the JAX package leaves it to XLA's psum.  The
cache-less forward (training) runs under one data row's ``1 x p`` group the
same per-rank loop, with K11 per rank at H/p, Hkv/p heads; with
``sequence_parallel`` the residual is cut over T between the blocks
(:func:`_group_layer`).  On a pipe mesh (``parallel/sharding.pipe_stages``)
the cache-less forward runs the stages as GPipe's schedule
(``parallel/pipeline.py``) or one after the other.

Parameters (layers stacked on a leading axis, linear weights ``[out, in]``):
``embed`` [V, D], ``lm_head`` [V, D] (untied only), ``norm``, and
``layers`` with ``ln1``, ``wqkv``, ``wo``, ``ln2``, ``w_gu`` (gate/up rows
interleaved), ``w_down`` and, for qk-norm, ``q_norm``/``k_norm`` -- see
``ops/fused_decode.py`` for the shapes.  An int8 tree holds ``{"q", "s"}``
leaves in place of the four weight stacks and an int8 ``lm_head`` with its
rows padded to a multiple of 2560 (tied models too).  The cache is updated
in place.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import LLMConfig
from ..ops import _build
from ..ops import attention as attn
from ..ops.core import Params, index_tree, matmul_f32, rms_norm
from ..ops.fused_decode import (
    KVCache,
    fused_decode_layers,
    fused_decode_supported,
)
from ..ops.fused_decode_mesh import (
    fused_decode_layers_mesh,
    fused_mesh_takes,
)
from ..ops.fused_decode_tp import (
    fused_decode_layers_perlayer,
    fused_perlayer_supported,
)
from ..ops.qmm import W8A8_MIN_ROWS, quant_matmul
from ..ops.quant import is_quantized
from ..ops.rope import apply_rope, llm_rope_cos_sin
from ..parallel.mesh import current_mesh, on_device
from ..parallel.pipeline import pipeline_decoder_hidden, pipeline_enabled
from ..parallel.sharding import (
    ShardedCache,
    ShardedLLM,
    data_rows,
    init_sharded_cache,
    qkv_rows,
)

__all__ = ["KVCache", "init_kv_cache", "init_llm", "init_lora", "llm_apply",
           "embed_tokens", "decode_step", "merge_lora"]

LORA_TARGETS = ("q", "k", "v")


def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int, dtype,
                  device):
    """A zeroed cache [L, batch, max_len, Hkv*Dh] on ``device``; under a
    mesh (``parallel/mesh.use_mesh``) the per-rank slices of one
    (``parallel/sharding.ShardedCache``, on the ranks' devices), as the JAX
    package shards its cache on the packed axis (``llm.py:47-59``)."""
    if current_mesh() is not None:
        return init_sharded_cache(cfg, batch, max_len, dtype)
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads * cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_llm(cfg: LLMConfig, dtype, device,
             generator: torch.Generator) -> Params:
    """Random init on ``device`` (N(0, 0.02) weights, unit norms, as the
    JAX package's ``init_llm``), drawn in place from ``generator``."""
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def normal(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=generator)

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}

    layers = {
        "ln1": ones(L, D),
        "wqkv": normal(L, (H + 2 * Hkv) * Dh, D),
        "wo": normal(L, D, H * Dh),
        "ln2": ones(L, D),
        "w_gu": normal(L, 2 * I, D),
        "w_down": normal(L, D, I),
    }
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, Dh)
        layers["k_norm"] = ones(L, Dh)
    p = {"embed": normal(cfg.vocab_size, D), "layers": layers,
         "norm": ones(D)}
    if not cfg.tie_word_embeddings:
        p["lm_head"] = normal(cfg.vocab_size, D)
    return p


def init_lora(cfg: LLMConfig, rank: int, device, generator: torch.Generator,
              dtype=torch.float32) -> Params:
    """LoRA adapters for q, k and v of every layer (``init_lora`` of the JAX
    package, ``llm.py:113-131``): ``{"layers": {t: {"a", "b"}}}`` with A ~
    N(0, 0.02) [L, D, r] and B zero [L, r, out], f32, in the JAX package's
    [in, r] / [r, out] layout."""
    L, D, Dh = cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim
    outs = {"q": cfg.num_attention_heads * Dh,
            "k": cfg.num_key_value_heads * Dh,
            "v": cfg.num_key_value_heads * Dh}
    return {"layers": {t: {
        "a": torch.empty(L, D, rank, dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=generator),
        "b": torch.zeros(L, rank, outs[t], dtype=dtype, device=device)}
        for t in LORA_TARGETS}}


def _lora_delta(x: torch.Tensor, lp: Params, scale: float,
                dropout: float = 0.0,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """peft's LoRA delta ``scale * dropout(x) @ A @ B`` -> f32 (scale =
    alpha / r; ``llm.py:159-172`` of the JAX package): the dropout (training
    only, with a generator) on the adapter's input with inverted scaling,
    the first product in x's dtype with f32 sums, the second in f32.
    ``rows`` (first, total): x holds batch rows first.. of a batch of
    ``total`` rows, whose mask is drawn whole and sliced, so that a batch
    split over devices drops what the whole batch drops."""
    if generator is not None and dropout > 0.0:
        lo, total = rows or (0, x.shape[0])
        keep = torch.rand((total,) + tuple(x.shape[1:]), generator=generator,
                          device=x.device)[lo:lo + x.shape[0]] < 1.0 - dropout
        x = torch.where(keep, x, torch.zeros_like(x)) / torch.tensor(
            1.0 - dropout, dtype=x.dtype, device=x.device)
    a = matmul_f32(x, lp["a"].to(x.dtype))
    return scale * matmul_f32(a, lp["b"].float())


def lora_layer_seed(seed: int, l: int) -> int:
    """Layer l's dropout seed of a step's seed (JAX's ``fold_in(key, l)``,
    ``llm.py:490``): fixed outside the layer, so a recompute under
    ``remat`` draws the masks of the forward again."""
    return (int(seed) * 1_000_003 + l) % (1 << 63)


def lora_qkv_delta(lora: Params, l: int, x: torch.Tensor, scale: float,
                   dropout: float = 0.0,
                   seed: Optional[int] = None,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Layer l's q|k|v deltas of the normed input x [..., D] -> f32 [...,
    (H + 2 Hkv) Dh], wqkv's row order.  With a seed and dropout > 0 each
    adapter draws its own mask from one generator seeded inside the layer
    (peft has one dropout a wrapped linear); ``rows`` as
    :func:`_lora_delta`'s."""
    gen = None
    if seed is not None and dropout > 0.0:
        gen = torch.Generator(x.device).manual_seed(lora_layer_seed(seed, l))
    lp = index_tree(lora["layers"], l)
    return torch.cat([_lora_delta(x, lp[t], scale, dropout, gen, rows)
                      for t in LORA_TARGETS], dim=-1)


def merge_lora(params: Params, lora: Params,
               lora_scale: float = 1.0) -> Params:
    """Fold the adapters into ``wqkv`` (peft ``merge_and_unload``; the JAX
    package's ``merge_lora``, ``llm.py:564-589``): W + scale * A @ B in f32,
    rounded once to W's dtype.  A @ B is summed over the rank one term at a
    time by elementwise f32 ops, an order every device keeps, so a merge on
    the card equals the CPU's bit for bit (and so do the int8 leaves
    quantized from it).  A serving transform: the merged tree decodes
    without the adapters, through the fused steps.  Raises ValueError on an
    int8 base (merge first, then quantize).  Returns a new tree; the input
    is not modified."""
    if isinstance(params, ShardedLLM):
        raise ValueError("merge_lora before apply_llm_sharding")
    w = params["layers"]["wqkv"]
    if is_quantized(w):
        raise ValueError("merge_lora needs the unquantized base weights "
                         "(wqkv is int8): merge first, then quantize")
    lay = lora["layers"]
    merged = torch.empty_like(w)
    for l in range(w.shape[0]):
        parts = []
        for t in LORA_TARGETS:
            a = lay[t]["a"][l].float().to(w.device)      # [D, r]
            b = lay[t]["b"][l].float().to(w.device)      # [r, out]
            acc = a[:, 0, None] * b[0]
            for k in range(1, a.shape[1]):
                acc = acc + a[:, k, None] * b[k]
            parts.append((acc * lora_scale).t())         # [out, D]
        merged[l] = (w[l].float() + torch.cat(parts)).to(w.dtype)
    return {**params, "layers": {**params["layers"], "wqkv": merged}}


def embed_tokens(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids]


def head_logits(params: Params, hidden: torch.Tensor,
                w8a8: bool = True, row_scale: int = 1) -> torch.Tensor:
    """Final hidden [..., D] -> f32 logits [..., V] (tied, untied or int8;
    the int8 head's padded rows are sliced off; ``w8a8`` and ``row_scale``
    as ``quant_matmul``'s)."""
    w = params.get("lm_head", params["embed"])
    if is_quantized(w):
        V = params["embed"].shape[0]
        return quant_matmul(hidden, w, torch.float32, w8a8=w8a8,
                            row_scale=row_scale)[..., :V]
    return matmul_f32(hidden, w.t())


def _linear(w, x: torch.Tensor, l: int, w8a8: bool = True,
            row_scale: int = 1) -> torch.Tensor:
    """x [..., in] through layer l's [out, in] weight (bf16, or an int8
    leaf through quant_matmul with its ``w8a8`` and ``row_scale``), rounded
    once to x's dtype."""
    if is_quantized(w):
        return quant_matmul(x, {"q": w["q"][l], "s": w["s"][l]}, w8a8=w8a8,
                            row_scale=row_scale)
    return matmul_f32(x, w[l].t()).to(x.dtype)


def _attention(p, x, cos, sin, mask, cfg: LLMConfig, l: int,
               cache: Optional[KVCache], ci, attention_mask=None,
               w8a8: bool = True, qkv_delta=None, row_scale: int = 1):
    return _linear(p["wo"], _attention_heads(p, x, cos, sin, mask, cfg, l,
                                             cache, ci, attention_mask,
                                             w8a8, qkv_delta, row_scale),
                   l, w8a8, row_scale)


def _attention_heads(p, x, cos, sin, mask, cfg: LLMConfig, l: int,
                     cache: Optional[KVCache], ci, attention_mask=None,
                     w8a8: bool = True, qkv_delta=None, row_scale: int = 1):
    """Layer l's attention up to the wo product: [B, T, H*Dh] in x's
    dtype.  qkv_delta (f32, wqkv's rows; LoRA's) is added to the rounded
    q, k and v, which are rounded again (``llm.py:185-197`` of the JAX
    package)."""
    B, T, _ = x.shape
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    HD, KVD = H * Dh, Hkv * Dh
    qkv = _linear(p["wqkv"], x, l, w8a8, row_scale)
    if qkv_delta is not None:
        qkv = (qkv.float() + qkv_delta).to(qkv.dtype)
    q = qkv[..., :HD].reshape(B, T, H, Dh)
    k = qkv[..., HD:HD + KVD].reshape(B, T, Hkv, Dh)
    v = qkv[..., HD + KVD:].reshape(B, T, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(index_tree(p["q_norm"], l), q, cfg.rms_norm_eps)
        k = rms_norm(index_tree(p["k_norm"], l), k, cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is None:
        # the cache-less forward: the JAX dispatch (flash at T >= 512)
        out = attn.mha(q, k, v, causal=True, attention_mask=attention_mask)
        return out.reshape(B, T, HD)
    # write the T new rows at each row's offset, then attend the cache; an
    # offset is clamped to [0, S - T] as JAX's dynamic_update_slice clamps
    # its start (llm.py:213-224), so a write past the end lands on the last
    # rows instead of raising
    ck, cv = cache.k[l], cache.v[l]
    rows = torch.arange(B, device=x.device)[:, None]
    start = torch.clamp(ci, 0, max(ck.shape[1] - T, 0))
    cols = start[:, None] + torch.arange(T, device=x.device)[None, :]
    ck[rows, cols] = k.reshape(B, T, KVD).to(ck.dtype)
    cv[rows, cols] = v.reshape(B, T, KVD).to(cv.dtype)
    S = ck.shape[1]
    k = ck.reshape(B, S, Hkv, Dh)
    v = cv.reshape(B, S, Hkv, Dh)
    # grouped-query attention with an explicit mask (llm.py:239-254)
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * (Dh ** -0.5)
    logits = torch.where(mask[:, :, None], logits,
                         torch.full((), -1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float())
    return out.to(x.dtype).reshape(B, T, HD)


def _mlp(p, x, l: int, w8a8: bool = True, row_scale: int = 1):
    return _linear(p["w_down"], _mlp_mid(p, x, l, w8a8, row_scale), l, w8a8,
                   row_scale)


def _mlp_mid(p, x, l: int, w8a8: bool = True, row_scale: int = 1):
    """Layer l's MLP up to the down product: silu(gate) * up."""
    gu = _linear(p["w_gu"], x, l, w8a8, row_scale)  # gate/up rounded apart
    g, u = gu[..., 0::2], gu[..., 1::2]
    return torch.nn.functional.silu(g.float()).to(x.dtype) * u


def _rank_parts(ws, xs, l: int, w8a8: bool = True,
                row_scale: int = 1) -> list:
    """Each rank's product of xs[m] [..., K/p] through its input-column
    shard ws[m] of layer l, in f32 and unrounded, on the rank's device.  An
    int8 W8A8 product quantizes each row with its amax over every rank's
    columns, the row's amax unsharded; ``w8a8=False`` (training) keeps the
    weight-only product, its regime read on ``row_scale`` times the rows
    (``quant_matmul``)."""
    amax = None
    if w8a8 and is_quantized(ws[0]) \
            and xs[0][..., :1].numel() >= W8A8_MIN_ROWS:
        dev = xs[0].device
        amax = torch.stack([x.float().abs().amax(-1, keepdim=True).to(dev)
                            for x in xs]).amax(0)
    parts = []
    for w, x in zip(ws, xs):
        with on_device(x.device):
            if is_quantized(w):
                parts.append(quant_matmul(
                    x, {"q": w["q"][l], "s": w["s"][l]}, torch.float32,
                    row_amax=None if amax is None else amax.to(x.device),
                    w8a8=w8a8, row_scale=row_scale))
            else:
                parts.append(matmul_f32(x, w[l].t()))
    return parts


def _sum_on(parts, device) -> torch.Tensor:
    """``parts`` summed in their order on ``device``."""
    tot = None
    for part in parts:
        tot = part.to(device) if tot is None else tot + part.to(device)
    return tot


def _rank_sum(ws, xs, l: int, device, w8a8: bool = True,
              row_scale: int = 1) -> torch.Tensor:
    """Sum over the ranks of one model group of their products
    (:func:`_rank_parts`), in f32 and in rank order on ``device``: what the
    JAX package's XLA psum does on a mesh."""
    return _sum_on(_rank_parts(ws, xs, l, w8a8, row_scale), device)


def _mesh_layers(params: ShardedLLM, cfg: LLMConfig, x, cos, sin, mask,
                 cache: ShardedCache, ci, attention_mask,
                 extra_layer_fn, lora_delta=None) -> torch.Tensor:
    """The layer loop under a mesh, driven from the first rank's device:
    per data row of the mesh and layer, each model rank's attention (its
    heads, its cache slice) and MLP (its I/p) on its device; the wo and
    down partials summed in f32 across the ranks (:func:`_rank_sum`) and
    rounded once into the residual, which stays whole on the first device
    for the norms and ``extra_layer_fn``.  ``lora_delta(l, xn)`` (LoRA's
    q|k|v deltas) runs whole on the first device; each rank adds its heads'
    columns."""
    mesh, lcfg, lay = params.mesh, params.local_cfg, params["layers"]
    dev0, eps = x.device, cfg.rms_norm_eps
    groups = [data_rows(mesh, x.shape[0], g) for g in range(mesh.n_data)]
    p = mesh.n_model
    cols = [qkv_rows(cfg, p, m).to(dev0) for m in range(p)]
    for l in range(cfg.num_hidden_layers):
        xn = rms_norm(index_tree(lay["ln1"], l), x, eps)
        delta = None if lora_delta is None else lora_delta(l, xn)
        outs = []
        for g, rows in enumerate(groups):
            lays = [r["layers"] for r in params.ranks[g]]
            heads = []
            for m, (lp, c, dev) in enumerate(zip(lays, cache.shards[g],
                                                 mesh.devices[g])):
                d = (None if delta is None
                     else delta[rows][..., cols[m]].to(dev))
                with on_device(dev):
                    heads.append(_attention_heads(
                        lp, xn[rows].to(dev), cos[rows].to(dev),
                        sin[rows].to(dev), mask[rows].to(dev), lcfg, l, c,
                        ci[rows].to(dev), attention_mask[rows].to(dev),
                        qkv_delta=d))
            outs.append(_rank_sum([lp["wo"] for lp in lays], heads, l, dev0))
        x = x + torch.cat(outs).to(x.dtype)
        xn = rms_norm(index_tree(lay["ln2"], l), x, eps)
        outs = []
        for g, rows in enumerate(groups):
            lays = [r["layers"] for r in params.ranks[g]]
            mids = []
            for lp, dev in zip(lays, mesh.devices[g]):
                with on_device(dev):
                    mids.append(_mlp_mid(lp, xn[rows].to(dev), l))
            outs.append(_rank_sum([lp["w_down"] for lp in lays], mids, l,
                                  dev0))
        x = x + torch.cat(outs).to(x.dtype)
        if extra_layer_fn is not None:
            x = extra_layer_fn(l, x)
    return x


def _spans_cards(params) -> bool:
    """True when a group's ranks (and a pipe mesh's stages) lie on more
    than one device."""
    return len(params.mesh.all_devices()) > 1


def _split_seq(x: torch.Tensor, devices) -> tuple:
    """The residual's slices over T, slice m on ``devices[m]``
    (``torch.tensor_split``: T need not divide); one device: x whole."""
    if len(devices) == 1:
        return (x.to(devices[0]),)
    return tuple(c.to(dev) for c, dev in
                 zip(torch.tensor_split(x, len(devices), dim=1), devices))


def _gather_seq(xs, device) -> torch.Tensor:
    """The slices gathered whole on ``device`` (an all-gather's share)."""
    if len(xs) == 1:
        return xs[0].to(device)
    return torch.cat([x.to(device) for x in xs], dim=1)


def _scatter_sum(parts, xs) -> tuple:
    """A reduce-scatter into the residual's slices ``xs``: slice m of the
    ranks' f32 products ``parts`` (each [B, T, D] on its rank), summed in
    rank order on slice m's device (:func:`_sum_on`, as :func:`_rank_sum`
    sums the whole), rounded once and added to ``xs[m]``."""
    out, lo = [], 0
    for x in xs:
        hi = lo + x.shape[1]
        tot = _sum_on(parts if len(xs) == 1 else
                      [part[:, lo:hi] for part in parts], x.device)
        out.append(x + tot.to(x.dtype))
        lo = hi
    return tuple(out)


def _group_layer(params: ShardedLLM, cfg: LLMConfig, l: int, xs, qkv_delta,
                 cos, sin, attention_mask, w8a8: bool,
                 parts_remat: bool = False, row_scale: int = 1) -> tuple:
    """Layer l of the cache-less forward on a ``1 x p`` group (training:
    one data row's group, ``train/step.py``), without the hook, on the
    residual's slices ``xs``: one, whole on the group's first device, or p
    of them cut over T (Megatron sequence parallelism, ``llm.py:310-330``
    of the JAX package), slice m [B, T_m, D] on rank m's device.  Each
    slice takes its ln1 / ln2 and residual adds; the normed slices are
    gathered on every rank before its attention heads (K11 at H/p, Hkv/p
    from T >= 512) and its I/p of the MLP; the wo and down partials are
    summed in f32 in rank order and rounded once into each slice
    (:func:`_scatter_sum`; one slice: :func:`_rank_sum`'s sum).  RMSNorm is
    per row, so both cuts give the same numbers.  ``qkv_delta(xn)`` (LoRA's
    f32 q|k|v deltas, or None) runs on the normed input whole on the first
    device; each rank adds its heads' columns.  Autograd carries the
    backward through the moves.

    ``parts_remat`` (under ``remat``, a group whose ranks lie on several
    cards): each device's share runs under a checkpoint of its own (the
    norms, LoRA's deltas, each rank's heads, each rank's MLP middle; the
    rank sums keep their inputs), in place of one checkpoint of the layer,
    which each card's autograd thread would recompute at once."""
    def run(fn, *args):
        if parts_remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def norm(name, lp):
        return lambda h: rms_norm(index_tree(lp[name], l), h,
                                  cfg.rms_norm_eps)

    mesh, lcfg = params.mesh, params.local_cfg
    ranks = [r["layers"] for r in params.ranks[0]]
    devs, p = mesh.devices[0], mesh.n_model
    xn = [run(norm("ln1", lp), x) for lp, x in zip(ranks, xs)]
    delta = (None if qkv_delta is None
             else run(qkv_delta, _gather_seq(xn, devs[0])))
    heads = []
    for m, (lp, dev) in enumerate(zip(ranks, devs)):
        d = (None if delta is None
             else delta[..., qkv_rows(cfg, p, m).to(delta.device)].to(dev))

        def attention(xm, cm, sm, am, dm, lp=lp, dev=dev):
            with on_device(dev):
                return _attention_heads(lp, xm, cm, sm, None, lcfg, l, None,
                                        None, am, w8a8, dm, row_scale)
        heads.append(run(attention, _gather_seq(xn, dev), cos.to(dev),
                         sin.to(dev), attention_mask.to(dev), d))
    xs = _scatter_sum(_rank_parts([lp["wo"] for lp in ranks], heads, l,
                                  w8a8, row_scale), xs)
    xn = [run(norm("ln2", lp), x) for lp, x in zip(ranks, xs)]
    mids = []
    for lp, dev in zip(ranks, devs):

        def mlp_mid(xm, lp=lp, dev=dev):
            with on_device(dev):
                return _mlp_mid(lp, xm, l, w8a8, row_scale)
        mids.append(run(mlp_mid, _gather_seq(xn, dev)))
    return _scatter_sum(_rank_parts([lp["w_down"] for lp in ranks], mids, l,
                                    w8a8, row_scale), xs)


def _plain_layer(lay, cfg: LLMConfig, l: int, x, qkv_delta, cos, sin, mask,
                 cache, ci, attention_mask, w8a8: bool,
                 row_scale: int = 1) -> torch.Tensor:
    """Layer l of one device's layer loop, without the hook."""
    xn = rms_norm(index_tree(lay["ln1"], l), x, cfg.rms_norm_eps)
    delta = None if qkv_delta is None else qkv_delta(xn)
    x = x + _attention(lay, xn, cos, sin, mask, cfg, l, cache, ci,
                       attention_mask, w8a8, delta, row_scale)
    return x + _mlp(lay, rms_norm(index_tree(lay["ln2"], l), x,
                                  cfg.rms_norm_eps), l, w8a8, row_scale)


def _decoder_layer(tree, cfg: LLMConfig, l: int, xs, cos, sin,
                   attention_mask, w8a8: bool, row_scale: int = 1,
                   parts_remat: bool = False, qkv_delta=None, mask=None,
                   cache=None, ci=None) -> tuple:
    """Layer l (``tree``'s own index) without the hook -> the residual's
    slices after it: on a ``1 x p`` group's ShardedLLM
    (:func:`_group_layer`, ``xs`` one slice or p), else on
    ``{"layers": ...}`` on the residual's device, ``xs`` its one slice
    (under ``parts_remat`` the layer is a checkpoint of its own).
    ``llm_apply``'s layer loop and a pipeline stage
    (``parallel/pipeline.py``) run it."""
    if isinstance(tree, ShardedLLM):
        return _group_layer(tree, cfg, l, xs, qkv_delta, cos, sin,
                            attention_mask, w8a8, parts_remat, row_scale)
    args = (tree["layers"], cfg, l, xs[0], qkv_delta, cos, sin, mask, cache,
            ci, attention_mask, w8a8, row_scale)
    if parts_remat:
        return (checkpoint(_plain_layer, *args, use_reentrant=False),)
    return (_plain_layer(*args),)


def _layer_loop(params, cfg: LLMConfig, layer, x, cos, sin, attention_mask,
                stages, *, remat: bool, parts_remat: bool,
                sequence_parallel: bool, qkv_delta, extra_layer_fn,
                extra_aux_init):
    """``llm_apply``'s layer loop -> (hidden before the final norm on x's
    device, the hook's aux or None).  ``layer(tree, l, xs, cos, sin,
    attention_mask, qkv_delta=)`` runs layer l of ``tree`` on the
    residual's slices ``xs`` (:func:`_decoder_layer`).  On a pipe mesh
    (``stages``) the layers run through the stages one after the other, the
    residual moving to each stage's first device; else over ``params``.
    With ``sequence_parallel`` the residual is held cut over T on the
    group's ranks.  ``qkv_delta(l, xn)`` (LoRA) and the hook run on x's
    device on whole rows.  Under ``remat`` each layer (with its hook) is a
    checkpoint, or each device's share is where ``parts_remat``."""
    dev = x.device
    res_devs = params.mesh.devices[0] if sequence_parallel else [dev]
    n_res = len(res_devs)

    def run(fn, *args):
        if parts_remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def step(l, lo, tree, tabs, *state):
        xs, aux = state[:n_res], state[n_res:]
        delta = None if qkv_delta is None else (
            lambda xn: qkv_delta(l, xn.to(dev)).to(xn.device))
        xs = layer(tree, l - lo, xs, *tabs, qkv_delta=delta)
        if extra_layer_fn is None:
            return (*xs, *aux)
        whole = _gather_seq(xs, dev)
        if extra_aux_init is not None:
            def hook(h, *aux):
                h, aux = extra_layer_fn(l, h, aux)
                return (h, *aux)
            whole, *aux = run(hook, whole, *aux)
        else:
            whole = run(lambda h: extra_layer_fn(l, h), whole)
        return (*_split_seq(whole, [h.device for h in xs]), *aux)

    segments = ([(st.lo, st.hi, st.tree, st.device) for st in stages]
                if stages is not None else
                [(0, cfg.num_hidden_layers, params, dev)])
    state = (*_split_seq(x, res_devs), *(extra_aux_init or ()))
    for lo, hi, tree, sdev in segments:
        tabs = (cos.to(sdev), sin.to(sdev), attention_mask.to(sdev))
        if not sequence_parallel:
            state = (state[0].to(sdev), *state[1:])
        for l in range(lo, hi):
            args = (l, lo, tree, tabs, *state)
            state = (checkpoint(step, *args, use_reentrant=False)
                     if remat and not parts_remat else step(*args))
    aux = tuple(state[n_res:]) if extra_aux_init is not None else None
    return _gather_seq(state[:n_res], dev), aux


def _mesh_decode_step(params: ShardedLLM, cfg: LLMConfig, x, attention_mask,
                      positions, cache: ShardedCache, ci, extra_layer_fn,
                      fused_injection):
    """The hidden state of a cached T == 1 step under a mesh through the
    fused tensor-parallel kernels, or None where the layer loop must run
    (the dispatch of ``llm.py:363-434`` of the JAX package): K10, with the
    injection inside when it takes it, and without a hook.  The JAX
    package's next choice, K9's pair under the mesh, takes no step that K10
    refuses here (``fused_decode_tp.tp_limits`` is K10's limits and
    more), so it is not dispatched."""
    if ((extra_layer_fn is None or fused_injection is not None)
            and fused_mesh_takes(params, cfg, cache, fused_injection)):
        return fused_decode_layers_mesh(params, cfg, x, attention_mask,
                                        positions, cache, ci,
                                        inject=fused_injection)[0]
    return None


def fused_step_logits(params: Params, cfg: LLMConfig, x: torch.Tensor,
                      attention_mask: torch.Tensor, positions: torch.Tensor,
                      cache: KVCache, ci: torch.Tensor,
                      fused_injection=None) -> torch.Tensor:
    """The fused decode step from its embeddings x [B, 1, D]:
    ``fused_decode_layers`` (the cache written in place at ci [B] on x's
    device), the final norm, the head -> f32 logits [B, 1, V].  The body of
    :func:`decode_step` and of :func:`llm_apply`'s fused branch."""
    hidden, _ = fused_decode_layers(params, cfg, x, attention_mask,
                                    positions, cache, ci,
                                    inject=fused_injection)
    hidden = rms_norm(params["norm"], hidden, cfg.rms_norm_eps)
    return head_logits(params, hidden)


def decode_step(params: Params, cfg: LLMConfig, ids: torch.Tensor,
                positions: torch.Tensor, ci: torch.Tensor,
                attention_mask: torch.Tensor, cache: KVCache,
                fused_injection=None) -> torch.Tensor:
    """One cached decode step through the fused kernels, on device tensors
    only (no host value reaches the device, so a CUDA graph can capture
    it): ids [B] int64, positions [B] int64, ci [B] int32 (each row's cache
    write position), attention_mask [B, >=S], the cache (written in place)
    and the fused injection spec or None -> f32 logits [B, V].  The caller
    checks ``fused_decode_supported``; :func:`llm_apply`'s fused T == 1
    branch runs the same body (:func:`fused_step_logits`), and on CPU
    tensors both run the plain versions."""
    x = embed_tokens(params, ids[:, None])
    return fused_step_logits(params, cfg, x, attention_mask,
                             positions[:, None], cache, ci,
                             fused_injection)[:, 0]


def _check_mesh(params, cache) -> bool:
    """True when the call runs under a mesh (the params cut for the current
    one; with a cache, a ShardedCache; without, a ``1 x p`` mesh: one data
    row's group); raises on a mismatch."""
    mesh = current_mesh()
    sharded = isinstance(params, ShardedLLM)
    if mesh is None and not sharded:
        return False
    if not sharded or params.mesh is not mesh:
        raise ValueError("under a mesh llm_apply takes the LLM cut for it by "
                         "parallel/sharding.apply_llm_sharding, and that LLM "
                         "only under its mesh")
    if cache is None:
        if mesh.n_data != 1:
            raise ValueError(
                "the cache-less forward under a mesh runs on one data row's "
                "1 x p group (Mesh.row_mesh, parallel/sharding.row_llm); "
                "train/step.py splits the batch over the data rows")
    elif mesh.n_pipe > 1:
        raise ValueError("a pipe mesh runs the cache-less forward only "
                         "(training); serve on a mesh without one")
    elif not isinstance(cache, ShardedCache):
        raise ValueError("under a mesh llm_apply takes a ShardedCache "
                         "(init_kv_cache under use_mesh)")
    return True


def llm_apply(params: Params, cfg: LLMConfig, *,
              input_ids: Optional[torch.Tensor] = None,
              inputs_embeds: Optional[torch.Tensor] = None,
              attention_mask: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None, cache_index=None,
              extra_layer_fn: Optional[Callable] = None,
              extra_aux_init=None,
              fused_injection=None, return_hidden: bool = False,
              skip_head: bool = False, remat: bool = False,
              w8a8: bool = True, lora: Optional[Params] = None,
              lora_scale: float = 1.0, lora_dropout: float = 0.0,
              lora_seed: Optional[int] = None,
              batch_rows: Optional[Tuple[int, int]] = None,
              pipeline_microbatches: int = 0,
              sequence_parallel: bool = False):
    """Forward pass -> (logits [B, T, V] f32, cache), or with
    ``return_hidden`` (logits, cache, final hidden [B, T, D] after the last
    norm); ``skip_head`` leaves logits None.  With ``extra_aux_init`` a
    last element carries the hook's final aux.

    input_ids [B, T] or inputs_embeds [B, T, D] (exactly one).
    attention_mask [B, T] 1/0 (left padding), or [B, S] covering the cache.
    positions [B, T] RoPE positions; default cumsum(mask)-1 without a
    cache, cache_index + arange(T) with one.  With a cache the new k/v rows
    land at ``cache_index`` (int or [B]) and the queries attend the whole
    cache under a causal-by-position mask.  On the layer loop a row's write
    start is clamped to [0, S - T] (JAX's ``dynamic_update_slice``); the
    fused decode step drops the positions past S instead.

    extra_layer_fn(l, h) -> h runs after every layer (ORCA's injection in
    PyTorch); with ``extra_aux_init`` (the cache-less forward only) it is
    ``fn(l, h, aux) -> (h, aux)``, aux a tuple of tensors threaded through
    the layers (ORCA's per-layer alignment sums, ``llm.py:303-321`` of the
    JAX package).  A cached T == 1 call takes the fused decode step where
    ``ops/fused_decode.fused_decode_supported`` holds (else the layer loop,
    counted by ``_build.count_fallback``): with
    ``fused_injection`` (the ``inject`` spec of ``ops/fused_decode.py``) the
    injection runs inside it; with only ``extra_layer_fn`` the step runs
    layer by layer here so the hook can run between layers, or, when
    ``ops/fused_decode_tp.fused_perlayer_supported`` holds (the opt-in),
    through the per-layer kernel pair (``llm.py:356-454`` of the JAX
    package).

    remat: without a cache and with grad mode on, each decoder layer runs
    under ``torch.utils.checkpoint`` (non-reentrant) and is recomputed in
    the backward, as ``jax.checkpoint`` does in the JAX package; the hook
    and its aux run inside it, so the recompute adds nothing to the aux.

    w8a8: the int8 tower's products and head may quantize activations from
    128 rows (``ops/qmm.quant_matmul``); training passes False.

    batch_rows (first, total): these B rows are rows first.. of a training
    batch of ``total`` rows split over devices or processes.  The int8
    tower's weight-only products pick their row regime for the whole batch
    (``quant_matmul``'s ``row_scale`` = total / B), and LoRA's dropout
    masks are drawn over the whole batch and sliced.

    lora (:func:`init_lora`'s tree), lora_scale (alpha / r): the adapters'
    deltas on q, k and v in every layer, through the layer loop only (no
    fused step, K9 or K10 takes the call; under a mesh the per-rank loop).
    lora_dropout with a lora_seed (training) drops the adapters' inputs,
    each layer's masks from a generator seeded by (lora_seed, layer)
    inside the layer, so the recompute under ``remat`` draws them again;
    without a seed there is no dropout.  An injection under LoRA comes as
    ``extra_layer_fn``.

    The cache-less forward under a ``1 x p`` mesh (training's data row
    group) runs each layer through :func:`_group_layer`, with the hook,
    its aux, LoRA and ``remat`` as above: a layer's checkpoint spans the
    group's ranks and its recompute runs each rank's part on its device;
    where the ranks lie on several cards, each device's share (and the
    hook) is checkpointed alone instead.

    sequence_parallel (``llm.py:310-330`` of the JAX package): on such a
    group with p > 1 and without a cache, the residual is cut over T
    between blocks (:func:`_group_layer`); the numbers are those without it.
    A no-op without a group, with a cache, or on a pipe mesh.

    pipeline_microbatches: under a ``1 x n_model x n_pipe`` mesh (a data
    row's group of a pipe mesh, ``parallel/sharding.pipe_stages``) and
    without a cache, LoRA or a hook, the layers run as a GPipe schedule of
    that many microbatches over the stages
    (``parallel/pipeline.pipeline_decoder_hidden``; ``llm.py:458-473`` of
    the JAX package).  Otherwise on a pipe mesh (0 microbatches, LoRA, the
    hook) the layers run in order through the stages as one microbatch,
    each stage on its own devices, the hook and LoRA on the first device:
    the numbers of one device.  Without a pipe axis it is a no-op.
    """
    if (input_ids is None) == (inputs_embeds is None):
        raise ValueError("provide exactly one of input_ids / inputs_embeds")
    if extra_aux_init is not None and cache is not None:
        raise ValueError("extra_aux_init takes the cache-less forward only")
    if lora is not None and fused_injection is not None \
            and extra_layer_fn is None:
        raise ValueError("under LoRA the layer loop runs: give the injection "
                         "as extra_layer_fn")
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids)
    x = inputs_embeds
    B, T, _ = x.shape
    dev = x.device
    ci = None
    sharded = _check_mesh(params, cache)
    if cache is not None:
        S = (cache.shape if sharded else cache.k.shape)[2]
        if attention_mask is None:
            attention_mask = torch.ones(B, S, dtype=torch.int32, device=dev)
        ci = torch.as_tensor(cache_index, device=dev).long()
        if ci.dim() == 0:
            ci = ci.expand(B)
        q_pos = ci[:, None] + torch.arange(T, device=dev)[None, :]
        key_pos = torch.arange(S, device=dev)
        mask = ((key_pos[None, None, :] <= q_pos[:, :, None])
                & (attention_mask[:, None, :S] > 0))[:, None]   # [B,1,T,S]
        if positions is None:
            positions = q_pos
        if sharded:
            hidden = None
            if T == 1 and lora is None:
                hidden = _mesh_decode_step(params, cfg, x, attention_mask,
                                           positions, cache, ci,
                                           extra_layer_fn, fused_injection)
            if hidden is None:
                cos, sin = llm_rope_cos_sin(cfg, positions)
                x = _mesh_layers(
                    params, cfg, x, cos, sin, mask, cache, ci,
                    attention_mask, extra_layer_fn,
                    None if lora is None else
                    lambda l, xn: lora_qkv_delta(lora, l, xn, lora_scale))
                hidden = x
            hidden = rms_norm(params["norm"], hidden, cfg.rms_norm_eps)
            logits = None if skip_head else head_logits(params, hidden)
            return (logits, cache, hidden) if return_hidden else (logits,
                                                                  cache)
        # under LoRA the layer loop below runs: no fused step takes it
        if lora is None and T == 1 and (fused_injection is not None
                                        or extra_layer_fn is None):
            if fused_decode_supported(params, cfg, x, cache):
                return fused_step_logits(params, cfg, x, attention_mask,
                                         positions, cache, ci,
                                         fused_injection), cache
            if extra_layer_fn is None and fused_injection is not None:
                raise ValueError("the decode step's kernels cannot take this "
                                 "step and no injection hook was given")
            # the kernels cannot take this step: the layer loop below (the
            # JAX package's XLA path), with the injection hook if any
            _build.count_fallback("fused_decode_layers")
        if (T == 1 and lora is None
                and fused_perlayer_supported(params, cfg, cache)):
            # opt-in: the per-layer kernel pair with the hook between
            # layers (llm.py:436-454 of the JAX package)
            hidden, cache = fused_decode_layers_perlayer(
                params, cfg, x, attention_mask, positions, cache, ci,
                extra_layer_fn=extra_layer_fn)
            hidden = rms_norm(params["norm"], hidden, cfg.rms_norm_eps)
            return head_logits(params, hidden), cache
    else:
        mask = None
        if attention_mask is None:
            attention_mask = torch.ones(B, T, dtype=torch.int32, device=dev)
        if positions is None:
            positions = torch.clamp(torch.cumsum(attention_mask, 1) - 1, min=0)

    cos, sin = llm_rope_cos_sin(cfg, positions)
    row_scale = 1 if batch_rows is None else batch_rows[1] // B
    remat = remat and cache is None and torch.is_grad_enabled()
    stages = params.stages[0] if sharded and pipeline_enabled() else None
    # a group or stages across cards checkpoint each device's share of a
    # layer alone
    parts_remat = remat and sharded and _spans_cards(params)

    def layer(tree, l, xs, co, si, am, parts_remat=parts_remat,
              qkv_delta=None):
        return _decoder_layer(tree, cfg, l, xs, co, si, am, w8a8, row_scale,
                              parts_remat, qkv_delta, mask, cache, ci)

    if stages is not None and pipeline_microbatches and lora is None \
            and extra_layer_fn is None and extra_aux_init is None:
        x, aux = pipeline_decoder_hidden(
            stages, layer, x, attention_mask, cos, sin,
            n_micro=pipeline_microbatches, remat=remat), None
    else:
        x, aux = _layer_loop(
            params, cfg, layer, x, cos, sin, attention_mask, stages,
            remat=remat, parts_remat=parts_remat,
            sequence_parallel=(sequence_parallel and cache is None
                               and sharded and stages is None
                               and params.mesh.n_model > 1),
            qkv_delta=None if lora is None else
            lambda l, xn: lora_qkv_delta(lora, l, xn, lora_scale,
                                         lora_dropout, lora_seed, batch_rows),
            extra_layer_fn=extra_layer_fn, extra_aux_init=extra_aux_init)
    hidden = rms_norm(params["norm"], x, cfg.rms_norm_eps)
    logits = None if skip_head else head_logits(params, hidden, w8a8,
                                                row_scale)
    out = (logits, cache, hidden) if return_hidden else (logits, cache)
    return out if aux is None else out + (aux,)
