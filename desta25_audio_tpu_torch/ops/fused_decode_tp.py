"""One int8 decode step as per-layer halves with f32 partial sums (port of
``desta25_audio_tpu/ops/fused_decode_tp.py``, K9).

The decode step of ``ops/fused_decode.py`` (K8) keeps the residual in bf16
and spans every layer.  K9 splits each layer in two, on an f32 residual h
[B, D], with each half ending in an f32 partial sum:

    h += reduce(attn_half(bf16(h)))    # ln1, int8 q/k/v, qk-norm, RoPE, the
                                       # cache write, scores, P.V, wo
    h += reduce(mlp_half(bf16(h)))     # ln2, gate/up, SwiGLU, down

Under tensor parallelism (p ranks, each holding H/p heads, Hkv/p kv heads
and I/p of the MLP, :func:`shard_layers`) ``reduce`` sums the ranks'
partials; at p = 1 it is the identity.  :func:`fused_decode_layers_perlayer`
runs the pair layer by layer on one device with an optional
``extra_layer_fn(l, bf16 hidden [B, 1, D])`` between layers (ORCA's deep
injection in PyTorch), the hidden cast back to f32 after it
(``fused_decode_tp.py:783-815`` of the JAX package).

Rounding points (the TPU kernels'): each half reads bf16(h); RMSNorm in f32
rounded to bf16; the q/k/v and gate/up sums in f32, times the int8 scale,
rounded to bf16; qk-norm and RoPE in f32, q and k rounded to bf16; scores in
f32; P normalised in f32, rounded to bf16 for the cached keys and kept f32
for the current token; bf16(silu(gate)) * up rounded to bf16; the wo and
down sums f32, times the scale, unrounded.  The attention and MLP math is
K8's plain version (``ops/fused_decode.attention_plain`` / ``mlp_plain``);
only the residual differs.

On CUDA tensors the halves launch K8's kernels on the f32 residual: the
attention half 4 (ln1, the step's norm kernel on f32 rows; the q/k/v
skinny GEMM; the attention with the cache write; wo), counted as
``fused_decode_tp_attn``; the MLP half 3 (ln2; the gate/up skinny GEMM with
SwiGLU; down), counted as ``fused_decode_tp_mlp``; in
``_build.kernel_counts()`` as ``rms_norm``, ``skinny_gemm`` and
``decode_attention``.  Every launch carries programmatic dependent launch,
so a layer's seven chain on the stream and in a CUDA graph
(``generate/graph.PerLayerStep`` replays the whole step with the hook
between layers).  At p = 1 the layer loop adds the partials into h inside
the wo / down epilogue (the same f32 add).  On CPU tensors the plain
versions run.

Under a mesh (``parallel/mesh.py``), :func:`fused_decode_layers_tp` runs the
pair on every "model" rank of the LLM cut by
``parallel/sharding.apply_llm_sharding``, the wo / down partials all-reduced
into each rank's f32 residual by ``csrc/tp_allreduce.cu``
(``fused_decode_tp.py:557-722`` of the JAX package).  ``models/llm.py``
does not dispatch it: the JAX package takes it where K10 exceeds the TPU's
VMEM budgets, and the port's K10 (``ops/fused_decode_mesh.py``) has none,
so every step :func:`fused_tp_supported` takes, K10 takes too.

The per-layer path is opt-in, as in the JAX package: ``FUSED_PERLAYER`` is
read once from ``DESTA_FUSED_PERLAYER`` ("1" turns it on); tests and
``chip_smoke.py`` set the attribute.  ``models/llm.py`` routes a cached
T == 1 step that has an ``extra_layer_fn`` and no in-kernel injection here
when :func:`fused_perlayer_supported` holds.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import List, NamedTuple, Optional

import torch

from ..parallel.mesh import current_mesh, on_device
from ..parallel.sharding import (  # noqa: F401 (shard_*: this module's API)
    ShardedCache,
    ShardedLLM,
    local_config,
    shard_cache,
    shard_layers,
)
from . import _build
from .fused_decode import (
    KVCache,
    _row_indices,
    attention_plain,
    kernel_limits,
    mlp_plain,
    plain_step,
    rms_plain,
    tower_is_int8,
)
from .rope import llm_rope_cos_sin
from .skinny_gemm import EPI_STORE, EPI_SWIGLU, passes
from .tp_allreduce import (
    ATTN_SLOT,
    MLP_SLOT,
    allreduce_plain,
    group_buffers,
    layer_round,
)

logger = logging.getLogger(__name__)

# Off by default, as in the JAX package: off, the hooked step runs the
# layer loop of ``models/llm.py``, whose bf16 residual between layers is the
# JAX package's default numerics (its greedy ids are the ones the port's
# default must reproduce); on, K9's f32 residual, whose ids can differ.
FUSED_PERLAYER = os.environ.get("DESTA_FUSED_PERLAYER", "0") == "1"
_logged: set = set()      # the fallback reasons logged once each


class DecodeStep(NamedTuple):
    """One decode step's per-row inputs, shared by every layer and rank:
    RoPE tables cos / sin [B, Dh] f32, the attention mask [B, >=S] int32
    (1 = attend) and each row's cache index ci [B] int32."""
    cos: torch.Tensor
    sin: torch.Tensor
    mask: torch.Tensor
    ci: torch.Tensor


def decode_step_inputs(cfg, attention_mask, positions, cache_index,
                       B: int) -> DecodeStep:
    dev = attention_mask.device
    cos, sin = llm_rope_cos_sin(cfg, positions.reshape(B))
    return DecodeStep(cos.float().contiguous(), sin.float().contiguous(),
                      attention_mask.to(torch.int32).contiguous(),
                      _row_indices(cache_index, B, dev))


# -- dispatch predicate ----------------------------------------------------------

def perlayer_limits(params, cfg, cache: KVCache, batch: int) -> List[str]:
    """Why the kernels cannot run this step (empty: they can): the JAX
    predicate's semantic conditions (an int8 tower, a bf16 cache; the port
    has no mesh and no LoRA on this path) and the CUDA kernels' own shape
    limits (``ops/fused_decode.kernel_limits``: the norm kernel's width,
    the attention's and the GEMMs' shapes)."""
    bad = []
    if not tower_is_int8(params):
        bad.append("the LLM is not int8 (apply_llm_quant)")
    if cache.k.dtype != torch.bfloat16 or cache.k.dim() != 4:
        bad.append(f"cache {cache.k.dtype} of rank {cache.k.dim()} (the "
                   "kernels take a bf16 [L, B, S, Hkv*Dh] cache)")
        return bad
    Hkv, Dh = cfg.num_key_value_heads, cfg.head_dim
    if cache.k.shape[3] != Hkv * Dh or cache.k.shape[1] != batch:
        bad.append(f"cache {tuple(cache.k.shape)} for B={batch}, "
                   f"Hkv*Dh={Hkv * Dh}")
    bad += kernel_limits(cfg, batch, 1, cache.k.shape[2], True,
                         _build.sm_count(cache.k.device))
    return bad


def fused_perlayer_supported(params, cfg, cache: KVCache) -> bool:
    """Does a cached T == 1 step with a per-layer hook take the per-layer
    pair?  Only with the opt-in (``FUSED_PERLAYER``).  With the opt-in and
    a step the kernels cannot take, the layer loop runs, as in the JAX
    package, and the reasons are logged once."""
    if not FUSED_PERLAYER:
        return False
    bad = perlayer_limits(params, cfg, cache, cache.k.shape[1])
    if bad:
        msg = "; ".join(bad)
        if msg not in _logged:
            _logged.add(msg)
            logger.warning("DESTA_FUSED_PERLAYER: the per-layer decode "
                           "kernels cannot take this step, running the "
                           "layer loop: %s", msg)
        return False
    return True


# -- the halves: plain versions ------------------------------------------------

def attn_half_plain(params, cfg, h: torch.Tensor, step: DecodeStep,
                    cache: KVCache, layer: int) -> torch.Tensor:
    """Layer ``layer``'s attention half on the f32 residual h [B, D]: the wo
    product's f32 partial sum [B, D]; the k/v rows of the step are written
    at each row's ci in place."""
    B = h.shape[0]
    lay = params["layers"]
    st = plain_step(step.cos, step.sin, step.mask, step.ci, B, 1,
                    cache.k.shape[2])
    xn = rms_plain(h.to(torch.bfloat16), lay["ln1"]["scale"][layer],
                   cfg.rms_norm_eps, torch.bfloat16)
    return attention_plain(lay, cfg, st, cache, layer, xn)


def mlp_half_plain(params, cfg, h: torch.Tensor, layer: int) -> torch.Tensor:
    """Layer ``layer``'s MLP half on the f32 residual h [B, D]: the down
    product's f32 partial sum [B, D]."""
    lay = params["layers"]
    xn = rms_plain(h.to(torch.bfloat16), lay["ln2"]["scale"][layer],
                   cfg.rms_norm_eps, torch.bfloat16)
    return mlp_plain(lay, layer, xn)


# -- the halves: kernels ----------------------------------------------------------

class Scratch(NamedTuple):
    """A step's buffers between the launches, bf16: the normalised rows [B,
    D], the q/k/v rows [B, (H+2Hkv)*Dh], the attention's output [B, H*Dh],
    the MLP's [B, I]."""
    xn: torch.Tensor
    qkv: torch.Tensor
    attn: torch.Tensor
    mid: torch.Tensor


def step_scratch(cfg, B: int, device) -> Scratch:
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    bf = dict(dtype=torch.bfloat16, device=device)
    return Scratch(torch.empty(B, cfg.hidden_size, **bf),
                   torch.empty(B, (H + 2 * Hkv) * Dh, **bf),
                   torch.empty(B, H * Dh, **bf),
                   torch.empty(B, cfg.intermediate_size, **bf))


class _Operands(NamedTuple):
    lay: dict
    xn: torch.Tensor       # the Scratch's buffers
    qkv: torch.Tensor
    attn: torch.Tensor
    mid: torch.Tensor
    stream: int


def _operands(params, cfg, h, name: str, step: Optional[DecodeStep] = None,
              cache: Optional[KVCache] = None,
              scratch: Optional[Scratch] = None) -> _Operands:
    """Check once what the launches read (the attention's step inputs and
    cache when given): the leaves' and the step's shapes, devices, dtypes
    and alignment; take ``scratch`` or allocate the step's.  Raises
    ValueError.  The kernel limits (``perlayer_limits``) are the dispatch
    predicate's to check; the kernels' entry points refuse what they
    cannot take with an error status, which raises RuntimeError."""
    B, D = h.shape
    bad = [] if tower_is_int8(params) else ["the LLM is not int8"]
    KVD = cfg.num_key_value_heads * cfg.head_dim
    if cache is not None and (cache.k.dim() != 4
                              or tuple(cache.k.shape[1:]) != (
                                  B, cache.k.shape[2], KVD)
                              or cache.v.shape != cache.k.shape):
        bad.append(f"cache {tuple(cache.k.shape)} / {tuple(cache.v.shape)} "
                   f"for B={B}, Hkv*Dh={KVD}")
    if D != cfg.hidden_size or h.dtype != torch.float32:
        bad.append(f"h {tuple(h.shape)} {h.dtype} (expected [B, "
                   f"{cfg.hidden_size}] float32)")
    if step is not None and (step.mask.shape[0] != B
                             or step.mask.shape[1] < cache.k.shape[2]
                             or step.ci.shape != (B,)):
        bad.append(f"mask {tuple(step.mask.shape)} / ci "
                   f"{tuple(step.ci.shape)} for B={B}, S={cache.k.shape[2]}")
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    I = cfg.intermediate_size
    lay = params["layers"]
    L = lay["wqkv"]["q"].shape[0]
    shapes = {"wqkv": (L, (H + 2 * Hkv) * Dh, D), "wo": (L, D, H * Dh),
              "w_gu": (L, 2 * I, D), "w_down": (L, D, I)}
    for key, shp in shapes.items():
        leaf = lay[key]
        if tuple(leaf["q"].shape) != shp or tuple(leaf["s"].shape) != shp[:2]:
            raise ValueError(f"{name}: {key} {tuple(leaf['q'].shape)}, "
                             f"expected {shp}")
    norms = [lay["ln1"]["scale"], lay["ln2"]["scale"]]
    if cfg.qk_norm:
        norms += [lay["q_norm"]["scale"], lay["k_norm"]["scale"]]
    _build.require_cuda(name, h, dtype=torch.float32)
    _build.require_cuda(name, *norms, dtype=torch.bfloat16)
    if cache is not None:
        _build.require_cuda(name, step.cos, step.sin, dtype=torch.float32)
        _build.require_cuda(name, cache.k, cache.v, dtype=torch.bfloat16)
        _build.require_cuda(name, step.mask, step.ci, dtype=torch.int32)
    _build.require_cuda(name, *(lay[k]["q"] for k in shapes),
                        dtype=torch.int8)
    _build.require_cuda(name, *(lay[k]["s"] for k in shapes),
                        dtype=torch.float32)
    if scratch is None:
        scratch = step_scratch(cfg, B, h.device)
    return _Operands(lay, *scratch, _build.stream_ptr(h.device))


def _launch(status: int, name: str) -> None:
    _build.check(status, name)
    _build.count_launch(name)


def _norm_gemm(op: _Operands, h, ln, leaf, l: int, eps: float, out, N: int,
               epi: int, name: str) -> None:
    """Layer l's norm of h into op.xn, then its int8 product ``leaf`` of
    op.xn into ``out`` [B, N] bf16 through epilogue ``epi`` (STORE or
    SWIGLU): two launches, K8's norm kernel on f32 rows and the skinny
    GEMM."""
    lib = _build.library()
    B, D = h.shape
    _launch(lib.desta_rms_norm_f32(
        h.data_ptr(), ln["scale"][l].data_ptr(), op.xn.data_ptr(), B, D, eps,
        op.stream), name)
    _build.count_kernel("rms_norm")
    _launch(lib.desta_skinny_gemm(
        op.xn.data_ptr(), leaf["q"][l].data_ptr(), leaf["s"][l].data_ptr(),
        None, out.data_ptr(), B, N, D, epi, 1, op.stream), name)
    _build.count_kernel("skinny_gemm", passes(B))


def _attn_launches(op: _Operands, cfg, h, step: DecodeStep, cache: KVCache,
                   l: int, out: torch.Tensor, accumulate: bool,
                   store=None) -> None:
    """The attention half's 4 launches on checked operands; with ``store``
    (``x, w, scale, name, stream``) the wo product goes there instead of
    into ``out`` (the mesh's all-reduce, ``ops/tp_allreduce.py``)."""
    name = "fused_decode_tp_attn"
    lib, lay = _build.library(), op.lay
    B, D = h.shape
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    eps = float(cfg.rms_norm_eps)
    wqkv, wo = lay["wqkv"], lay["wo"]
    _norm_gemm(op, h, lay["ln1"], wqkv, l, eps, op.qkv, (H + 2 * Hkv) * Dh,
               EPI_STORE, name)
    qn = lay["q_norm"]["scale"][l].data_ptr() if cfg.qk_norm else None
    kn = lay["k_norm"]["scale"][l].data_ptr() if cfg.qk_norm else None
    _launch(lib.desta_tp_attention(
        op.qkv.data_ptr(), cache.k[l].data_ptr(), cache.v[l].data_ptr(),
        step.cos.data_ptr(), step.sin.data_ptr(), step.mask.data_ptr(),
        step.mask.shape[1], step.ci.data_ptr(), qn, kn, op.attn.data_ptr(),
        B, cache.k.shape[2], H, Hkv, Dh, eps, Dh ** -0.5, op.stream), name)
    _build.count_kernel("decode_attention")
    if store is not None:
        store(op.attn, wo["q"][l], wo["s"][l], name, op.stream)
        return
    _launch(lib.desta_tp_gemm(
        op.attn.data_ptr(), wo["q"][l].data_ptr(), wo["s"][l].data_ptr(),
        out.data_ptr(), B, D, H * Dh, int(accumulate), op.stream), name)
    _build.count_kernel("skinny_gemm", passes(B))


def _mlp_launches(op: _Operands, cfg, h, l: int, out: torch.Tensor,
                  accumulate: bool, store=None) -> None:
    """The MLP half's 3 launches on checked operands (``store``: as
    :func:`_attn_launches`'s, for the down product)."""
    name = "fused_decode_tp_mlp"
    lib, lay = _build.library(), op.lay
    B, D = h.shape
    I = cfg.intermediate_size
    wgu, wd = lay["w_gu"], lay["w_down"]
    _norm_gemm(op, h, lay["ln2"], wgu, l, float(cfg.rms_norm_eps), op.mid, I,
               EPI_SWIGLU, name)
    if store is not None:
        store(op.mid, wd["q"][l], wd["s"][l], name, op.stream)
        return
    _launch(lib.desta_tp_gemm(
        op.mid.data_ptr(), wd["q"][l].data_ptr(), wd["s"][l].data_ptr(),
        out.data_ptr(), B, D, I, int(accumulate), op.stream), name)
    _build.count_kernel("skinny_gemm", passes(B))


def attn_half(params, cfg, h: torch.Tensor, step: DecodeStep,
              cache: KVCache, layer: int) -> torch.Tensor:
    """:func:`attn_half_plain`'s function: the kernels on CUDA tensors, the
    plain version on CPU tensors."""
    if h.device.type == "cpu":
        return attn_half_plain(params, cfg, h, step, cache, layer)
    op = _operands(params, cfg, h, "fused_decode_tp_attn", step, cache)
    out = torch.empty_like(h)
    _attn_launches(op, cfg, h, step, cache, layer, out, False)
    return out


def mlp_half(params, cfg, h: torch.Tensor, layer: int) -> torch.Tensor:
    """:func:`mlp_half_plain`'s function: the kernels on CUDA tensors, the
    plain version on CPU tensors."""
    if h.device.type == "cpu":
        return mlp_half_plain(params, cfg, h, layer)
    op = _operands(params, cfg, h, "fused_decode_tp_mlp")
    out = torch.empty_like(h)
    _mlp_launches(op, cfg, h, layer, out, False)
    return out


# -- the p = 1 layer loop ----------------------------------------------------------

def fused_decode_layers_perlayer(params, cfg, inputs_embeds, attention_mask,
                                 positions, cache: KVCache, cache_index,
                                 extra_layer_fn=None,
                                 scratch: Optional[Scratch] = None):
    """One decode step through every layer as per-layer halves on one
    device, the f32 residual carried between them, with an optional
    ``extra_layer_fn(layer, hidden [B, 1, D] bf16) -> hidden`` after each
    layer.  Same contract as ``ops/fused_decode.fused_decode_layers``:
    inputs_embeds [B, 1, D]; attention_mask [B, >=S]; positions [B, 1];
    the cache written in place at ``cache_index`` (int or [B]) and returned;
    returns (hidden [B, 1, D] bf16 before the final norm, cache).  On the
    card the residual is one f32 buffer for the whole step (the hook's
    output copied into it) and ``scratch`` (:func:`step_scratch`, kept by
    a caller across steps) the launches' buffers; a CUDA graph captures
    the step whole (``generate/graph.PerLayerStep``) given a device
    ``cache_index``."""
    B, T, D = inputs_embeds.shape
    if T != 1:
        raise ValueError("fused_decode_layers_perlayer takes one token a row")
    if inputs_embeds.device.type == "cpu":
        return fused_decode_layers_perlayer_plain(
            params, cfg, inputs_embeds, attention_mask, positions, cache,
            cache_index, extra_layer_fn)
    step = decode_step_inputs(cfg, attention_mask, positions, cache_index, B)
    h = inputs_embeds.reshape(B, D).to(torch.bfloat16).float().contiguous()
    op = _operands(params, cfg, h, "fused_decode_layers_perlayer", step,
                   cache, scratch)
    for l in range(cache.k.shape[0]):
        _attn_launches(op, cfg, h, step, cache, l, h, True)
        _mlp_launches(op, cfg, h, l, h, True)
        if extra_layer_fn is not None:
            hb = extra_layer_fn(l, h.to(torch.bfloat16).reshape(B, 1, D))
            h.copy_(hb.reshape(B, D))
    return h.to(torch.bfloat16).reshape(B, 1, D), cache


def fused_decode_layers_perlayer_plain(params, cfg, inputs_embeds,
                                       attention_mask, positions,
                                       cache: KVCache, cache_index,
                                       extra_layer_fn=None):
    """:func:`fused_decode_layers_perlayer` through the plain halves, on
    any device (the CPU path, and the card's comparisons)."""
    B, _, D = inputs_embeds.shape
    step = decode_step_inputs(cfg, attention_mask, positions, cache_index, B)
    h = inputs_embeds.reshape(B, D).to(torch.bfloat16).float()
    for l in range(cache.k.shape[0]):
        h = h + attn_half_plain(params, cfg, h, step, cache, l)
        h = h + mlp_half_plain(params, cfg, h, l)
        if extra_layer_fn is not None:
            hb = extra_layer_fn(l, h.to(torch.bfloat16).reshape(B, 1, D))
            h = hb.reshape(B, D).float()
    return h.to(torch.bfloat16).reshape(B, 1, D), cache


# -- under a mesh ------------------------------------------------------------------

def tp_limits(params, cfg, cache) -> List[str]:
    """Why the per-layer pair cannot run a decode step of ``cache`` under
    the current mesh (empty: it can): the JAX predicate's conditions
    (``fused_decode_tp.py:557-594``: a "model" axis > 1 and no "data" axis
    > 1, H, Hkv and I splitting p ways, an int8 tower, a bf16 cache) and the
    kernels' limits at the shard's shape (:func:`perlayer_limits`)."""
    mesh = current_mesh()
    if mesh is None or mesh.n_model <= 1:
        return ["no mesh with a model axis > 1 is active"]
    if mesh.n_data > 1:
        return ["a data axis > 1 (the JAX package's validated path has none)"]
    try:
        lcfg = local_config(cfg, mesh.n_model)
    except ValueError as e:
        return [str(e)]
    kvd = lcfg.num_key_value_heads * lcfg.head_dim
    local = (cache.shards[0][0] if isinstance(cache, ShardedCache)
             else KVCache(cache.k[..., :kvd], cache.v[..., :kvd]))
    return perlayer_limits(params, lcfg, local, local.k.shape[1])


def fused_tp_supported(params, cfg, cache) -> bool:
    """Does a decode step take the per-layer pair under the current mesh?"""
    return not tp_limits(params, cfg, cache)


def fused_decode_layers_tp_plain(params: ShardedLLM, cfg, inputs_embeds,
                                 attention_mask, positions,
                                 cache: ShardedCache, cache_index):
    """:func:`fused_decode_layers_tp` in plain PyTorch: each rank's plain
    halves on its device, the f32 partials reduced in rank order into each
    rank's f32 residual."""
    B, _, D = inputs_embeds.shape
    lcfg, row = params.local_cfg, params.mesh.devices[0]
    ranks, caches = params.ranks[0], cache.shards[0]
    steps = [decode_step_inputs(lcfg, attention_mask.to(dev),
                                positions.to(dev),
                                torch.as_tensor(cache_index).to(dev), B)
             for dev in row]
    hs = [inputs_embeds.reshape(B, D).to(torch.bfloat16).float().to(dev)
          for dev in row]
    for l in range(caches[0].k.shape[0]):
        hs = allreduce_plain([attn_half_plain(rp, lcfg, h, st, c, l)
                              for rp, h, st, c in zip(ranks, hs, steps,
                                                      caches)], hs)
        hs = allreduce_plain([mlp_half_plain(rp, lcfg, h, l)
                              for rp, h in zip(ranks, hs)], hs)
    dev0 = inputs_embeds.device
    return hs[0].to(torch.bfloat16).reshape(B, 1, D).to(dev0), cache


def fused_decode_layers_tp(params: ShardedLLM, cfg, inputs_embeds,
                           attention_mask, positions, cache: ShardedCache,
                           cache_index):
    """One decode step as the per-layer pair on every rank of the current
    mesh's model group, the partials all-reduced into each rank's f32
    residual by ``csrc/tp_allreduce.cu`` (``fused_decode_tp.py:662-722``
    of the JAX package).  The contract of
    ``ops/fused_decode.fused_decode_layers`` with the LLM cut by
    ``parallel/sharding.apply_llm_sharding`` and its ShardedCache; ranks on
    their own streams, interleaved per half as the K10 driver
    (``ops/fused_decode_mesh.py``) runs them.  Returns (hidden [B, 1, D]
    bf16 on the first rank's device, cache)."""
    name = "fused_decode_layers_tp"
    if not isinstance(params, ShardedLLM) or not isinstance(cache,
                                                            ShardedCache):
        raise ValueError(f"{name}: takes the LLM cut by apply_llm_sharding "
                         "and its ShardedCache")
    if inputs_embeds.device.type == "cpu":
        return fused_decode_layers_tp_plain(params, cfg, inputs_embeds,
                                            attention_mask, positions, cache,
                                            cache_index)
    bad = tp_limits(params, cfg, cache)
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
    B, _, D = inputs_embeds.shape
    mesh, lcfg = params.mesh, params.local_cfg
    row = mesh.devices[0]
    callers = [torch.cuda.current_stream(dev) for dev in row]
    streams = mesh.streams()[0]
    bufs = group_buffers(mesh, 0, B, D)
    bufs.begin(2 * cache.shards[0][0].k.shape[0])
    for s, c in zip(streams, callers):
        s.wait_stream(c)
    ci = _row_indices(cache_index, B, inputs_embeds.device)
    hs, steps, ops = [], [], []
    for m, dev in enumerate(row):
        with on_device(dev), torch.cuda.stream(streams[m]):
            step = decode_step_inputs(lcfg, attention_mask.to(dev),
                                      positions.to(dev), ci.to(dev), B)
            h = inputs_embeds.reshape(B, D).to(dev).to(torch.bfloat16)
            h = h.float().contiguous()
            ops.append(_operands(params.ranks[0][m], lcfg, h, name, step,
                                 cache.shards[0][m]))
            hs.append(h)
            steps.append(step)
    caches = cache.shards[0]
    for l in range(caches[0].k.shape[0]):
        rnd = layer_round(l, ATTN_SLOT)
        for m, dev in enumerate(row):
            with on_device(dev):
                _attn_launches(ops[m], lcfg, hs[m], steps[m], caches[m], l,
                               None, False, functools.partial(
                                   bufs.store, m, ATTN_SLOT, rnd))
        for m, dev in enumerate(row):
            with on_device(dev):
                bufs.reduce(m, ATTN_SLOT, rnd, hs[m], ops[m].stream)
        rnd = layer_round(l, MLP_SLOT)
        for m, dev in enumerate(row):
            with on_device(dev):
                _mlp_launches(ops[m], lcfg, hs[m], l, None, False,
                              functools.partial(bufs.store, m, MLP_SLOT,
                                                rnd))
        for m, dev in enumerate(row):
            with on_device(dev):
                bufs.reduce(m, MLP_SLOT, rnd, hs[m], ops[m].stream)
    for s, c in zip(streams, callers):
        c.wait_stream(s)
    bufs.check_timeouts(name)
    hs[0].record_stream(callers[0])
    return hs[0].to(torch.bfloat16).reshape(B, 1, D), cache
