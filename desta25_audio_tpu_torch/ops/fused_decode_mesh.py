"""Tensor-parallel decode and verify steps: the fused step of
``ops/fused_decode.py`` run once per "model" rank of a mesh, the wo and
w_down partial sums all-reduced between ranks by a kernel (port of
``desta25_audio_tpu/ops/fused_decode_mesh.py``, K10).

Each rank holds H/p heads, Hkv/p kv heads and I/p of the MLP
(``parallel/sharding.py``) and its slice of the packed cache.  Per layer,
every rank runs the kernels of K8 (K8v at Kd > 1) on its shard; its wo
product, instead of adding into the residual, is stored as an f32 partial
sum into every rank's receive buffer, and the all-reduce of
``csrc/tp_allreduce.cu`` then adds the ranks' sum into each rank's bf16
residual, ``h = bf16(h + bf16(sum))`` (``fused_decode.py:660-729`` of the
JAX package); the same for w_down.  The residual stays replicated bit for
bit on every rank (``ops/tp_allreduce.py``), so the ORCA injection (K8i,
``inject=``) runs after the w_down all-reduce on every rank from replicated
injection weights and audio K/V, as the JAX package does
(``fused_decode_mesh.py:19-23``).  The "data" axis runs one model group per
block of batch rows (``:209-229``).

Launch order: the ranks' kernels go layer by layer, interleaved: every
rank's half up to its producer GEMM, then every rank's all-reduce.  Each rank
launches on its own CUDA stream (``Mesh.streams``), so ranks on one card run
concurrently and ranks on several cards in parallel; ``serial=True`` puts
every rank on its card's current stream, where every producer precedes
every consumer and no all-reduce waits (``chip_smoke.py`` holds the two
orders equal).  A spin that times out raises RuntimeError after
the step.

Counts: the step's launches as ``fused_decode_layers_mesh`` (Kd = 1) or
``fused_verify_layers_mesh`` (Kd > 1), the all-reduce as ``tp_allreduce``,
the injection's as ``fused_decode_inject``.  On CPU tensors
:func:`fused_decode_layers_mesh_plain` runs: per rank the plain attention
and MLP of K8 on its shard (f32 partials), reduced by
``ops/tp_allreduce.allreduce_plain``, at the kernels' rounding points.
"""

from __future__ import annotations

import functools
from typing import List

import torch

from ..parallel.mesh import current_mesh, on_device
from ..parallel.sharding import (
    ShardedCache,
    ShardedLLM,
    data_rows,
    local_config,
    to_device,
)
from . import _build
from .fused_decode import (
    FusedStep,
    _inject_plain,
    _row_indices,
    attention_plain,
    fused_inject_limits,
    fused_verify_layers,
    kernel_limits,
    mlp_plain,
    plain_step,
    rms_plain,
    tower_is_int8,
)
from .quant import LLM_QUANT_KEYS
from .rope import llm_rope_cos_sin
from .tp_allreduce import ATTN_SLOT, MLP_SLOT, allreduce_plain, group_buffers

def _cache_shape(cache):
    """The unsharded [L, B, S, Hkv*Dh] of a KVCache or a ShardedCache."""
    return tuple(cache.shape if isinstance(cache, ShardedCache)
                 else cache.k.shape)


def fused_mesh_limits(params, cfg, batch: int, cache_len: int, kd: int = 1,
                      inject_params=None, ta: int = 0, heads: int = 0,
                      cache_dtype=torch.bfloat16) -> List[str]:
    """Why the tensor-parallel step cannot run under the current mesh
    (empty: it can): the JAX predicate's semantic conditions
    (``fused_decode_mesh.py:81-138``: a mesh with a "model" axis > 1, H, Hkv
    and I splitting p ways, B splitting over "data", an int8 or bf16 tower
    and a bf16 cache, injection only with the int8 tower) and the port's
    kernel limits at the shard's shape (``kernel_limits``,
    ``fused_inject_limits``).  The TPU's VMEM budgets are left out."""
    mesh = current_mesh()
    if mesh is None or mesh.n_model <= 1:
        return ["no mesh with a model axis > 1 is active"]
    p = mesh.n_model
    bad = []
    lay = params["layers"]
    int8 = tower_is_int8(params)
    if not int8 and any(lay[k].dtype != torch.bfloat16
                        for k in LLM_QUANT_KEYS):
        bad.append("the tower is neither int8 nor bf16")
    if cache_dtype != torch.bfloat16:
        bad.append(f"cache dtype {cache_dtype} (the kernels take bfloat16)")
    if inject_params is not None and not int8:
        bad.append("in-kernel injection needs the int8 tower")
    H, Hkv, I = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.intermediate_size)
    if H % p or Hkv % p or I % p:
        return bad + [f"H={H}, Hkv={Hkv}, I={I} do not split {p} ways"]
    if batch % mesh.n_data:
        return bad + [f"batch {batch} does not split over {mesh.n_data} data "
                      "rows"]
    lcfg = local_config(cfg, p)
    bad += kernel_limits(lcfg, batch // mesh.n_data, kd, cache_len, int8,
                         _build.sm_count(mesh.devices[0][0]))
    if inject_params is not None:
        bad += fused_inject_limits(inject_params, cfg, heads or H, ta, kd)
    return bad


def fused_mesh_supported(params, cfg, cache, kd: int = 1, inject_params=None,
                         ta: int = 0, heads: int = 0) -> bool:
    """Does a decode (kd = 1) or verify step of this cache take the
    tensor-parallel kernels under the current mesh?  ``cache``: the
    ShardedCache (or an unsharded KVCache of the same shape)."""
    _, B, S, _ = _cache_shape(cache)
    dtype = cache.dtype if isinstance(cache, ShardedCache) else cache.k.dtype
    return not fused_mesh_limits(params, cfg, B, S, kd, inject_params, ta,
                                 heads, dtype)


def pick_verify_fn(params, cfg, cache, kd: int, inject_params=None,
                   ta: int = 0, heads: int = 0):
    """The speculative loop's verify step (``fused_decode_mesh.py:251-264``
    of the JAX package): ``fused_verify_layers`` off-mesh, the
    tensor-parallel step on a "model" mesh when it can take the request,
    else None."""
    if current_mesh() is None:
        return fused_verify_layers
    if fused_mesh_supported(params, cfg, cache, kd, inject_params, ta, heads):
        return fused_verify_layers_mesh
    return None


def _inject_rows(inject, rows: slice, device):
    """The injection spec of a block of batch rows on ``device``: the stack
    replicated, the audio K/V and the per-row flags of those rows."""
    if inject is None:
        return None
    return {**inject, "params": to_device(inject["params"], device),
            "k": inject["k"][:, rows].to(device).contiguous(),
            "v": inject["v"][:, rows].to(device).contiguous(),
            "on": torch.as_tensor(inject["on"])[rows].to(device, copy=True)}


def _check_operands(params, cache, name: str) -> None:
    mesh = current_mesh()
    if not isinstance(params, ShardedLLM) or not isinstance(cache,
                                                            ShardedCache):
        raise ValueError(f"{name}: takes the LLM cut by apply_llm_sharding "
                         "and its ShardedCache")
    if mesh is not params.mesh:
        raise ValueError(f"{name}: the params were cut for {params.mesh}, "
                         f"the current mesh is {mesh}")


def fused_decode_layers_mesh_plain(params: ShardedLLM, cfg, inputs_embeds,
                                   attention_mask, positions,
                                   cache: ShardedCache, cache_index,
                                   inject=None):
    """The tensor-parallel step in plain PyTorch, each rank on its device
    with its own residual (module docstring).  Returns the first rank's
    hidden rows of every data row, on the first rank's device."""
    mesh, lcfg = params.mesh, params.local_cfg
    B, Kd, D = inputs_embeds.shape
    dev0 = inputs_embeds.device
    ci = _row_indices(cache_index, B, dev0)
    eps = cfg.rms_norm_eps
    L, _, S, _ = _cache_shape(cache)
    outs = []
    for g, row in enumerate(mesh.devices):
        rows = data_rows(mesh, B, g)
        Bl = rows.stop - rows.start
        lays = [params.ranks[g][m]["layers"] for m in range(len(row))]
        caches = cache.shards[g]
        sts, hs, injs = [], [], []
        for dev in row:
            cos, sin = llm_rope_cos_sin(
                lcfg, positions[rows].reshape(Bl * Kd).to(dev))
            sts.append(plain_step(cos, sin, attention_mask[rows].to(dev),
                                  ci[rows].to(dev), Bl, Kd, S))
            hs.append(inputs_embeds[rows].reshape(Bl * Kd, D).to(dev))
            injs.append(_inject_rows(inject, rows, dev))
        for l in range(L):
            hs = allreduce_plain([attention_plain(
                lay, lcfg, st, c, l, rms_plain(h, lay["ln1"]["scale"][l], eps,
                                               h.dtype))
                for lay, st, c, h in zip(lays, sts, caches, hs)], hs)
            hs = allreduce_plain([mlp_plain(
                lay, l, rms_plain(h, lay["ln2"]["scale"][l], eps, h.dtype))
                for lay, h in zip(lays, hs)], hs)
            if inject is not None:
                hs = [_inject_plain(h, inj, l, Bl, Kd)
                      for h, inj in zip(hs, injs)]
        outs.append(hs[0].reshape(Bl, Kd, D).to(dev0))
    return torch.cat(outs), cache


def _launch_group(params: ShardedLLM, g: int, x, mask, positions, ci, cache,
                  name: str, inject, serial: bool):
    """Launch the kernels of data row g's model group, without waiting on
    them; returns (steps, streams, callers, buffers) for
    :func:`_finish_groups`."""
    mesh, lcfg = params.mesh, params.local_cfg
    row = mesh.devices[g]
    callers = [torch.cuda.current_stream(dev) for dev in row]
    streams = callers if serial else mesh.streams()[g]
    for s, c in zip(streams, callers):
        if s is not c:
            s.wait_stream(c)     # the inputs and the cache are the caller's
    steps = []
    for m, dev in enumerate(row):
        with on_device(dev), torch.cuda.stream(streams[m]):
            steps.append(FusedStep(
                params.ranks[g][m], lcfg, x.to(dev), mask.to(dev),
                positions.to(dev), cache.shards[g][m], ci.to(dev), name,
                _inject_rows(inject, slice(None), dev)))
    bufs = group_buffers(mesh, g, steps[0].R, steps[0].D)

    def round_(half: str, l: int, slot: int) -> None:
        epoch = bufs.next_round()
        for m, st in enumerate(steps):        # every producer ...
            with on_device(row[m]):
                getattr(st, half)(l, functools.partial(bufs.store, m, slot,
                                                       epoch))
        for m, st in enumerate(steps):        # ... before any consumer
            with on_device(row[m]):
                bufs.reduce(m, slot, epoch, st.h, st.stream)

    for l in range(steps[0].L):
        round_("attention", l, ATTN_SLOT)
        round_("mlp", l, MLP_SLOT)
        if inject is not None:
            for m, st in enumerate(steps):
                with on_device(row[m]):
                    st.inject(l)
    return steps, streams, callers, bufs


def _finish_groups(launched, name: str):
    """Join every group's streams to their callers, then read the error
    words once (one host sync a step, after every group is launched, so
    the groups of a "data" axis run side by side); returns every rank's
    hidden [b, Kd, D], ``[group][rank]``."""
    for steps, streams, callers, _ in launched:
        for st, s, c in zip(steps, streams, callers):
            if s is not c:
                c.wait_stream(s)
                st.h.record_stream(c)
    for *_, bufs in launched:
        bufs.check_timeouts(name)
    return [[st.h.reshape(st.B, st.Kd, st.D) for st in steps]
            for steps, *_ in launched]


def _mesh_step(params, cfg, inputs_embeds, attention_mask, positions, cache,
               cache_index, name: str, inject, serial, all_ranks=False):
    _check_operands(params, cache, name)
    if inputs_embeds.device.type == "cpu":
        return fused_decode_layers_mesh_plain(
            params, cfg, inputs_embeds, attention_mask, positions, cache,
            cache_index, inject)
    mesh = params.mesh
    bad = fused_mesh_limits(params, cfg, inputs_embeds.shape[0],
                            _cache_shape(cache)[2], inputs_embeds.shape[1],
                            None if inject is None else inject["params"],
                            0 if inject is None else int(inject["ta_real"]),
                            0 if inject is None else int(inject["heads"]))
    if bad:
        raise ValueError(f"{name}: " + "; ".join(bad))
    B = inputs_embeds.shape[0]
    dev0 = inputs_embeds.device
    ci = _row_indices(cache_index, B, dev0)
    launched = []
    for g in range(mesh.n_data):
        rows = data_rows(mesh, B, g)
        # a block's own copy: the kernels take 16-byte aligned operands,
        # which a slice past row 0 need not be
        own = ((lambda t: t) if mesh.n_data == 1
               else (lambda t: t[rows].clone()))
        launched.append(_launch_group(
            params, g, own(inputs_embeds), own(attention_mask),
            own(positions), own(ci), cache, name,
            _inject_rows(inject, rows, mesh.devices[g][0]), serial))
    outs = _finish_groups(launched, name)
    if all_ranks:
        return outs
    return torch.cat([hs[0].to(dev0) for hs in outs]), cache


def fused_decode_layers_mesh(params: ShardedLLM, cfg, inputs_embeds,
                             attention_mask, positions, cache: ShardedCache,
                             cache_index, inject=None, serial=False):
    """One decode step through all layers under the current mesh; the
    contract of ``ops/fused_decode.fused_decode_layers`` with the LLM cut
    by ``parallel/sharding.apply_llm_sharding`` and its ShardedCache
    (written in place).  Returns (hidden [B, 1, D] on the first rank's
    device, cache).  serial: every rank on one stream (module docstring)."""
    if inputs_embeds.shape[1] != 1:
        raise ValueError("fused_decode_layers_mesh takes one token per row")
    return _mesh_step(params, cfg, inputs_embeds, attention_mask, positions,
                      cache, cache_index, "fused_decode_layers_mesh", inject,
                      serial)


def fused_verify_layers_mesh(params: ShardedLLM, cfg, inputs_embeds,
                             attention_mask, positions, cache: ShardedCache,
                             cache_index, inject=None, serial=False):
    """The speculative-verify step (Kd = 2..8 tokens per row) under the
    current mesh; the contract of ``ops/fused_decode.fused_verify_layers``
    as :func:`fused_decode_layers_mesh` takes K8's."""
    if inputs_embeds.shape[1] < 2:
        raise ValueError("fused_verify_layers_mesh takes 2 or more tokens "
                         "per row")
    return _mesh_step(params, cfg, inputs_embeds, attention_mask, positions,
                      cache, cache_index, "fused_verify_layers_mesh", inject,
                      serial)


def mesh_step_ranks(params: ShardedLLM, cfg, inputs_embeds, attention_mask,
                    positions, cache: ShardedCache, cache_index, inject=None,
                    serial=False):
    """Every rank's hidden after one decode (Kd = 1) or verify step through
    the kernels, ``[data row][rank]`` -> [b, Kd, D] on the rank's device:
    the residuals the all-reduce keeps replicated (``chip_smoke.py`` holds
    them equal bit for bit)."""
    name = ("fused_decode_layers_mesh" if inputs_embeds.shape[1] == 1
            else "fused_verify_layers_mesh")
    if inputs_embeds.device.type == "cpu":
        raise ValueError(f"{name}: the ranks' residuals are the kernels'")
    return _mesh_step(params, cfg, inputs_embeds, attention_mask, positions,
                      cache, cache_index, name, inject, serial,
                      all_ranks=True)
