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
JAX package), and writes the next half's RMSNorm of it (ln2 of the layer;
after w_down, ln1 of the next layer unless an injection comes between):
7 launches a layer a rank, as K8's step.  The residual stays replicated bit for
bit on every rank (``ops/tp_allreduce.py``), so the ORCA injection (K8i,
``inject=``) runs after the w_down all-reduce on every rank from replicated
injection weights and audio K/V, as the JAX package does
(``fused_decode_mesh.py:19-23``).  The "data" axis runs one model group per
block of batch rows (``:209-229``).

Launch order: the ranks' kernels go layer by layer, interleaved: every
rank's half up to its producer GEMM, then every rank's all-reduce.  Each rank
launches on its own CUDA stream (``Mesh.streams``), so ranks on one card run
concurrently and ranks on several cards in parallel; the step functions'
``serial=True`` puts every rank on its card's current stream, where every
producer precedes every consumer and no all-reduce waits (``chip_smoke.py``
holds the two orders equal).  The epochs of the all-reduce's rounds live on
the device (``MeshBuffers.begin`` fills each rank's base word before a
step; a launch carries its round within the step).  :class:`MeshStep`
launches every step: its per-call work done once and no host sync in one, so
that ``generate/graph.py`` captures a ``generate()`` call's decode step as
one CUDA graph per card and reads the error words once, at the end of the
call; the step functions make one a call and read them at once (a spin that
timed out raises RuntimeError there).

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
from .tp_allreduce import (
    ATTN_SLOT,
    MLP_SLOT,
    allreduce_plain,
    group_buffers,
    layer_round,
)

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


def _inject_args(inject):
    """(inject_params, ta, heads) of a fused injection spec, or of None."""
    if inject is None:
        return None, 0, 0
    return inject["params"], int(inject["ta_real"]), int(inject["heads"])


def fused_mesh_takes(params, cfg, cache, inject=None) -> bool:
    """Does the tensor-parallel decode step take this cache with the fused
    injection spec ``inject`` (or none)?  The dispatch of
    ``models/llm.py`` and of ``generate/decode.py``."""
    return fused_mesh_supported(params, cfg, cache, 1, *_inject_args(inject))


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


def _streams(mesh, g: int, serial: bool):
    """(callers, streams) of data row g's ranks: each device's current
    stream, and the rank's own stream (``Mesh.streams``) or, with
    ``serial``, the caller's."""
    row = mesh.devices[g]
    callers = [torch.cuda.current_stream(dev) for dev in row]
    return callers, (callers if serial else mesh.streams()[g])


def _fork(streams, callers) -> None:
    for s, c in zip(streams, callers):
        if s is not c:
            s.wait_stream(c)     # the inputs and the cache are the caller's


def _join(streams, callers) -> None:
    for s, c in zip(streams, callers):
        if s is not c:
            c.wait_stream(s)


def _launch_layers(steps, bufs, row, inject: bool, ranks) -> None:
    """Every layer of one step on a model group's ranks (``steps[m]``, the
    FusedStep of rank m on ``row[m]``), half by half: every rank's half up
    to its producer GEMM, then every rank's consumer (so that ranks on one
    stream never wait on a later launch), which adds the ranks' sum into
    the residual and writes the next half's norm into the rank's ``xn``:
    ln2 of the layer after the attention, ln1 of the next layer after the
    MLP, none after the last layer, nor before an injection, whose kernels
    change the residual (the next attention then launches its own norm).
    The round of each half is :func:`layer_round`, its epoch the step's
    base (``MeshBuffers.begin``, the caller's) plus that round.  ``ranks``:
    the ranks to launch (all, or one card's for that card's graph)."""
    L, eps = steps[0].L, float(steps[0].cfg.rms_norm_eps)
    for l in range(L):
        for slot, half in ((ATTN_SLOT, "attention"), (MLP_SLOT, "mlp")):
            rnd = layer_round(l, slot)
            normed = slot == MLP_SLOT or (l > 0 and not inject)
            for m in ranks:                           # every producer ...
                with on_device(row[m]):
                    getattr(steps[m], half)(l, functools.partial(
                        bufs.store, m, slot, rnd), normed=normed)
            nxt = ((1, l) if slot == ATTN_SLOT
                   else (0, l + 1) if l + 1 < L and not inject else None)
            for m in ranks:                           # ... before any consumer
                st = steps[m]
                with on_device(row[m]):
                    if nxt is None:
                        bufs.reduce(m, slot, rnd, st.h, st.stream)
                    else:
                        bufs.reduce(m, slot, rnd, st.h, st.stream,
                                    st.norms[nxt[0]][nxt[1]], st.xn, eps)
        if inject:
            for m in ranks:
                with on_device(row[m]):
                    steps[m].inject(l)


def _card(device) -> torch.device:
    """A device with its index (a bare "cuda" is card 0, as
    ``Mesh.enable_peer_access`` reads it)."""
    device = torch.device(device)
    return torch.device(device.type, device.index or 0)




def _inputs(b: int, kd: int, D: int, dev, mask):
    """A card's static step inputs for b batch rows."""
    return {"x": torch.zeros(b, kd, D, dtype=torch.bfloat16, device=dev),
            "pos": torch.zeros(b, kd, dtype=torch.long, device=dev),
            "ci": torch.zeros(b, dtype=torch.int32, device=dev),
            "mask": mask}


class MeshStep:
    """K10's decode (``kd`` = 1) or verify (``kd`` > 1) step under the
    current mesh, its per-call work done once: per data row of the mesh and
    card, static inputs (the rows' embeddings, RoPE positions, cache
    indices and, off the call's own card or with a "data" axis, a copy of
    the call's mask), every rank's FusedStep (operands, scratch, the
    injection rows copied to its card) and the group's all-reduce buffers.
    A step is :meth:`fill` (on each card's current stream: the inputs and
    every group's epoch base, ``MeshBuffers.begin``), then :meth:`run`,
    which reads only those static device buffers, so that one CUDA graph
    per card can capture it (``generate/graph.py``): per rank the layers
    (:func:`_launch_layers`, each rank on its own stream), and per data row
    ``head`` on its first rank.  No host sync: :meth:`check` reads the
    error words.  ``generate()`` keeps one MeshStep for all its decode
    steps and checks it once, at the end of the call;
    :func:`fused_decode_layers_mesh` and :func:`fused_verify_layers_mesh`
    make one a call and check it at once.  On the CPU :meth:`run` is the
    plain step (:func:`fused_decode_layers_mesh_plain`) on the filled
    tensors."""

    def __init__(self, params: ShardedLLM, cfg, mask: torch.Tensor,
                 cache: ShardedCache, inject=None, kd: int = 1):
        self.name = ("fused_decode_layers_mesh" if kd == 1
                     else "fused_verify_layers_mesh")
        _check_operands(params, cache, self.name)
        mesh = self.mesh = params.mesh
        self.params, self.cfg, self.cache = params, cfg, cache
        self.mask, self.inject = mask, inject
        B, D = mask.shape[0], cfg.hidden_size
        self.dev0 = mask.device
        self.cpu = self.dev0.type == "cpu"
        self.cards = list(dict.fromkeys(_card(d) for d in [self.dev0] + [
            d for row in mesh.devices for d in row]))
        self.groups, self.ins = [], None
        if self.cpu:
            return
        bad = fused_mesh_limits(params, cfg, B, _cache_shape(cache)[2], kd,
                                *_inject_args(inject))
        if bad:
            raise ValueError(f"{self.name}: " + "; ".join(bad))
        for g, row in enumerate(mesh.devices):
            rows = data_rows(mesh, B, g)
            b = rows.stop - rows.start
            # a block's own copies: the kernels take 16-byte aligned
            # operands, which a slice past row 0 need not be
            ins = {dev: _inputs(b, kd, D, dev, mask[rows].to(
                       dev, torch.int32, copy=True)
                       if mesh.n_data > 1 or dev != self.dev0 else mask)
                   for dev in dict.fromkeys(row)}
            steps = []
            for m, dev in enumerate(row):
                inp = ins[dev]
                with on_device(dev):
                    steps.append(FusedStep(
                        params.ranks[g][m], params.local_cfg, inp["x"],
                        inp["mask"], inp["pos"], cache.shards[g][m],
                        inp["ci"], self.name, _inject_rows(inject, rows,
                                                           dev)))
            self.groups.append((g, rows, ins, steps,
                                group_buffers(mesh, g, b * kd, D)))
        self.outs = [None] * len(self.groups)

    def fill(self, x: torch.Tensor, pos: torch.Tensor, ci) -> None:
        """The step's inputs: embeddings ``x`` [B, Kd, D] bf16 and RoPE
        positions ``pos`` [B, Kd] on the caller's device, and every row's
        cache write position ``ci``, a [B] tensor or an int (which the
        caller's mask already attends; fill marks it on the mask's copies);
        then every group's epoch base.  With a [B] tensor (a server's rows,
        each at its own position, its mask and ``on`` flags changed in
        place between steps) the mask's and the flags' copies are taken
        anew from the caller's."""
        if self.cpu:
            self.ins = (x, pos, ci)
            return
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{self.name}: x is {x.dtype}, the kernels take "
                             "bfloat16")
        rows_ci = torch.is_tensor(ci)
        if rows_ci:
            ci = _row_indices(ci, x.shape[0], ci.device)
        for g, rows, ins, steps, bufs in self.groups:
            for inp in ins.values():
                inp["x"].copy_(x[rows])
                inp["pos"].copy_(pos[rows])
                if rows_ci:
                    inp["ci"].copy_(ci[rows])
                    if inp["mask"] is not self.mask:
                        inp["mask"].copy_(self.mask[rows])
                else:
                    inp["ci"].fill_(int(ci))
                    if inp["mask"] is not self.mask:
                        inp["mask"][:, int(ci)] = 1
            if rows_ci and self.inject is not None:
                on = torch.as_tensor(self.inject["on"])
                for st in steps:
                    st.inj["on"].copy_(on[rows])
            bufs.begin(2 * steps[0].L)

    def sync_inject(self) -> None:
        """Take the caller's audio K/V (``inject["k"]`` / ``["v"]``, written
        in place since this step was built) into the copies the ranks read
        where they are copies (another card, or a block of rows)."""
        if self.cpu or self.inject is None:
            return
        for g, rows, ins, steps, bufs in self.groups:
            for st in steps:
                for key in ("k", "v"):
                    src = self.inject[key][:, rows]
                    if st.inj[key].data_ptr() != src.data_ptr():
                        st.inj[key].copy_(src)

    def error_words(self) -> List[torch.Tensor]:
        """Every rank's all-reduce error word (nonzero after a timed-out
        round; :meth:`check` reads and clears them)."""
        return [e for *_, bufs in self.groups for e in bufs.err]

    def run(self, head=None, only=None, serial: bool = False
            ) -> List[torch.Tensor]:
        """Launch one step (with ``only``, the ranks on that card alone: its
        card's graph); per data row, ``head(tree, hidden)`` of its first
        rank's tree and hidden [b, Kd, D] on that rank's device (with no
        ``head``, the hidden itself), kept in the list this returns, where a
        run of another card's ranks finds it.  ``serial`` puts every rank
        on its card's current stream: the reference launch order of
        ``fused_decode_layers_mesh(serial=True)``."""
        head = head or (lambda tree, h: h)
        if self.cpu:
            x, pos, ci = self.ins
            h, _ = fused_decode_layers_mesh_plain(
                self.params, self.cfg, x, self.mask, pos, self.cache, ci,
                self.inject)
            return [head(self.params, h)]
        for g, rows, ins, steps, bufs in self.groups:
            row = self.mesh.devices[g]
            ranks = [m for m, dev in enumerate(row)
                     if only is None or _card(dev) == _card(only)]
            if not ranks:
                continue
            callers, streams = _streams(self.mesh, g, serial)
            callers, streams = ([c[m] for m in ranks]
                                for c in (callers, streams))
            _fork(streams, callers)
            for m, s in zip(ranks, streams):
                dev, st, inp = row[m], steps[m], ins[row[m]]
                with on_device(dev), torch.cuda.stream(s):
                    st.stream = _build.stream_ptr(dev)   # this run's stream
                    st.load(inp["x"], inp["pos"])
            _launch_layers(steps, bufs, row, self.inject is not None, ranks)
            _join(streams, callers)
            if ranks[0] == 0:
                st = steps[0]
                with on_device(row[0]):
                    self.outs[g] = head(self.params.ranks[g][0],
                                        st.h.reshape(st.B, st.Kd, st.D))
        return self.outs

    def hidden_ranks(self) -> List[List[torch.Tensor]]:
        """Every rank's hidden after :meth:`run`, ``[data row][rank]`` ->
        [b, Kd, D] on the rank's device."""
        return [[st.h.reshape(st.B, st.Kd, st.D) for st in steps]
                for *_, steps, _ in self.groups]

    def check(self) -> None:
        """Raise RuntimeError if an all-reduce of the steps run so far timed
        out (one host sync; clears the error words)."""
        for *_, bufs in self.groups:
            bufs.check_timeouts(self.name)


def _one_step(params, cfg, x, mask, positions, cache, ci, inject, serial):
    """One step through a MeshStep of its own: fill, run, check.  Returns
    (the step, its per-data-row hidden)."""
    step = MeshStep(params, cfg, mask, cache, inject, x.shape[1])
    step.fill(x, positions, ci)
    outs = step.run(serial=serial)
    step.check()
    return step, outs


def fused_decode_layers_mesh(params: ShardedLLM, cfg, inputs_embeds,
                             attention_mask, positions, cache: ShardedCache,
                             cache_index, inject=None, serial=False):
    """One decode step through all layers under the current mesh; the
    contract of ``ops/fused_decode.fused_decode_layers`` with the LLM cut
    by ``parallel/sharding.apply_llm_sharding`` and its ShardedCache
    (written in place).  Returns (hidden [B, 1, D] on inputs_embeds'
    device, cache).  serial: every rank on one stream (module docstring)."""
    if inputs_embeds.shape[1] != 1:
        raise ValueError("fused_decode_layers_mesh takes one token per row")
    _, outs = _one_step(params, cfg, inputs_embeds, attention_mask,
                        positions, cache, cache_index, inject, serial)
    return torch.cat([h.to(inputs_embeds.device) for h in outs]), cache


def fused_verify_layers_mesh(params: ShardedLLM, cfg, inputs_embeds,
                             attention_mask, positions, cache: ShardedCache,
                             cache_index, inject=None, serial=False):
    """The speculative-verify step (Kd = 2..8 tokens per row) under the
    current mesh; the contract of ``ops/fused_decode.fused_verify_layers``
    as :func:`fused_decode_layers_mesh` takes K8's."""
    if inputs_embeds.shape[1] < 2:
        raise ValueError("fused_verify_layers_mesh takes 2 or more tokens "
                         "per row")
    _, outs = _one_step(params, cfg, inputs_embeds, attention_mask,
                        positions, cache, cache_index, inject, serial)
    return torch.cat([h.to(inputs_embeds.device) for h in outs]), cache


def mesh_step_ranks(params: ShardedLLM, cfg, inputs_embeds, attention_mask,
                    positions, cache: ShardedCache, cache_index, inject=None):
    """Every rank's hidden after one decode (Kd = 1) or verify step through
    the kernels, ``[data row][rank]`` -> [b, Kd, D] on the rank's device:
    the residuals the all-reduce keeps replicated (``chip_smoke.py`` holds
    them equal bit for bit)."""
    if inputs_embeds.device.type == "cpu":
        raise ValueError("mesh_step_ranks: the ranks' residuals are the "
                         "kernels'")
    step, _ = _one_step(params, cfg, inputs_embeds, attention_mask,
                        positions, cache, cache_index, inject, False)
    return step.hidden_ranks()
