"""The LLM cut for a device mesh (counterpart of
``desta25_audio_tpu/parallel/sharding.py:69-97``, ``:146-157``, ``:202-212``
and, for the cache, ``models/llm.py:47-59``).

Tensor parallelism over the mesh's "model" axis (p ranks) follows the JAX
package's ``_LLM_RULES`` on the port's layouts (``models/llm.py``, linear
weights ``[out, in]``):

- ``wqkv``: the output rows of the rank's H/p query heads, then of its Hkv/p
  key heads, then of its Hkv/p value heads (the fused q/k/v weight, cut as
  the JAX package cuts wq, wk and wv on their output dim);
- ``w_gu``: the interleaved gate/up rows of the rank's I/p slice of the MLP;
- ``wo`` and ``w_down``: the input columns of the rank's heads and of its I/p
  slice, made contiguous; their int8 scales stay whole (they scale output
  columns, which every rank's partial sum shares);
- the norms whole.

int8 leaves ``{"q", "s"}`` cut their rows with their scales; bf16 tensors
the same way.  Each rank's KV cache is its slice of the packed Hkv*Dh axis
(:func:`shard_cache`), so the k/v rows land on the rank that projects them.

One departure from the JAX rules: ``embed``, ``lm_head`` and ``norm`` stay
**replicated** (the JAX package splits embed and lm_head over the vocab).
Each logit is a full-D dot product, so a vocab split changes no number, and
the int8 head's rows are padded to a multiple of 2560 for K7's row tiling:
130560 / 2 is no such multiple, so a split would break that tiling.  The
decode steps end with a residual replicated on every rank, and the head runs
once, on the first rank's device.

The "data" axis splits the batch rows: data row d of the mesh holds rows
``d*B/n_data .. (d+1)*B/n_data`` in its model group's cache slices, and each
of its ranks holds the same layer shard as the ranks of the other rows.

On a mesh with a "pipe" axis (``parallel/mesh.make_mesh(n_pipe=P)``) the
layer stack is cut into P stages first, as the JAX package's
``pipe_layer_specs`` (``parallel/pipeline.py:56``) prefixes each stacked
leaf's layer axis with "pipe": stage s holds layers ``s*L/P ..
(s+1)*L/P - 1`` (:class:`PipeStage`), and within the stage they are cut over
"model" as above.  A stage on the device the layers already lie on holds
views of the stacked leaves, not copies.  ``L % P != 0`` raises ValueError.

Training (``train/step.py``) adds the trainable state's layout
(``sharding.py:167-200`` of the JAX package): with ``fsdp`` each large
trainable leaf is cut over the data rows (:func:`fsdp_partition_specs`,
:class:`Shards`), and every other leaf lives whole on the first data row's
device (its owner).  Across processes each process holds a replica of that
layout over its own data rows (hybrid sharding), where the JAX package cuts
over every host's devices: the layout differs, the numbers do not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.fused_decode import KVCache
from ..ops.quant import is_quantized
from .mesh import Mesh, current_mesh


def local_config(cfg, p: int):
    """The config of one of p model ranks: H/p heads, Hkv/p kv heads,
    I/p of the MLP.  Raises ValueError when they do not split p ways."""
    H, Hkv, I = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.intermediate_size)
    if H % p or Hkv % p or I % p:
        raise ValueError(f"H={H}, Hkv={Hkv}, I={I} do not split {p} ways")
    return dataclasses.replace(cfg, num_attention_heads=H // p,
                               num_key_value_heads=Hkv // p,
                               intermediate_size=I // p)


def qkv_rows(cfg, p: int, rank: int) -> torch.Tensor:
    """The rows of ``wqkv`` (q | k | v) that rank ``rank`` of p holds: its
    H/p query heads, then its Hkv/p key and value heads."""
    sc = local_config(cfg, p)
    Dh = cfg.head_dim
    HD, KVD = cfg.num_attention_heads * Dh, cfg.num_key_value_heads * Dh
    hd, kvd = sc.num_attention_heads * Dh, sc.num_key_value_heads * Dh
    return torch.cat([torch.arange(rank * hd, (rank + 1) * hd),
                      HD + torch.arange(rank * kvd, (rank + 1) * kvd),
                      HD + KVD + torch.arange(rank * kvd, (rank + 1) * kvd)])


def shard_layers(params, cfg, p: int, rank: int):
    """Rank ``rank`` of p's shard of the layer stack, int8 or bf16 -> (params
    with the shard's ``layers``, the shard's config) (module docstring)."""
    sc = local_config(cfg, p)
    if not 0 <= rank < p:
        raise ValueError(f"rank {rank} of {p}")
    hd, il = sc.num_attention_heads * cfg.head_dim, sc.intermediate_size
    lay = params["layers"]
    rows = qkv_rows(cfg, p, rank)

    def out_rows(leaf, idx):
        if is_quantized(leaf):
            idx = idx.to(leaf["q"].device)
            return {"q": leaf["q"][:, idx].contiguous(),
                    "s": leaf["s"][:, idx].contiguous()}
        return leaf[:, idx.to(leaf.device)].contiguous()

    def in_cols(leaf, lo, hi):
        if is_quantized(leaf):
            return {"q": leaf["q"][:, :, lo:hi].contiguous(), "s": leaf["s"]}
        return leaf[:, :, lo:hi].contiguous()

    layers = dict(lay)
    layers["wqkv"] = out_rows(lay["wqkv"], rows)
    layers["wo"] = in_cols(lay["wo"], rank * hd, (rank + 1) * hd)
    layers["w_gu"] = out_rows(lay["w_gu"],
                              torch.arange(2 * rank * il, 2 * (rank + 1) * il))
    layers["w_down"] = in_cols(lay["w_down"], rank * il, (rank + 1) * il)
    return {**params, "layers": layers}, sc


def shard_cache(cache: KVCache, cfg, p: int, rank: int) -> KVCache:
    """Rank ``rank``'s slice of a packed cache [L, B, S, Hkv*Dh] (a copy)."""
    kvd = cfg.num_key_value_heads // p * cfg.head_dim
    sl = slice(rank * kvd, (rank + 1) * kvd)
    return KVCache(cache.k[..., sl].contiguous(), cache.v[..., sl].contiguous())


def to_device(tree, device):
    """A param tree on ``device`` (leaves already there are shared)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ShardedLLM(dict):
    """The LLM cut for ``mesh``.  ``ranks[d][m]`` is each rank's tree (its
    layer shard and the replicated leaves, on its device), ``cfg`` the full
    config and ``local_cfg`` a rank's.  As a dict it is the first rank's
    tree, so embedding, the head and the checks of the tower's kind read it
    as they read an unsharded tree.  On a pipe mesh ``stages[d][s]`` is data
    row d's stage s (:class:`PipeStage`), and ``ranks`` and the dict's
    ``layers`` are stage 0's."""

    def __init__(self, tree: dict, mesh: Mesh, cfg, local_cfg,
                 ranks: List[List[dict]],
                 stages: Optional[List[List["PipeStage"]]] = None):
        super().__init__(tree)
        self.mesh = mesh
        self.cfg = cfg
        self.local_cfg = local_cfg
        self.ranks = ranks
        self.stages = stages


class PipeStage(NamedTuple):
    """One data row's stage: layers ``lo .. hi - 1`` of the LLM on the
    stage's ``1 x n_model`` group ``mesh``.  ``tree`` holds them at local
    indices ``0 .. hi - lo - 1``: a :class:`ShardedLLM` over ``mesh`` where
    n_model > 1, else ``{"layers": ...}`` on the stage's one device."""
    lo: int
    hi: int
    tree: dict
    mesh: Mesh

    @property
    def device(self) -> torch.device:
        """The stage's first device (its residual's)."""
        return self.mesh.devices[0][0]


def pipe_layer_ranges(n_layers: int, n_pipe: int) -> List[Tuple[int, int]]:
    """Each stage's layers ``(lo, hi)``; ValueError unless P divides L."""
    if n_layers % n_pipe:
        raise ValueError(f"{n_layers} layers do not split into {n_pipe} "
                         "pipeline stages")
    n = n_layers // n_pipe
    return [(s * n, (s + 1) * n) for s in range(n_pipe)]


def stage_layers(layers: dict, lo: int, hi: int) -> dict:
    """Layers ``lo .. hi - 1`` of a stacked layer tree (views)."""
    return {k: stage_layers(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
            for k, v in layers.items()}


class ShardedCache(NamedTuple):
    """Per-rank caches ``shards[d][m]`` [L, B/n_data, S, Hkv/p*Dh]: rank
    (d, m) holds the rows of data row d and slice m of the packed axis."""
    shards: List[List[KVCache]]

    @property
    def shape(self):
        """The unsharded cache's shape [L, B, S, Hkv*Dh]."""
        L, b, S, kvd = self.shards[0][0].k.shape
        return (L, b * len(self.shards), S, kvd * len(self.shards[0]))

    @property
    def dtype(self):
        return self.shards[0][0].k.dtype


def apply_llm_sharding(params, cfg, mesh: Mesh) -> ShardedLLM:
    """Cut an LLM param tree (int8 or bf16, ``models/llm.py`` layouts) for
    ``mesh``: every rank of model index m gets shard m of the layers, on its
    device; the other leaves are replicated (module docstring).  On a pipe
    mesh the layers are cut into stages first (:func:`pipe_stages`).  The
    source tree is left as it is; the caller drops it to free it."""
    if mesh.n_pipe > 1:
        return pipe_stages(params, cfg, mesh)
    p = mesh.n_model
    shards = [shard_layers(params, cfg, p, m) for m in range(p)]
    top = {k: v for k, v in params.items() if k != "layers"}
    ranks = [[{**to_device(top, dev), "layers": to_device(
        shards[m][0]["layers"], dev)} for m, dev in enumerate(row)]
        for row in mesh.devices]
    return ShardedLLM(ranks[0][0], mesh, cfg, shards[0][1], ranks)


def pipe_stages(params, cfg, mesh: Mesh) -> ShardedLLM:
    """The LLM cut for a pipe mesh: data row d's stage s holds layers
    :func:`pipe_layer_ranges` gives it, views where its device is the
    layers', cut over the stage's "model" ranks by
    :func:`apply_llm_sharding` where n_model > 1; the other leaves whole on
    each data row's first device."""
    ranges = pipe_layer_ranges(cfg.num_hidden_layers, mesh.n_pipe)
    top = {k: v for k, v in params.items() if k != "layers"}
    p = mesh.n_model
    lcfg = local_config(cfg, p)
    # each stage's layers (views), cut over "model" once for every data row
    cuts = [[stage_layers(params["layers"], lo, hi)] if p == 1 else
            [shard_layers({"layers": stage_layers(params["layers"], lo, hi)},
                          cfg, p, m)[0]["layers"] for m in range(p)]
            for lo, hi in ranges]
    stages = []
    for d in range(mesh.n_data):
        row = []
        for s, (lo, hi) in enumerate(ranges):
            sm = mesh.stage_mesh(d, s)
            trees = [{"layers": to_device(c, dev)}
                     for c, dev in zip(cuts[s], sm.devices[0])]
            tree = trees[0] if p == 1 else ShardedLLM(
                trees[0], sm, dataclasses.replace(
                    cfg, num_hidden_layers=hi - lo), lcfg, [trees])
            row.append(PipeStage(lo, hi, tree, sm))
        stages.append(row)
    ranks = []
    for d, row in enumerate(mesh.devices):
        first = stages[d][0].tree
        lays = ([r["layers"] for r in first.ranks[0]] if p > 1
                else [first["layers"]])
        ranks.append([{**to_device(top, dev), "layers": lay}
                      for dev, lay in zip(row, lays)])
    return ShardedLLM(ranks[0][0], mesh, cfg, lcfg, ranks, stages)


def data_rows(mesh: Mesh, B: int, d: int) -> slice:
    """The batch rows of data row ``d``."""
    if B % mesh.n_data:
        raise ValueError(f"batch {B} does not split over {mesh.n_data} data "
                         "rows")
    b = B // mesh.n_data
    return slice(d * b, (d + 1) * b)


def shard_kv_cache(cache: KVCache, cfg, mesh: Mesh) -> ShardedCache:
    """An unsharded cache [L, B, S, Hkv*Dh] cut for ``mesh`` (copies)."""
    B, p = cache.k.shape[1], mesh.n_model
    shards = []
    for d, row in enumerate(mesh.devices):
        rows = data_rows(mesh, B, d)
        part = KVCache(cache.k[:, rows], cache.v[:, rows])
        shards.append([KVCache(*(t.to(dev) for t in shard_cache(
            part, cfg, p, m))) for m, dev in enumerate(row)])
    return ShardedCache(shards)


def init_sharded_cache(cfg, batch: int, max_len: int,
                       dtype) -> ShardedCache:
    """Zeroed per-rank caches for the current mesh."""
    mesh = current_mesh()
    p = mesh.n_model
    local_config(cfg, p)
    b = data_rows(mesh, batch, 0).stop
    shape = (cfg.num_hidden_layers, b, max_len,
             cfg.num_key_value_heads // p * cfg.head_dim)
    return ShardedCache([[KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                                  torch.zeros(shape, dtype=dtype, device=dev))
                          for dev in row] for row in mesh.devices])


def gather_cache(cache: ShardedCache, device=None) -> KVCache:
    """The unsharded cache [L, B, S, Hkv*Dh] of per-rank slices, on
    ``device`` (default: the first rank's)."""
    device = device or cache.shards[0][0].k.device

    def cat(side):
        return torch.cat([torch.cat([getattr(c, side).to(device) for c in row],
                                    -1) for row in cache.shards], 1)
    return KVCache(cat("k"), cat("v"))


def row_llm(sharded: ShardedLLM, d: int) -> ShardedLLM:
    """Data row d's group of a cut LLM as an LLM cut for that group's own
    ``1 x n_model`` mesh (``Mesh.row_mesh``; ``1 x n_model x n_pipe`` with
    the row's stages on a pipe mesh), sharing the row's tensors."""
    ranks = sharded.ranks[d]
    return ShardedLLM(ranks[0], sharded.mesh.row_mesh(d), sharded.cfg,
                      sharded.local_cfg, [ranks],
                      None if sharded.stages is None
                      else [sharded.stages[d]])


# -- the trainable state under fsdp ----------------------------------------

FSDP_MIN_SIZE = 8192


class Shards:
    """A tensor cut over a mesh's data rows along ``dim``: ``parts[d]``, on
    data row d's device, holds its d-th equal slice."""

    def __init__(self, parts: Sequence[torch.Tensor], dim: int):
        self.parts = list(parts)
        self.dim = dim

    @property
    def shape(self):
        s = list(self.parts[0].shape)
        s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first part's)."""
        device = device or self.parts[0].device
        return torch.cat([p.detach().to(device) for p in self.parts],
                         self.dim)

    def map(self, fn) -> "Shards":
        return Shards([fn(p) for p in self.parts], self.dim)


def fsdp_partition_specs(flat: Dict[str, torch.Tensor], n: int,
                         min_size: int = FSDP_MIN_SIZE
                         ) -> Dict[str, Optional[int]]:
    """The dim each trainable leaf is cut along over n data rows, or None
    (whole): a leaf of at least ``min_size`` elements on its largest dim
    that n divides, the later dim on a tie (``fsdp_partition_specs`` of the
    JAX package, ``sharding.py:167-200``)."""
    specs: Dict[str, Optional[int]] = {}
    for k, t in flat.items():
        specs[k] = None
        if n <= 1 or t.numel() < min_size:
            continue
        cand = [(d, i) for i, d in enumerate(t.shape) if d % n == 0]
        if cand:
            specs[k] = max(cand)[1]
    return specs


def shard_leaf(t: torch.Tensor, dim: Optional[int], devices) -> object:
    """``t`` cut along ``dim`` over ``devices`` (one part each, copies), or
    whole on the first device (shared where it is there already)."""
    if dim is None:
        return t.detach().to(devices[0])
    n = len(devices)
    return Shards([c.detach().to(dev).contiguous() for c, dev in
                   zip(torch.chunk(t, n, dim), devices)], dim)


def shard_trainable(flat: Dict[str, torch.Tensor], mesh: Mesh,
                    fsdp: bool = True,
                    min_size: int = FSDP_MIN_SIZE) -> Dict[str, object]:
    """A flat trainable dict laid out on ``mesh``'s data rows (the first
    device of each row): with ``fsdp`` the leaves of
    :func:`fsdp_partition_specs` as :class:`Shards`, the others whole on
    the first row's device; without, every leaf whole there."""
    devices = [row[0] for row in mesh.devices]
    specs = (fsdp_partition_specs(flat, len(devices), min_size) if fsdp
             else dict.fromkeys(flat))
    return {k: shard_leaf(t, specs[k], devices) for k, t in flat.items()}


def gather_leaf(t, device=None) -> torch.Tensor:
    """A whole tensor of a :class:`Shards` or a tensor (detached)."""
    if isinstance(t, Shards):
        return t.gather(device)
    t = t.detach()
    return t if device is None else t.to(device)


def gather_trainable(flat: Dict[str, object], device=None
                     ) -> Dict[str, torch.Tensor]:
    """:func:`shard_trainable` undone: every leaf whole on ``device``
    (default: where its first part is)."""
    return {k: gather_leaf(t, device) for k, t in flat.items()}
