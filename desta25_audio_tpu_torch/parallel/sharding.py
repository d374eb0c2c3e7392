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
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

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
    as they read an unsharded tree."""

    def __init__(self, tree: dict, mesh: Mesh, cfg, local_cfg,
                 ranks: List[List[dict]]):
        super().__init__(tree)
        self.mesh = mesh
        self.cfg = cfg
        self.local_cfg = local_cfg
        self.ranks = ranks


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
    device; the other leaves are replicated (module docstring).  The source
    tree is left as it is; the caller drops it to free it."""
    p = mesh.n_model
    shards = [shard_layers(params, cfg, p, m) for m in range(p)]
    top = {k: v for k, v in params.items() if k != "layers"}
    ranks = [[{**to_device(top, dev), "layers": to_device(
        shards[m][0]["layers"], dev)} for m, dev in enumerate(row)]
        for row in mesh.devices]
    return ShardedLLM(ranks[0][0], mesh, cfg, shards[0][1], ranks)


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
