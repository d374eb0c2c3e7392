"""Training and eval steps (port of ``desta25_audio_tpu/train/step.py``).

One step: log-mel of ``batch["audio"]``, the frozen Whisper encoder (no
grad) and the trainable connector, the transcription embeddings (no grad),
the splice, the frozen LLM forward with ``skip_head`` (K11 in every
attention at T >= 512, each layer checkpointed with ``remat``), the chunked
masked CE and the loss dict; then the backward with respect to the trainable
subtree only, ``grad_norm`` (the global norm before clipping) and the
optimizer update.  The frozen leaves never require grad, so no gradient
memory is spent on the towers: only activations carry gradients through
them.

Every step runs on a :class:`TrainLayout`: a ``(n_data, n_model)`` mesh
(one device is its ``1 x 1`` case), or a ``(n_data, n_model, n_pipe)`` one
whose "pipe" axis cuts the LLM's layers into stages, and, across
processes, a process group.  The batch's rows split over the data rows
(each row's clips travel with it), each data row runs its rows' forward on
its ``1 x n_model`` group (``1 x n_model x n_pipe`` with stages: GPipe with
``pipeline_microbatches``, ``parallel/pipeline.py``; Megatron sequence
parallelism over the group's "model" ranks with ``sequence_parallel``;
both as ``models/llm.llm_apply`` takes them),
the loss is the whole batch's (:func:`loss_from_parts`), and the rows'
gradients are summed in row order onto each trainable leaf's owner, then
across processes.

ORCA (``orca_hybrid``): the gated cross-attention stack is injected after
every LLM layer (``models/orca.make_deep_injection_fn``, inside each
layer's checkpoint), its per-layer alignment term comes back as the
forward's aux, and ``orca_aux_losses`` join the loss.  An int8 tower trains
through the straight-through backward of ``ops/qmm.quant_matmul`` with
``w8a8=False``: the products and the CE's head never quantize activations
(``train/step.py:95-120`` of the JAX package).

LoRA (``params["lora"]``, trained with the connector): the adapters' deltas
join q, k and v in every LLM layer; a training step with
``batch["lora_seed"]`` (the trainer's per-step seed) drops the adapters'
inputs at ``lora_dropout``, and eval runs without dropout
(``step.py:99-102`` of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..audio.mel import log_mel, pad_or_trim
from ..config import DeSTA25Config
from ..models import llm as tllm
from ..models.orca import make_deep_injection_fn, orca_inject_tokens
from ..models.perception import perception_apply
from ..models.splice import apply_splice
from .losses import (
    IGNORE_INDEX,
    masked_lm_sums_chunked,
    orca_aux_losses,
    qformer_aux_losses,
    total_loss_from_dict,
)
from ..parallel.mesh import Mesh, on_device, use_mesh
from ..parallel.sharding import (
    Shards,
    apply_llm_sharding,
    gather_leaf,
    row_llm,
    to_device,
)
from .optimizer import (
    apply_updates,
    flatten_tree,
    global_norm,
    unflatten_tree,
)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [B, T, H], mask [B, T] -> [B, H]."""
    m = mask[..., None].float()
    return (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def forward_parts(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                  config: DeSTA25Config, remat: bool, training: bool = True,
                  n_has: Optional[int] = None,
                  batch_rows: Optional[Tuple[int, int]] = None,
                  pipeline_microbatches: int = 0,
                  sequence_parallel: bool = False) -> Dict[str, Any]:
    """The forward of one device's rows -> the pieces its loss is made of
    (:func:`loss_from_parts`): the summed target log-probabilities ``s`` and
    their count ``n``, and the aux losses' inputs (``audio_feats``,
    ``local_tokens``, ORCA's per-layer ``align`` sums, the Q-Former
    ablation's pooled embeddings).  ``training`` adds ORCA's per-layer
    alignment term (eval leaves it out, as the JAX package does); ``n_has``
    and ``batch_rows`` say what whole batch these rows belong to
    (``make_deep_injection_fn``, ``llm_apply``); ``pipeline_microbatches``
    and ``sequence_parallel`` go to ``llm_apply`` (no-ops off a pipe mesh /
    a group, as in the JAX package)."""
    llm = params["llm"]
    llm_cfg = config.llm_config
    labels = batch["labels"]
    text_embeds = tllm.embed_tokens(llm, batch["input_ids"])
    audio_feats = local_tokens = None
    mel = batch.get("mel")
    if mel is None and "audio" in batch:
        enc_cfg = config.encoder_config
        wav = pad_or_trim(batch["audio"], enc_cfg.expected_mel_frames * 160)
        mel = log_mel(wav, enc_cfg.num_mel_bins, layout="btm").to(
            text_embeds.dtype)
    if mel is not None:
        audio_feats, local_tokens = perception_apply(params, mel, config)
        with torch.no_grad():
            trans_embeds = tllm.embed_tokens(llm, batch["trans_ids"])
        inputs_embeds = apply_splice(text_embeds, audio_feats, trans_embeds,
                                     batch["kind"], batch["aidx"],
                                     batch["pos"])
    else:
        inputs_embeds = text_embeds
    hook = aux_init = None
    inject_tokens = orca_inject_tokens(config, params, audio_feats,
                                       local_tokens)
    if inject_tokens is not None:
        # the transcription embeddings' positions, from the splice map
        hook, aux_init = make_deep_injection_fn(
            params["orca_cross_attns"], config, inject_tokens,
            trans_pos_mask=(batch["kind"] == 2).int(), training=training,
            n_has=n_has)
    # skip_head + chunked CE: the [B, T, V] f32 logits (and their gradient)
    # are never materialised whole; an int8 tower keeps its weight-only
    # forward (w8a8=False)
    out = tllm.llm_apply(
        llm, llm_cfg, inputs_embeds=inputs_embeds,
        attention_mask=batch["attention_mask"], extra_layer_fn=hook,
        extra_aux_init=aux_init, remat=remat, return_hidden=True,
        skip_head=True, w8a8=False, lora=params.get("lora"),
        lora_scale=config.lora_scale,
        lora_dropout=config.lora_dropout if training else 0.0,
        lora_seed=batch.get("lora_seed") if training else None,
        batch_rows=batch_rows, pipeline_microbatches=pipeline_microbatches,
        sequence_parallel=sequence_parallel)
    s, n = masked_lm_sums_chunked(
        llm, llm_cfg, out[2], labels,
        row_scale=1 if batch_rows is None else batch_rows[1] // len(labels))
    parts: Dict[str, Any] = {"s": s, "n": n}
    if config.connector_mode == "orca_hybrid":
        parts.update(audio_feats=audio_feats, local_tokens=local_tokens,
                     align=out[3] if aux_init is not None else None)
    elif (config.connector_mode == "qformer_1" and config.orca_enabled
            and (config.orca_ortho_diversity_weight > 0
                 or config.orca_align_weight_local > 0)
            and audio_feats is not None):
        # the Q-Former ablation losses: pooled transcription and target
        # embeddings without gradient, one audio per sample
        with torch.no_grad():
            trans_mask = batch.get("trans_mask",
                                   (batch["trans_ids"] != 0).int())
            trans_pooled = _masked_mean(
                tllm.embed_tokens(llm, batch["trans_ids"]), trans_mask > 0)
            tgt_mask = labels != IGNORE_INDEX
            tgt_ids = torch.where(tgt_mask, labels, torch.zeros_like(labels))
            target_pooled = _masked_mean(tllm.embed_tokens(llm, tgt_ids),
                                         tgt_mask)
        parts.update(audio_feats=audio_feats, trans_pooled=trans_pooled,
                     target_pooled=target_pooled)
    return parts


def _cat(parts, key: str, device):
    xs = [p[key].to(device) for p in parts if p.get(key) is not None]
    if not xs:
        return None
    return xs[0] if len(xs) == 1 else torch.cat(xs)


def loss_from_parts(config: DeSTA25Config, parts: List[Dict[str, Any]],
                    n_tokens: Optional[int] = None,
                    shares: Optional[Dict[str, float]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) of the rows whose :func:`forward_parts` are
    ``parts`` (in row order), on the first part's device: the sums add up
    before the one division, so the loss is that of the rows together, and
    the aux losses run on their inputs gathered in row order.

    Across processes: ``n_tokens`` is the whole batch's target count, and
    ``shares`` scales each mean aux loss by this process's share of its
    items (``clips``: ORCA's terms over the audio tokens; ``pairs``: the
    Q-Former ablation's, over min(N, B)), so that the processes' totals and
    metrics add up to the whole batch's (ppl excepted: it is exp(lm_loss)
    of the sum)."""
    dev = parts[0]["s"].device
    s = parts[0]["s"]
    n = parts[0]["n"]
    for p in parts[1:]:
        s = s + p["s"].to(dev)
        n = n + p["n"].to(dev)
    if n_tokens is not None:
        n = torch.tensor(n_tokens, dtype=torch.long, device=dev)
    n = torch.clamp(n, min=1)
    lm_loss = -s / n
    metrics = {"lm_loss": lm_loss, "ppl": torch.exp(lm_loss), "n_tokens": n}
    aux: Dict[str, torch.Tensor] = {}
    share = 1.0
    if config.connector_mode == "orca_hybrid":
        align = None
        if parts[0].get("align") is not None:
            # the mean per-layer term, 0 without transcription positions
            # (prompt-only training); every part counts the same layers
            align_sum = parts[0]["align"][0]
            for p in parts[1:]:
                align_sum = align_sum + p["align"][0].to(dev)
            align_n = parts[0]["align"][1]
            align = torch.where(align_n > 0,
                                align_sum / torch.clamp(align_n, min=1.0),
                                torch.zeros_like(align_sum)).reshape(1)
        aux = orca_aux_losses(config, _cat(parts, "audio_feats", dev),
                              _cat(parts, "local_tokens", dev), align)
        share = (shares or {}).get("clips", 1.0)
        if share != 1.0:
            # the alignment sums are the whole batch's already
            aux = {k: v if k == "L_align_layerwise" else v * share
                   for k, v in aux.items()}
    elif parts[0].get("trans_pooled") is not None:
        feats = _cat(parts, "audio_feats", dev)
        target = _cat(parts, "target_pooled", dev)
        m = min(feats.shape[0], target.shape[0])
        aux = qformer_aux_losses(config, feats[:m],
                                 _cat(parts, "trans_pooled", dev)[:m],
                                 target[:m])
        share = (shares or {}).get("pairs", 1.0)
        if share != 1.0:
            aux = {k: v * share for k, v in aux.items()}
    total = total_loss_from_dict(lm_loss, aux)
    metrics.update(aux)
    metrics["loss"] = total
    return total, metrics


def forward_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                 config: DeSTA25Config, remat: bool, training: bool = True
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The shared forward of one device -> (total loss, metrics)."""
    return loss_from_parts(config, [forward_parts(params, batch, config,
                                                  remat, training)])


# -- the step: on one device, on a mesh, across processes ---------------------

CLIP_KEYS = ("audio", "mel", "trans_ids", "trans_mask")


class TrainLayout:
    """Where a model trains on ``mesh``: data row d's group (its first
    device ``devices[d]``) holds the frozen towers (``frozen[d]``: the
    encoder and the non-LLM leaves whole, shared where the device repeats;
    the LLM whole, or with ``n_model`` > 1 or ``n_pipe`` > 1 cut by
    ``parallel/sharding.apply_llm_sharding`` (on a pipe mesh into the row's
    stages, views of the stacked layers where a stage's device is theirs)
    and seen as the group's own ``1 x n_model (x n_pipe)`` mesh,
    ``meshes[d]``).  ``mesh`` None: the ``1 x 1``
    mesh of the device the frozen LLM lies on (one device, the frozen tree
    as it is).  ``group``: the process group the gradients are summed over
    (None: one process).  ``pipeline_microbatches`` (GPipe on a pipe mesh)
    and ``sequence_parallel`` (on a group of p > 1 ranks) are how each
    group's forward runs, as ``train/step.py:42-43`` of the JAX package
    takes them (:func:`forward_parts`; no-ops elsewhere)."""

    def __init__(self, mesh: Optional[Mesh], frozen: Dict[str, Any],
                 config: DeSTA25Config, group=None,
                 pipeline_microbatches: int = 0,
                 sequence_parallel: bool = False):
        if mesh is None:
            mesh = Mesh([[frozen["llm"]["embed"].device]])
        self.mesh, self.group = mesh, group
        self.pipeline_microbatches = pipeline_microbatches
        self.sequence_parallel = sequence_parallel
        self.devices = [row[0] for row in mesh.devices]
        llm = frozen["llm"]
        cut = (apply_llm_sharding(llm, config.llm_config, mesh)
               if mesh.n_model > 1 or mesh.n_pipe > 1 else None)
        rest = {k: v for k, v in frozen.items() if k != "llm"}
        self.frozen: List[Dict[str, Any]] = []
        self.meshes: List[Optional[Mesh]] = []
        for d, dev in enumerate(self.devices):
            row_tower = row_llm(cut, d) if cut is not None else to_device(
                llm, dev)
            self.frozen.append({**to_device(rest, dev), "llm": row_tower})
            self.meshes.append(row_tower.mesh if cut is not None else None)

    def world(self) -> Tuple[int, int]:
        if self.group is None:
            return 0, 1
        import torch.distributed as dist
        return dist.get_rank(self.group), dist.get_world_size(self.group)


def batch_counts(batch: Dict[str, Any]) -> Dict[str, int]:
    """What a loss over the whole batch divides by, read on the host: the
    target tokens, the clips, the Q-Former ablation's pairs min(N, B) and
    ORCA's rows with transcription positions."""
    labels = batch["labels"]
    B = labels.shape[0]
    N = batch["audio"].shape[0] if "audio" in batch else (
        batch["mel"].shape[0] if "mel" in batch else 0)
    return {"tokens": int((labels[:, 1:] != IGNORE_INDEX).sum()),
            "clips": int(N), "pairs": int(min(N, B)),
            "has_trans": int((batch["kind"] == 2).any(1).sum())}


def clip_bounds(batch: Dict[str, Any], cuts: List[int]) -> List[int]:
    """The clip index where each part of the rows cut at ``cuts`` (row
    bounds, first 0, last B) begins, and N: the collate numbers clips in row
    order, so part d takes clips bounds[d]..bounds[d+1], each row's clips
    (those its splice maps name) travel with it, and a clip no map names
    stays with the part before.  Raises ValueError if a row names a clip
    outside its part's range."""
    N = batch["audio"].shape[0] if "audio" in batch else batch["mel"].shape[0]
    if len(cuts) == 2:
        return [0, N]
    last = []
    for r in range(batch["kind"].shape[0]):
        named = [int(batch[a][r][batch[k][r] > 0].max())
                 for k, a in (("kind", "aidx"),
                              ("context_kind", "context_aidx"))
                 if k in batch and bool((batch[k][r] > 0).any())]
        last.append(max(named, default=-1))
    bounds = [0]
    for hi in cuts[1:-1]:
        bounds.append(max(bounds[-1], 1 + max(last[:hi], default=-1)))
    bounds.append(N)
    for d in range(len(cuts) - 1):
        for k, a in (("kind", "aidx"), ("context_kind", "context_aidx")):
            if k not in batch:
                continue
            sel = batch[k][cuts[d]:cuts[d + 1]] > 0
            named = batch[a][cuts[d]:cuts[d + 1]][sel]
            if named.numel() and (int(named.min()) < bounds[d]
                                  or int(named.max()) >= bounds[d + 1]):
                raise ValueError("a row's clips are not in row order")
    return bounds


def split_batch(batch: Dict[str, Any], devices, first_row: int = 0,
                total_rows: Optional[int] = None) -> List[Dict[str, Any]]:
    """A batch of tensors cut into equal runs of rows, one a device: each
    run's rows, its clips (``CLIP_KEYS``, :func:`clip_bounds`) with
    ``aidx`` / ``context_aidx`` renumbered to them, and ``batch_rows``
    (the run's first row in the whole batch of ``total_rows``, which starts
    at ``first_row`` of it); other entries (``lora_seed``) as they are."""
    B = batch["input_ids"].shape[0]
    n = len(devices)
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} data rows")
    b = B // n
    cuts = [d * b for d in range(n + 1)]
    has_clips = "audio" in batch or "mel" in batch
    bounds = clip_bounds(batch, cuts) if has_clips else None
    total = B if total_rows is None else total_rows
    out = []
    for d, dev in enumerate(devices):
        rows = slice(cuts[d], cuts[d + 1])
        part: Dict[str, Any] = {}
        for k, v in batch.items():
            if not isinstance(v, torch.Tensor) or v.dim() == 0:
                part[k] = v
            elif k in CLIP_KEYS:
                part[k] = v[bounds[d]:bounds[d + 1]].to(dev)
            elif v.shape[0] == B:
                v = v[rows]
                if k in ("aidx", "context_aidx") and bounds[d]:
                    kind = batch[k.replace("aidx", "kind")][rows]
                    v = torch.where(kind > 0, v - bounds[d],
                                    torch.zeros_like(v))
                part[k] = v.to(dev)
            else:
                raise ValueError(f"batch entry {k!r} of shape "
                                 f"{tuple(v.shape)} is neither per row nor "
                                 "per clip")
        part["batch_rows"] = (first_row + cuts[d], total)
        out.append(part)
    return out


def _all_reduce(tensors, group) -> None:
    import torch.distributed as dist
    for t in tensors:
        dist.all_reduce(t, group=group)


def _reduce_to_owner(owner, grads):
    """The rows' gradients of one leaf summed in row order in f32 onto its
    owner's layout (a tensor on its device, or a Shards' parts), rounded
    once to the leaf's dtype.  A row's gradient is a whole tensor, or (a
    stack gathered a layer at a time) a Shards alike the owner's."""
    def total(parts, device, dtype):
        acc = None
        for g in parts:
            g = g.float().to(device)
            acc = g if acc is None else acc + g
        # contiguous: NCCL's all_reduce takes no strided tensor
        return acc.to(dtype).contiguous()
    if isinstance(owner, Shards):
        out, off = [], 0
        for e, p in enumerate(owner.parts):
            size = p.shape[owner.dim]
            out.append(total([g.parts[e] if isinstance(g, Shards)
                              else g.narrow(owner.dim, off, size)
                              for g in grads], p.device, p.dtype))
            off += size
        return Shards(out, owner.dim)
    return total(grads, owner.device, owner.dtype)


def _owner_tensors(flat) -> List[torch.Tensor]:
    out = []
    for t in flat.values():
        out.extend(t.parts if isinstance(t, Shards) else [t])
    return out


# the trainable subtrees gathered where they are used, a layer at a time
# (models/orca.layer_trees), not whole onto every data row
LAYER_GATHERED = ("orca_cross_attns/",)


def _replica(key: str, owner, device, grad: bool):
    """One row's leaf of its own: the owner's tensor itself (a new autograd
    leaf on its storage) where it lies on ``device`` whole, else a copy
    there (a Shards gathered); a Shards of ``LAYER_GATHERED`` stays in its
    parts (new leaves on their storage)."""
    if isinstance(owner, Shards) and key.startswith(LAYER_GATHERED):
        return owner.map(lambda p: p.detach().requires_grad_(grad))
    return gather_leaf(owner, device).requires_grad_(grad)


def mesh_forward(trainable, layout: TrainLayout, batch, config, remat,
                 training: bool, counts: Dict[str, int],
                 local: Dict[str, int], across: bool = True):
    """Every data row's forward on its group -> (total, metrics, the rows'
    replicas of the trainable leaves), ``trainable`` a flat dict of the
    leaves' owners.  ``counts``: the whole batch's (:func:`batch_counts`,
    summed across processes when ``across``); ``local``: this process's."""
    rank, world = layout.world() if across else (0, 1)
    B = batch["input_ids"].shape[0]
    rows = split_batch(batch, layout.devices, rank * B, world * B)
    replicas, parts = [], []
    for d, (dev, part) in enumerate(zip(layout.devices, rows)):
        rep = {k: _replica(k, t, dev, training)
               for k, t in trainable.items()}
        replicas.append(rep)
        params = {**layout.frozen[d], **unflatten_tree(rep)}
        with on_device(dev), use_mesh(layout.meshes[d]):
            parts.append(forward_parts(
                params, part, config, remat, training,
                n_has=counts["has_trans"],
                batch_rows=part.pop("batch_rows"),
                pipeline_microbatches=layout.pipeline_microbatches,
                sequence_parallel=layout.sequence_parallel))
    shares = None
    if world > 1:
        shares = {k: local[k] / max(counts[k], 1) for k in ("clips", "pairs")}
    total, metrics = loss_from_parts(
        config, parts, n_tokens=counts["tokens"] if world > 1 else None,
        shares=shares)
    return total, metrics, replicas


def _global_counts(batch, layout: TrainLayout):
    local = batch_counts(batch)
    counts = dict(local)
    if layout.group is not None:
        keys = sorted(local)
        t = torch.tensor([local[k] for k in keys], dtype=torch.long,
                         device=layout.devices[0])
        _all_reduce([t], layout.group)
        counts = dict(zip(keys, t.tolist()))
    return counts, local


def _sum_metrics(metrics, layout: TrainLayout):
    """The processes' metrics summed (each is its share of the whole
    batch's), ppl recomputed from the summed lm_loss."""
    if layout.group is None:
        return metrics
    keys = [k for k in sorted(metrics) if k not in ("ppl", "n_tokens")]
    dev = metrics["lm_loss"].device
    t = torch.stack([metrics[k].detach().float().reshape(()).to(dev)
                     for k in keys])
    _all_reduce([t], layout.group)
    out = dict(zip(keys, t.unbind()))
    out["ppl"] = torch.exp(out["lm_loss"])
    out["n_tokens"] = metrics["n_tokens"]
    return out


def make_train_step(config: DeSTA25Config, optimizer, remat: bool = False):
    """``step(trainable, layout, opt_state, batch) -> (trainable, opt_state,
    metrics)`` on a :class:`TrainLayout`'s mesh and process group (one
    device: ``TrainLayout(None, frozen, config)``).  ``trainable``: the
    leaves' owners, a nested tree or a flat dict
    (``parallel/sharding.shard_trainable``: Shards, or whole tensors on the
    first row's device), updated in place outside autograd and handed back;
    ``batch``: this process's batch, on the host or on the device.

    The rows run their forward on their groups (:func:`mesh_forward`), one
    backward takes each row's gradients on its own replica of the leaves,
    and they are summed in row order in f32 onto the owners, then across
    processes (``all_reduce``); the loss is the whole batch's
    (:func:`loss_from_parts`), ``grad_norm`` the global norm before
    clipping.  Adafactor then updates the owners.  A device OOM in any
    process raises in every process (their flags are summed before the
    gradients), so that all back off together."""

    def train_step(trainable, layout, opt_state, batch):
        owners = flatten_tree(trainable)
        counts, local = _global_counts(batch, layout)
        failed = None
        try:
            total, metrics, replicas = mesh_forward(
                owners, layout, batch, config, remat, True, counts, local)
            leaves = [t for rep in replicas for t in _owner_tensors(rep)]
            got = iter(torch.autograd.grad(total, leaves, allow_unused=True))
            del total, leaves

            def grad_of(t):
                g = next(got)
                return torch.zeros_like(t) if g is None else g
            rows = [{k: t.map(grad_of) if isinstance(t, Shards)
                     else grad_of(t) for k, t in rep.items()}
                    for rep in replicas]
            del got, replicas
            grads = {k: _reduce_to_owner(owner, [r[k] for r in rows])
                     for k, owner in owners.items()}
            del rows
        except torch.cuda.OutOfMemoryError as e:
            failed = e
        if layout.group is not None:
            flag = torch.tensor([0 if failed is None else 1],
                                device=layout.devices[0])
            _all_reduce([flag], layout.group)
            if failed is None and int(flag.item()):
                failed = torch.cuda.OutOfMemoryError(
                    "another process of the run ran out of device memory")
        if failed is not None:
            raise failed
        with torch.no_grad():
            if layout.group is not None:
                _all_reduce(_owner_tensors(grads), layout.group)
            metrics = _sum_metrics(
                {k: v.detach() for k, v in metrics.items()}, layout)
            metrics["grad_norm"] = global_norm(grads)
            updates, opt_state = optimizer.update(grads, opt_state, owners)
            apply_updates(owners, updates)
        return trainable, opt_state, metrics

    return train_step


def make_eval_step(config: DeSTA25Config, layout: TrainLayout,
                   remat: bool = False):
    """``eval_step(trainable, batch) -> metrics`` (loss / ppl) on
    ``layout``'s mesh, no grad: this process's batch alone (no collective,
    so processes may see different numbers of eval batches); the layout's
    ``pipeline_microbatches`` and ``sequence_parallel`` as the train step's
    (the JAX package's ``make_eval_step``, ``step.py:202-210``)."""

    @torch.no_grad()
    def eval_step(trainable, batch):
        local = batch_counts(batch)
        return mesh_forward(flatten_tree(trainable), layout, batch, config,
                            remat, False, local, local, across=False)[1]

    return eval_step
