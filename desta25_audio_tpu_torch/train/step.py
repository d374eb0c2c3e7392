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

from typing import Any, Dict, Tuple

import torch

from ..audio.mel import log_mel, pad_or_trim
from ..config import DeSTA25Config
from ..models import llm as tllm
from ..models.orca import make_deep_injection_fn, orca_inject_tokens
from ..models.perception import perception_apply
from ..models.splice import apply_splice
from .losses import (
    IGNORE_INDEX,
    masked_lm_loss_chunked,
    orca_aux_losses,
    qformer_aux_losses,
    total_loss_from_dict,
)
from .optimizer import apply_updates, flatten_tree, global_norm


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [B, T, H], mask [B, T] -> [B, H]."""
    m = mask[..., None].float()
    return (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def forward_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                 config: DeSTA25Config, remat: bool, training: bool = True
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The shared forward -> (total loss, metrics).  ``training`` adds
    ORCA's per-layer alignment term (eval leaves it out, as the JAX package
    does)."""
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
            trans_pos_mask=(batch["kind"] == 2).int(), training=training)
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
        lora_seed=batch.get("lora_seed") if training else None)
    hidden = out[2]
    d = masked_lm_loss_chunked(llm, llm_cfg, hidden, labels)
    metrics = {"lm_loss": d["lm_loss"], "ppl": d["ppl"],
               "n_tokens": d["n_tokens"]}
    aux: Dict[str, torch.Tensor] = {}
    if config.connector_mode == "orca_hybrid":
        align = None
        if aux_init is not None:
            # the mean per-layer term, 0 without transcription positions
            # (prompt-only training)
            align_sum, align_n = out[3]
            align = torch.where(align_n > 0,
                                align_sum / torch.clamp(align_n, min=1.0),
                                torch.zeros_like(align_sum)).reshape(1)
        aux = orca_aux_losses(config, audio_feats, local_tokens, align)
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
        n = min(audio_feats.shape[0], target_pooled.shape[0])
        aux = qformer_aux_losses(config, audio_feats[:n], trans_pooled[:n],
                                 target_pooled[:n])
    total = total_loss_from_dict(d["lm_loss"], aux)
    metrics.update(aux)
    metrics["loss"] = total
    return total, metrics


def make_train_step(config: DeSTA25Config, optimizer, remat: bool = False):
    """``step(trainable, frozen, opt_state, batch) -> (trainable, opt_state,
    metrics)``.  The trainable leaves must require grad (the trainer sets
    it); they are updated in place, outside autograd."""

    def train_step(trainable, frozen, opt_state, batch):
        params = {**frozen, **trainable}
        leaves = flatten_tree(trainable)
        total, metrics = forward_loss(params, batch, config, remat)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p))
                 for (k, p), g in zip(leaves.items(), grads)}
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
            updates, opt_state = optimizer.update(grads, opt_state, leaves)
            apply_updates(leaves, updates)
        return trainable, opt_state, {k: v.detach()
                                      for k, v in metrics.items()}

    return train_step


def make_eval_step(config: DeSTA25Config, remat: bool = False):
    """``eval_step(params, batch) -> metrics`` (loss / ppl), no grad."""

    @torch.no_grad()
    def eval_step(params, batch):
        return forward_loss(params, batch, config, remat,
                            training=False)[1]

    return eval_step
