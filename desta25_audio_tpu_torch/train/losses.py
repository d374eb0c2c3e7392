"""Training losses (port of ``desta25_audio_tpu/train/losses.py``).

- Masked next-token cross-entropy with HF label semantics (-100 ignored,
  shift by one), full-logit and chunked.
- The Q-Former ablation losses (diversity, margin-contrastive alignment).
- The ORCA auxiliary losses (diversity, global-local orthogonality,
  layer-wise alignment).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import DeSTA25Config

IGNORE_INDEX = -100


def _token_logp_sums(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of the target log-probabilities over unmasked positions, their
    count) for f32 logits [B, T, V] and targets [B, T]."""
    mask = targets != IGNORE_INDEX
    safe = torch.where(mask, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits, dim=-1)
    tl = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return torch.where(mask, tl, torch.zeros_like(tl)).sum(), mask.sum()


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """logits [B, T, V], labels [B, T] with -100 masking.  Shift-by-one
    next-token CE -> {"lm_loss", "n_tokens", "ppl"}."""
    s, n = _token_logp_sums(logits[:, :-1].float(), labels[:, 1:])
    n = torch.clamp(n, min=1)
    loss = -s / n
    return {"lm_loss": loss, "n_tokens": n, "ppl": torch.exp(loss)}


def masked_lm_loss_chunked(llm_params, llm_cfg, hidden: torch.Tensor,
                           labels: torch.Tensor, chunk: int = 64
                           ) -> Dict[str, torch.Tensor]:
    """The CE of :func:`masked_lm_loss` without the full [B, T, V] logits:
    the head and the log-softmax run per ``chunk`` positions of the shifted
    sequence, each chunk under ``torch.utils.checkpoint`` when grad mode is
    on, so forward and backward hold one chunk's logits at a time.  The
    per-chunk sums add in sequence order, as the JAX package's scan does.

    hidden [B, T, D] (``llm_apply(skip_head=True, return_hidden=True)``),
    labels [B, T] with -100 ignore positions.  An int8 head keeps its
    weight-only product (``w8a8=False``, ``losses.py:72-73`` of the JAX
    package)."""
    s, n = masked_lm_sums_chunked(llm_params, llm_cfg, hidden, labels, chunk)
    n = torch.clamp(n, min=1)
    loss = -s / n
    return {"lm_loss": loss, "n_tokens": n, "ppl": torch.exp(loss)}


def masked_lm_sums_chunked(llm_params, llm_cfg, hidden: torch.Tensor,
                           labels: torch.Tensor, chunk: int = 64,
                           row_scale: int = 1):
    """(the summed target log-probabilities f32, the count of target
    tokens) of :func:`masked_lm_loss_chunked`, before the division: a batch
    split over devices or processes adds both and divides once, so its loss
    is the whole batch's.  ``row_scale``: these rows are one of that many
    equal parts of the batch (an int8 head's regime, ``quant_matmul``)."""
    from ..models.llm import head_logits

    hidden = hidden[:, :-1]
    targets = labels[:, 1:]

    def chunk_sums(h, t):
        return _token_logp_sums(head_logits(llm_params, h, w8a8=False,
                                            row_scale=row_scale).float(), t)

    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.long, device=hidden.device)
    for lo in range(0, hidden.shape[1], chunk):
        h, t = hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            ds, dn = checkpoint(chunk_sums, h, t, use_reentrant=False)
        else:
            ds, dn = chunk_sums(h, t)
        s = s + ds
        n = n + dn
    return s, n


def _normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    # sqrt(sum(x^2) + eps^2): the norm's backward at x == 0 stays finite
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(sq + 1e-12)


def diversity_loss(tokens: torch.Tensor) -> torch.Tensor:
    """||G^T G - I||^2 over normalised tokens [B, K, H]."""
    g = _normalize(tokens.float())
    gram = torch.einsum("bkh,bqh->bkq", g, g)
    eye = torch.eye(gram.shape[-1], device=gram.device)
    return torch.mean((gram - eye[None]) ** 2)


def global_local_ortho_loss(global_tokens: torch.Tensor,
                            local_tokens: torch.Tensor,
                            max_local: int = 100) -> torch.Tensor:
    """Mean squared global x local cross-similarity, the local tokens
    sampled uniformly down to ``max_local``."""
    g = _normalize(global_tokens.float())
    l = _normalize(local_tokens.float())
    Tl = l.shape[1]
    if Tl > max_local:
        idx = torch.linspace(0, Tl - 1, max_local,
                             device=l.device).to(torch.long)
        l = l[:, idx]
    cross = torch.einsum("bgh,blh->bgl", g, l)
    return torch.mean(cross ** 2)


def qformer_aux_losses(config: DeSTA25Config,
                       qformer_tokens: Optional[torch.Tensor],
                       transcription_embeds: Optional[torch.Tensor],
                       target_embeds: Optional[torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Q-Former ablation losses; only called when ``config.orca_enabled``
    and a weight is > 0.  qformer_tokens [B, K, H], the pooled
    transcription and target embeddings [B, H]."""
    losses: Dict[str, torch.Tensor] = {}
    if qformer_tokens is not None and config.orca_ortho_diversity_weight > 0:
        losses["L_ortho_diversity"] = (config.orca_ortho_diversity_weight
                                       * diversity_loss(qformer_tokens))
    if (qformer_tokens is not None and config.orca_align_weight_local > 0
            and transcription_embeds is not None
            and target_embeds is not None):
        audio_pooled = _normalize(qformer_tokens.float().mean(1))
        trans_pooled = _normalize(transcription_embeds.float())
        target_pooled = _normalize(target_embeds.float())
        sim_trans = torch.sum(audio_pooled * trans_pooled, dim=-1)
        sim_target = torch.sum(audio_pooled * target_pooled, dim=-1)
        margin = 0.5
        contrastive = torch.mean(torch.clamp(margin + sim_trans - sim_target,
                                             min=0.0))
        target_align = torch.mean(1.0 - sim_target)
        losses["L_align"] = (config.orca_align_weight_local
                             * (contrastive + 0.5 * target_align))
        losses["L_align_contrastive"] = contrastive
        losses["L_align_target"] = target_align
        losses["sim_trans"] = torch.mean(sim_trans)
        losses["sim_target"] = torch.mean(sim_target)
    return losses


def orca_aux_losses(config: DeSTA25Config,
                    global_tokens: Optional[torch.Tensor],
                    local_tokens: Optional[torch.Tensor],
                    layer_align_losses: Optional[torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """ORCA losses; layer_align_losses [n_layers] or None."""
    losses: Dict[str, torch.Tensor] = {}
    if global_tokens is not None:
        losses["L_ortho_diversity"] = (config.orca_ortho_diversity_weight
                                       * diversity_loss(global_tokens))
    if global_tokens is not None and local_tokens is not None:
        losses["L_ortho_qformer_local"] = (
            config.orca_ortho_weight_qformer_local
            * global_local_ortho_loss(global_tokens, local_tokens))
    if layer_align_losses is not None:
        losses["L_align_layerwise"] = (config.orca_align_weight_local
                                       * torch.mean(layer_align_losses))
    return losses


def total_loss_from_dict(lm_loss: torch.Tensor,
                         aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """lm + the weighted aux terms; the monitoring keys are left out."""
    total = lm_loss
    for k, v in aux.items():
        if k.startswith("L_") and k not in ("L_align_contrastive",
                                            "L_align_target"):
            total = total + v
    return total
