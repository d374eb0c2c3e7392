"""WhisperPerception: mel -> tapped encoder -> connector (Q-Former, or the
ORCA hybrid connector), counterpart of
``desta25_audio_tpu/models/perception.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DeSTA25Config
from .orca import orca_connector_apply
from .qformer import qformer_connector_apply
from .whisper import whisper_encoder_apply


def perception_apply(params, mel: torch.Tensor, config: DeSTA25Config
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """mel [N, 3000, n_mels] (NWC) -> (audio tokens [N, K, d_llm], ORCA
    local tokens [N, T', d_llm] or None); K = prompt_size (Q-Former) or
    orca_global_num_tokens (ORCA).

    The Whisper encoder is frozen: it runs under ``torch.no_grad()``, so its
    kernels never see grad mode and its taps carry no graph; gradients start
    at the connector."""
    with torch.no_grad():
        _, taps = whisper_encoder_apply(
            params["whisper"]["encoder"], mel, config.encoder_config,
            target_layer_ids=config.target_layer_ids)
    if config.connector_mode == "qformer_1":
        return qformer_connector_apply(params["connector"], taps, config), None
    if config.connector_mode == "orca_hybrid":
        return orca_connector_apply(params["connector"], taps, config)
    raise NotImplementedError(
        f"connector_mode {config.connector_mode!r} not implemented")
