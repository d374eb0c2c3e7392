"""DeSTA25AudioModel for the PyTorch port: the public ``generate()`` API.

Counterpart of ``desta25_audio_tpu/models/desta.py`` for the slices ported
so far: bf16 (or f32) towers, the Whisper encoder in bf16 or int8 (W8A8,
``encoder_quant``), the LLM in bf16 or int8 (``llm_quant``), the Q-Former
or the ORCA hybrid connector with deep injection (``models/orca.py``; its
cross-attention stack float or int8), transcriptions supplied by the
caller or made by Whisper ASR in the loop (greedy, or the temperature
fallback cascade with ``asr_fallback``), long clips chunked
(``auto_chunk_long_audio``), the audio-feature cache
(:meth:`DeSTA25AudioModel.enable_audio_cache`), plain or speculative
(``speculative_k >= 2``) decoding, LoRA adapters on the LLM's q, k and v
(``use_lora``: trained with the connector, decoded through the layer loop;
:meth:`DeSTA25AudioModel.merge_lora_for_serving` folds them in for the
fused steps).
:meth:`DeSTA25AudioModel.from_pretrained` loads a checkpoint directory
(``config.json`` + the reference's trainable-only ``model.safetensors``) with
the frozen towers from a weights root (``ckpt/desta_io.load_frozen_tower``)
and applies the JAX package's inference default (``encoder_quant="auto"`` ->
int8, ``orca_xattn_quant``); :meth:`DeSTA25AudioModel.save_pretrained` writes
one.  A model built directly reaches the int8 encoder through
:meth:`DeSTA25AudioModel.apply_inference_encoder_quant`; an existing bf16 LLM
is quantized with :meth:`DeSTA25AudioModel.apply_llm_quant`, and the ORCA
stack with :meth:`DeSTA25AudioModel.apply_orca_xattn_quant`.

- phase A: audio decode (``audio/io.py``: WAV natively, other containers
  through the native FFmpeg codec) + energy VAD (a clip without speech gets the
  transcription " "), then ASR on the device for every speech clip without
  a transcription (its own mel and encoder pass, the Whisper decoder);
  with the feature cache on, a hit skips the decode, the VAD and, once its
  transcription is filled, the ASR;
- host phase B: chat template, ``<start_audio><|AUDIO|><end_audio>`` wrap,
  placeholder expansion, left-pad tokenization, splice maps;
- device phase C: mel -> Whisper encoder taps -> Q-Former (or ORCA's
  global and local branches) -> splice into the embedding stream ->
  prefill -> KV-cached decode (one token a step, or n-gram drafts verified
  k at a time), with ORCA's gated cross-attention after every layer; with
  the feature cache on, perception runs over the misses only (padded to a
  power of two) and the splice over the cached tokens.

Tensor-parallel serving: :meth:`DeSTA25AudioModel.apply_llm_sharding` cuts
the LLM for a mesh (``parallel/mesh.make_mesh``), and ``generate()`` under
``use_mesh(mesh)`` runs perception on the mesh's first device and the LLM's
prefill and decode on every rank (``models/llm.py``: the tensor-parallel
decode step K10, its verify step, the layer loop elsewhere); sampling stays
on the first device.  ORCA's stack is replicated on every rank.

A connector mode other than ``qformer_1`` / ``orca_hybrid`` raises
``NotImplementedError`` (:func:`check_slice`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..audio.chunking import WINDOW, chunk_audio, expand_message_for_chunks
from ..audio.io import AudioSegment, write_wav
from ..audio.mel import log_mel, pad_or_trim
from ..audio.vad import has_speech
from ..config import DeSTA25Config
from ..data.tokenizer import build_tokenizer
from ..generate.decode import (
    WHISPER_BEGIN_SUPPRESS_TOKEN_IDS,
    WHISPER_NON_SPEECH_TOKEN_IDS,
    llm_generate,
    whisper_transcribe,
    whisper_transcribe_with_fallback,
)
from ..generate.speculative import (
    left_aligned,
    llm_generate_spec,
    spec_cache_len,
    spec_limits,
)
from ..ops.quant import (
    is_quantized,
    quantize_encoder_params,
    quantize_llm_params,
    quantize_orca_cross_attns,
)
from ..parallel.sharding import ShardedLLM, apply_llm_sharding
from . import llm as tllm
from .feature_cache import AudioFeatureCache
from .orca import (
    init_orca_connector,
    init_orca_cross_attns,
    orca_inject_tokens,
)
from .perception import perception_apply
from .qformer import init_qformer_connector
from .splice import (
    SpliceEntry,
    apply_splice,
    build_splice_maps,
    expand_audio_placeholders,
)
from .whisper import init_whisper_decoder, init_whisper_encoder

logger = logging.getLogger(__name__)

# the LoRA adapters' generator is seeded from the model's seed plus this,
# so that turning LoRA on leaves the rest of a seed's tree as it was
_LORA_SEED_OFFSET = 104729


@dataclass
class GenerationOutput:
    """Reference GenerationOutput (modeling_desta25.py:492-496)."""

    audios: list
    generated_ids: list
    text: List[str]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _CharASR:
    """The ``test/`` encoders' detokenizer: ids below 128 as characters."""

    @staticmethod
    def batch_decode(ids_batch, skip_special_tokens=True):
        return ["".join(chr(i) for i in ids if int(i) < 128)
                for ids in np.asarray(ids_batch)]


def check_slice(config: DeSTA25Config) -> None:
    """Raise NotImplementedError for configurations the port lacks."""
    if config.connector_mode not in ("qformer_1", "orca_hybrid"):
        raise NotImplementedError(
            f"connector_mode {config.connector_mode!r} not implemented")
    if config.llm_quant not in ("none", "int8"):
        raise ValueError(f"llm_quant={config.llm_quant!r} (none | int8)")


class DeSTA25AudioModel:
    """Frozen Whisper encoder + Q-Former or ORCA connector + frozen LLM.

    device: where the params live and every device phase runs (no default:
    pass "cuda" or "cpu").  params: a port param tree (``ckpt/bridge.py``
    converts the JAX package's); None draws random weights on ``device``
    from ``torch.Generator(device).manual_seed(seed)``.  On a CUDA device
    TF32 is turned off for matmuls and cuDNN, so f32 products (mel, conv
    stem, Q-Former) keep f32 precision as in the JAX package.
    """

    def __init__(self, config: DeSTA25Config, device, params=None,
                 seed: int = 0, tokenizer=None):
        check_slice(config)
        self.config = config
        self.device = torch.device(device)
        self.llm_cfg = config.llm_config
        self.enc_cfg = config.encoder_config
        self.audio_locator = config.audio_locator
        self.placeholder_token = config.placeholder_token
        self.dtype = (torch.bfloat16 if config.dtype == "bfloat16"
                      else torch.float32)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.params = (params if params is not None
                       else self.init_params(seed))
        self._tokenizer = tokenizer
        self._whisper_tokenizer = None
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        # the ASR temperature-fallback cascade: None keeps the reference's
        # one greedy pass; a (possibly empty) dict of keyword arguments of
        # whisper_transcribe_with_fallback turns it on
        self.asr_fallback: Optional[Dict[str, Any]] = None
        # the audio-feature cache (serving): None = off, enable_audio_cache()
        self.audio_cache: Optional[AudioFeatureCache] = None
        # the rows each fallback tier after the first decoded again in the
        # last ASR call (empty without asr_fallback)
        self.last_asr_retried: List[List[int]] = []
        # host-clock phase times of the last generate() call
        self.last_timings: Dict[str, float] = {}
        # why the last generate(speculative_k >= 2) decoded one token a step
        # instead (empty when it speculated)
        self.last_spec_fallback: List[str] = []

    def init_params(self, seed: int) -> Dict[str, Any]:
        g = torch.Generator(self.device).manual_seed(seed)
        with torch.no_grad():
            enc = init_whisper_encoder(self.enc_cfg, self.dtype, self.device,
                                       g)
            params = {
                "whisper": {"encoder": enc},
                "llm": tllm.init_llm(self.llm_cfg, self.dtype, self.device,
                                     g),
            }
            if self.config.connector_mode == "qformer_1":
                params["connector"] = init_qformer_connector(
                    self.config, torch.float32, self.device, g)
            else:
                params["connector"] = init_orca_connector(
                    self.config, torch.float32, self.device, g)
                if self.config.orca_deep_injection_enabled:
                    params["orca_cross_attns"] = init_orca_cross_attns(
                        self.config,
                        getattr(torch, self.config.orca_xattn_dtype),
                        self.device, g)
            # drawn last, so the other weights stay those of a seed; it
            # stays in the model dtype when the encoder is quantized, as in
            # the JAX package
            params["whisper"]["decoder"] = init_whisper_decoder(
                self.enc_cfg, self.dtype, self.device, g)
            if self.config.llm_quant == "int8":
                params["llm"] = quantize_llm_params(params["llm"])
            if self.config.resolved_encoder_quant(inference=False) == "int8":
                params["whisper"]["encoder"] = quantize_encoder_params(enc)
            if self.config.use_lora:
                # last and from its own generator (the JAX package's own
                # key, desta.py:132-134): the other weights stay a seed's
                params["lora"] = tllm.init_lora(
                    self.llm_cfg, self.config.lora_rank, self.device,
                    torch.Generator(self.device).manual_seed(
                        seed + _LORA_SEED_OFFSET))
            return params

    def merge_lora_for_serving(self, quantize: bool = True) -> None:
        """Fold the LoRA adapters into the LLM's q/k/v weights and drop them
        (peft ``merge_and_unload``; the JAX package's
        ``merge_lora_for_serving``, ``desta.py:137-156``): a serving
        transform that re-opens the fused decode steps.  ``quantize`` then
        makes the merged tower int8 on the model's device
        (``quantize_llm_params``, which divides exactly: the card's leaves
        equal the CPU's) and the config ``llm_quant="int8"``.  The base must
        be unquantized (else ValueError, and the adapters stay).  A no-op
        without adapters.  Exact at inference; do not train or save a
        checkpoint afterwards."""
        lora = self.params.get("lora")
        if lora is None:
            return
        with torch.no_grad():
            merged = tllm.merge_lora(self.params["llm"], lora,
                                     self.config.lora_scale)
            if quantize:
                merged = quantize_llm_params(merged)
        # the adapters go only once the merge succeeded
        self.params["llm"] = merged
        del self.params["lora"]
        if quantize:
            self.config = dataclasses.replace(self.config, llm_quant="int8")

    def apply_llm_quant(self) -> None:
        """Replace the model's bf16 LLM with its int8 tree
        (``quantize_llm_params``; the bf16 weights are released) and make
        the config ``llm_quant="int8"``.  A no-op when the LLM already
        holds int8 leaves."""
        if is_quantized(self.params["llm"]["layers"]["wqkv"]):
            return
        if isinstance(self.params["llm"], ShardedLLM):
            raise ValueError("apply_llm_quant before apply_llm_sharding")
        with torch.no_grad():
            self.params["llm"] = quantize_llm_params(self.params["llm"])
        self.config = dataclasses.replace(self.config, llm_quant="int8")

    def apply_llm_sharding(self, mesh) -> None:
        """Cut the model's LLM for ``mesh`` once (``parallel/sharding``:
        tensor-parallel layer shards over its "model" axis, the rest
        replicated; the unsharded tree is released), so that ``generate()``
        under ``use_mesh(mesh)`` decodes through the tensor-parallel steps.
        The mesh's first device must be the model's: perception runs there
        and the spliced embeddings go from there to every rank.  Quantize
        first (:meth:`apply_llm_quant`): a cut LLM is not quantized again.
        A no-op when the LLM is already cut for ``mesh``."""
        llm = self.params["llm"]
        if isinstance(llm, ShardedLLM):
            if llm.mesh is not mesh:
                raise ValueError("the LLM is already cut for another mesh")
            return
        first = torch.empty(0, device=mesh.device(0, 0)).device
        if first != torch.empty(0, device=self.device).device:
            raise ValueError(f"the mesh's first device {mesh.device(0, 0)} is "
                             f"not the model's {self.device}")
        with torch.no_grad():
            self.params["llm"] = apply_llm_sharding(llm, self.llm_cfg, mesh)

    def apply_orca_xattn_quant(self) -> None:
        """Quantize the ORCA cross-attention stack for serving
        (``quantize_orca_cross_attns``; the float stack is released) and
        make the config ``orca_xattn_quant="int8"``: with an int8 LLM the
        decode and verify steps then run the injection inside their
        kernels.  A no-op without a stack or when it already holds int8
        leaves (the JAX package's ``_apply_orca_xattn_quant``)."""
        xa = self.params.get("orca_cross_attns")
        if xa is None or is_quantized(xa["layers"]["q"]):
            return
        with torch.no_grad():
            self.params["orca_cross_attns"] = quantize_orca_cross_attns(xa)
        self.config = dataclasses.replace(self.config,
                                          orca_xattn_quant="int8")

    def apply_inference_encoder_quant(self) -> None:
        """``encoder_quant="auto"`` resolves to int8 on the inference path
        (the JAX package's ``_apply_inference_encoder_quant``): quantize the
        frozen encoder ("dual" attention leaves, int8 FFN) unless it already
        holds int8 leaves.  A no-op for ``encoder_quant="none"``."""
        if self.config.resolved_encoder_quant(inference=True) != "int8":
            return
        enc = self.params["whisper"]["encoder"]
        if "q" in enc["layers"]["fc1"]:
            return
        with torch.no_grad():
            self.params["whisper"]["encoder"] = quantize_encoder_params(enc)

    def trainable_keys(self) -> Tuple[str, ...]:
        """The top-level param subtrees that train: everything but the LLM
        and Whisper (the reference's configure_trainable_parameters,
        ``desta.py:158-165`` of the JAX package)."""
        return tuple(k for k in self.params if k not in ("whisper", "llm"))

    def split_params(self):
        """(trainable, frozen) param trees, sharing the model's tensors."""
        trainable = {k: self.params[k] for k in self.trainable_keys()}
        frozen = {k: v for k, v in self.params.items() if k not in trainable}
        return trainable, frozen

    # -- persistence ------------------------------------------------------

    def save_pretrained(self, path: str) -> None:
        """``path/config.json`` and the trainable params as the reference's
        ``model.safetensors`` (``ckpt/desta_io.py``); the frozen towers are
        not written."""
        from ..ckpt.desta_io import save_trainable_safetensors
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(self.config.to_json())
        trainable, _ = self.split_params()
        save_trainable_safetensors(trainable, self.config,
                                   os.path.join(path, "model.safetensors"))

    def _load_frozen_towers(self, weights_root: str, warn: bool) -> None:
        from ..ckpt.desta_io import load_frozen_tower
        cfg = self.config
        for tower, model_id in (("whisper", cfg.encoder_model_id),
                                ("llm", cfg.llm_model_id)):
            quant = (cfg.llm_quant if tower == "llm"
                     else cfg.resolved_encoder_quant(inference=True))
            loaded = load_frozen_tower(tower, model_id, weights_root, cfg,
                                       self.dtype, self.device, quant=quant)
            if loaded is not None:
                self.params[tower] = loaded
            elif warn:
                logger.warning("no local weights for %s (%s); keeping "
                               "random init", tower, model_id)

    @classmethod
    def from_pretrained(cls, path: str, device,
                        weights_root: Optional[str] = None, seed: int = 0,
                        config_overrides: Optional[Dict[str, Any]] = None,
                        **kwargs) -> "DeSTA25AudioModel":
        """Load ``path/config.json`` and the trainable weights of
        ``path/model.safetensors`` onto ``device`` (the JAX package's
        ``from_pretrained``, ``desta.py:763-837``).  The frozen Whisper and
        LLM towers come from ``weights_root`` (or ``$DESTA_TPU_WEIGHTS``),
        built on ``device``; a tower without weights there keeps its random
        draw of ``seed``, with a warning.  ``config_overrides`` replaces
        config fields after ``config.json`` loads (e.g. ``{"encoder_quant":
        "none"}``).  A checkpoint whose ORCA tap count differs from the
        config's rebuilds the model with ``orca_use_all_layers`` set from
        it (the reference's shape-driven reconfiguration).  Then the ORCA
        stack is quantized where ``orca_xattn_quant="int8"`` and the
        encoder where ``encoder_quant`` resolves to int8 for inference.
        ``kwargs`` go to the constructor (``tokenizer``)."""
        from ..ckpt.desta_io import load_trainable_safetensors
        from ..ckpt.flat_io import SafetensorsFile
        with open(os.path.join(path, "config.json")) as f:
            config = DeSTA25Config.from_json(f.read())
        if config_overrides:
            config = dataclasses.replace(config, **config_overrides)
        model = cls(config, device, seed=seed, **kwargs)
        weights_root = weights_root or os.environ.get("DESTA_TPU_WEIGHTS")
        if weights_root:
            model._load_frozen_towers(weights_root, warn=True)
        st = os.path.join(path, "model.safetensors")
        if os.path.exists(st):
            try:
                model.params = load_trainable_safetensors(model.params,
                                                          config, st)
            except ValueError as e:
                if "tapped layers" not in str(e):
                    raise
                n_taps = SafetensorsFile(st).entries[
                    "perception.connector.global_layer_weights"]["shape"][1]
                all_layers = n_taps == config.encoder_config.encoder_layers
                logger.warning("checkpoint has %d tapped layers; "
                               "reconfiguring connector with "
                               "orca_use_all_layers=%s", n_taps, all_layers)
                config = dataclasses.replace(config,
                                             orca_use_all_layers=all_layers)
                model = cls(config, device, seed=seed, **kwargs)
                if weights_root:
                    model._load_frozen_towers(weights_root, warn=False)
                model.params = load_trainable_safetensors(model.params,
                                                          config, st)
        if config.orca_xattn_quant == "int8":
            model.apply_orca_xattn_quant()
        model.apply_inference_encoder_quant()
        return model

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            self._tokenizer = build_tokenizer(
                self.config.llm_model_id, self.placeholder_token,
                chat_template=self.llm_cfg.chat_template)
        return self._tokenizer

    @property
    def whisper_tokenizer(self):
        """The ASR detokenizer: :class:`_CharASR` for ``test/`` encoders,
        else the encoder's HF ``AutoProcessor``, loaded on first use."""
        if self._whisper_tokenizer is None:
            if self.config.encoder_model_id.startswith("test/"):
                self._whisper_tokenizer = _CharASR()
            else:
                from transformers import AutoProcessor
                self._whisper_tokenizer = AutoProcessor.from_pretrained(
                    self.config.encoder_model_id)
        return self._whisper_tokenizer

    # -- device programs --------------------------------------------------

    def _mel(self, audio_batch: np.ndarray) -> torch.Tensor:
        """[N, samples] -> [N, frames, n_mels] log-mel in the model dtype."""
        a = torch.as_tensor(audio_batch, dtype=torch.float32,
                            device=self.device)
        x = pad_or_trim(a, self.enc_cfg.expected_mel_frames * 160)
        return log_mel(x, self.enc_cfg.num_mel_bins, layout="btm").to(
            self.dtype)

    def _asr(self, audio_batch: np.ndarray, max_new_tokens: int = 128,
             timings: Optional[Dict[str, float]] = None) -> List[str]:
        """Transcribe [N, samples] on the model's device: its own mel and
        encoder pass, then the Whisper decoder (the JAX package's ``_asr``,
        ``desta.py:212-241``).  A real checkpoint's vocab blanks the
        special-token block, the non-speech ids and, at the first token, a
        bare space; the ``test/`` vocabs keep every id.  With
        ``asr_fallback`` set the temperature cascade runs.  timings, if
        given, gets ``asr_ms`` (host clock, device synchronised: mel,
        encoder, cross K/V and decode), ``asr_steps`` (decoder steps after
        the prefix, all tiers) and ``asr_decode_ms`` (those steps' share of
        ``asr_ms``)."""
        t0 = time.perf_counter()
        mel = self._mel(audio_batch)
        if self.config.encoder_model_id.startswith("test/"):
            sup: Dict[str, Any] = dict(suppress_from=None)
        else:
            sup = dict(suppress_from=self.enc_cfg.decoder_start_token_id,
                       suppress_ids=WHISPER_NON_SPEECH_TOKEN_IDS,
                       begin_suppress_ids=WHISPER_BEGIN_SUPPRESS_TOKEN_IDS)
        stats: Dict[str, Any] = {}
        whisper = self.params["whisper"]
        if "decoder" not in whisper:
            raise ValueError("ASR needs params['whisper']['decoder'], which "
                             "these params lack")
        if self.asr_fallback is not None:
            texts, _, _ = whisper_transcribe_with_fallback(
                whisper, self.enc_cfg, mel, self._asr_detokenize,
                max_new_tokens=max_new_tokens, stats=stats, **sup,
                **self.asr_fallback)
        else:
            ids, _ = whisper_transcribe(whisper, self.enc_cfg, mel,
                                        max_new_tokens=max_new_tokens,
                                        stats=stats, **sup)
            texts = self._asr_detokenize(ids.cpu().numpy())
        self.last_asr_retried = stats.get("asr_retried", [])
        if timings is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings["asr_ms"] = (timings.get("asr_ms", 0.0)
                                 + (time.perf_counter() - t0) * 1e3)
            for k in ("asr_steps", "asr_decode_ms"):
                timings[k] = timings.get(k, 0) + stats[k]
        return texts

    def _asr_detokenize(self, ids) -> List[str]:
        return self.whisper_tokenizer.batch_decode(
            np.asarray(ids), skip_special_tokens=True)

    def prepare_inputs_embeds(self, input_ids, mel, trans_ids, kind, aidx,
                              pos):
        """Perception + splice -> (inputs_embeds [B, T, D], aux), aux =
        (audio tokens, ORCA local tokens or None) per clip."""
        llm = self.params["llm"]
        text_embeds = tllm.embed_tokens(llm, input_ids)
        audio_feats, local_tokens = perception_apply(self.params, mel,
                                                     self.config)
        trans_embeds = tllm.embed_tokens(llm, trans_ids)
        embeds = apply_splice(text_embeds, audio_feats, trans_embeds, kind,
                              aidx, pos)
        return embeds, (audio_feats, local_tokens)

    def prepare_inputs_embeds_from_feats(self, input_ids, audio_feats,
                                         trans_ids, kind, aidx, pos):
        """The splice alone, on per-clip connector tokens [N, K, D] that
        perception made earlier (the feature cache's path)."""
        llm = self.params["llm"]
        return apply_splice(tllm.embed_tokens(llm, input_ids), audio_feats,
                            tllm.embed_tokens(llm, trans_ids), kind, aidx,
                            pos)

    def enable_audio_cache(self, capacity: int = 64) -> None:
        """Turn on the per-clip feature cache (``models/feature_cache.py``:
        hits skip file decode, VAD, ASR and perception); a capacity of 0 or
        less turns it off.  A cache of the same capacity is kept."""
        if capacity <= 0:
            self.audio_cache = None
        elif (self.audio_cache is None
              or self.audio_cache.capacity != capacity):
            self.audio_cache = AudioFeatureCache(capacity)

    def _orca_inject_tokens(self, aux):
        """The deep-injection tokens [N, Ta, D] from perception's aux, or
        None (``models/orca.orca_inject_tokens``)."""
        if aux is None:
            return None
        return orca_inject_tokens(self.config, self.params, *aux)

    # -- generate ---------------------------------------------------------

    def generate(self, messages, temperature: float = 0.7,
                 top_p: float = 0.9, do_sample: bool = True,
                 max_new_tokens: int = 512,
                 auto_chunk_long_audio: bool = False,
                 speculative_k: int = 0) -> GenerationOutput:
        """Reference-compatible inference entry point
        (modeling_desta25.py:1491-1721).  ``speculative_k >= 2`` decodes
        with n-gram drafts verified ``speculative_k`` tokens at a time
        (``generate/speculative.py``); below 2, one token a step.

        auto_chunk_long_audio: clips longer than Whisper's 30 s window and
        without a transcription are split into overlapping windows, spliced
        as consecutive audio blocks (``audio/chunking.py``; the reference
        truncates at 30 s).  The chunks' temporary WAVs are removed before
        the call returns."""
        if isinstance(messages, list):
            messages_list = ([messages] if isinstance(messages[0], dict)
                             else messages)
        else:
            raise ValueError(
                "messages should be a list of dicts or a list of lists.")
        cleanup_paths: List[str] = []
        try:
            if auto_chunk_long_audio:
                messages_list = self._chunk_long_audios(messages_list,
                                                        cleanup_paths)
            with torch.no_grad():
                return self._generate_impl(messages_list, temperature,
                                           top_p, do_sample, max_new_tokens,
                                           speculative_k)
        finally:
            for path in cleanup_paths:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _chunk_long_audios(self, messages_list, cleanup_paths: List[str]):
        """Split each clip over 30 s that has no transcription into window
        chunks (temporary WAVs, their paths appended to ``cleanup_paths``),
        and repeat its locator once per chunk (the JAX package's
        ``_chunk_long_audios``)."""
        out_list = []
        for msgs in messages_list:
            new_msgs = []
            for message in msgs:
                audios = message.get("audios", [])
                if not audios:
                    new_msgs.append(message)
                    continue
                new_audios, n_chunks = [], []
                for audio in audios:
                    if audio.get("text") is not None:
                        new_audios.append(audio)
                        n_chunks.append(1)
                        continue
                    seg = AudioSegment.from_file(
                        audio["audio"], target_sr=16000,
                        channel_selector="average")
                    if seg.num_samples <= WINDOW:
                        new_audios.append(audio)
                        n_chunks.append(1)
                        continue
                    chunks = chunk_audio(seg.samples)
                    for c in chunks:
                        fd, path = tempfile.mkstemp(suffix=".wav")
                        os.close(fd)
                        cleanup_paths.append(path)
                        write_wav(path, c)
                        new_audios.append({"audio": path, "text": None})
                    n_chunks.append(len(chunks))
                content = expand_message_for_chunks(
                    message["content"], self.audio_locator, n_chunks)
                new_msgs.append({**message, "content": content,
                                 "audios": new_audios})
            out_list.append(new_msgs)
        return out_list

    def _run_generation_phases(self, messages_list,
                               timings: Dict[str, float],
                               return_prompt_ids: bool = False):
        """Host phases A+B (ASR on the device within A) and device
        perception/splice.  Returns None for a text-only batch, else
        (embeds, attn_mask, aux, audios, transcripts), aux = (audio tokens,
        ORCA local tokens or None) per clip, plus, with
        ``return_prompt_ids``, the prompt ids [B, T] (numpy) with each
        transcription's ids at its splice positions -- the text the model is
        most likely to echo, which n-gram drafting feeds on
        (``desta.py:593-602`` of the JAX package).  Records in timings
        ``host_ms`` (phases A+B without the ASR), ``asr_ms`` and
        ``asr_steps`` where ASR ran (:meth:`_asr`), and ``perception_ms``
        (mel, encoder, connector and splice, device synchronised)."""
        t0 = time.perf_counter()
        tk = self.tokenizer
        all_audios: List[str] = []
        all_transcriptions: List[Optional[str]] = []
        for msgs in messages_list:
            for message in msgs:
                content = message["content"]
                audios = message.get("audios", [])
                assert len(audios) == content.count(self.audio_locator), \
                    "audio count does not match (<|AUDIO|>) count"
                for audio in audios:
                    all_audios.append(audio["audio"])
                    all_transcriptions.append(audio.get("text"))
        if not all_audios:
            return None

        # --- phase A: audio decode + VAD + ASR ---------------------------
        # (with the feature cache on, a hit skips the decode and the VAD,
        # and the ASR once the entry holds a transcription)
        N = len(all_audios)
        cache = self.audio_cache
        keys: List[Any] = [None] * N
        centries: List[Optional[Dict[str, Any]]] = [None] * N
        samples: List[Optional[np.ndarray]] = [None] * N
        speech_flags = [True] * N

        def load(i):
            if samples[i] is None:
                samples[i] = AudioSegment.from_file(
                    all_audios[i], target_sr=16000,
                    channel_selector="average").samples
            return samples[i]

        asr_indices: List[int] = []
        for i, (path, trans) in enumerate(zip(all_audios,
                                              all_transcriptions)):
            if not os.path.exists(path):
                raise ValueError(f"Audio file {path} does not exist.")
            if cache is not None:
                keys[i] = cache.key(path)
                centries[i] = cache.get(keys[i])
            speech = (centries[i]["speech"] if centries[i] is not None
                      else has_speech(load(i)))
            speech_flags[i] = speech
            if not speech:
                all_transcriptions[i] = " "
            elif trans is None:
                hit_text = (centries[i] or {}).get("asr_text")
                if hit_text is not None:
                    all_transcriptions[i] = hit_text
                else:
                    # a hit without a transcription yet fills it now
                    asr_indices.append(i)
        max_len = self.enc_cfg.expected_mel_frames * 160

        def audio_batch(idxs, pad_to=None):
            ab = np.zeros((pad_to or len(idxs), max_len), np.float32)
            for j, i in enumerate(idxs):
                s = load(i)
                ab[j, :min(len(s), max_len)] = s[:max_len]
            return ab

        asr_ms = 0.0
        if asr_indices:
            texts = self._asr(audio_batch(asr_indices), timings=timings)
            asr_ms = timings["asr_ms"]
            for i, text in zip(asr_indices, texts):
                all_transcriptions[i] = text.strip()
                if centries[i] is not None:
                    centries[i]["asr_text"] = text.strip()

        # --- phase B: tokenize + expand + splice maps --------------------
        K = self.config.audio_token_size
        audio_size_list = [K] * N
        transcription_size_list = [
            len(tk.tokenize(t, add_special_tokens=False))
            for t in all_transcriptions]
        context_list: List[str] = []
        start_positions_list: List[List[int]] = []
        consumed = 0
        for msgs in messages_list:
            ctx = tk.apply_chat_template(msgs, tokenize=False,
                                         add_generation_prompt=True)
            ctx = ctx.replace(
                self.audio_locator,
                f"<start_audio>{self.audio_locator}<end_audio>")
            n_here = ctx.count(self.audio_locator)
            toks, starts = expand_audio_placeholders(
                tk.tokenize(ctx), self.audio_locator,
                audio_size_list[consumed:consumed + n_here],
                transcription_size_list[consumed:consumed + n_here],
                self.placeholder_token)
            consumed += n_here
            context_list.append(tk.convert_tokens_to_string(toks))
            start_positions_list.append(starts)

        enc = tk(context_list, padding="longest", truncation=True,
                 add_special_tokens=False)
        input_ids = np.asarray(enc["input_ids"], np.int64)
        attn_mask = np.asarray(enc["attention_mask"], np.int32)
        B, T = input_ids.shape
        entries = []
        audio_idx = 0
        for b in range(B):
            pad_len = int(T - attn_mask[b].sum())
            for s in start_positions_list[b]:
                entries.append(SpliceEntry(
                    batch_idx=b, start=s + pad_len, audio_idx=audio_idx,
                    audio_size=K,
                    trans_len=transcription_size_list[audio_idx]))
                audio_idx += 1
        kind, aidx, pos = build_splice_maps(B, T, entries)
        trans_max = max(1, _round_up(max(transcription_size_list + [1]), 8))
        trans_ids = np.zeros((N, trans_max), np.int64)
        for i, t in enumerate(all_transcriptions):
            ids = tk.encode(t, add_special_tokens=False)[:trans_max]
            trans_ids[i, :len(ids)] = ids

        # --- phase C: device ----------------------------------------------
        timings["host_ms"] = (time.perf_counter() - t0) * 1e3 - asr_ms
        t0 = time.perf_counter()
        dev = self.device
        as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        maps = (as_dev(trans_ids), as_dev(kind), as_dev(aidx), as_dev(pos))
        if cache is None:
            # one pass: perception over every clip, then the splice
            embeds, aux = self.prepare_inputs_embeds(
                as_dev(input_ids), self._mel(audio_batch(range(N))), *maps)
        else:
            # perception over the misses only, padded to a power of two
            # (the JAX package compiles for a handful of shapes; here the
            # padding keeps the encoder's batch, and so its attention arm,
            # the JAX package's), then the splice over every clip's tokens
            miss = [i for i in range(N) if centries[i] is None]
            if miss:
                P = 1 << (len(miss) - 1).bit_length()
                feats_m, local_m = perception_apply(
                    self.params, self._mel(audio_batch(miss, pad_to=P)),
                    self.config)
                asr_set = set(asr_indices)
                for j, i in enumerate(miss):
                    entry = {"speech": speech_flags[i],
                             "asr_text": (all_transcriptions[i]
                                          if i in asr_set else None),
                             "feats": feats_m[j].clone(),
                             "local": (None if local_m is None
                                       else local_m[j].clone())}
                    cache.put(keys[i], entry)
                    centries[i] = entry
            audio_feats = torch.stack([e["feats"] for e in centries])
            local_tokens = (None if centries[0]["local"] is None else
                            torch.stack([e["local"] for e in centries]))
            aux = (audio_feats, local_tokens)
            embeds = self.prepare_inputs_embeds_from_feats(
                as_dev(input_ids), audio_feats, *maps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["perception_ms"] = (time.perf_counter() - t0) * 1e3
        out = (embeds, as_dev(attn_mask), aux, all_audios,
               all_transcriptions)
        if return_prompt_ids:
            # pos at audio-token slots runs past trans_max: clamp before the
            # gather (np.where evaluates both arms)
            pos_c = np.minimum(pos, trans_ids.shape[1] - 1)
            out += (np.where(kind == 2, trans_ids[aidx, pos_c], input_ids),)
        return out

    def _prepare_generation_inputs(self, messages_list):
        """Host phases A+B and device perception and splice for a batch of
        conversations: the serving engine's entry point (the JAX package's
        ``_prepare_generation_inputs``, ``desta.py:381-413``), through the
        feature cache when it is on.  Returns (inputs_embeds [B, T, D],
        attention_mask [B, T] int32 on the device, ORCA's injection tokens
        [B, Ta, D] or None, prompt ids [B, T] host int32 with each
        transcription's ids at its splice positions).  A text-only batch
        takes the chat-template path (modeling_desta25.py:1686-1703)."""
        with torch.no_grad():
            prep = self._run_generation_phases(messages_list, {},
                                               return_prompt_ids=True)
            if prep is None:
                embeds, mask, ids = self._chat_inputs(messages_list)
                return embeds, mask, None, ids.astype(np.int32)
            embeds, mask, aux, _, _, prompt_ids = prep
            return (embeds, mask, self._orca_inject_tokens(aux),
                    np.asarray(prompt_ids, np.int32))

    def _chat_inputs(self, messages_list):
        """A text-only batch's inputs (modeling_desta25.py:1686-1703): the
        chat template's left-padded ids [B, T] (numpy int64), their
        embeddings and the mask on the model's device."""
        tk = self.tokenizer
        texts = tk.apply_chat_template(messages_list, tokenize=False,
                                       add_generation_prompt=True)
        if isinstance(texts, str):
            texts = [texts]
        enc = tk(texts, padding="longest", add_special_tokens=False)
        ids = np.asarray(enc["input_ids"], np.int64)
        embeds = tllm.embed_tokens(self.params["llm"],
                                   torch.as_tensor(ids, device=self.device))
        mask = torch.as_tensor(np.asarray(enc["attention_mask"], np.int32),
                               device=self.device)
        return embeds, mask, ids

    def _terminators(self) -> Tuple[int, ...]:
        tk = self.tokenizer
        terms = {tk.eos_token_id}
        for tok in ("<|eot_id|>", "<|im_end|>", "<|end_of_text|>",
                    "<|endoftext|>"):
            try:
                tid = tk.convert_tokens_to_ids(tok)
            except (KeyError, ValueError, TypeError):
                continue  # not a single token of this tokenizer
            if tid is not None and tid >= 0:
                terms.add(int(tid))
        return tuple(sorted(terms))

    def _spec_eligible(self, speculative_k: int, B: int, T: int,
                       max_new_tokens: int, inject_kwargs=None) -> bool:
        """Does this request take the speculative loop?  Below 2 tokens per
        step it does not.  At 2 or more it does unless the verify kernel
        cannot take the request (``spec_limits``, ORCA's included: the
        verify step injects inside the kernel, which needs the int8 stack
        and the int8 LLM); then the plain loop runs, as the JAX package's
        ``_spec_eligible`` falls back (``desta.py:607-633``), and the
        reasons are logged and kept in ``last_spec_fallback``.  Under LoRA
        (``desta.py:617``) the plain loop runs too: no verify step takes the
        adapters."""
        self.last_spec_fallback = []
        if speculative_k < 2:
            return False
        if self.params.get("lora") is not None:
            self.last_spec_fallback = [
                "LoRA adapters (merge_lora_for_serving folds them in)"]
            logger.info("speculative_k=%d under LoRA: decoding one token a "
                        "step", speculative_k)
            return False
        inj = inject_kwargs or {}
        bad = spec_limits(self.params["llm"], self.llm_cfg, B,
                          spec_cache_len(T, max_new_tokens, speculative_k),
                          speculative_k, self.dtype,
                          inject_params=inj.get("inject_params"),
                          inject_heads=inj.get("inject_heads", 0),
                          inject_len=(inj["inject_tokens"].shape[1]
                                      if inj else 0))
        if bad:
            self.last_spec_fallback = bad
            logger.info("speculative_k=%d: the verify kernel cannot take "
                        "this request, decoding one token a step: %s",
                        speculative_k, "; ".join(bad))
            return False
        return True

    def _generate_impl(self, messages_list, temperature, top_p, do_sample,
                       max_new_tokens, speculative_k: int = 0
                       ) -> GenerationOutput:
        tk = self.tokenizer
        timings: Dict[str, float] = {}
        prep = self._run_generation_phases(messages_list, timings,
                                           return_prompt_ids=True)
        if prep is None:  # text-only chat (modeling_desta25.py:1686-1721)
            embeds, attn_mask, prompt_ids = self._chat_inputs(messages_list)
            audios, transcripts, aux = [], [], None
        else:
            embeds, attn_mask, aux, audios, transcripts, prompt_ids = prep
        B, T = embeds.shape[:2]
        common = dict(max_new_tokens=max_new_tokens, temperature=temperature,
                      top_p=top_p, do_sample=do_sample,
                      eos_ids=self._terminators(), pad_id=tk.pad_token_id,
                      timings=timings)
        lora = dict(lora=self.params.get("lora"),
                    lora_scale=self.config.lora_scale)
        inject_tokens = self._orca_inject_tokens(aux)
        inject_kwargs = {}
        if inject_tokens is not None:
            if inject_tokens.shape[0] != B:
                raise NotImplementedError(
                    f"ORCA injection takes one clip per conversation, got "
                    f"{inject_tokens.shape[0]} clips for {B} rows")
            inject_kwargs = dict(
                inject_params=self.params["orca_cross_attns"],
                inject_tokens=inject_tokens,
                inject_scale=self.config.orca_audio_position_scale,
                inject_heads=self.llm_cfg.num_attention_heads)
        common.update(inject_kwargs)
        if self._spec_eligible(speculative_k, B, T, max_new_tokens,
                               inject_kwargs):
            # left-padded rows -> left-aligned n-gram history
            lens = attn_mask.sum(1).cpu().numpy()
            tokens, _ = llm_generate_spec(
                self.params["llm"], self.llm_cfg, embeds, attn_mask,
                self.generator, speculative_k=speculative_k,
                prompt_ids=torch.as_tensor(left_aligned(prompt_ids, lens),
                                           device=self.device),
                prompt_lens=torch.as_tensor(lens, device=self.device),
                **common)
        else:
            tokens, _ = llm_generate(
                self.params["llm"], self.llm_cfg, embeds, attn_mask,
                self.generator, **common, **lora)
        self.last_timings = timings
        tokens = tokens.cpu().numpy()
        return GenerationOutput(
            text=tk.batch_decode(tokens, skip_special_tokens=True),
            audios=[(a, t) for a, t in zip(audios, transcripts)],
            generated_ids=tokens.tolist(),
        )
