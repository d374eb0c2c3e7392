"""Trainable-only checkpoints in the reference's key space, and the frozen
towers (counterpart of ``desta25_audio_tpu/ckpt/desta_io.py``).

The reference saves only its trainable params to ``model.safetensors``
(modeling_desta25.py:1284-1292), torch-named and ``[out, in]``, e.g.
``perception.connector.qformer.layer.0.attention.self.query.weight``.  The
port stores linears ``[out, in]`` too, so the maps here only rename and
unstack (or stack) the layer axis, in both directions:

- a reference checkpoint loads into the port (:func:`load_trainable_safetensors`,
  the legacy ``ocar_`` prefixes renamed ``orca_``);
- a model trained here exports a file the reference and the JAX package
  load (:func:`save_trainable_safetensors`);
- LoRA adapters travel in both directions under peft's key names
  (``ckpt/lora_io.py``; the JAX package's ``desta_io.py:165-167,191-193``).

The frozen towers come from ``weights_root/<model_id>/``
(:func:`load_frozen_tower`): the port's staged files
(``ckpt/hf_convert.py``), else the JAX package's staged files carried over
by ``ckpt/bridge.py``, else the raw HF shards, converted on the target
device.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import torch

from ..config import DeSTA25Config
from .flat_io import load_safetensors, save_safetensors
from .hf_convert import _map
from .lora_io import lora_from_ref, lora_to_ref
from .orca_io import (
    _PRE,
    _bert_from_ref,
    _bert_to_ref,
    _device,
    _f32,
    _lin_from_ref,
    _lin_to_ref,
    _ln_from_ref,
    _ln_to_ref,
    orca_from_ref,
    orca_to_ref,
)

logger = logging.getLogger(__name__)


# -- Q-Former connector <-> reference keys ------------------------------------------

def _qformer_to_ref(connector: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    lp = connector["layer_prompts"]
    for i in range(lp.shape[0]):
        out[f"{_PRE}.layer_prompts.{i}"] = _f32(lp[i:i + 1])   # [1, K, d]
    out[f"{_PRE}.layer_weights"] = _f32(connector["layer_weights"])
    out.update(_bert_to_ref(connector["qformer"], f"{_PRE}.qformer"))
    _ln_to_ref(connector["proj_ln"], f"{_PRE}.proj.0", out)
    _lin_to_ref(connector["proj"], f"{_PRE}.proj.1", out)
    return out


def _qformer_from_ref(connector: Dict[str, Any],
                      sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A new connector tree from reference-keyed tensors, on the device
    of ``connector`` (whose tap and layer counts it takes)."""
    dev = _device(connector)
    n_taps = connector["layer_prompts"].shape[0]
    n_layers = connector["qformer"]["layers"]["inter"]["w"].shape[0]
    return {
        **connector,
        "layer_prompts": torch.stack([sd[f"{_PRE}.layer_prompts.{i}"][0]
                                      for i in range(n_taps)]).to(dev),
        "layer_weights": sd[f"{_PRE}.layer_weights"].to(dev),
        "qformer": _bert_from_ref(sd, f"{_PRE}.qformer", n_layers, dev),
        "proj_ln": _ln_from_ref(sd, f"{_PRE}.proj.0", dev),
        "proj": _lin_from_ref(sd, f"{_PRE}.proj.1", dev),
    }


# -- public API ------------------------------------------------------------------

def trainable_state_dict(trainable: Dict[str, Any],
                         config: DeSTA25Config) -> Dict[str, torch.Tensor]:
    """The port's trainable tree -> reference-named f32 ``[out, in]``
    tensors, on the tree's device (meta tensors give keys and shapes
    without data); LoRA adapters under peft's names (``ckpt/lora_io.py``)."""
    out: Dict[str, torch.Tensor] = {}
    if config.connector_mode == "qformer_1":
        out.update(_qformer_to_ref(trainable["connector"]))
    elif config.connector_mode == "orca_hybrid":
        out.update(orca_to_ref(trainable, config))
    if "lora" in trainable:
        out.update(lora_to_ref(trainable["lora"], config))
    return out


def save_trainable_safetensors(trainable: Dict[str, Any],
                               config: DeSTA25Config, path: str) -> None:
    save_safetensors(trainable_state_dict(trainable, config), path)


def load_trainable_safetensors(params: Dict[str, Any],
                               config: DeSTA25Config,
                               path: str) -> Dict[str, Any]:
    """A reference-format ``model.safetensors`` into ``params`` (a new
    top-level dict; the frozen towers are shared)."""
    # the legacy-key rename (reference modeling_desta25.py:1294-1310)
    sd = {k.replace("ocar_", "orca_"): v
          for k, v in load_safetensors(path).items()}
    params = dict(params)
    with torch.no_grad():
        if config.connector_mode == "qformer_1":
            params["connector"] = _qformer_from_ref(params["connector"], sd)
        elif config.connector_mode == "orca_hybrid":
            params = orca_from_ref(params, sd, config)
        if "lora" in params and any("lora_A" in k for k in sd):
            params["lora"] = lora_from_ref(params["lora"], sd)
    return params


def _cast(tree, dtype):
    return _map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def load_frozen_tower(tower: str, model_id: str, weights_root: str,
                      config: DeSTA25Config, dtype, device,
                      quant: Optional[str] = None) -> Optional[Dict]:
    """A frozen tower (``"whisper"``: encoder and decoder; ``"llm"``) from
    ``weights_root/<model_id>/``, built on ``device``; None where the
    directory or its weights are missing.  Sources, in order:

    1. the port's staged files: ``desta_torch_int8.safetensors`` when
       ``quant="int8"`` asks for the LLM in int8, else
       ``desta_torch.safetensors``;
    2. the JAX package's ``desta_tpu_int8.safetensors`` /
       ``desta_tpu.safetensors``, carried over by ``ckpt/bridge.py``, so one
       weights root serves both packages;
    3. the raw HF shards (every ``*.safetensors`` that is no staged file),
       converted tensor by tensor.

    A float staged tree is cast to ``dtype``, or quantized on ``device``
    where int8 is asked for and no int8 file exists; a whisper tower with
    ``quant="int8"`` gets its encoder quantized ("dual" attention leaves),
    as the JAX package's loader does."""
    from . import bridge
    from .flat_io import load_tree_safetensors, shard_files
    from .hf_convert import (
        JAX_STAGED,
        JAX_STAGED_INT8,
        STAGED,
        STAGED_INT8,
        STAGED_NAMES,
        convert_llm_state,
        convert_whisper_state,
        load_safetensors_state,
    )
    from ..ops.quant import quantize_encoder_params, quantize_llm_params

    path = os.path.join(weights_root, model_id)
    if not os.path.isdir(path):
        return None
    want_int8 = tower == "llm" and quant == "int8"

    def port_tree(t):
        return t

    def jax_tree(t):
        if tower == "llm":
            return bridge.llm_from_jax(t, device)
        out = {"encoder": bridge.whisper_encoder_from_jax(t["encoder"],
                                                          device)}
        if "decoder" in t:
            out["decoder"] = bridge.whisper_decoder_from_jax(t["decoder"],
                                                             device)
        return out

    tree = None
    with torch.no_grad():
        for q_name, name, carry in ((STAGED_INT8, STAGED, port_tree),
                                    (JAX_STAGED_INT8, JAX_STAGED, jax_tree)):
            if want_int8 and os.path.exists(os.path.join(path, q_name)):
                tree = carry(load_tree_safetensors(os.path.join(path, q_name),
                                                   device))
                break
            if os.path.exists(os.path.join(path, name)):
                tree = carry(load_tree_safetensors(os.path.join(path, name),
                                                   device))
                if want_int8:
                    logger.warning("no pre-quantized %s in %s; quantizing on "
                                   "%s (stage with --int8 to skip this)",
                                   tower, path, device)
                    tree = quantize_llm_params(tree)
                else:
                    tree = _cast(tree, dtype)
                break
        if tree is None:
            if not shard_files(path, exclude=STAGED_NAMES):
                return None
            sd = load_safetensors_state(path, device, exclude=STAGED_NAMES)
            if tower == "whisper":
                tree = convert_whisper_state(sd, config.encoder_config, dtype,
                                             device)
            else:
                tree = convert_llm_state(sd, config.llm_config, dtype, device)
                if want_int8:
                    tree = quantize_llm_params(tree)
            sd.close()
        if tower == "whisper" and quant == "int8":
            tree = {**tree, "encoder": quantize_encoder_params(tree["encoder"])}
    return tree
