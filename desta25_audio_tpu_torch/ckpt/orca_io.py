"""ORCA trainable-checkpoint key maps, reference <-> the port's trees
(counterpart of ``desta25_audio_tpu/ckpt/orca_io.py``).

Reference key space (``ORCAHybridConnector``, modeling_desta25.py:208-357,
and the ``orca_cross_attns`` ModuleList, :1101-1141):

- perception.connector.global_queries.{i}            [1, K, d_enc]
- perception.connector.global_layer_weights          [K, n_taps]
- perception.connector.global_qformer.layer.{i}.*    (BertEncoder keys)
- perception.connector.global_proj.{0,1}.*           (LayerNorm, Linear)
- perception.connector.local_layer_weights           [n_taps]
- perception.connector.local_proj_in.*               Linear
- perception.connector.local_conv.*                  Conv1d [out, in, k]
- perception.connector.local_ln.*                    LayerNorm
- orca_cross_attns.{i}.cross_attn.{in_proj_weight,in_proj_bias,
  out_proj.weight,out_proj.bias}                     torch MultiheadAttention
- orca_cross_attns.{i}.gate_proj.{0,2}.*             gate MLP
- orca_cross_attns.{i}.ln.*                          LayerNorm

The port stores linears ``[out, in]`` and convs ``[out, in, k]`` as torch
does, so only the layer axis is unstacked or stacked.  Legacy ``ocar_*``
keys are renamed by ``desta_io.load_trainable_safetensors`` before this
module sees them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import DeSTA25Config
from .hf_convert import _map, _stacked, convert_bert_encoder_state

_PRE = "perception.connector"
_BERT_ATTN = (("q", "self.query"), ("k", "self.key"), ("v", "self.value"),
              ("o", "output.dense"))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float()


# -- BERT layers <-> reference keys ------------------------------------------------

def _bert_to_ref(tree: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    layers = tree["layers"]

    def put(key, leaf, i):
        out[f"{key}.weight"] = _f32(leaf["w"][i])
        out[f"{key}.bias"] = _f32(leaf["b"][i])

    for i in range(layers["inter"]["w"].shape[0]):
        p = f"{prefix}.layer.{i}"
        for block, name in ((layers["self"], "attention"),
                            (layers["cross"], "crossattention")):
            for ours, theirs in _BERT_ATTN:
                put(f"{p}.{name}.{theirs}", block[ours], i)
            out[f"{p}.{name}.output.LayerNorm.weight"] = _f32(
                block["ln"]["scale"][i])
            out[f"{p}.{name}.output.LayerNorm.bias"] = _f32(
                block["ln"]["bias"][i])
        put(f"{p}.intermediate.dense", layers["inter"], i)
        put(f"{p}.output.dense", layers["out"], i)
        out[f"{p}.output.LayerNorm.weight"] = _f32(layers["out_ln"]["scale"][i])
        out[f"{p}.output.LayerNorm.bias"] = _f32(layers["out_ln"]["bias"][i])
    return out


def _bert_from_ref(sd: Dict[str, torch.Tensor], prefix: str, n_layers: int,
                   device) -> Dict[str, Any]:
    sub = {k[len(prefix) + 1:]: v for k, v in sd.items()
           if k.startswith(prefix + ".")}
    return convert_bert_encoder_state(sub, n_layers, device=device)


def _lin_to_ref(leaf, key: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{key}.weight"] = _f32(leaf["w"])
    out[f"{key}.bias"] = _f32(leaf["b"])


def _ln_to_ref(leaf, key: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{key}.weight"] = _f32(leaf["scale"])
    out[f"{key}.bias"] = _f32(leaf["bias"])


def _lin_from_ref(sd, key: str, device) -> Dict[str, torch.Tensor]:
    return {"w": sd[f"{key}.weight"].to(device),
            "b": sd[f"{key}.bias"].to(device)}


def _ln_from_ref(sd, key: str, device) -> Dict[str, torch.Tensor]:
    return {"scale": sd[f"{key}.weight"].to(device),
            "bias": sd[f"{key}.bias"].to(device)}


def _device(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


# -- ORCA connector and cross-attention stack <-> reference keys -------------------

def orca_to_ref(trainable: Dict[str, Any],
                config: DeSTA25Config) -> Dict[str, torch.Tensor]:
    """The ORCA connector and its cross-attention stack -> the reference's
    keys (``ckpt/orca_io.py`` of the JAX package): ``global_queries.{i}``
    [1, K, d_enc], ``global_layer_weights`` [K, n_taps], the global
    Q-Former's BERT keys, ``global_proj.{0,1}``, the local branch where the
    model has one, and per LLM layer ``orca_cross_attns.{i}`` with q/k/v
    packed into torch MultiheadAttention's ``in_proj``."""
    out: Dict[str, torch.Tensor] = {}
    c = trainable["connector"]
    gq = c["global_queries"]
    for i in range(gq.shape[0]):
        out[f"{_PRE}.global_queries.{i}"] = _f32(gq[i:i + 1])
    out[f"{_PRE}.global_layer_weights"] = _f32(c["global_layer_weights"])
    out.update(_bert_to_ref(c["global_qformer"], f"{_PRE}.global_qformer"))
    _ln_to_ref(c["global_proj_ln"], f"{_PRE}.global_proj.0", out)
    _lin_to_ref(c["global_proj"], f"{_PRE}.global_proj.1", out)
    if "local_layer_weights" in c:
        out[f"{_PRE}.local_layer_weights"] = _f32(c["local_layer_weights"])
        _lin_to_ref(c["local_proj_in"], f"{_PRE}.local_proj_in", out)
        _lin_to_ref(c["local_conv"], f"{_PRE}.local_conv", out)  # [o, i, k]
        _ln_to_ref(c["local_ln"], f"{_PRE}.local_ln", out)

    if "orca_cross_attns" in trainable:
        lay = trainable["orca_cross_attns"]["layers"]
        for i in range(lay["ln"]["scale"].shape[0]):
            pre = f"orca_cross_attns.{i}"
            out[f"{pre}.cross_attn.in_proj_weight"] = torch.cat(
                [_f32(lay[k]["w"][i]) for k in ("q", "k", "v")])
            out[f"{pre}.cross_attn.in_proj_bias"] = torch.cat(
                [_f32(lay[k]["b"][i]) for k in ("q", "k", "v")])
            for ours, theirs in (("o", "cross_attn.out_proj"),
                                 ("gate1", "gate_proj.0"),
                                 ("gate2", "gate_proj.2")):
                out[f"{pre}.{theirs}.weight"] = _f32(lay[ours]["w"][i])
                out[f"{pre}.{theirs}.bias"] = _f32(lay[ours]["b"][i])
            out[f"{pre}.ln.weight"] = _f32(lay["ln"]["scale"][i])
            out[f"{pre}.ln.bias"] = _f32(lay["ln"]["bias"][i])
    return out


def orca_from_ref(params: Dict[str, Any], sd: Dict[str, torch.Tensor],
                  config: DeSTA25Config) -> Dict[str, Any]:
    """Reference-keyed tensors -> the ORCA connector (and the stack, where
    both the file and ``params`` have one).  A checkpoint whose tap count
    differs from the model's raises ValueError ("tapped layers"), which
    ``from_pretrained`` answers by reconfiguring the connector."""
    params = dict(params)
    c = dict(params["connector"])
    dev = _device(c)
    n_taps_ckpt = sd[f"{_PRE}.global_layer_weights"].shape[1]
    n_taps_ours = c["global_queries"].shape[0]
    if n_taps_ckpt != n_taps_ours:
        raise ValueError(
            f"checkpoint has {n_taps_ckpt} tapped layers but config expects "
            f"{n_taps_ours}; set orca_use_all_layers accordingly")
    c["global_queries"] = torch.stack(
        [sd[f"{_PRE}.global_queries.{i}"][0]
         for i in range(n_taps_ckpt)]).to(dev)
    c["global_layer_weights"] = sd[f"{_PRE}.global_layer_weights"].to(dev)
    c["global_qformer"] = _bert_from_ref(
        sd, f"{_PRE}.global_qformer",
        c["global_qformer"]["layers"]["inter"]["w"].shape[0], dev)
    c["global_proj_ln"] = _ln_from_ref(sd, f"{_PRE}.global_proj.0", dev)
    c["global_proj"] = _lin_from_ref(sd, f"{_PRE}.global_proj.1", dev)
    if f"{_PRE}.local_layer_weights" in sd:
        c["local_layer_weights"] = sd[f"{_PRE}.local_layer_weights"].to(dev)
        c["local_proj_in"] = _lin_from_ref(sd, f"{_PRE}.local_proj_in", dev)
        c["local_conv"] = _lin_from_ref(sd, f"{_PRE}.local_conv", dev)
        c["local_ln"] = _ln_from_ref(sd, f"{_PRE}.local_ln", dev)
    params["connector"] = c

    if "orca_cross_attns.0.ln.weight" in sd and "orca_cross_attns" in params:
        xa = params["orca_cross_attns"]["layers"]
        n, dev = xa["ln"]["scale"].shape[0], _device(xa)

        def layer(i):
            pre = f"orca_cross_attns.{i}"
            ipw = sd[f"{pre}.cross_attn.in_proj_weight"]
            ipb = sd[f"{pre}.cross_attn.in_proj_bias"]
            d = ipw.shape[1]
            out = {k: {"w": ipw[j * d:(j + 1) * d], "b": ipb[j * d:(j + 1) * d]}
                   for j, k in enumerate(("q", "k", "v"))}
            for ours, theirs in (("o", "cross_attn.out_proj"),
                                 ("gate1", "gate_proj.0"),
                                 ("gate2", "gate_proj.2")):
                out[ours] = _lin_from_ref(sd, f"{pre}.{theirs}", dev)
            out["ln"] = _ln_from_ref(sd, f"{pre}.ln", dev)
            return out

        params["orca_cross_attns"] = {"layers": _stacked(
            n, lambda i: _map(lambda t: t.to(dev), layer(i)))}
    return params
