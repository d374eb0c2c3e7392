"""HF checkpoints -> the port's param trees, and the staging CLI.

Counterpart of ``desta25_audio_tpu/ckpt/hf_convert.py``.  Converts
PyTorch state dicts (safetensors shards read by ``ckpt/flat_io.py``, or
in-memory HF modules) for Whisper, Llama-3.x and Qwen3, and the BERT
Q-Former, straight into the port's layout (``ckpt/bridge.py``): linears
stay ``[out, in]`` and convs ``[out, in, k]`` as torch stores them, layers
stack on a leading axis, the LLM's q/k/v weights are fused into ``wqkv``
and its gate/up weights row-interleaved into ``w_gu``.  A leaf is read,
moved to ``device`` and cast there (through f32, as the JAX package reads
f16 and bf16), then copied into its stacked tensor, so a conversion holds
the finished tree and one layer's leaves, never a second copy of the
checkpoint.

Staged files are in the port's layout and so take names of their own,
``desta_torch.safetensors`` and ``desta_torch_int8.safetensors``; the JAX
package's ``desta_tpu*.safetensors`` hold its own layout and are read only
through ``ckpt/bridge.py`` (``ckpt/desta_io.load_frozen_tower``).

    python -m desta25_audio_tpu_torch.ckpt.hf_convert SRC WEIGHTS_ROOT \\
        [--model-id ID] [--int8] [--dtype bfloat16|float32]
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from ..config import LLMConfig, WhisperConfig
from .flat_io import (
    as_tensor,
    flatten_tree,
    load_safetensors_state,
    save_tree_safetensors,
)

STAGED = "desta_torch.safetensors"
STAGED_INT8 = "desta_torch_int8.safetensors"
JAX_STAGED = "desta_tpu.safetensors"
JAX_STAGED_INT8 = "desta_tpu_int8.safetensors"
STAGED_NAMES = (STAGED, STAGED_INT8, JAX_STAGED, JAX_STAGED_INT8)


class _SD:
    """State-dict view: each lookup is one tensor on ``device`` in
    ``dtype`` (floating leaves through f32, as the JAX package's ``_SD`` and
    ``tree_cast`` take them)."""

    def __init__(self, sd: Mapping[str, Any], dtype, device):
        self.sd, self.dtype, self.device = sd, dtype, torch.device(device)

    def __call__(self, key: str) -> torch.Tensor:
        t = as_tensor(self.sd[key]).to(self.device)
        if t.is_floating_point() and t.dtype != self.dtype:
            t = t.float().to(self.dtype)
        return t

    def has(self, key: str) -> bool:
        return key in self.sd


def _stacked(n: int, fn: Callable[[int], Any]) -> Any:
    """Stack ``fn(0..n-1)`` (tensors or trees of them) on a new leading axis,
    each layer copied into the stack as it is made."""
    out = None
    for i in range(n):
        layer = fn(i)
        if out is None:
            out = _map(lambda t: t.new_empty((n, *t.shape)), layer)
        _zip(out, layer, lambda o, t: o[i].copy_(t))
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip(a, b, fn):
    if isinstance(a, dict):
        for k in a:
            _zip(a[k], b[k], fn)
    else:
        fn(a, b)


# -- Whisper -------------------------------------------------------------------

def _whisper_attn(g: _SD, p: str) -> Dict[str, Any]:
    return {
        "q": {"w": g(f"{p}.q_proj.weight"), "b": g(f"{p}.q_proj.bias")},
        "k": {"w": g(f"{p}.k_proj.weight")},
        "v": {"w": g(f"{p}.v_proj.weight"), "b": g(f"{p}.v_proj.bias")},
        "o": {"w": g(f"{p}.out_proj.weight"), "b": g(f"{p}.out_proj.bias")},
    }


def _ln(g: _SD, p: str) -> Dict[str, torch.Tensor]:
    return {"scale": g(f"{p}.weight"), "bias": g(f"{p}.bias")}


def _lin(g: _SD, p: str) -> Dict[str, torch.Tensor]:
    return {"w": g(f"{p}.weight"), "b": g(f"{p}.bias")}


def convert_whisper_state(sd: Mapping[str, Any], cfg: WhisperConfig,
                          dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """HF ``WhisperForConditionalGeneration`` state dict -> the port's
    ``{"encoder", "decoder"}`` tree (``k_proj`` has no bias; the decoder's
    ``embed_tokens`` is the tied ``proj_out``)."""
    g = _SD(sd, dtype, device)
    pre = "model." if g.has("model.encoder.conv1.weight") else ""

    def enc_layer(i):
        p = f"{pre}encoder.layers.{i}"
        return {"ln1": _ln(g, f"{p}.self_attn_layer_norm"),
                "attn": _whisper_attn(g, f"{p}.self_attn"),
                "ln2": _ln(g, f"{p}.final_layer_norm"),
                "fc1": _lin(g, f"{p}.fc1"), "fc2": _lin(g, f"{p}.fc2")}

    def dec_layer(i):
        p = f"{pre}decoder.layers.{i}"
        return {"ln1": _ln(g, f"{p}.self_attn_layer_norm"),
                "self_attn": _whisper_attn(g, f"{p}.self_attn"),
                "ln_x": _ln(g, f"{p}.encoder_attn_layer_norm"),
                "cross_attn": _whisper_attn(g, f"{p}.encoder_attn"),
                "ln2": _ln(g, f"{p}.final_layer_norm"),
                "fc1": _lin(g, f"{p}.fc1"), "fc2": _lin(g, f"{p}.fc2")}

    e, d = f"{pre}encoder", f"{pre}decoder"
    return {
        "encoder": {
            "conv1": _lin(g, f"{e}.conv1"), "conv2": _lin(g, f"{e}.conv2"),
            "embed_positions": g(f"{e}.embed_positions.weight"),
            "layers": _stacked(cfg.encoder_layers, enc_layer),
            "ln_post": _ln(g, f"{e}.layer_norm"),
        },
        "decoder": {
            "embed_tokens": g(f"{d}.embed_tokens.weight"),
            "embed_positions": g(f"{d}.embed_positions.weight"),
            "layers": _stacked(cfg.decoder_layers, dec_layer),
            "ln": _ln(g, f"{d}.layer_norm"),
        },
    }


# -- Llama / Qwen3 ---------------------------------------------------------------

def convert_llm_state(sd: Mapping[str, Any], cfg: LLMConfig,
                      dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """HF ``LlamaForCausalLM`` / ``Qwen3ForCausalLM`` state dict -> the
    port's LLM tree: ``wqkv`` = [q; k; v] rows, ``w_gu`` = gate and up rows
    interleaved, qk-norm where the config has it, ``lm_head`` [V, D] unless
    the embeddings are tied (the embedding itself where an untied snapshot
    has no head)."""
    g = _SD(sd, dtype, device)
    pre = "model." if g.has("model.embed_tokens.weight") else ""

    def layer(i):
        p = f"{pre}layers.{i}"
        a = f"{p}.self_attn"
        gate, up = g(f"{p}.mlp.gate_proj.weight"), g(f"{p}.mlp.up_proj.weight")
        out = {
            "ln1": {"scale": g(f"{p}.input_layernorm.weight")},
            "wqkv": torch.cat([g(f"{a}.q_proj.weight"), g(f"{a}.k_proj.weight"),
                               g(f"{a}.v_proj.weight")]),
            "wo": g(f"{a}.o_proj.weight"),
            "ln2": {"scale": g(f"{p}.post_attention_layernorm.weight")},
            "w_gu": torch.stack([gate, up], 1).reshape(-1, gate.shape[1]),
            "w_down": g(f"{p}.mlp.down_proj.weight"),
        }
        if cfg.qk_norm:
            out["q_norm"] = {"scale": g(f"{a}.q_norm.weight")}
            out["k_norm"] = {"scale": g(f"{a}.k_norm.weight")}
        return out

    params = {"embed": g(f"{pre}embed_tokens.weight"),
              "layers": _stacked(cfg.num_hidden_layers, layer),
              "norm": {"scale": g(f"{pre}norm.weight")}}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = (g("lm_head.weight") if g.has("lm_head.weight")
                             else params["embed"].clone())
    return params


# -- BERT (Q-Former) ---------------------------------------------------------------

def convert_bert_encoder_state(sd: Mapping[str, Any], num_layers: int,
                               prefix: str = "", dtype=torch.float32,
                               device="cpu") -> Dict[str, Any]:
    """HF ``BertEncoder`` state dict (``layer.{i}.attention.self.query``
    ..., with the ``crossattention`` blocks) -> the port's Q-Former tree
    ``{"layers": ...}``."""
    g = _SD(sd, dtype, device)

    def attn(p):
        return {"q": _lin(g, f"{p}.self.query"), "k": _lin(g, f"{p}.self.key"),
                "v": _lin(g, f"{p}.self.value"),
                "o": _lin(g, f"{p}.output.dense"),
                "ln": _ln(g, f"{p}.output.LayerNorm")}

    def layer(i):
        p = f"{prefix}layer.{i}"
        return {"self": attn(f"{p}.attention"),
                "cross": attn(f"{p}.crossattention"),
                "inter": _lin(g, f"{p}.intermediate.dense"),
                "out": _lin(g, f"{p}.output.dense"),
                "out_ln": _ln(g, f"{p}.output.LayerNorm")}

    return {"layers": _stacked(num_layers, layer)}


def convert_from_torch_module(module, convert_fn: Callable, cfg,
                              dtype=torch.float32, device="cpu"):
    """Convert straight from an in-memory torch module (tests, local
    checkpoints)."""
    return convert_fn(dict(module.state_dict()), cfg, dtype, device)


# -- staging ------------------------------------------------------------------------

# the HF config fields that must agree with a preset, for each tower kind
_WHISPER_MATCH = {
    "num_mel_bins": "num_mel_bins", "d_model": "d_model",
    "encoder_layers": "encoder_layers",
    "encoder_attention_heads": "encoder_attention_heads",
    "encoder_ffn_dim": "encoder_ffn_dim", "decoder_layers": "decoder_layers",
    "vocab_size": "vocab_size",
    "max_source_positions": "max_source_positions",
}
_LLM_MATCH = {
    "vocab_size": "vocab_size", "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_hidden_layers": "num_hidden_layers",
    "num_attention_heads": "num_attention_heads",
    "num_key_value_heads": "num_key_value_heads",
    "rope_theta": "rope_theta",
}


def match_preset(hf_cfg: Dict[str, Any]):
    """The preset an HF ``config.json`` dict describes, by its dims (not its
    name), so a local snapshot stages without knowing the port's id for it.
    Presets with the same dims count once (the first in the table).
    Returns (kind, model_id, config); raises SystemExit on no match or more
    than one."""
    from ..config import (
        _LLM_PRESETS,
        _WHISPER_PRESETS,
        llm_config_for,
        whisper_config_for,
    )
    mt = hf_cfg.get("model_type", "")
    matches = []
    if mt == "whisper":
        for mid in _WHISPER_PRESETS:
            if mid.startswith("test/"):
                continue
            cfg = whisper_config_for(mid)
            if all(hf_cfg.get(h) == getattr(cfg, o)
                   for h, o in _WHISPER_MATCH.items()):
                matches.append(("whisper", mid, cfg))
    elif mt in ("llama", "qwen2", "qwen3"):
        seen = set()
        for mid in _LLM_PRESETS:
            if mid.startswith("test/"):
                continue
            cfg = llm_config_for(mid)
            sig = tuple(getattr(cfg, o) for o in _LLM_MATCH.values())
            if all(hf_cfg.get(h, getattr(cfg, o)) == getattr(cfg, o)
                   for h, o in _LLM_MATCH.items()) and sig not in seen:
                seen.add(sig)
                matches.append(("llm", mid, cfg))
    else:
        raise SystemExit(f"unsupported model_type {mt!r} in config.json")
    if not matches:
        keys = _WHISPER_MATCH if mt == "whisper" else _LLM_MATCH
        raise SystemExit(
            f"no preset matches this {mt} config (dims "
            f"{ {h: hf_cfg.get(h) for h in keys} }); add a preset to "
            "config.py or pass --model-id")
    if len(matches) > 1:
        raise SystemExit(
            f"ambiguous: {[m[1] for m in matches]}; pass --model-id")
    return matches[0]


def _convert_snapshot(src: str, model_id: Optional[str], dtype: str,
                      dst_root: str, int8: bool):
    """An HF snapshot dir's tower in the port's layout on the host CPU,
    tensor by tensor from the shards' memory maps, and its staging dir
    ``dst_root/<model_id>`` made, with the snapshot's ``config.json``
    (``int8``: an LLM snapshot only).  Returns (kind, model_id, tree,
    staging dir)."""
    from ..config import llm_config_for, whisper_config_for

    with open(os.path.join(src, "config.json")) as f:
        hf_cfg = json.load(f)
    if model_id is not None:
        kind = "whisper" if hf_cfg.get("model_type", "") == "whisper" else "llm"
        cfg = (whisper_config_for(model_id) if kind == "whisper"
               else llm_config_for(model_id))
    else:
        kind, model_id, cfg = match_preset(hf_cfg)
    if int8 and kind != "llm":
        raise SystemExit("--int8 applies to LLM towers only")
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    sd = load_safetensors_state(src, exclude=STAGED_NAMES)
    with torch.no_grad():
        tree = (convert_whisper_state if kind == "whisper"
                else convert_llm_state)(sd, cfg, tdtype, "cpu")
    sd.close()
    dst = os.path.join(dst_root, model_id)
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(src, "config.json"),
                os.path.join(dst, "config.json"))
    return kind, model_id, tree, dst


def _write_int8(tree, dst: str) -> None:
    """``dst/desta_torch_int8.safetensors``: an LLM tree quantized
    (``ops/quant.quantize_llm_params``)."""
    from ..ops.quant import quantize_llm_params
    with torch.no_grad():
        qtree = quantize_llm_params(tree)
    save_tree_safetensors(qtree, os.path.join(dst, STAGED_INT8))
    print(f"wrote {dst}/{STAGED_INT8}")


def stage_checkpoint(src: str, weights_root: str,
                     model_id: Optional[str] = None, int8: bool = False,
                     dtype: str = "bfloat16") -> str:
    """Convert an HF snapshot dir into the port's staged layout:
    ``weights_root/<model_id>/desta_torch.safetensors`` (the port's tree in
    ``dtype``), with ``int8`` also ``desta_torch_int8.safetensors`` (the LLM
    quantized, ``ops/quant.quantize_llm_params``), and the snapshot's
    ``config.json``.  Runs on the host CPU, tensor by tensor from the
    shards' memory maps."""
    kind, model_id, tree, dst = _convert_snapshot(src, model_id, dtype,
                                                  weights_root, int8)
    n_params = sum(t.numel() for t in flatten_tree(tree).values())
    if int8:
        _write_int8(tree, dst)
    save_tree_safetensors(tree, os.path.join(dst, STAGED))
    print(f"staged {kind} {model_id}: {n_params / 1e9:.2f}B params -> {dst}")
    return model_id


def stage_int8(src: str, weights_root: str, model_id: str) -> str:
    """The int8 half of ``stage_checkpoint(..., int8=True)`` alone: only
    ``desta_torch_int8.safetensors`` (and ``config.json``) is written, not
    the bf16 tree, for a weights root that serves the int8 LLM only."""
    _, model_id, tree, dst = _convert_snapshot(src, model_id, "bfloat16",
                                               weights_root, True)
    _write_int8(tree, dst)
    return model_id


def _cli(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m desta25_audio_tpu_torch.ckpt.hf_convert",
        description="Stage a local HF snapshot (config.json + *.safetensors)"
                    " into the port's weights_root layout, read by"
                    " DeSTA25AudioModel.from_pretrained / DESTA_TPU_WEIGHTS.")
    p.add_argument("src", help="HF snapshot dir (a hub download of the"
                   " frozen tower, e.g. openai/whisper-large-v3)")
    p.add_argument("weights_root", help="destination root; towers land at"
                   " <weights_root>/<model_id>/")
    p.add_argument("--model-id", default=None,
                   help="preset id (default: inferred from config dims)")
    p.add_argument("--int8", action="store_true",
                   help="also write a pre-quantized int8 LLM tree")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    a = p.parse_args(argv)
    stage_checkpoint(a.src, a.weights_root, model_id=a.model_id,
                     int8=a.int8, dtype=a.dtype)


if __name__ == "__main__":
    _cli()
