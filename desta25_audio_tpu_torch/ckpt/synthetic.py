"""Seeded random weights at a preset's full shapes, as the checkpoint
phases of ``chip_smoke.py`` and the tests build them: HF-layout snapshots
(the state dict names and shapes of ``WhisperForConditionalGeneration``,
``LlamaForCausalLM`` and ``Qwen3ForCausalLM``, with the ``config.json``
fields ``hf_convert.match_preset`` reads) written by the port's codec; the
int8 quantizer's rows whose ``max / 127`` and ``max * fl(1/127)`` round
apart, and ``quantize_llm_params`` on the card against the CPU (alone, and
after a LoRA merge); and a count of the leaves two trees differ in."""

import json
import os
import time

import numpy as np
import torch


def reciprocal_rows(n: int, k: int, seed: int = 0):
    """[n, k] f32 rows whose max |w| is a value where ``amax / 127`` and
    ``amax * fl(1 / 127)`` (what PyTorch's CUDA division by a Python
    number computes) round apart, the max's sign alternating; and those
    maxima."""
    rng = np.random.default_rng(seed)
    cand = rng.uniform(0.01, 2.0, 64 * n).astype(np.float32)
    inv = np.float32(1) / np.float32(127)
    cand = cand[cand / np.float32(127) != cand * inv][:n]
    w = rng.uniform(-1, 1, (n, k)).astype(np.float32) * cand[:, None] * 0.9
    w[np.arange(n), rng.integers(0, k, n)] = cand * np.where(
        np.arange(n) % 2, -1, 1)
    return w, cand


def count_differing(got, want) -> int:
    """Leaves of two trees (on any devices) that are not bit-identical in
    value and dtype; 0: all equal."""
    if isinstance(want, dict):
        return sum(count_differing(got[k], want[k]) for k in want)
    return int(got.dtype != want.dtype
               or not torch.equal(got.cpu(), want.cpu()))


def quantize_card_vs_cpu(gen, model_id: str = "meta-llama/Llama-3.1-8B-Instruct",
                        layers: int = 1) -> dict:
    """The int8 weight quantiser on the card against the CPU
    (``ops/quant.quantize_weight``: ``max|w| / 127`` as an IEEE division):
    4096 rows of 512 chosen so that the reciprocal product rounds apart in
    every row, then ``quantize_llm_params`` on ``layers`` random bf16
    layers of ``model_id`` at full width and its head, drawn on the card
    from ``gen``.  Returns {"scales", "q_rows": of the chosen rows, those
    that differ card vs CPU; "leaves": of the trees, those that differ;
    "weights": the trees' weights; "card_s", "cpu_s": the quantizer's wall
    times}."""
    from ..config import llm_config_for
    from ..ops.quant import quantize_llm_params, quantize_weight
    w, _ = reciprocal_rows(4096, 512)
    card = quantize_weight(torch.from_numpy(w).cuda())
    host = quantize_weight(torch.from_numpy(w))
    out = {"scales": int((card["s"].cpu() != host["s"]).sum()),
           "q_rows": int((card["q"].cpu() != host["q"]).any(-1).sum())}
    cfg = llm_config_for(model_id)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    qkv = (H + 2 * cfg.num_key_value_heads) * Dh

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 0.02).bfloat16()

    tree = {"embed": rnd(V, D), "norm": {"scale": rnd(D)}, "lm_head": rnd(V, D),
            "layers": {"wqkv": rnd(layers, qkv, D),
                       "wo": rnd(layers, D, H * Dh),
                       "w_gu": rnd(layers, 2 * F, D),
                       "w_down": rnd(layers, D, F)}}
    t0 = time.perf_counter()
    card_tree = quantize_llm_params(tree)
    torch.cuda.synchronize()
    out["card_s"] = time.perf_counter() - t0
    host_in = {"embed": tree["embed"].cpu(),
               "norm": {"scale": tree["norm"]["scale"].cpu()},
               "lm_head": tree["lm_head"].cpu(),
               "layers": {k: v.cpu() for k, v in tree["layers"].items()}}
    t0 = time.perf_counter()
    host_tree = quantize_llm_params(host_in)
    out["cpu_s"] = time.perf_counter() - t0
    out["weights"] = sum(t.numel() for t in tree["layers"].values()) + V * D
    out["leaves"] = count_differing(card_tree, host_tree)
    return out


def hf_whisper_shapes(cfg):
    """{name: (shape, kind)} of an HF ``WhisperForConditionalGeneration``
    state dict (kind "w" a weight, "b" a bias, "n" a LayerNorm scale);
    ``k_proj`` has no bias, ``proj_out`` is tied to the decoder's
    ``embed_tokens``."""
    D, out = cfg.d_model, {}

    def attn(p):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{p}.{proj}.weight"] = ((D, D), "w")
            if proj != "k_proj":
                out[f"{p}.{proj}.bias"] = ((D,), "b")

    def ln(p):
        out[f"{p}.weight"], out[f"{p}.bias"] = ((D,), "n"), ((D,), "b")

    def ffn(p, F):
        out[f"{p}.fc1.weight"], out[f"{p}.fc1.bias"] = ((F, D), "w"), ((F,), "b")
        out[f"{p}.fc2.weight"], out[f"{p}.fc2.bias"] = ((D, F), "w"), ((D,), "b")

    e, d = "model.encoder", "model.decoder"
    out[f"{e}.conv1.weight"] = ((D, cfg.num_mel_bins, 3), "w")
    out[f"{e}.conv1.bias"] = ((D,), "b")
    out[f"{e}.conv2.weight"] = ((D, D, 3), "w")
    out[f"{e}.conv2.bias"] = ((D,), "b")
    out[f"{e}.embed_positions.weight"] = ((cfg.max_source_positions, D), "w")
    ln(f"{e}.layer_norm")
    for i in range(cfg.encoder_layers):
        p = f"{e}.layers.{i}"
        ln(f"{p}.self_attn_layer_norm")
        attn(f"{p}.self_attn")
        ln(f"{p}.final_layer_norm")
        ffn(p, cfg.encoder_ffn_dim)
    out[f"{d}.embed_tokens.weight"] = ((cfg.vocab_size, D), "w")
    out[f"{d}.embed_positions.weight"] = ((cfg.max_target_positions, D), "w")
    ln(f"{d}.layer_norm")
    for i in range(cfg.decoder_layers):
        p = f"{d}.layers.{i}"
        for name in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                     "final_layer_norm"):
            ln(f"{p}.{name}")
        attn(f"{p}.self_attn")
        attn(f"{p}.encoder_attn")
        ffn(p, cfg.decoder_ffn_dim)
    return out


def hf_llm_shapes(cfg):
    """{name: (shape, kind)} of an HF ``LlamaForCausalLM`` /
    ``Qwen3ForCausalLM`` state dict (qk-norm and the tied head as the
    config has them)."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    out = {"model.embed_tokens.weight": ((cfg.vocab_size, D), "w"),
           "model.norm.weight": ((D,), "n")}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = ((D,), "n")
        out[f"{p}.post_attention_layernorm.weight"] = ((D,), "n")
        out[f"{p}.self_attn.q_proj.weight"] = ((H * Dh, D), "w")
        out[f"{p}.self_attn.k_proj.weight"] = ((Hkv * Dh, D), "w")
        out[f"{p}.self_attn.v_proj.weight"] = ((Hkv * Dh, D), "w")
        out[f"{p}.self_attn.o_proj.weight"] = ((D, H * Dh), "w")
        out[f"{p}.mlp.gate_proj.weight"] = ((F, D), "w")
        out[f"{p}.mlp.up_proj.weight"] = ((F, D), "w")
        out[f"{p}.mlp.down_proj.weight"] = ((D, F), "w")
        if cfg.qk_norm:
            out[f"{p}.self_attn.q_norm.weight"] = ((Dh,), "n")
            out[f"{p}.self_attn.k_norm.weight"] = ((Dh,), "n")
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = ((cfg.vocab_size, D), "w")
    return out


def hf_config_json(kind: str, cfg) -> dict:
    """The HF ``config.json`` fields ``hf_convert.match_preset`` reads."""
    if kind == "whisper":
        keys = ("num_mel_bins", "d_model", "encoder_layers",
                "encoder_attention_heads", "encoder_ffn_dim",
                "decoder_layers", "vocab_size", "max_source_positions")
        return {"model_type": "whisper",
                **{k: getattr(cfg, k) for k in keys}}
    keys = ("vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "rope_theta")
    return {"model_type": "qwen3" if cfg.qk_norm else "llama",
            "tie_word_embeddings": cfg.tie_word_embeddings,
            **{k: getattr(cfg, k) for k in keys}}


def fill_state(shapes, make):
    """{name: make(shape, kind)} in name order (``make`` draws from one
    seeded generator, so the order fixes the values)."""
    return {k: make(*shapes[k]) for k in sorted(shapes)}


def write_snapshot(d: str, kind: str, cfg, state, shards: int = 1) -> int:
    """An HF snapshot dir: ``config.json`` and the state dict in ``shards``
    safetensors files of about equal bytes (tensors on any device),
    written by the port's codec; returns the bytes written."""
    from .flat_io import save_safetensors
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_config_json(kind, cfg), f)
    items = list(state.items())
    total = sum(t.numel() * t.element_size() for _, t in items)
    per, part, nbytes, i = -(-total // shards), {}, 0, 0
    for name, t in items:
        part[name] = t
        nbytes += t.numel() * t.element_size()
        if nbytes >= per * (i + 1) or name == items[-1][0]:
            i += 1
            save_safetensors(part, os.path.join(
                d, f"model-{i:05d}-of-{shards:05d}.safetensors"))
            part = {}
    return total


def merge_card_vs_cpu(llm, lora, scale: float, layers: int = 2,
                      head_rows: int = 4096) -> dict:
    """``merge_lora`` then ``quantize_llm_params`` (what
    ``merge_lora_for_serving(quantize=True)`` runs) on the card against
    the same on the CPU, over the first ``layers`` layers of a bf16 tower
    ``llm`` on the card at full width, its adapters ``lora`` and the first
    ``head_rows`` rows of its head.  Returns {"leaves": of the merged int8
    trees, those that differ; "merged": of the merged bf16 ``wqkv``
    elements, those that differ; "weights": the merged int8 weights
    compared; "card_s", "cpu_s": the merge and quantizer's wall times}."""
    from ..models.llm import merge_lora
    from ..ops.quant import quantize_llm_params

    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        return t[:layers]

    head = llm.get("lm_head", llm["embed"])[:head_rows]
    tree = {"embed": head, "norm": llm["norm"], "lm_head": head,
            "layers": cut(llm["layers"])}
    ad = {"layers": cut(lora["layers"])}
    out = {}
    t0 = time.perf_counter()
    card_m = merge_lora(tree, ad, scale)
    card_q = quantize_llm_params(card_m)
    if head.is_cuda:
        torch.cuda.synchronize()
    out["card_s"] = time.perf_counter() - t0

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        return t.cpu()

    tree_h, ad_h = host(tree), host(ad)
    t0 = time.perf_counter()
    host_m = merge_lora(tree_h, ad_h, scale)
    host_q = quantize_llm_params(host_m)
    out["cpu_s"] = time.perf_counter() - t0
    out["merged"] = int((card_m["layers"]["wqkv"].cpu()
                         != host_m["layers"]["wqkv"]).sum())
    out["leaves"] = count_differing(card_q, host_q)
    out["weights"] = (sum(v["q"].numel() for v in card_q["layers"].values()
                          if isinstance(v, dict) and "q" in v)
                      + card_q["lm_head"]["q"].numel())
    return out
