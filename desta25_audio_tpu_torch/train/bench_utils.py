"""Flagship-scale training-step setup for benchmarks and card smoke runs
(port of ``desta25_audio_tpu/train/bench_utils.py``).

Builds the DeSTA2.5 training step at the reference flagship's own geometry
(desta25_llama31-8B_Qformer6L.yaml: whisper-large-v3 encoder, Llama-3.1-8B,
a 6-layer Q-Former, per-device batch 12, max_seq_length 300, Adafactor,
remat), as the JAX package builds it: the frozen LLM in weight-only int8,
built at random directly in its quantized shapes (no transient bf16 copy),
the encoder in bf16, the trainable connector in f32.  The ORCA flagship
(``connector_mode="orca_hybrid"``) runs Qwen3-4B-Instruct-2507 with its
gated cross-attention stack in bf16 (``orca_xattn_dtype``).  Random
weights: for time and memory only.

Departures from the JAX package:

- :func:`build_flagship_train_setup` returns the port's
  ``train/step.TrainLayout`` where JAX returns the frozen tree (the port's
  step takes a layout), and builds on ``device``, the card by default;
- :func:`hbm_analysis` measures one step on the card where JAX reads the
  compiler's memory plan.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import DeSTA25Config

GIB = 1024 ** 3


def flagship_config(connector_mode: str = "qformer_1") -> DeSTA25Config:
    kw = {}
    llm_id = "DeSTA-ntu/Llama-3.1-8B-Instruct"
    if connector_mode == "orca_hybrid":
        # desta25_qwen3-4b_ORCAHybrid.yaml: the reference's ORCA flagship
        # runs on Qwen3-4B (deep injection adds ~4 d_model^2 trainable
        # parameters per LLM layer), its stack in bf16
        llm_id = "Qwen/Qwen3-4B-Instruct-2507"
        kw = dict(orca_global_num_tokens=64, orca_local_downsample=4,
                  orca_local_kernel_size=5, orca_audio_position_scale=2.5,
                  orca_gate_init=0.1, orca_xattn_dtype="bfloat16")
    return DeSTA25Config(
        llm_model_id=llm_id,
        encoder_model_id="openai/whisper-large-v3",
        connector_mode=connector_mode, qformer_num_hidden_layers=6,
        prompt_size=64, dtype="bfloat16", **kw)


def _device(device) -> torch.device:
    """``device`` as asked; a CUDA device where none is present raises
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_flagship_train_setup: no CUDA device; pass "
                           "device='cpu' to build on the CPU")
    return device


def build_flagship_train_setup(batch_size: int = 12, seq_len: int = 300,
                               seed: int = 0, warmup_steps: int = 100,
                               connector_mode: str = "qformer_1",
                               device="cuda"):
    """Returns (cfg, step, trainable, layout, opt_state, batch): the
    flagship config (:func:`flagship_config`), ``step(trainable, layout,
    opt_state, batch) -> (trainable, opt_state, metrics)`` with remat,
    the trainable tree, the ``TrainLayout`` of the frozen towers (in the
    JAX package's ``frozen`` slot), the Adafactor state and a synthetic
    batch (:func:`synth_train_batch`), all on ``device``."""
    return build_train_setup(flagship_config(connector_mode), batch_size,
                             seq_len, seed, warmup_steps, device)


def build_train_setup(cfg: DeSTA25Config, batch_size: int, seq_len: int,
                      seed: int = 0, warmup_steps: int = 100,
                      device="cuda"):
    """:func:`build_flagship_train_setup`'s body for any ``cfg``: the int8
    LLM (``quantize_llm_params``' shapes), the bf16 encoder, the f32
    connector and, for ``orca_hybrid``, the stack in
    ``cfg.orca_xattn_dtype``, each filled by ``random_tree_like`` (scale
    0.02) from one generator seeded ``seed`` on ``device``."""
    from ..models import llm as tllm
    from ..models.orca import init_orca_connector, init_orca_cross_attns
    from ..models.qformer import init_qformer_connector
    from ..models.whisper import init_whisper_encoder
    from ..ops.quant import quantize_llm_params
    from ..utils.fast_init import random_tree_like
    from .optimizer import OptimizerConfig, flatten_tree, make_optimizer
    from .step import TrainLayout, make_train_step

    device = _device(device)
    gen = torch.Generator(device).manual_seed(seed)
    llm_cfg, enc_cfg = cfg.llm_config, cfg.encoder_config
    llm_p = random_tree_like(lambda d, g: quantize_llm_params(
        tllm.init_llm(llm_cfg, torch.bfloat16, d, g)), gen, device)
    enc_p = random_tree_like(lambda d, g: init_whisper_encoder(
        enc_cfg, torch.bfloat16, d, g), gen, device)
    if cfg.connector_mode == "orca_hybrid":
        xdtype = getattr(torch, cfg.orca_xattn_dtype)
        trainable: Dict[str, Any] = {
            "connector": random_tree_like(lambda d, g: init_orca_connector(
                cfg, torch.float32, d, g), gen, device),
            "orca_cross_attns": random_tree_like(
                lambda d, g: init_orca_cross_attns(cfg, xdtype, d, g), gen,
                device)}
    else:
        trainable = {"connector": random_tree_like(
            lambda d, g: init_qformer_connector(cfg, torch.float32, d, g),
            gen, device)}
    # only the encoder half of whisper takes part in training
    frozen = {"llm": llm_p, "whisper": {"encoder": enc_p}}
    optimizer = make_optimizer(OptimizerConfig(
        lr=1e-4, warmup_steps=warmup_steps, total_steps=10_000))
    opt_state = optimizer.init(flatten_tree(trainable))
    step = make_train_step(cfg, optimizer, remat=True)
    layout = TrainLayout(None, frozen, cfg)
    batch = synth_train_batch(cfg, batch_size, seq_len, seed=seed,
                              device=device)
    return cfg, step, trainable, layout, opt_state, batch


def synth_train_arrays(cfg: DeSTA25Config, B: int, L: int,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's ``synth_train_batch`` as numpy arrays, drawn from
    ``np.random.default_rng(seed)`` in its order (equal to its arrays bit
    for bit): one audio per row, K audio tokens spliced at offset 4, the
    answer region in the second half."""
    rng = np.random.default_rng(seed)
    K = cfg.audio_token_size
    vocab = cfg.llm_config.vocab_size
    ids = rng.integers(10, vocab - 10, size=(B, L)).astype(np.int32)
    labels = ids.copy()
    labels[:, :L // 2] = -100
    kind = np.zeros((B, L), np.int32)
    kind[:, 4:4 + K] = 1
    aidx = np.zeros((B, L), np.int32)
    for b in range(B):
        aidx[b, 4:4 + K] = b
    pos = np.zeros((B, L), np.int32)
    pos[:, 4:4 + K] = np.arange(K)
    n_samples = cfg.encoder_config.expected_mel_frames * 160
    return {
        "input_ids": ids,
        "attention_mask": np.ones((B, L), np.int32),
        "labels": labels,
        "audio": (0.1 * rng.standard_normal((B, n_samples))).astype(
            np.float32),
        "trans_ids": np.zeros((B, 8), np.int32),
        "trans_mask": np.zeros((B, 8), np.int32),
        "kind": kind,
        "aidx": aidx,
        "pos": pos,
    }


def synth_train_batch(cfg: DeSTA25Config, B: int, L: int, seed: int = 0,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """:func:`synth_train_arrays` as tensors on ``device``, the integer
    arrays as int64, as the trainer hands a collated batch to the step."""
    out = {}
    for k, v in synth_train_arrays(cfg, B, L, seed).items():
        t = torch.from_numpy(v)
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


def tree_bytes(*trees) -> int:
    """The bytes of every tensor in ``trees`` (dicts and lists of tensors
    and ints), each storage counted once."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            key = (x.device, st.data_ptr())
            if key not in seen:
                seen.add(key)
                total += st.nbytes()
    for t in trees:
        walk(t)
    return total


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def hbm_analysis(step, trainable, layout, opt_state, batch
                 ) -> Dict[str, float]:
    """The step's device memory (GiB, 2 places), by the JAX package's keys:
    ``argument_gb`` the trainable tree, the layout's frozen towers, the
    optimizer state and the batch; ``temp_gb`` the peak of
    ``torch.cuda.max_memory_allocated`` over one step less what was
    resident when it began (the arguments among it); ``output_gb`` the
    returned trainable tree, state and metrics.  JAX reads these from the
    compiled program's plan; PyTorch compiles none, so this runs one step,
    on clones of ``trainable`` and ``opt_state`` (the caller's are left as
    they were).  Off a CUDA device: ``{"error": ...}``, as JAX's where its
    backend lacks the analysis."""
    dev = layout.devices[0]
    if dev.type != "cuda":
        return {"error": f"RuntimeError: hbm_analysis measures a step on a "
                         f"CUDA device; the layout is on {dev}"[:120]}
    args = tree_bytes(trainable, layout.frozen, opt_state, batch)
    tr, st = _clone(trainable), _clone(opt_state)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tr, st, metrics = step(tr, layout, st, batch)
    torch.cuda.synchronize(dev)
    temp = torch.cuda.max_memory_allocated(dev) - base
    out = tree_bytes(tr, st, metrics)
    return {"argument_gb": round(args / GIB, 2),
            "temp_gb": round(temp / GIB, 2),
            "output_gb": round(out / GIB, 2)}

