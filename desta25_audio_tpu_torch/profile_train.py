"""Where the time of one flagship training step goes, on one GPU.

    python -m desta25_audio_tpu_torch.profile_train [--batch 4] [--seq 512]
        [--repeats 3] [--orca] [--int8-llm]

Builds the flagship configuration (configs/desta25_llama31-8B_Qformer6L.yaml,
bf16 towers, f32 Q-Former, random weights from a seed, CharTokenizer; with
``--orca`` configs/desta25_llama31-8B_ORCAHybrid.yaml and its f32
cross-attention stack, injected after every layer; with ``--int8-llm`` the
tower quantized, ``apply_llm_quant()``),
collates ``--batch`` synthetic clips at ``max_seq_length=--seq`` and runs
the train step of ``train/step.py`` with remat on (the config's
``gradient_checkpointing``) and Adafactor: one warm-up step, ``--repeats``
steps timed without the profiler (host clock, device synchronised), then
``--repeats`` steps each under its own ``torch.profiler``.  Prints for each
profiled step the wall time, the device busy time (sum of kernel times) and
the idle share, for the first the kernels by total device time and grouped
by where the time is spent, then the spread of the idle shares and the
peak device memory.  At
``--seq 512`` every attention of the LLM runs K11; at 300, the masked path.
Needs CUDA; the numbers belong to the card it runs on (nvidia-smi's name and
power limit are printed first).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from .audio.io import write_wav
from .config import config_from_yaml_file
from .data.dataset import AudioTextDataset, CollateFn, DataConfig
from .data.tokenizer import CharTokenizer
from .models.desta import DeSTA25AudioModel
from .profile_generate import CONFIG, ORCA_CONFIG, report
from .train.optimizer import OptimizerConfig, flatten_tree, make_optimizer
from .train.step import TrainLayout, make_train_step

# kernel-name substrings of the step's device time, by where it is spent
GROUPS = {
    "K11": ("flash_fwd", "flash_bwd"),
    "K2": ("enc_attention",),
    # csrc/gemm_sm90.cuh in bf16 (earlier checkouts: gemm_bias_kernel)
    "K3": ("gemm_kernel<__nv_bfloat16", "gemm_bias"),
    "f32 GEMM (connector, ORCA injection, mel, conv)": (
        "f32f32", "sgemm", "cudnn", "implicit_gemm", "conv"),
    "bf16 GEMM (LLM, head)": ("nvjet", "sm90_xmma", "cutlass", "gemm"),
    "softmax, log-softmax, reductions": ("softmax", "reduce"),
    "copies and casts": ("copy",),
    "other elementwise": ("elementwise",),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--orca", action="store_true",
                    help="the ORCA hybrid config (deep injection)")
    ap.add_argument("--int8-llm", action="store_true",
                    help="train through the int8 tower (apply_llm_quant)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = config_from_yaml_file(ORCA_CONFIG if args.orca else CONFIG)
    model = DeSTA25AudioModel(cfg, device="cuda", seed=0,
                              tokenizer=CharTokenizer("llama3"))
    if args.int8_llm:
        model.apply_llm_quant()
        cfg = model.config
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        rows = []
        for i in range(args.batch):
            t = np.arange(int((2 + 0.5 * i) * 16000)) / 16000.0
            sig = (0.5 * np.sin(2 * np.pi * (250 + 30 * i) * t)
                   * (np.sin(6 * t) > 0) + 0.01 * rng.standard_normal(t.size))
            write_wav(os.path.join(d, f"c{i}.wav"), sig.astype(np.float32))
            rows.append({"id": f"c{i}.wav", "prompt": f"Clip {i}: <|AUDIO|>",
                         "response": f"A synthetic tone number {i}."})
        with open(os.path.join(d, "m.jsonl"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        dcfg = DataConfig(manifest_filepaths=[os.path.join(d, "m.jsonl")],
                          data_root=d, batch_size=args.batch,
                          max_seq_length=args.seq, shuffle=False)
        ds = AudioTextDataset(cfg, dcfg, model.tokenizer)
        np_batch = CollateFn(cfg, dcfg, model.tokenizer)(list(ds.iter_valid()))
    batch = {k: (torch.as_tensor(v) if v.dtype.kind == "f"
                 else torch.as_tensor(v).long()).to("cuda")
             for k, v in np_batch.items() if isinstance(v, np.ndarray)}
    trainable, frozen = model.split_params()
    layout = TrainLayout(None, frozen, cfg)
    tx = make_optimizer(OptimizerConfig(lr=1e-4, warmup_steps=2))
    state = tx.init(flatten_tree(trainable))
    step = make_train_step(cfg, tx, remat=True)
    trainable, state, _ = step(trainable, layout, state, batch)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainable, state, _ = step(trainable, layout, state, batch)
        torch.cuda.synchronize()
        print(f"train step B={args.batch} T={args.seq} without the profiler: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    stats = []
    for i in range(args.repeats):
        trainable, state, _ = report(
            f"train step B={args.batch} T={args.seq}, profiled step {i}",
            lambda: step(trainable, layout, state, batch),
            top=16 if i == 0 else 0, groups=GROUPS if i == 0 else None,
            stats=stats)
    idle = [1 - busy / wall for wall, busy in stats]
    print(f"idle share over {len(stats)} profiled steps: min {min(idle):.3f}"
          f" max {max(idle):.3f}; wall ms "
          + ", ".join(f"{w:.2f}" for w, _ in stats) + "; busy ms "
          + ", ".join(f"{b:.2f}" for _, b in stats))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB allocated")


if __name__ == "__main__":
    main()
