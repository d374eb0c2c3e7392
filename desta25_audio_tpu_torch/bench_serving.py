"""The serving engine's decode tick on one GPU (the port's counterpart of
``bench.py:492`` ``bench_serving`` of the JAX package).

    python -m desta25_audio_tpu_torch.bench_serving [--slots 8,16,32] \
        [--json PATH]

Builds Llama-3.1-8B's LLM at full width and depth (32 layers) with random
weights from a seed, quantized to int8 (``quantize_llm_params``, the
engine's flagship tower), and for each slot count B runs the engine's tick
(``serve/engine.decode_tick``: K = 8 decode steps, each the kept
``DecodeGraph`` step of all B rows at their own cache positions, then
``sample_token_dynamic``) on a cache of T_MAX = 384 positions whose rows
start at the cache indices (64 + 16 i) % 256, half of the rows sampled
(temperature 0.7, top-p 0.9), the rest greedy.  Every tick starts from the
same indices and mask, as the JAX bench's does.  Prints the card's name
and power limit first, then for each B the median of 9 ticks after 5
warm-ups (host clock, the tick's tokens read back), in ms a tick and
tokens/s, the device's busy time a tick and idle share over 3 ticks under
``torch.profiler``, the graph's capture count, and the step's byte bound
(every layer and head weight, scale and norm read once, each row's cached
keys and values below its index read once and its new row written, over
3.35 TB/s; the mean over the tick's steps).  ``--json`` writes the
readings.  Needs CUDA.  ``chip_smoke.py`` calls :func:`serving_ticks` on
its own int8 flagship tower.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

HBM = 3.35e12
K, T_MAX = 8, 384
WARMUP, TICKS, PROFILED, REPLAYS = 5, 9, 3, 20
# kernel-name pieces of the decode step's launches (csrc/: the norm, the
# skinny GEMM with the head, the decode attention)
STEP_KERNELS = ("rms_norm", "skinny", "decode_attention", "decode_attn",
                "qmm")


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def step_bound_ms(params, cfg, ci) -> float:
    """The least time of one decode step of the rows at cache indices
    ``ci``: every layer weight, scale and norm, the final norm and the head
    read once, each row's cached keys and values below its index read once
    and its new k/v row written, over HBM bytes/s."""
    kvd = cfg.num_key_value_heads * cfg.head_dim
    L = cfg.num_hidden_layers
    head = params.get("lm_head", params["embed"])
    nb = (_tree_bytes(params["layers"]) + _tree_bytes(params["norm"])
          + _tree_bytes(head))
    nb += L * (sum(int(c) for c in ci) + len(ci)) * kvd * 2 * 2
    return nb / HBM * 1e3


def serving_ticks(params, cfg, B: int, seed: int = 0, gpu: str = "",
                  show=print) -> dict:
    """The tick of ``B`` slots on ``params`` (module docstring); returns
    {"slots", "tick_ms", "tok_s", "device_ms", "idle", "bound_ms",
    "captures", "ticks"}."""
    from .generate.graph import DecodeGraph
    from .models import llm as tllm
    from .profile_generate import _device_ms
    from .serve.engine import decode_tick
    dev = torch.device("cuda")
    cache = tllm.init_kv_cache(cfg, B, T_MAX, torch.bfloat16, dev)
    ci0 = (64 + 16 * torch.arange(B, device=dev, dtype=torch.int32)) % 256
    mask0 = (torch.arange(T_MAX, device=dev)[None, :] < ci0[:, None]).int()
    mask = mask0.clone()
    toks = torch.ones(B, dtype=torch.long, device=dev)
    temp = torch.full((B,), 0.7, device=dev)
    top_p = torch.full((B,), 0.9, device=dev)
    do_sample = torch.arange(B, device=dev) % 2 == 0
    gen = torch.Generator(dev).manual_seed(seed)
    graph = DecodeGraph(params, cfg, mask, cache, None, capture=True)

    def tick():
        mask.copy_(mask0)
        outs = decode_tick(graph.step, mask, toks, ci0.long(), ci0, gen,
                           temp, top_p, do_sample, None, K)
        return outs.cpu()

    try:
        for _ in range(WARMUP):
            tick()
        samples = []
        for _ in range(TICKS):
            t0 = time.perf_counter()
            tick()
            samples.append((time.perf_counter() - t0) * 1e3)
        med = sorted(samples)[len(samples) // 2]
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                tick()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILED
        kernels = _device_ms(prof)
        busy = sum(ms for ms, _ in kernels.values()) / PROFILED
        # the step's own kernels (the graph's: the repo's kernels and the
        # head) against the sampling and glue around it
        step_ms = sum(ms for name, (ms, _) in kernels.items()
                      if any(k in name for k in STEP_KERNELS)) / PROFILED
        top = sorted(kernels.items(), key=lambda kv: kv[1][0],
                     reverse=True)[:8]
        # the graph's replays alone, back to back on the current stream
        mask.copy_(mask0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        graph.cards.replay()
        start.record()
        for _ in range(REPLAYS):
            graph.cards.replay()
        end.record()
        torch.cuda.synchronize()
        replay_ms = start.elapsed_time(end) / REPLAYS
        ci = ci0.tolist()
        bound = sum(step_bound_ms(params, cfg, [c + s for c in ci])
                    for s in range(K)) / K
        out = {"slots": B, "tick_ms": med, "tok_s": B * K / med * 1e3,
               "device_ms": busy, "idle": 1 - busy / wall,
               "bound_ms": bound, "captures": graph.captures,
               "replay_ms": replay_ms, "step_kernels_ms": step_ms,
               "ticks": samples}
    finally:
        graph.close()
    show(f"serving tick b{B} ({gpu}): {med:.3f} ms a tick of {K} steps "
         f"(median of {TICKS}; {min(samples):.3f}-{max(samples):.3f}), "
         f"{out['tok_s']:.1f} tokens/s, {med / K:.3f} ms a step against a "
         f"{bound:.3f} ms byte bound; device busy {busy:.3f} ms a tick "
         f"(profiled wall {wall:.3f}), idle share {out['idle']:.3f}, of it "
         f"the step's kernels {step_ms:.3f} ms and sampling and glue "
         f"{busy - step_ms:.3f} ms; the graph's replay alone {replay_ms:.3f} "
         f"ms; {graph.captures} capture; top kernels a tick: "
         + "; ".join(f"{name[:60]} {ms / PROFILED:.3f} ms x{n // PROFILED}"
                     for name, (ms, n) in top), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", default="8,16,32")
    ap.add_argument("--json", default=None, help="write the readings here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_serving needs a CUDA device")
    from .config import llm_config_for
    from .models import llm as tllm
    from .ops.quant import quantize_llm_params
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu, flush=True)
    cfg = llm_config_for("meta-llama/Llama-3.1-8B-Instruct")
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        params = quantize_llm_params(
            tllm.init_llm(cfg, torch.bfloat16, "cuda", gen))
        torch.cuda.empty_cache()
        readings = [serving_ticks(params, cfg, int(b), gpu=gpu)
                    for b in args.slots.split(",")]
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"gpu": gpu, "readings": readings}, f, indent=1)


if __name__ == "__main__":
    main()
