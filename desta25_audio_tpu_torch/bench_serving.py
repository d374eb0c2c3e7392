"""The serving engine's decode tick on one GPU (the port's counterpart of
``bench.py:492`` ``bench_serving`` of the JAX package).

    python -m desta25_audio_tpu_torch.bench_serving [--slots 8,16,32] \
        [--speculative-k 4] [--json PATH]

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
keys and values below its index read once and its new rows written, over
3.35 TB/s; the mean over the tick's steps).

``--speculative-k Kd`` (slots 4 and 16 unless ``--slots`` is given) runs,
beside each plain tick, the engine's spec tick alone on the same tower
(``serve/engine.spec_tick``: K = 8 verify steps of Kd tokens a row through
the kept verify graph, n-gram drafts over each row's history of random
ids, the sampler at every verify position since half of the rows sample)
from the same cache, mask and indices, and prints its ms a tick, the
tokens a verify step it accepted, tokens/s, T_spec / T_plain (the tick
durations' ratio, the break-even acceptance of the adaptive controller),
its device time and idle share, the verify graph's replay alone and its
byte bound.  ``--json`` writes the readings.  Needs CUDA.
``chip_smoke.py`` calls :func:`serving_ticks` and :func:`spec_ticks` on
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


def step_bound_ms(params, cfg, ci, kd: int = 1) -> float:
    """The least time of one decode (kd = 1) or verify step of the rows at
    cache indices ``ci``: every layer weight, scale and norm, the final
    norm and the head read once, each row's cached keys and values below
    its index read once and its kd new k/v rows written, over HBM
    bytes/s."""
    kvd = cfg.num_key_value_heads * cfg.head_dim
    L = cfg.num_hidden_layers
    head = params.get("lm_head", params["embed"])
    nb = (_tree_bytes(params["layers"]) + _tree_bytes(params["norm"])
          + _tree_bytes(head))
    nb += L * (sum(int(c) for c in ci) + kd * len(ci)) * kvd * 2 * 2
    return nb / HBM * 1e3


def _measure(tick, graph, reset):
    """The readings of ``tick`` (which returns its tokens on the host):
    the median and samples of TICKS host-clock ticks after WARMUP, then
    the device's busy time, the step's kernels' share and the top kernels
    a tick over PROFILED ticks under ``torch.profiler``, then ``graph``'s
    replay alone, back to back on the current stream after ``reset()``."""
    from torch.profiler import ProfilerActivity, profile
    from .profile_generate import _device_ms
    for _ in range(WARMUP):
        tick()
    samples = []
    for _ in range(TICKS):
        t0 = time.perf_counter()
        tick()
        samples.append((time.perf_counter() - t0) * 1e3)
    med = sorted(samples)[len(samples) // 2]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            tick()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED
    kernels = _device_ms(prof)
    busy = sum(ms for ms, _ in kernels.values()) / PROFILED
    # the step's own kernels (the graph's: the repo's kernels and the head)
    # against the sampling and glue around it
    step_ms = sum(ms for name, (ms, _) in kernels.items()
                  if any(k in name for k in STEP_KERNELS)) / PROFILED
    top = sorted(kernels.items(), key=lambda kv: kv[1][0],
                 reverse=True)[:8]
    reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.cards.replay()
    start.record()
    for _ in range(REPLAYS):
        graph.cards.replay()
    end.record()
    torch.cuda.synchronize()
    return dict(tick_ms=med, ticks=samples, device_ms=busy,
                idle=1 - busy / wall, wall_ms=wall, step_kernels_ms=step_ms,
                replay_ms=start.elapsed_time(end) / REPLAYS, top=top)


def _top(top) -> str:
    return "; ".join(f"{name[:60]} {ms / PROFILED:.3f} ms x{n // PROFILED}"
                     for name, (ms, n) in top)


def _rows(cfg, B: int, dev):
    """The bench's rows: cache, start indices, mask, sampling."""
    from .models import llm as tllm
    cache = tllm.init_kv_cache(cfg, B, T_MAX, torch.bfloat16, dev)
    ci0 = (64 + 16 * torch.arange(B, device=dev, dtype=torch.int32)) % 256
    mask0 = (torch.arange(T_MAX, device=dev)[None, :] < ci0[:, None]).int()
    temp = torch.full((B,), 0.7, device=dev)
    top_p = torch.full((B,), 0.9, device=dev)
    do_sample = torch.arange(B, device=dev) % 2 == 0
    return cache, ci0, mask0, temp, top_p, do_sample


def serving_ticks(params, cfg, B: int, seed: int = 0, gpu: str = "",
                  show=print) -> dict:
    """The tick of ``B`` slots on ``params`` (module docstring); returns
    {"slots", "tick_ms", "tok_s", "device_ms", "idle", "bound_ms",
    "captures", "replay_ms", "step_kernels_ms", "ticks"}."""
    from .generate.graph import DecodeGraph
    from .serve.engine import decode_tick
    dev = torch.device("cuda")
    cache, ci0, mask0, temp, top_p, do_sample = _rows(cfg, B, dev)
    mask = mask0.clone()
    toks = torch.ones(B, dtype=torch.long, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    graph = DecodeGraph(params, cfg, mask, cache, None, capture=True)

    def tick():
        mask.copy_(mask0)
        outs = decode_tick(graph.step, mask, toks, ci0.long(), ci0, gen,
                           temp, top_p, do_sample, None, K)
        return outs.cpu()

    try:
        r = _measure(tick, graph, lambda: mask.copy_(mask0))
        ci = ci0.tolist()
        bound = sum(step_bound_ms(params, cfg, [c + s for c in ci])
                    for s in range(K)) / K
        out = {"slots": B, "tick_ms": r["tick_ms"],
               "tok_s": B * K / r["tick_ms"] * 1e3,
               "device_ms": r["device_ms"], "idle": r["idle"],
               "bound_ms": bound, "captures": graph.captures,
               "replay_ms": r["replay_ms"],
               "step_kernels_ms": r["step_kernels_ms"], "ticks": r["ticks"]}
    finally:
        graph.close()
    med, samples, busy = r["tick_ms"], r["ticks"], r["device_ms"]
    show(f"serving tick b{B} ({gpu}): {med:.3f} ms a tick of {K} steps "
         f"(median of {TICKS}; {min(samples):.3f}-{max(samples):.3f}), "
         f"{out['tok_s']:.1f} tokens/s, {med / K:.3f} ms a step against a "
         f"{bound:.3f} ms byte bound; device busy {busy:.3f} ms a tick "
         f"(profiled wall {r['wall_ms']:.3f}), idle share {out['idle']:.3f}, "
         f"of it the step's kernels {r['step_kernels_ms']:.3f} ms and "
         f"sampling and glue {busy - r['step_kernels_ms']:.3f} ms; the "
         f"graph's replay alone {r['replay_ms']:.3f} ms; {graph.captures} "
         f"capture; top kernels a tick: " + _top(r["top"]), flush=True)
    return out


def spec_ticks(params, cfg, B: int, kd: int, seed: int = 0, gpu: str = "",
               plain: dict = None, show=print) -> dict:
    """The spec tick of ``B`` slots at ``kd`` tokens a verify step on
    ``params`` (module docstring), beside ``plain`` (the same slots'
    :func:`serving_ticks` readings) for T_spec / T_plain; returns
    {"slots", "kd", "tick_ms", "tok_s", "tokens_per_step", "ratio",
    "device_ms", "idle", "bound_ms", "captures", "replay_ms", "ticks"}."""
    from .generate.graph import DecodeGraph
    from .serve.engine import spec_tick
    dev = torch.device("cuda")
    cache, ci0, mask0, temp, top_p, do_sample = _rows(cfg, B, dev)
    vmask = mask0.clone()
    gen = torch.Generator(dev).manual_seed(seed)
    draw = torch.Generator(dev).manual_seed(seed + 1)
    hcap = T_MAX + K * kd + 8
    hist0 = torch.randint(2, cfg.vocab_size, (B, hcap), generator=draw,
                          device=dev)
    # a row's history: its context's ids and its last token (ci + 1 ids)
    hlen0 = ci0.long() + 1
    toks = hist0.gather(1, (hlen0 - 1)[:, None])[:, 0]
    hist = hist0.clone()
    graph = DecodeGraph(params, cfg, vmask, cache, None, capture=True, kd=kd)
    accepted = []

    def tick():
        hist.copy_(hist0)
        _, ms, *_ = spec_tick(graph.step, vmask, mask0, ci0.long(), toks,
                              ci0.long(), ci0.long(), hist, hlen0, gen,
                              temp, top_p, do_sample, None, K, kd,
                              sample_positions=kd)
        ms = ms.cpu()
        accepted.append(float(ms.float().mean()))
        return ms

    try:
        r = _measure(tick, graph, lambda: None)
        ci = ci0.tolist()
        acc = sum(accepted) / len(accepted)
        # the rows' indices as the verify steps advance them (one token a
        # step where nothing is accepted past the last token)
        bound = sum(step_bound_ms(params, cfg, [c + round(acc * s)
                                                for c in ci], kd)
                    for s in range(K)) / K
        out = {"slots": B, "kd": kd, "tick_ms": r["tick_ms"],
               "tok_s": B * K * acc / r["tick_ms"] * 1e3,
               "tokens_per_step": acc,
               "ratio": (r["tick_ms"] / plain["tick_ms"] if plain else None),
               "device_ms": r["device_ms"], "idle": r["idle"],
               "bound_ms": bound, "captures": graph.captures,
               "replay_ms": r["replay_ms"],
               "step_kernels_ms": r["step_kernels_ms"], "ticks": r["ticks"]}
    finally:
        graph.close()
    med, samples, busy = r["tick_ms"], r["ticks"], r["device_ms"]
    ratio = (f"T_spec / T_plain {out['ratio']:.3f} (plain "
             f"{plain['tick_ms']:.3f} ms, {plain['tok_s']:.1f} tokens/s)"
             if plain else "no plain tick beside it")
    show(f"spec tick b{B} Kd={kd} ({gpu}): {med:.3f} ms a tick of {K} "
         f"verify steps (median of {TICKS}; {min(samples):.3f}-"
         f"{max(samples):.3f}), {acc:.3f} tokens a verify step, "
         f"{out['tok_s']:.1f} tokens/s; {ratio}; {med / K:.3f} ms a step "
         f"against a {bound:.3f} ms byte bound; device busy {busy:.3f} ms a "
         f"tick (profiled wall {r['wall_ms']:.3f}), idle share "
         f"{out['idle']:.3f}, of it the step's kernels "
         f"{r['step_kernels_ms']:.3f} ms and drafting, sampling and glue "
         f"{busy - r['step_kernels_ms']:.3f} ms; the verify graph's replay "
         f"alone {r['replay_ms']:.3f} ms; {graph.captures} capture; top "
         f"kernels a tick: " + _top(r["top"]), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", default=None,
                    help="slot counts (default 8,16,32; 4,16 with "
                    "--speculative-k)")
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="also run the spec tick at this many tokens a "
                    "verify step")
    ap.add_argument("--json", default=None, help="write the readings here")
    args = ap.parse_args()
    kd = args.speculative_k
    slots = args.slots or ("4,16" if kd >= 2 else "8,16,32")
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
        readings = []
        for b in slots.split(","):
            plain = serving_ticks(params, cfg, int(b), gpu=gpu)
            readings.append(plain)
            if kd >= 2:
                readings.append(spec_ticks(params, cfg, int(b), kd, gpu=gpu,
                                           plain=plain))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"gpu": gpu, "readings": readings}, f, indent=1)


if __name__ == "__main__":
    main()
