"""Device time of one LLM decode step (K8 and K8-int8, and with ``--orca``
K8i) on one GPU, launched eagerly and as the replay of one CUDA graph.

    python -m desta25_audio_tpu_torch.bench_decode_step [--root DIR] \
        [--orca] [--json PATH]

Builds Llama-3.1-8B's LLM at full width and depth (32 layers) with random
weights from a seed, in bf16 and quantized to int8 (``quantize_llm_params``),
and runs ``fused_decode_layers`` of the package found under ``--root``
(default: this checkout; an older checkout unpacked with ``git archive``
under ``exp/`` is timed alike, each in its own process) at B = 2 rows, a
256-position cache with random contents, the rows writing at 100 and 200
(the setting of ``chip_smoke.py``'s K8 check).  Each time is the mean of
ITERS steps queued behind a sleep kernel, so that it is the card's and
not the Python launch path's: the step's eager launches, and the step
captured once in a CUDA graph and replayed (the cache index a device
tensor, as ``generate/graph.py`` holds it).  Prints the card's name and
power limit first, each time beside the step's bound (every layer weight,
scale and norm read once, the cached keys and values below each row's
index read once, over 3.35 TB/s); ``--json`` writes the readings.  Needs
CUDA.  ``--orca`` times the int8 step alone, then with the in-kernel ORCA
injection (a random int8 cross-attention stack for all 32 layers, random
audio K/V of Ta = 375 tokens, every row injecting) at Kd = 1 (the decode
step) and Kd = 4 (the verify step, the rows writing at 100 and 252), each
eager and as a graph's replay; the bound adds the stack's leaves and the
audio K/V read once.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import types

import torch

HBM = 3.35e12
ITERS = 10
B, S, CI = 2, 256, (100, 200)


def _queued_ms(fn, iters: int = ITERS) -> float:
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # ~20 ms: the steps queue behind it
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="checkout whose desta25_audio_tpu_torch to time")
    ap.add_argument("--orca", action="store_true",
                    help="the int8 step with and without the injection")
    ap.add_argument("--json", default=None, help="write the readings here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_step needs a CUDA device")
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules
                     if m.startswith("desta25_audio_tpu_torch")]:
            del sys.modules[name]
    pkg = "desta25_audio_tpu_torch"
    config = importlib.import_module(f"{pkg}.config")
    tllm = importlib.import_module(f"{pkg}.models.llm")
    fd = importlib.import_module(f"{pkg}.ops.fused_decode")
    quant = importlib.import_module(f"{pkg}.ops.quant")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    print(f"package {fd.__file__}")
    cfg = config.llm_config_for("meta-llama/Llama-3.1-8B-Instruct")
    gen = torch.Generator("cuda").manual_seed(0)
    readings = []
    with torch.no_grad():
        params = tllm.init_llm(cfg, torch.bfloat16, "cuda", gen)
        cache = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
        cache.k.normal_(generator=gen)
        cache.v.normal_(generator=gen)
        mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
        ci = torch.tensor(CI, device="cuda")
        x = tllm.embed_tokens(params, torch.randint(
            0, 512, (B, 1), generator=gen, device="cuda"))
        kvd = cfg.num_key_value_heads * cfg.head_dim
        kv_bytes = cfg.num_hidden_layers * sum(CI) * kvd * 2 * 2
        if args.orca:
            readings = _orca(cfg, params, cache, mask, x, gen, kv_bytes, gpu,
                             tllm, fd, quant, pkg)
        for tower in () if args.orca else ("bf16", "int8"):
            if tower == "int8":
                params = quant.quantize_llm_params(params)
                torch.cuda.empty_cache()

            def step():
                fd.fused_decode_layers(params, cfg, x, mask, ci[:, None],
                                       cache, ci)
            eager = _queued_ms(step, iters=3)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            replay = _queued_ms(graph.replay)
            del graph
            bound = (_tree_bytes(params["layers"]) + kv_bytes) / HBM * 1e3
            rec = dict(tower=tower, eager_ms=eager, graph_ms=replay,
                       bound_ms=bound, gpu=gpu)
            readings.append(rec)
            print(f"decode step [{tower}] L={cfg.num_hidden_layers} B={B} "
                  f"S={S} ci={list(CI)}: eager {eager:.4f} ms queued, graph "
                  f"replay {replay:.4f} ms queued, bound {bound:.4f} ms "
                  f"({bound / replay:.3f} of it as a graph)", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(readings, f, indent=1)


def _orca(cfg, params, cache, mask, x, gen, kv_bytes, gpu, tllm, fd, quant,
          pkg):
    """The int8 step alone, then with the injection at Kd = 1 and 4."""
    orca = importlib.import_module(f"{pkg}.models.orca")
    ta, L, D = 375, cfg.num_hidden_layers, cfg.hidden_size
    params = quant.quantize_llm_params(params)
    stack = orca.init_orca_cross_attns(
        types.SimpleNamespace(llm_config=cfg, orca_gate_init=0.1),
        torch.bfloat16, "cuda", gen)
    stack["layers"]["gate2"]["w"].normal_(0.0, 0.2, generator=gen)
    stack = quant.quantize_orca_cross_attns(stack)
    torch.cuda.empty_cache()
    kv = torch.randn(2, L, B, ta, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    spec = dict(params=stack, k=kv[0], v=kv[1], ta_real=ta,
                heads=cfg.num_attention_heads,
                on=torch.ones(B, dtype=torch.float32, device="cuda"))
    il = stack["layers"]
    inj_bytes = (sum(_tree_bytes(il[k]) for k in ("q", "o", "gate1",
                                                  "gate2", "ln"))
                 + kv[0].numel() * 2 * 2)
    readings = []
    for label, kd, ci_rows, inject in (("int8", 1, CI, None),
                                       ("K8i Kd=1", 1, CI, spec),
                                       ("K8i Kd=4", 4, (100, 252), spec)):
        ci = torch.tensor(ci_rows, device="cuda")
        xs = x.expand(B, kd, D).contiguous()
        pos = ci[:, None] + torch.arange(kd, device="cuda")[None, :]
        fn = fd.fused_decode_layers if kd == 1 else fd.fused_verify_layers

        def step():
            fn(params, cfg, xs, mask, pos, cache, ci, inject=inject)
        eager = _queued_ms(step, iters=3)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        replay = _queued_ms(graph.replay)
        del graph
        bound = (_tree_bytes(params["layers"]) + kv_bytes
                 + (inj_bytes if inject else 0)) / HBM * 1e3
        readings.append(dict(tower=label, eager_ms=eager, graph_ms=replay,
                             bound_ms=bound, gpu=gpu))
        print(f"decode step [{label}] L={L} B={B} S={S} ci={list(ci_rows)}"
              f"{f' Ta={ta}' if inject else ''}: eager {eager:.4f} ms "
              f"queued, graph replay {replay:.4f} ms queued, bound "
              f"{bound:.4f} ms ({bound / replay:.3f} of it as a graph)",
              flush=True)
    return readings


if __name__ == "__main__":
    main()
