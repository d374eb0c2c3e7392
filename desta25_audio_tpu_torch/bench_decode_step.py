"""Device time of one LLM decode step (K8 and K8-int8, and with ``--orca``
K8i) on one GPU, launched eagerly and as the replay of one CUDA graph.

    python -m desta25_audio_tpu_torch.bench_decode_step [--root DIR] \
        [--orca | --perlayer] [--json PATH]

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
audio K/V read once.  ``--perlayer`` times the int8 step (K8-int8) as a
graph's replay beside K9, the per-layer pair
(``ops/fused_decode_tp.fused_decode_layers_perlayer``, no hook between the
layers), eager and as a graph's replay, and K9's device time by launch:
the eager step under ``torch.profiler``, K9's kernels in launch order, each
layer's seven (ln1, q/k/v, attention, wo, ln2, gate/up, down; a checkout
of PRs 6-17: five, its fused-norm GEMVs taking the norms) labelled by
position, each credited with the time it adds past every earlier
kernel's end (a launch under programmatic dependent launch starts while
its predecessor drains) and with its own span, means over the layers of
PROFILED_STEPS steps.
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
PROFILED_STEPS = 3
# K9's launches a layer, by their count: this checkout's, PRs 6-17's
K9_LAUNCHES = {7: ("ln1", "q/k/v", "attention", "wo", "ln2", "gate/up",
                   "down"),
               5: ("norm + q/k/v", "attention", "wo", "norm + gate/up",
                   "down")}
# K9's kernel names: the norm, the skinny GEMM, PRs 6-17's fused-norm GEMV,
# the attention
K9_KERNELS = ("rms_norm", "skinny_gemm", "norm_gemv", "decode_attention")


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
    ap.add_argument("--perlayer", action="store_true",
                    help="K9's per-layer step beside the int8 step")
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
        if args.perlayer:
            readings = _perlayer(cfg, params, cache, mask, x, kv_bytes, gpu,
                                 fd, quant, pkg)
        for tower in () if args.orca or args.perlayer else ("bf16", "int8"):
            if tower == "int8":
                params = quant.quantize_llm_params(params)
                torch.cuda.empty_cache()

            def step():
                fd.fused_decode_layers(params, cfg, x, mask, ci[:, None],
                                       cache, ci)
            eager = _queued_ms(step, iters=3)
            replay = _replay_ms(step)
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
        replay = _replay_ms(step)
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


def _replay_ms(step) -> float:
    """step() captured once in a CUDA graph, its replay queued (step() has
    run before, so its first-use host work is done)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    ms = _queued_ms(graph.replay)
    del graph
    return ms


def _launch_times(step, L: int):
    """{launch label: (credited ms, span ms)} a layer, the mean over the
    layers of PROFILED_STEPS eager steps under the profiler (module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    credit, covered = [], float("-inf")
    for start, end, name in spans:
        credit.append((max(0.0, end - max(start, covered)), end - start,
                       name))
        covered = max(covered, end)
    k9 = [c for c in credit if any(k in c[2] for k in K9_KERNELS)]
    n = len(k9) // (PROFILED_STEPS * L)
    if n not in K9_LAUNCHES or len(k9) != PROFILED_STEPS * L * n:
        raise RuntimeError(f"{len(k9)} K9 kernels in {PROFILED_STEPS} "
                           f"steps of {L} layers")
    out = {}
    for j, label in enumerate(K9_LAUNCHES[n]):
        mine = k9[j::n]
        out[label] = (sum(c[0] for c in mine) / len(mine) / 1e3,
                      sum(c[1] for c in mine) / len(mine) / 1e3,
                      mine[0][2])
    return out


def _perlayer(cfg, params, cache, mask, x, kv_bytes, gpu, fd, quant, pkg):
    """K8-int8's replay, then K9's step eager and replayed and its device
    time by launch."""
    ttp = importlib.import_module(f"{pkg}.ops.fused_decode_tp")
    L = cfg.num_hidden_layers
    params = quant.quantize_llm_params(params)
    torch.cuda.empty_cache()
    ci = torch.tensor(CI, device="cuda")
    bound = (_tree_bytes(params["layers"]) + kv_bytes) / HBM * 1e3

    def k8():
        fd.fused_decode_layers(params, cfg, x, mask, ci[:, None], cache, ci)

    def k9():
        ttp.fused_decode_layers_perlayer(params, cfg, x, mask, ci[:, None],
                                         cache, ci)
    k8(), k9()
    k8_replay = _replay_ms(k8)
    eager = _queued_ms(k9, iters=3)
    replay = _replay_ms(k9)
    launches = _launch_times(k9, L)
    rec = dict(tower="K9 int8", eager_ms=eager, graph_ms=replay,
               k8_int8_graph_ms=k8_replay, bound_ms=bound, gpu=gpu,
               launches={k: dict(ms=v[0], span_ms=v[1], kernel=v[2])
                         for k, v in launches.items()})
    print(f"decode step [K9 int8] L={L} B={B} S={S} ci={list(CI)}: eager "
          f"{eager:.4f} ms queued, graph replay {replay:.4f} ms queued, "
          f"bound {bound:.4f} ms ({bound / replay:.3f} of it as a graph, "
          f"{bound / eager:.3f} eager); K8-int8 graph replay "
          f"{k8_replay:.4f} ms", flush=True)
    print(f"K9 by launch, a layer (eager, {PROFILED_STEPS} profiled steps; "
          "credited = past every earlier kernel's end / own span):")
    for label, (ms, span, name) in launches.items():
        print(f"   {label:15s} {ms * 1e3:8.2f} us / {span * 1e3:8.2f} us  "
              f"{name[:90]}")
    layer_ms = sum(v[0] for v in launches.values())
    print(f"   layer total credited {layer_ms * 1e3:.2f} us; x{L} layers "
          f"{layer_ms * L:.4f} ms", flush=True)
    return [rec]


if __name__ == "__main__":
    main()
