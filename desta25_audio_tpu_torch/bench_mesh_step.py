"""Times of K10, the tensor-parallel decode step, and of its all-reduce, on
virtual ranks of one GPU or on distinct GPUs.

    python -m desta25_audio_tpu_torch.bench_mesh_step [--root DIR] \
        [--cards] [--json PATH]

Builds Llama-3.1-8B's LLM at full width and depth (32 layers) with random
weights from a seed, quantized to int8 (the serving setting), and cuts it
for a (1, p) mesh at p = 2 and 4 (``apply_llm_sharding``): p virtual ranks
of the first card, or with ``--cards`` one rank on each of the first p
cards.  It runs the package found under ``--root`` (default: this
checkout; an older checkout unpacked with ``git archive`` under ``exp/`` is
timed alike, each in its own process) at B = 2 rows and a 256-position
cache with random contents (the setting of ``chip_smoke.py`` phase 20b).
Prints the card's name and power limit first, then, each as the mean of
ITERS steps:

* the step's function ``fused_decode_layers_mesh`` (rows writing at 100
  and 200), each rank on its own stream and every rank on its card's
  current stream, back to back (it reads the error words after each step);
* where the package has it (``ops/fused_decode_mesh.MeshStep``), the decode
  step of ``generate()``: eagerly, and as the replay of one CUDA graph per
  card (``generate/graph.CardGraphs``), back to back and, on virtual
  ranks, queued behind a sleep kernel (the card's time; on cards the sleep
  would hold one card only);
* the all-reduce's consumer alone at p ranks, R = 2 rows of D = 4096, on
  flags already published, queued: the package's consumer that writes the
  next half's norm (where it has one), and its consumer without the norm
  followed by the step's norm kernel (``decode_rms_norm``: what the older
  packages launch); and, where the package has the fused consumer, rank
  0's wo peer-store GEMM, the consumer and the gate/up GEMM chained under
  PDL, with and without the consumer (the most a consumer folded into the
  next GEMM could save);
* with ``--cards``, ``torch.cuda.nccl.all_reduce`` of the same [2, 4096]
  f32 partials over the p cards (one PyTorch call for the sum, information
  only);
* the unsharded int8 step on one card (``fused_decode_layers``), eager and
  as a graph's replay, queued, for reference.

Each step time stands beside the step's bound: every layer weight, scale
and norm read once and the cached keys and values below each row's index
read once, over 3.35 TB/s (spread over p cards on ``--cards``).  ``--json``
writes the readings.  Needs CUDA (and p cards with ``--cards``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time

import torch

HBM = 3.35e12
ITERS = 10
B, S, CI = 2, 256, (100, 200)
R, D = 2, 4096


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


def _wall_ms(fn, devices, iters: int = ITERS) -> float:
    """Back to back: host clock around iters calls, every card synchronised
    before and after."""
    fn()
    for d in devices:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    for d in devices:
        torch.cuda.synchronize(d)
    return (time.perf_counter() - t0) * 1e3 / iters


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _import(pkg: str, name: str):
    try:
        return importlib.import_module(f"{pkg}.{name}")
    except ImportError:
        return None


def _consumer(mods, devs, gen):
    """(the fused consumer queued or None, the consumer without the norm
    plus the norm kernel queued) at p = len(devs), R x D, flags published."""
    tar, fd, quant = mods["tp_allreduce"], mods["fused_decode"], mods["quant"]
    p = len(devs)
    K = D // p
    bufs = tar.MeshBuffers(devs, R, D)
    stream = torch.cuda.current_stream(devs[0]).cuda_stream
    h = torch.randn(R, D, generator=gen, device="cuda").bfloat16()
    hs = [h.to(d, copy=True) for d in devs]
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    xn = torch.empty(R, D, dtype=torch.bfloat16, device=devs[0])
    device_epochs = hasattr(bufs, "begin")
    if device_epochs:
        bufs.begin(1)
        tag = 1
    else:
        tag = bufs.next_round()
    for m, d in enumerate(devs):
        leaf = quant.quantize_weight(torch.randn(D, K, generator=gen,
                                                 device="cuda"))
        x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
        with torch.cuda.device(d):
            bufs.store(m, 0, tag, x.to(d), leaf["q"].to(d), leaf["s"].to(d),
                       "bench", torch.cuda.current_stream(d).cuda_stream)
    for m, d in enumerate(devs):
        with torch.cuda.device(d):
            bufs.reduce(m, 0, tag, hs[m],
                        torch.cuda.current_stream(d).cuda_stream)
    for d in devs:
        torch.cuda.synchronize(d)
    bufs.check_timeouts("bench")

    def pair():
        bufs.reduce(0, 0, tag, hs[0], stream)
        fd.decode_rms_norm(hs[0], w, 1e-5)
    fused = in_chain = None
    if device_epochs:
        fused = _queued_ms(lambda: bufs.reduce(0, 0, tag, hs[0], stream, w,
                                               xn, 1e-5), iters=50)
        in_chain = _consumer_in_chain(mods, bufs, hs[0], w, xn, gen)
    paired = _queued_ms(pair, iters=50)
    bufs.check_timeouts("bench")
    return fused, paired, in_chain


def _consumer_in_chain(mods, bufs, h, w, xn, gen):
    """What the consumer costs between rank 0's producer (the wo peer-store
    GEMM, K = D / p) and the GEMM after it (gate/up at I / p = 14336 / p
    columns of SwiGLU pairs), all under PDL on one stream, queued: (the
    chain with the consumer, the chain without it, per round).  Their
    difference is the most that folding the wait, the sum and the norm
    into the next GEMM could save a round; flags already hold the round's
    epoch, so no consumer waits."""
    sg, quant = mods["skinny_gemm"], mods["quant"]
    K, inter = D // bufs.p, 14336 // bufs.p
    wo = quant.quantize_weight(torch.randn(D, K, generator=gen,
                                           device="cuda"))
    wgu = quant.quantize_weight(torch.randn(2 * inter, D, generator=gen,
                                            device="cuda"))
    x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
    stream = torch.cuda.current_stream().cuda_stream

    def chain(consumer: bool):
        bufs.store(0, 0, 1, x, wo["q"], wo["s"], "bench", stream)
        if consumer:
            bufs.reduce(0, 0, 1, h, stream, w, xn, 1e-5)
        sg.skinny_gemm(xn, wgu["q"], wgu["s"], sg.EPI_SWIGLU)
    return tuple(_queued_ms(lambda: chain(c), iters=50) for c in (True,
                                                                 False))


def _nccl_ms(devs) -> float:
    import torch.cuda.nccl as nccl
    xs = [torch.randn(R, D, device=d) for d in devs]
    return _wall_ms(lambda: nccl.all_reduce(xs), devs, iters=50)


def _time_mesh_step(rec, mods, sp, cfg, mask, ck, ids, cards, on_cards):
    """generate()'s decode step (``MeshStep``, every row writing at 150,
    its embeddings gathered and filled as ``DecodeGraph.step`` does):
    eagerly and as the replay of one graph per card, back to back and, on
    virtual ranks, queued."""
    tllm, fdm = mods["llm"], mods["fdm"]
    m2 = mask.clone()
    m2[:, 150] = 1
    step = fdm.MeshStep(sp, cfg, m2, ck)
    pos = torch.full((B, 1), 150, dtype=torch.long, device="cuda")

    def fill():
        step.fill(tllm.embed_tokens(sp, ids[:, None]), pos, 150)

    def eager():
        fill()
        step.run()
    rec["eager_ms"] = _wall_ms(eager, cards)
    if not on_cards:
        rec["eager_queued_ms"] = _queued_ms(eager)
    cg = mods["graph"].CardGraphs(cards)
    fill()
    cg.run(step.run)
    cg.capture(step.run)

    def replay():
        fill()
        cg.replay()
    rec["graph_ms"] = _wall_ms(replay, cards)
    if not on_cards:
        rec["graph_queued_ms"] = _queued_ms(replay)
    step.check()
    cg.reset()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="checkout whose desta25_audio_tpu_torch to time")
    ap.add_argument("--cards", action="store_true",
                    help="one rank a card (p cards) instead of virtual ranks")
    ap.add_argument("--json", default=None, help="write the readings here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_mesh_step needs a CUDA device")
    if args.cards and torch.cuda.device_count() < 4:
        raise SystemExit("bench_mesh_step --cards needs 4 CUDA devices")
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules
                     if m.startswith("desta25_audio_tpu_torch")]:
            del sys.modules[name]
    pkg = "desta25_audio_tpu_torch"
    mods = {n: _import(pkg, path) for n, path in (
        ("config", "config"), ("llm", "models.llm"),
        ("fused_decode", "ops.fused_decode"),
        ("fdm", "ops.fused_decode_mesh"), ("tp_allreduce", "ops.tp_allreduce"),
        ("quant", "ops.quant"), ("mesh", "parallel.mesh"),
        ("sharding", "parallel.sharding"), ("graph", "generate.graph"),
        ("skinny_gemm", "ops.skinny_gemm"))}
    tllm, fd, fdm = mods["llm"], mods["fused_decode"], mods["fdm"]
    pm, sh = mods["mesh"], mods["sharding"]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    print(f"package {fdm.__file__}")
    cfg = mods["config"].llm_config_for("meta-llama/Llama-3.1-8B-Instruct")
    gen = torch.Generator("cuda").manual_seed(0)
    readings = []
    with torch.no_grad():
        params = mods["quant"].quantize_llm_params(
            tllm.init_llm(cfg, torch.bfloat16, "cuda", gen))
        torch.cuda.empty_cache()
        cache = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
        cache.k.normal_(generator=gen)
        cache.v.normal_(generator=gen)
        mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
        ci = torch.tensor(CI, device="cuda")
        ids = torch.randint(0, 512, (B,), generator=gen, device="cuda")
        x = tllm.embed_tokens(params, ids[:, None])
        kvd = cfg.num_key_value_heads * cfg.head_dim
        kv_bytes = cfg.num_hidden_layers * sum(CI) * kvd * 2 * 2
        bound = (_tree_bytes(params["layers"]) + kv_bytes) / HBM * 1e3

        def k8():
            fd.fused_decode_layers(params, cfg, x, mask, ci[:, None], cache,
                                   ci)
        k8_eager = _queued_ms(k8, iters=3)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            k8()
        k8_replay = _queued_ms(graph.replay)
        del graph
        rec = dict(what="unsharded int8 step", eager_ms=k8_eager,
                   graph_ms=k8_replay, bound_ms=bound, gpu=gpu)
        readings.append(rec)
        print(f"unsharded int8 step (fused_decode_layers) L=32 B={B} S={S}: "
              f"eager {k8_eager:.4f} ms queued, graph replay {k8_replay:.4f} "
              f"ms queued, bound {bound:.4f} ms", flush=True)
        for p in (2, 4):
            devs = [f"cuda:{i}" for i in range(p)] if args.cards else (
                ["cuda:0"] * p)
            mesh = pm.make_mesh(n_model=p, devices=devs)
            cards = sorted({torch.device(d) for d in devs},
                           key=lambda d: d.index)
            where = f"{p} cards" if args.cards else f"{p} virtual ranks"
            rec = dict(what=f"K10 p={p} on {where}", gpu=gpu,
                       bound_ms=bound, bound_per_card_ms=(
                           bound / p if args.cards else bound))
            with pm.use_mesh(mesh):
                sp = sh.apply_llm_sharding(params, cfg, mesh)
                ck = sh.shard_kv_cache(cache, cfg, mesh)
                for serial in (False, True):
                    rec[f"fn_ms_serial{int(serial)}"] = _wall_ms(
                        lambda: fdm.fused_decode_layers_mesh(
                            sp, cfg, x, mask, ci[:, None], ck, ci,
                            serial=serial), cards)
                if hasattr(fdm, "MeshStep"):
                    _time_mesh_step(rec, mods, sp, cfg, mask, ck, ids,
                                    cards, args.cards)
                del sp, ck
                mesh.buffers.clear()
                torch.cuda.empty_cache()
            fused, paired, in_chain = _consumer(
                mods, [torch.device(d) for d in devs], gen)
            rec["consumer_fused_queued_ms"] = fused
            rec["consumer_then_norm_queued_ms"] = paired
            if in_chain is not None:
                rec["chain_with_consumer_queued_ms"] = in_chain[0]
                rec["chain_without_consumer_queued_ms"] = in_chain[1]
            if args.cards:
                rec["nccl_allreduce_ms"] = _nccl_ms(cards)
            readings.append(rec)
            print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(readings, f, indent=1)


if __name__ == "__main__":
    main()
