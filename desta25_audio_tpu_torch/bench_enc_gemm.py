"""Device time of the encoder FFN and W8A8 kernels (K3, K4, K5, K6) and of
the int8 LLM's W8A8 prefill at the model shapes, on one GPU.

    python -m desta25_audio_tpu_torch.bench_enc_gemm [--root DIR]
        [--rows 1500,3000,6000] [--prefill-rows 250,296] [--k7-rows 121]
        [--json PATH] [--sweep]

Calls the Python wrappers (``ops/enc_ffn``, ``ops/w8a8_proj``, ``ops/qmm``)
of the package found under ``--root`` (default: this checkout), so that the
same script times an older checkout's kernels, whose wrappers take the same
arguments, beside this one's (unpack it with ``git archive`` under
``exp/``).  Shapes: whisper-large-v3's encoder FFN (D=1280, F=5120) in bf16
(K3) and W8A8 (K4), its int8 q/k/v (K5) and o (K6) projections at M = B *
1500 rows, and Llama-3.1-8B's four layer GEMMs (wqkv 6144 x 4096, wo 4096
x 4096, gate/up 28672 x 4096, down 4096 x 14336) through the W8A8 prefill
at the b2 prompt's rows and, with ``--k7-rows``, through K7 (``qmm``,
``csrc/qmm.cu``'s mma path between 17 and 127 rows; the b1 prompt's 121)
with bf16 outputs, bound as bf16 operations.  Inputs are random from a seed.  Each time is the
mean of ITERS calls queued behind a sleep kernel (the card's time, not the
Python launch path's), printed with its rate and the bound (the larger of
the bytes, each input read and each output written once, over 3.35 TB/s
and the operations over 989 TFLOP/s bf16 / 1,979 TOP/s int8), beside the
same calls timed back to back without the sleep (``chip_smoke.py``'s
kernels-line method, the host's launch path included), then the call's
device time by kernel (``torch.profiler``).  ``--sweep`` (this
checkout only) times every tile and split the GEMM is built for at each
shape through its C entry points, beside ``ops/gemm.plan_gemm``'s choice.
Needs CUDA; prints the card's name and power limit first; ``--json``
writes the readings.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

HBM = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12}
ITERS = 20
D, F = 1280, 5120
LLAMA = (("wqkv", 6144, 4096), ("wo", 4096, 4096), ("gate/up", 28672, 4096),
         ("down", 4096, 14336))


def _queued_ms(fn, iters=ITERS, queued=True) -> float:
    """Mean device ms of fn() over `iters` calls queued behind a sleep
    (``queued``) or back to back."""
    fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(40_000_000)  # ~20 ms: the calls queue behind it
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _by_kernel(fn, iters=5):
    """{kernel name: device ms a call} under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key[:72]] = us / 1e3 / iters
    return out


def _leaf(gen, n, k, quant, bias=True):
    p = {"w": (torch.randn(n, k, generator=gen, device="cuda")
               / k ** 0.5).bfloat16()}
    if bias:
        p["b"] = (0.1 * torch.randn(n, generator=gen, device="cuda")
                  ).bfloat16()
    return quant.quantize_linear(p)


def cases(pkg, gen, rows, prefill_rows, k7_rows=()):
    """(label, fn, bytes, operations, kind) per reading."""
    ffn = importlib.import_module(pkg + ".ops.enc_ffn")
    proj = importlib.import_module(pkg + ".ops.w8a8_proj")
    qmm = importlib.import_module(pkg + ".ops.qmm")
    quant = importlib.import_module(pkg + ".ops.quant")
    bf = torch.bfloat16
    w1 = (torch.randn(F, D, generator=gen, device="cuda") / D ** 0.5).to(bf)
    b1 = (0.1 * torch.randn(F, generator=gen, device="cuda")).to(bf)
    w2 = (torch.randn(D, F, generator=gen, device="cuda") / F ** 0.5).to(bf)
    b2 = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf)
    l1, l2 = _leaf(gen, F, D, quant), _leaf(gen, D, F, quant)
    q8 = (l1["q"], l1["s"], l1["b"], l2["q"], l2["s"], l2["b"])
    lq, lk, lv, lo = (_leaf(gen, D, D, quant, bias=b)
                      for b in (True, False, True, True))
    out = []
    for M in rows:
        x = torch.randn(1, M, D, generator=gen, device="cuda").to(bf)
        io = 2 * M * D * 2
        out += [
            (f"K3 encoder_ffn M={M}",
             lambda x=x: ffn.encoder_ffn(x, w1, b1, w2, b2),
             io + 2 * (2 * D * F + F + D), 4 * M * D * F, "bf16"),
            (f"K4 encoder_ffn_w8a8 M={M}",
             lambda x=x: ffn.encoder_ffn_w8a8(x, *q8),
             io + 2 * D * F + 6 * (F + D), 4 * M * D * F, "int8"),
            (f"K5 qkv_w8a8 M={M}",
             lambda x=x: proj.qkv_w8a8(x, lq, lk, lv),
             io + 2 * M * D * 2 + 3 * D * (D + 6), 6 * M * D * D, "int8"),
            (f"K6 proj_w8a8 M={M}", lambda x=x: proj.proj_w8a8(x, lo),
             io + D * (D + 6), 2 * M * D * D, "int8"),
        ]
    for M in prefill_rows:
        for name, N, K in LLAMA:
            leaf = quant.quantize_weight(
                torch.randn(N, K, generator=gen, device="cuda") / K ** 0.5)
            x = torch.randn(M, K, generator=gen, device="cuda").to(bf)
            out.append((
                f"W8A8 prefill {name} M={M}",
                lambda x=x, leaf=leaf: qmm.w8a8_matmul(
                    x, leaf["q"], leaf["s"], torch.bfloat16),
                M * K * 2 + N * K + N * 4 + M * N * 2, 2 * M * N * K, "int8"))
    for M in k7_rows:
        for name, N, K in LLAMA:
            leaf = quant.quantize_weight(
                torch.randn(N, K, generator=gen, device="cuda") / K ** 0.5)
            x = torch.randn(M, K, generator=gen, device="cuda").to(bf)
            out.append((
                f"K7 qmm {name} M={M}",
                lambda x=x, leaf=leaf: qmm.qmm(
                    x, leaf["q"], leaf["s"], torch.bfloat16),
                M * K * 2 + N * K + N * 4 + M * N * 2, 2 * M * N * K, "bf16"))
    return out


def sweep(pkg, gen, rows, prefill_rows, gpu) -> list:
    """Every tile and split of the GEMM at each product of the shapes,
    through the C entry points, beside plan_gemm's choice."""
    build = importlib.import_module(pkg + ".ops._build")
    gemm = importlib.import_module(pkg + ".ops.gemm")
    lib = build.library()
    st = torch.cuda.current_stream().cuda_stream
    prods = []
    for M in rows:
        prods += [(f"K3 fc1 M={M}", M, F, D, gemm.EPI_BIAS_GELU, 1),
                  (f"K3 fc2 M={M}", M, D, F, gemm.EPI_BIAS, 1),
                  (f"K4 fc1 M={M}", M, F, D, gemm.EPI_GELU_Q8, 1),
                  (f"K4 fc2 M={M}", M, D, F, gemm.EPI_SEG, 1),
                  (f"K5 M={M}", M, D, D, gemm.EPI_PROJ, 3),
                  (f"K6 M={M}", M, D, D, gemm.EPI_PROJ, 1)]
    for M in prefill_rows:
        prods += [(f"W8A8 {n} M={M}", M, N, K, gemm.EPI_LLM_BF16, 1)
                  for n, N, K in LLAMA]
    out = []
    for label, M, N, K, epi, nproj in prods:
        int8 = epi not in gemm.BF16_EPIS
        if int8:
            seg = 1280 if epi == gemm.EPI_SEG else K
            a = torch.randint(-127, 128, (M, K), generator=gen,
                              device="cuda", dtype=torch.int8)
            sa = torch.rand(M, -(-K // seg), generator=gen,
                            device="cuda") * 1e-2
            od = torch.int8 if epi == gemm.EPI_GELU_Q8 else torch.bfloat16
            sq = torch.empty(M, N // gemm.Q8_CHUNK + 1, device="cuda")
            ptrs, keep = [], []
            for _ in range(nproj):
                t = (torch.randint(-127, 128, (N, K), generator=gen,
                                   device="cuda", dtype=torch.int8),
                     torch.rand(N, generator=gen, device="cuda") * 1e-2,
                     torch.randn(N, generator=gen, device="cuda").bfloat16(),
                     torch.empty(M, N, dtype=od, device="cuda"))
                keep.append(t)
                ptrs += [v.data_ptr() for v in t]
            ptrs += [None] * (12 - len(ptrs))

            def call(bm, bn, sp, cl):
                build.check(lib.desta_gemm_s8(
                    epi, a.data_ptr(), sa.data_ptr(), nproj, *ptrs,
                    sq.data_ptr(), M, N, K, seg, bm, bn, sp, cl, st), label)
        else:
            a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(N, K, generator=gen, device="cuda")
                 * 0.03).bfloat16()
            b = torch.randn(N, generator=gen, device="cuda").bfloat16()
            o = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")

            def call(bm, bn, sp, cl):
                build.check(lib.desta_gemm_bias(
                    a.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
                    M, N, K, int(epi == gemm.EPI_BIAS_GELU), bm, bn, cl, st),
                    label)
        plan = gemm.plan_gemm(M, N, K, epi, nproj)
        nkt = -(-K * (1 if int8 else 2) // gemm.K_BYTES)
        times = []
        tiles = (gemm.Q8_TILES if epi == gemm.EPI_GELU_Q8 else
                 gemm.SEG_TILES if epi == gemm.EPI_SEG else gemm.TILES)
        splits = range(1, gemm.SPLITS_MAX + 1) if (
            int8 and epi not in (gemm.EPI_SEG, gemm.EPI_GELU_Q8)) else (1,)
        cands = []
        for bm, bn in tiles:
            for sp in splits:
                if N % bn or -(-nkt // -(-nkt // sp)) != sp:
                    continue
                cands.append((bm, bn, sp, gemm.Q8_CHUNK // bn
                              if epi == gemm.EPI_GELU_Q8 else sp))
        for c in cands:
            times.append((_queued_ms(lambda: call(*c)),) + c)
        times.sort()
        chosen = next(t for t in times if t[1:] == (
            plan.bm, plan.bn, plan.splits, plan.cluster))

        def name(t):
            return f"({t[1]}, {t[2]}, splits {t[3]}, cluster {t[4]})"
        print(f"sweep {label}: plan {name(chosen)} {chosen[0]:.5f} ms; "
              "fastest " + ", ".join(f"{name(t)} {t[0]:.5f}"
                                     for t in times[:4]), flush=True)
        out.append(dict(label=label, plan=list(chosen[1:]),
                        plan_ms=chosen[0], times=times, gpu=gpu))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="checkout whose desta25_audio_tpu_torch to time")
    ap.add_argument("--rows", default="1500,3000,6000")
    ap.add_argument("--prefill-rows", default="250,296")
    ap.add_argument("--k7-rows", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--json", default=None, help="write the readings here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_enc_gemm needs a CUDA device")
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules
                     if m.startswith("desta25_audio_tpu_torch")]:
            del sys.modules[name]
    pkg = "desta25_audio_tpu_torch"
    build = importlib.import_module(pkg + ".ops._build")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    print(f"kernels of {build.CSRC}")
    build.library()
    gen = torch.Generator("cuda").manual_seed(0)
    rows = [int(r) for r in args.rows.split(",") if r]
    prefill_rows = [int(r) for r in args.prefill_rows.split(",") if r]
    k7_rows = [int(r) for r in args.k7_rows.split(",") if r]
    readings = []
    with torch.no_grad():
        for label, fn, nbytes, ops, kind in cases(pkg, gen, rows,
                                                  prefill_rows, k7_rows):
            ms = _queued_ms(fn)
            b2b = _queued_ms(fn, queued=False)
            bound = max(nbytes / HBM, ops / PEAK[kind]) * 1e3
            kern = _by_kernel(fn)
            readings.append(dict(label=label, ms=ms, back_to_back_ms=b2b,
                                 bound_ms=bound, by_kernel=kern, gpu=gpu))
            print(f"{label}: {ms:.5f} ms queued ({ops / ms / 1e9:.1f} "
                  f"T{'FL' if kind == 'bf16' else ''}OP/s), {b2b:.5f} back "
                  f"to back, bound {bound:.5f} ms ({bound / ms:.3f} of it); "
                  "by kernel: "
                  + "; ".join(f"{k} {v:.5f}" for k, v in kern.items()),
                  flush=True)
        if args.sweep:
            readings += sweep(pkg, gen, rows, prefill_rows, gpu)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(readings, f, indent=1)


if __name__ == "__main__":
    main()
