"""Device time of the encoder FFN and W8A8 kernels (K3, K4, K5, K6) and of
the int8 LLM's W8A8 prefill at the model shapes, on one GPU.

    python -m desta25_audio_tpu_torch.bench_enc_gemm [--root DIR]
        [--rows 1500,3000,6000] [--prefill-rows 250,296] [--k7-rows 121]
        [--json PATH] [--sweep] [--k7-sweep]

Calls the Python wrappers (``ops/enc_ffn``, ``ops/w8a8_proj``, ``ops/qmm``)
of the package found under ``--root`` (default: this checkout), so that the
same script times an older checkout's kernels, whose wrappers take the same
arguments, beside this one's (unpack it with ``git archive`` under
``exp/``).  Shapes: whisper-large-v3's encoder FFN (D=1280, F=5120) in bf16
(K3) and W8A8 (K4), its int8 q/k/v (K5) and o (K6) projections at M = B *
1500 rows, and Llama-3.1-8B's four layer GEMMs (wqkv 6144 x 4096, wo 4096
x 4096, gate/up 28672 x 4096, down 4096 x 14336) through the W8A8 prefill
at the b2 prompt's rows and, with ``--k7-rows``, through K7 (``qmm``:
``csrc/qmm.cu``'s wgmma path between 17 and 127 rows, the b1 prompt's 121;
the skinny GEMM at 16 rows and fewer) with bf16 outputs, bound as bf16
operations.  K7's weights are held in enough copies that each call finds
its weight evicted from the 50 MB L2 by the calls between, as every
prefill layer does; each K7 reading also names the plan taken
(``ops/qmm.plan_qmm`` where the checkout has it) and times
``torch._weight_int8pack_mm`` on the same x, q and s (the library's one
call for this function, its ``library_ms``; bf16 scales where it refuses
f32 ones; "none: not in this torch" where this torch has no CUDA kernel
for it).  Inputs are random from a seed.  Each time is the
mean of ITERS calls queued behind a sleep kernel (the card's time, not the
Python launch path's), printed with its rate and the bound (the larger of
the bytes, each input read and each output written once, over 3.35 TB/s
and the operations over 989 TFLOP/s bf16 / 1,979 TOP/s int8), beside the
same calls timed back to back without the sleep (``chip_smoke.py``'s
kernels-line method, the host's launch path included), then the call's
device time by kernel (``torch.profiler``).  ``--sweep`` (this
checkout only) times every tile and split the GEMM is built for at each
shape through its C entry points, beside ``ops/gemm.plan_gemm``'s choice;
``--k7-sweep`` (this checkout only) every split of K7's wgmma path at the
``--k7-rows`` through ``desta_qmm``, beside ``plan_qmm``'s.
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
COLD_BYTES = 200e6     # K7: the copies of a weight, well past the L2
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


def _k7_weights(quant, gen, N, K):
    """Copies of one random int8 weight [N, K] and its scales, enough that
    a call's weight left the L2 during the calls between."""
    copies = min(ITERS, max(2, -(-int(COLD_BYTES) // (N * K))))
    return [quant.quantize_weight(
        torch.randn(N, K, generator=gen, device="cuda") / K ** 0.5)
        for _ in range(copies)]


def library_k7():
    """(fn(x, q, s), note) for ``torch._weight_int8pack_mm`` on this torch
    (K7's function in one PyTorch call, the yardstick of ``library_ms``;
    the port never calls it), or (None, why)."""
    op = "aten::_weight_int8pack_mm"
    if not (hasattr(torch, "_weight_int8pack_mm")
            and torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")):
        return None, "none: not in this torch"
    x = torch.randn(32, 128, device="cuda").bfloat16()
    q = torch.randint(-127, 128, (256, 128), device="cuda",
                      dtype=torch.int8)
    s = torch.rand(256, device="cuda")
    try:
        torch._weight_int8pack_mm(x, q, s)
        return (lambda x, q, s: torch._weight_int8pack_mm(x, q, s)), \
            "f32 scales"
    except RuntimeError:
        torch._weight_int8pack_mm(x, q, s.bfloat16())
        return (lambda x, q, s: torch._weight_int8pack_mm(
            x, q, s.bfloat16())), "bf16 scales"


def _sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _cycle(fn, items):
    """A call of fn on the next of ``items`` at every call."""
    state = [0]

    def call():
        item = items[state[0] % len(items)]
        state[0] += 1
        return fn(item)
    return call


def cases(pkg, gen, rows, prefill_rows, k7_rows=()):
    """(label, fn, bytes, operations, kind, extra) per reading; extra:
    K7's plan and library call."""
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
             io + 2 * (2 * D * F + F + D), 4 * M * D * F, "bf16", {}),
            (f"K4 encoder_ffn_w8a8 M={M}",
             lambda x=x: ffn.encoder_ffn_w8a8(x, *q8),
             io + 2 * D * F + 6 * (F + D), 4 * M * D * F, "int8", {}),
            (f"K5 qkv_w8a8 M={M}",
             lambda x=x: proj.qkv_w8a8(x, lq, lk, lv),
             io + 2 * M * D * 2 + 3 * D * (D + 6), 6 * M * D * D, "int8",
             {}),
            (f"K6 proj_w8a8 M={M}", lambda x=x: proj.proj_w8a8(x, lo),
             io + D * (D + 6), 2 * M * D * D, "int8", {}),
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
                M * K * 2 + N * K + N * 4 + M * N * 2, 2 * M * N * K, "int8",
                {}))
    lib_fn, lib_note = library_k7() if k7_rows else (None, "")
    for name, N, K in LLAMA if k7_rows else ():
        leaves = _k7_weights(quant, gen, N, K)
        for M in k7_rows:
            x = torch.randn(M, K, generator=gen, device="cuda").to(bf)
            if hasattr(qmm, "plan_qmm") and M > qmm.QMM_SKINNY_ROWS:
                plan = str(qmm.plan_qmm(M, N, K, _sm_count()))
            else:
                plan = "skinny GEMM" if M <= 16 else "the checkout's own"
            extra = {"plan": plan, "library_note": lib_note}
            if lib_fn is not None:
                extra["library"] = _cycle(
                    lambda lf, x=x: lib_fn(x, lf["q"], lf["s"]), leaves)
            out.append((
                f"K7 qmm {name} M={M}",
                _cycle(lambda lf, x=x: qmm.qmm(x, lf["q"], lf["s"],
                                               torch.bfloat16), leaves),
                M * K * 2 + N * K + N * 4 + M * N * 2, 2 * M * N * K, "bf16",
                extra))
    return out


def k7_sweep(pkg, gen, k7_rows, gpu) -> list:
    """Every split of K7's wgmma path at Llama-3.1-8B's four shapes and
    the given rows, through ``desta_qmm``, beside plan_qmm's choice."""
    build = importlib.import_module(pkg + ".ops._build")
    qmm = importlib.import_module(pkg + ".ops.qmm")
    quant = importlib.import_module(pkg + ".ops.quant")
    lib = build.library()
    st = torch.cuda.current_stream().cuda_stream
    out = []
    for name, N, K in LLAMA:
        leaves = _k7_weights(quant, gen, N, K)
        for M in k7_rows:
            if M <= qmm.QMM_SKINNY_ROWS:
                continue
            x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
            o = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
            plan = qmm.plan_qmm(M, N, K, _sm_count())
            times = []
            for sp in range(1, qmm.QMM_SPLITS_MAX + 1):
                tps = -(-plan.nkt // sp)
                if -(-plan.nkt // tps) != sp:
                    continue

                def call(lf, sp=sp):
                    build.check(lib.desta_qmm(
                        x.data_ptr(), lf["q"].data_ptr(), lf["s"].data_ptr(),
                        o.data_ptr(), M, N, K, sp, 0, st), "desta_qmm")
                times.append((_queued_ms(_cycle(call, leaves)), sp))
            times.sort()
            chosen = next(t for t in times if t[1] == plan.splits)
            print(f"k7 sweep {name} M={M}: plan splits {plan.splits} "
                  f"{chosen[0]:.5f} ms; by time "
                  + ", ".join(f"splits {sp} {ms:.5f}" for ms, sp in times),
                  flush=True)
            out.append(dict(label=f"k7 sweep {name} M={M}",
                            plan=plan._asdict(), plan_ms=chosen[0],
                            times=times, gpu=gpu))
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
    ap.add_argument("--k7-sweep", action="store_true")
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
        for label, fn, nbytes, ops, kind, extra in cases(
                pkg, gen, rows, prefill_rows, k7_rows):
            ms = _queued_ms(fn)
            b2b = _queued_ms(fn, queued=False)
            t_bytes, t_ops = nbytes / HBM * 1e3, ops / PEAK[kind] * 1e3
            bound = max(t_bytes, t_ops)
            kern = _by_kernel(fn)
            lib_ms = (_queued_ms(extra["library"]) if "library" in extra
                      else None)
            readings.append(dict(
                label=label, ms=ms, back_to_back_ms=b2b, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                by_kernel=kern, gpu=gpu, plan=extra.get("plan"),
                library_ms=lib_ms, library_note=extra.get("library_note")))
            more = ""
            if "plan" in extra:
                more = (f"; plan {extra['plan']}; torch._weight_int8pack_mm "
                        + (f"{lib_ms:.5f} ms ({extra['library_note']})"
                           if lib_ms is not None
                           else extra["library_note"]))
            print(f"{label}: {ms:.5f} ms queued ({ops / ms / 1e9:.1f} "
                  f"T{'FL' if kind == 'bf16' else ''}OP/s), {b2b:.5f} back "
                  f"to back, bound {bound:.5f} ms ({bound / ms:.3f} of it); "
                  "by kernel: "
                  + "; ".join(f"{k} {v:.5f}" for k, v in kern.items())
                  + more, flush=True)
        if args.sweep:
            readings += sweep(pkg, gen, rows, prefill_rows, gpu)
        if args.k7_sweep:
            readings += k7_sweep(pkg, gen, k7_rows, gpu)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(readings, f, indent=1)


if __name__ == "__main__":
    main()
