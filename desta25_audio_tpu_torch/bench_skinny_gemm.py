"""Device time of the skinny weight-streaming GEMM (``csrc/skinny_gemm.cuh``)
at Llama-3.1-8B's decode shapes, on one GPU.

    python -m desta25_audio_tpu_torch.bench_skinny_gemm [--root DIR]
        [--rows 1,2,8,16] [--norm] [--json PATH]

Calls the C entry point ``desta_skinny_gemm`` of the package found under
``--root`` (default: this checkout), so that the same script times an
older checkout's kernel, whose entry point has the same arguments, beside
this one's (unpack it with ``git archive`` under ``exp/``).  Shapes (output
columns x K): qkv 6144 x 4096, wo 4096 x 4096, gate/up 14336 x 4096 with
the SWIGLU epilogue (28672 weight rows), down 4096 x 14336 and the K7 head
130560 x 4096, and one CTA's tile, 64 x 128 (what a launch costs beside
its bytes), each with int8 weights (one f32 scale a row) and bf16
weights, at R token rows.  Inputs are random from a seed; each weight is
held in enough copies (at most ITERS) that one launch's weight was evicted
from the 50 MB L2 by the launches between (as in the decode step, where
every launch reads another layer's weight; the one-tile shape stays in L2).  Each time is the mean of ITERS launches
queued behind a sleep kernel (the card's time, not the Python launch
path's), printed with its rate, the bound (the weight, its scales, x and
the output, once each, over 3.35 TB/s) and the host's time to enqueue a
launch (the ctypes call, taken while the card sleeps).  For bf16 STORE,
``torch.nn.functional.linear`` on the same operands is timed alike as the
yardstick (``library_ms``); the port never calls it.  Needs CUDA; prints
the card's name and power limit first; ``--json`` writes the readings.

``--norm`` times K9's q/k/v and gate/up products of the f32 residual h
instead, at qkv 6144 x 4096 (STORE) and gate/up 14336 x 4096 (SWIGLU),
int8, at R rows: the two launches of this checkout (the step's norm
kernel on the f32 rows, ``desta_rms_norm_f32``, then the skinny GEMM on
the bf16 rows it wrote), or in a checkout of PRs 6-17 its one-launch
fused-norm GEMV (``desta_tp_norm_gemv``), beside the skinny GEMM alone on
the normalised rows; the bound: the weight, its scales, h (f32), the norm
weight and the output, once each, over 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

EPI_STORE, EPI_SWIGLU = 0, 2
SHAPES = (  # label, output columns, K, epilogue
    ("qkv", 6144, 4096, EPI_STORE),
    ("wo", 4096, 4096, EPI_STORE),
    ("gate/up", 14336, 4096, EPI_SWIGLU),
    ("down", 4096, 14336, EPI_STORE),
    ("head", 130560, 4096, EPI_STORE),
    ("one tile", 64, 128, EPI_STORE),   # a launch's fixed cost
)
HBM = 3.35e12
ITERS = 20
COLD_BYTES = 200e6     # the copies of a weight: well past the L2


def _time_queued(fn, iters=ITERS):
    """(device ms, host us) a launch: `iters` launches queued behind a
    sleep kernel, timed by CUDA events on the card and by the host clock
    around their enqueueing (the card sleeps meanwhile)."""
    fn(0)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # ~20 ms: the launches queue behind it
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host_us = (time.perf_counter() - t0) / iters * 1e6
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_us


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="checkout whose desta25_audio_tpu_torch to time")
    ap.add_argument("--rows", default="1,2,8,16")
    ap.add_argument("--norm", action="store_true",
                    help="K9's norm and product on the f32 residual")
    ap.add_argument("--json", default=None, help="write the readings here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_skinny_gemm needs a CUDA device")
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules
                     if m.startswith("desta25_audio_tpu_torch")]:
            del sys.modules[name]
    build = importlib.import_module("desta25_audio_tpu_torch.ops._build")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    print(f"kernels of {build.CSRC}")
    lib = build.library()
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = [int(r) for r in args.rows.split(",")]
    readings = []
    if args.norm:
        readings = _norm(build, lib, gen, stream, rows, gpu)
    for int8 in () if args.norm else (True, False):
        for label, N, K, epi in SHAPES:
            nw = 2 if epi == EPI_SWIGLU else 1
            wbytes = N * nw * K * (1 if int8 else 2)
            copies = min(ITERS, max(2, -(-int(COLD_BYTES) // wbytes)))
            ws, ss = [], []
            for _ in range(copies):
                if int8:
                    ws.append(torch.randint(-127, 128, (N * nw, K),
                                            generator=gen, device="cuda",
                                            dtype=torch.int8))
                    ss.append(torch.rand(N * nw, generator=gen,
                                         device="cuda") * 1e-3)
                else:
                    ws.append((torch.randn(N * nw, K, generator=gen,
                                           device="cuda") * 0.02).bfloat16())
            for R in rows:
                x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
                out = torch.empty(R, N, dtype=torch.bfloat16, device="cuda")

                def launch(i):
                    j = i % copies
                    build.check(lib.desta_skinny_gemm(
                        x.data_ptr(), ws[j].data_ptr(),
                        ss[j].data_ptr() if int8 else None, None,
                        out.data_ptr(), R, N, K, epi, int(int8), stream),
                        "desta_skinny_gemm")
                ms, host_us = _time_queued(launch)
                nbytes = (wbytes + (N * nw * 4 if int8 else 0) + R * K * 2
                          + R * N * 2)
                bound = nbytes / HBM * 1e3
                lib_ms = None
                if not int8 and epi == EPI_STORE:
                    lib_ms, _ = _time_queued(
                        lambda i: F.linear(x, ws[i % copies]))
                rec = dict(label=label, int8=int8, R=R, N=N, K=K, epi=epi,
                           ms=ms, tbps=nbytes / ms / 1e9, bound_ms=bound,
                           host_us=host_us, library_ms=lib_ms, gpu=gpu)
                readings.append(rec)
                print(f"skinny GEMM [{label} {'int8' if int8 else 'bf16'} "
                      f"R={R}] {N}x{K}: {ms:.5f} ms queued "
                      f"({nbytes / ms / 1e9:.3f} TB/s), bound {bound:.5f} ms "
                      f"({bound / ms:.3f} of it); host {host_us:.1f} us a "
                      "launch"
                      + ("" if lib_ms is None else
                         f"; F.linear {lib_ms:.5f} ms"), flush=True)
            del ws, ss
            torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(readings, f, indent=1)


NORM_SHAPES = (("qkv", 6144, 4096, False), ("gate/up", 14336, 4096, True))
EPS = 1e-5


def _norm(build, lib, gen, stream, rows, gpu):
    """K9's products (``--norm``): module docstring."""
    two = hasattr(lib, "desta_rms_norm_f32")
    readings = []
    for label, N, K, swiglu in NORM_SHAPES:
        nw = 2 if swiglu else 1
        epi = EPI_SWIGLU if swiglu else EPI_STORE
        copies = min(ITERS, max(2, -(-int(COLD_BYTES) // (N * nw * K))))
        ws = [torch.randint(-127, 128, (N * nw, K), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(copies)]
        ss = [torch.rand(N * nw, generator=gen, device="cuda") * 1e-3
              for _ in range(copies)]
        lw = (1 + 0.2 * torch.randn(K, generator=gen, device="cuda")
              ).bfloat16()
        for R in rows:
            h = torch.randn(R, K, generator=gen, device="cuda") * 3
            xn = (h.bfloat16().float() * torch.rsqrt(
                h.bfloat16().float().square().mean(-1, keepdim=True) + EPS)
                  * lw.float()).bfloat16()
            out = torch.empty(R, N, dtype=torch.bfloat16, device="cuda")

            def gemm(i):
                j = i % copies
                build.check(lib.desta_skinny_gemm(
                    xn.data_ptr(), ws[j].data_ptr(), ss[j].data_ptr(), None,
                    out.data_ptr(), R, N, K, epi, 1, stream), "skinny GEMM")

            def norm_and_gemm(i):
                build.check(lib.desta_rms_norm_f32(
                    h.data_ptr(), lw.data_ptr(), xn.data_ptr(), R, K, EPS,
                    stream), "rms_norm_f32")
                gemm(i)

            def fused_norm_gemv(i):
                j = i % copies
                build.check(lib.desta_tp_norm_gemv(
                    h.data_ptr(), lw.data_ptr(), EPS, ws[j].data_ptr(),
                    ss[j].data_ptr(), out.data_ptr(), R, N, K, int(swiglu),
                    stream), "fused-norm GEMV")
            ms, host_us = _time_queued(norm_and_gemm if two
                                       else fused_norm_gemv)
            gemm_ms = _time_queued(gemm)[0]
            nbytes = (N * nw * K + N * nw * 4 + R * K * 4 + K * 2
                      + R * N * 2)
            bound = nbytes / HBM * 1e3
            form = "norm + skinny GEMM" if two else "fused-norm GEMV"
            readings.append(dict(label=label, form=form, R=R, N=N, K=K,
                                 swiglu=swiglu, ms=ms, gemm_ms=gemm_ms,
                                 bound_ms=bound, host_us=host_us, gpu=gpu))
            print(f"K9 {label} [{form}, int8 R={R}] {N}x{K}: {ms:.5f} ms "
                  f"queued ({nbytes / ms / 1e9:.3f} TB/s), bound "
                  f"{bound:.5f} ms ({bound / ms:.3f} of it); the skinny GEMM "
                  f"alone {gemm_ms:.5f} ms; host {host_us:.1f} us a call",
                  flush=True)
        del ws, ss
        torch.cuda.empty_cache()
    return readings


if __name__ == "__main__":
    main()
