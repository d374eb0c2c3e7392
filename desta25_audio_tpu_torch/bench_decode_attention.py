"""Device time of the decode step's attention launches on one GPU: the
decode attention (``csrc/decode_attention.cuh``) at the decode and verify
shapes of Llama-3.1-8B, and K8i's injection attention and gate
(``csrc/fused_inject.cu``) at the ORCA decode and verify shapes of
Llama-3.1-8B and Qwen3-4B.

    python -m desta25_audio_tpu_torch.bench_decode_attention [--root DIR] \
        [--json PATH]

Calls the C entry points ``desta_decode_attention``,
``desta_inject_attention`` and ``desta_inject_gate`` of the package found
under ``--root`` (default: this checkout), so that the same script times an
older checkout's kernels, whose entry points have the same arguments,
beside this one's (unpack it with ``git archive`` under ``exp/``; time each
checkout in its own process).  Inputs are random from a seed.  The decode
attention: bf16 qkv rows and a cache [B, S, 8*128], H=32, Hkv=8, a mask
with row 0 left-padded by 10.  The injection: q rows [B*Kd, D] and one
layer's audio K/V [B, Ta, D] in bf16 (Ta=375, and B=4 Ta=3000 whose key
ranges exceed shared memory and are read from global memory); the gate's
h, ig, iao rows (Dg = D/4) and its f32 weights.  Each time is the mean of
50 launches queued behind a sleep kernel (the card's time, not the Python
launch path's), printed beside the bound: the bytes (inputs read once,
outputs written once) over 3.35 TB/s, or the f32 operations over 67
TFLOP/s where larger, and the host's time to enqueue a launch (the ctypes
call into the C entry point, taken while the card sleeps); the injection's
kernels also back to back (CUDA events without the sleep: the host's call
included).  Needs CUDA; prints the card's name and power limit first;
``--json`` writes the readings.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time

import torch

SHAPES = (  # label, B, S, kd, ci
    ("b2 decode", 2, 256, 1, (100, 200)),
    ("b2 verify", 2, 256, 4, (100, 252)),
    ("long cache", 2, 4096, 1, (3000, 4095)),
    ("b8", 8, 1024, 1, (900, 1000, 64, 1023, 512, 700, 300, 100)),
)
INJECT = (  # label, B, kd, Ta, D, heads
    ("Llama-3.1-8B b2 decode", 2, 1, 375, 4096, 32),
    ("Llama-3.1-8B b1 decode", 1, 1, 375, 4096, 32),
    ("Llama-3.1-8B b2 verify", 2, 4, 375, 4096, 32),
    ("Qwen3-4B b2 decode", 2, 1, 375, 2560, 32),
    ("Llama-3.1-8B b4 Ta=3000 (keys from global memory)", 4, 1, 3000, 4096,
     32),
)
GATE = (  # label, R, kd, D
    ("Llama-3.1-8B b2 decode", 2, 1, 4096),
    ("Llama-3.1-8B b1 decode", 1, 1, 4096),
    ("Llama-3.1-8B b2 verify", 8, 4, 4096),
    ("Qwen3-4B b2 decode", 2, 1, 2560),
)
H, HKV, DH = 32, 8, 128
ITERS = 50
HBM, F32 = 3.35e12, 67e12


def _time(fn, queued: bool = True):
    """(device ms, host us) a launch: ITERS launches queued behind a sleep
    kernel (or back to back), timed by CUDA events on the card and by the
    host clock around their enqueueing (the card sleeps meanwhile)."""
    fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(40_000_000)  # ~20 ms: the launches queue behind it
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    host_us = (time.perf_counter() - t0) / ITERS * 1e6
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS, host_us


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="checkout whose desta25_audio_tpu_torch to time")
    ap.add_argument("--json", default=None, help="write the readings here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_attention needs a CUDA device")
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
    bf = torch.bfloat16
    readings = []
    for label, B, S, kd, ci in SHAPES:
        R, KVD = B * kd, HKV * DH
        qkv = torch.randn(R, (H + 2 * HKV) * DH, generator=gen,
                          device="cuda").bfloat16()
        kc, vc = torch.randn(2, B, S, KVD, generator=gen,
                             device="cuda").bfloat16()
        ang = torch.rand(R, DH // 2, generator=gen, device="cuda") * 6.2832
        cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
        sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
        mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
        mask[0, :10] = 0
        ci_t = torch.tensor(ci, dtype=torch.int32, device="cuda")
        out = torch.empty(R, H * DH, dtype=torch.bfloat16, device="cuda")

        def launch():
            build.check(lib.desta_decode_attention(
                qkv.data_ptr(), kc.data_ptr(), vc.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), mask.data_ptr(), S, ci_t.data_ptr(), None,
                None, out.data_ptr(), B, kd, S, H, HKV, DH, 1e-5,
                DH ** -0.5, stream), "desta_decode_attention")
        ms, host_us = _time(launch)
        keys = sum(min(c, S) for c in ci)
        written = sum(max(0, min(c + kd, S) - c) for c in ci)
        nbytes = (keys * KVD * 4 + keys * 4 + qkv.numel() * 2
                  + 2 * cos.numel() * 4 + R * H * DH * 2 + written * KVD * 4)
        bound = nbytes / HBM * 1e3
        readings.append(dict(kernel="decode_attention", label=label, ms=ms,
                             bound_ms=bound, host_us=host_us, gpu=gpu))
        print(f"decode attention [{label}] B={B} S={S} Kd={kd} ci={list(ci)}"
              f": {ms:.5f} ms queued ({nbytes / ms / 1e6:.1f} GB/s), bound "
              f"{bound:.5f} ms (bytes: {nbytes}), {bound / ms:.3f} of it; "
              f"host {host_us:.1f} us a launch (the ctypes call)", flush=True)

    def report(kernel, label, fn, nbytes, ops):
        (q, host_us), (b2b, _) = _time(fn), _time(fn, queued=False)
        bound = max(nbytes / HBM, ops / F32) * 1e3
        readings.append(dict(kernel=kernel, label=label, ms=q,
                             back_to_back_ms=b2b, bound_ms=bound,
                             host_us=host_us, gpu=gpu))
        print(f"{kernel} [{label}]: {q:.5f} ms queued ({nbytes / q / 1e6:.1f}"
              f" GB/s, {bound / q:.3f} of the bound), {b2b:.5f} back to "
              f"back, bound {bound:.5f} ms; host {host_us:.1f} us a launch",
              flush=True)

    for label, B, kd, Ta, D, heads in INJECT:
        iq = (torch.randn(B * kd, D, generator=gen, device="cuda") * 2).to(bf)
        kv = torch.randn(2, B, Ta, D, generator=gen, device="cuda").to(bf)
        out = torch.empty_like(iq)
        ptrs = (iq.data_ptr(), kv[0].data_ptr(), kv[1].data_ptr(),
                out.data_ptr())

        def attn(ptrs=ptrs, B=B, kd=kd, Ta=Ta, D=D, heads=heads):
            build.check(lib.desta_inject_attention(
                *ptrs, B, kd, Ta, Ta, D, heads, (D // heads) ** -0.5,
                stream), "desta_inject_attention")
        report("inject_attention", label, attn,
               2 * B * Ta * D * 2 + 2 * B * kd * D * 2, 4 * Ta * D * B * kd)

    for label, R, kd, D in GATE:
        Dg = D // 4
        f = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                   device="cuda")
        h, ig, iao = f(R, D).to(bf), (0.5 * f(R, Dg)).to(bf), (
            3 * f(R, D) + 1).to(bf)
        wg2, bg2, lns, lnb = 0.2 * f(Dg), 0.1 * f(1), 1 + 0.1 * f(D), \
            0.1 * f(D)
        on = torch.ones(R // kd, device="cuda")
        ptrs = tuple(t.data_ptr() for t in (h, ig, iao, wg2, bg2, lns, lnb,
                                            on))

        def gate(ptrs=ptrs, R=R, kd=kd, D=D, Dg=Dg):
            build.check(lib.desta_inject_gate(*ptrs, R, kd, D, Dg, stream),
                        "desta_inject_gate")
        report("inject_gate", label, gate,
               R * Dg * 2 + 3 * R * D * 2 + Dg * 4 + 4 + 2 * D * 4
               + (R // kd) * 4, R * (2 * Dg + 10 * D))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(readings, fh, indent=1)


if __name__ == "__main__":
    main()
