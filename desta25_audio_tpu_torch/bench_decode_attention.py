"""Device time of the decode attention launch (``csrc/decode_attention.cuh``)
at the decode and verify shapes of Llama-3.1-8B, on one GPU.

    python -m desta25_audio_tpu_torch.bench_decode_attention [--root DIR]

Calls the C entry point ``desta_decode_attention`` of the package found
under ``--root`` (default: this checkout), so that the same script times an
older checkout's kernel, whose entry point has the same arguments, beside
this one's (unpack it with ``git archive`` under ``exp/``).  Inputs are
random from a seed: bf16 qkv rows and a cache [B, S, 8*128], H=32, Hkv=8,
a mask with row 0 left-padded by 10.  Each time is the mean of 50 launches
queued behind a sleep kernel (the card's time, not the Python launch
path's), printed beside the bound: the cached K/V rows below ci, the qkv
rows, the output and the written rows, once each, over 3.35 TB/s, and the
host's time to enqueue a launch (the ctypes call into the C entry point,
taken while the card sleeps).  Needs CUDA; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import importlib
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
H, HKV, DH = 32, 8, 128
ITERS = 50


def _time_queued(fn):
    """(device ms, host us) a launch: ITERS launches queued behind a sleep
    kernel, timed by CUDA events on the card and by the host clock around
    their enqueueing (the card sleeps meanwhile)."""
    fn()
    torch.cuda.synchronize()
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_attention needs a CUDA device")
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules
                     if m.startswith("desta25_audio_tpu_torch")]:
            del sys.modules[name]
    build = importlib.import_module("desta25_audio_tpu_torch.ops._build")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"kernels of {build.CSRC}")
    lib = build.library()
    gen = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
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
        ms, host_us = _time_queued(launch)
        keys = sum(min(c, S) for c in ci)
        written = sum(max(0, min(c + kd, S) - c) for c in ci)
        nbytes = (keys * KVD * 4 + keys * 4 + qkv.numel() * 2
                  + 2 * cos.numel() * 4 + R * H * DH * 2 + written * KVD * 4)
        bound = nbytes / 3.35e12 * 1e3
        print(f"decode attention [{label}] B={B} S={S} Kd={kd} ci={list(ci)}"
              f": {ms:.5f} ms queued ({nbytes / ms / 1e6:.1f} GB/s), bound "
              f"{bound:.5f} ms (bytes: {nbytes}), {bound / ms:.3f} of it; "
              f"host {host_us:.1f} us a launch (the ctypes call)", flush=True)


if __name__ == "__main__":
    main()
