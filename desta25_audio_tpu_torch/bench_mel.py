"""Device time of K1, the log-mel frontend (``csrc/mel.cu``), on one GPU.

    python -m desta25_audio_tpu_torch.bench_mel [--root DIR] [--json PATH]

Calls ``ops/mel.log_mel_spec`` of the package found under ``--root``
(default: this checkout), so that the same script times an older
checkout's kernel, whose wrapper takes the same arguments, beside this
one's (unpack it with ``git archive`` under ``exp/``; time each checkout in
its own process).  Audio: B = 1, 2 and 4 clips of 3000 frames (30 s at
16 kHz) of noise plus a 523 Hz tone, random from a seed, 128 mels (the
flagship encoder's).  For each B: the kernel's time queued behind a sleep
kernel (the card's time, not the Python launch path's) and back to back
(``chip_smoke.py``'s kernels-line method), the plain version's
(``log_mel_spec_plain``, the JAX formula's three dense products), the
bound (:func:`mel_work`: the larger of the bytes over 3.35 TB/s and the
operations over 67 TFLOP/s f32) and, as information, :func:`stft_log_mel`:
``torch.stft`` (cuFFT) followed by the dense filterbank product and log10
on the same audio, three calls that the port never makes.  Also the
kernel's max |kernel - plain| over the bins above the clip-wide clamp and
whether two launches gave the same bits, and, over the same bins, the
kernel's and the plain version's distance from a float64 reference
(:func:`stft_log_mel` in float64): the largest, which sits at a bin whose
power cancelled to a small share of its frame's, and the median and
99.99th percentile.  Each time is the mean of ITERS
calls after a warm-up.  Needs CUDA; prints the card's name and power limit
first; ``--json`` writes the readings.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ITERS = 20
FRAMES, N_MELS = 3000, 128


def mel_work(B: int, frames: int, n_mels: int):
    """(bytes, operations) of K1 on [B, frames * 160] audio.  Bytes: the
    audio read once, the output written once and the tables the kernel
    reads (``ops/mel.kernel_tables``: the window [400] and twiddles
    [401, 2] f32, the sparse filterbank's index [n_mels, 3] int32 and its
    weights [402] f32), about 8 KB, read once.  Operations: what the
    function needs, not a dense DFT's: per frame the window (400
    multiplies), a real 400-point FFT (2.5 N log2 N, half a complex FFT's
    5 N log2 N), the power (3 a bin), 2 per nonzero filterbank entry (the
    slaney filters overlap at most two a bin) and one log a mel."""
    from desta25_audio_tpu_torch.audio.mel import mel_filter_bank
    tables = 4 * (400 + 401 * 2 + n_mels * 3 + 2 * 201)
    nb = 4 * (B * frames * 160 + B * frames * n_mels) + tables
    nnz = int(np.count_nonzero(mel_filter_bank(n_mels)))
    per_frame = 400 + 2.5 * 400 * np.log2(400) + 3 * 201 + 2 * nnz + n_mels
    return nb, B * frames * per_frame


def mel_bound_ms(B: int, frames: int, n_mels: int):
    """(least ms, "bytes" or "operations") of :func:`mel_work` on the
    H100's 3.35 TB/s and 67 TFLOP/s f32 (``chip_smoke.bound``'s rates)."""
    nb, ops = mel_work(B, frames, n_mels)
    t_bytes = nb / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stft_log_mel(audio: torch.Tensor, fb: torch.Tensor,
                 window: torch.Tensor) -> torch.Tensor:
    """The same log10 mel energies through ``torch.stft`` (centered,
    reflect-padded, the last frame dropped as WhisperFeatureExtractor does),
    the dense filterbank ``fb`` [201, n_mels] and log10: the yardstick of
    three library calls, timed as information."""
    spec = torch.stft(audio, 400, 160, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2                  # [B, 201, frames]
    return torch.log10(torch.clamp(power.transpose(1, 2) @ fb, min=1e-10))


def time_ms(fn, queued: bool = True, iters: int = ITERS) -> float:
    """Mean device ms of fn() over ``iters`` calls queued behind a sleep
    kernel (``queued``) or back to back."""
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


def signal(B: int, frames: int, gen: torch.Generator) -> torch.Tensor:
    """[B, frames * 160] noise (std 0.3) plus a 523 Hz tone on clip 0."""
    n = frames * 160
    t = torch.arange(n, device="cuda") / 16000.0
    audio = 0.3 * torch.randn(B, n, generator=gen, device="cuda")
    audio[0] += 0.5 * torch.sin(2 * torch.pi * 523.0 * t)
    return audio


def queued_ms(log_mel_spec, audio: torch.Tensor, fb: torch.Tensor,
              window: torch.Tensor):
    """(K1's ms, :func:`stft_log_mel`'s ms) on ``audio`` at ``fb``'s mel
    count, each queued behind a sleep kernel: the sweep that
    ``chip_smoke.py`` phase 4 prints and :func:`main` records."""
    n_mels = fb.shape[1]
    return (time_ms(lambda: log_mel_spec(audio, n_mels)),
            time_ms(lambda: stft_log_mel(audio, fb, window)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="checkout whose desta25_audio_tpu_torch to time")
    ap.add_argument("--json", default=None, help="write the readings here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_mel needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.root:
        sys.path.insert(0, args.root)
        for name in [m for m in sys.modules
                     if m.startswith("desta25_audio_tpu_torch")]:
            del sys.modules[name]
    pkg = "desta25_audio_tpu_torch"
    build = importlib.import_module(pkg + ".ops._build")
    mel = importlib.import_module(pkg + ".ops.mel")
    amel = importlib.import_module(pkg + ".audio.mel")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    print(f"kernels of {build.CSRC}")
    build.library()
    gen = torch.Generator("cuda").manual_seed(0)
    fb = torch.as_tensor(amel.mel_filter_bank(N_MELS), device="cuda")
    window = torch.hann_window(400, periodic=True, device="cuda")
    readings = []
    with torch.no_grad():
        for B in (1, 2, 4):
            audio = signal(B, FRAMES, gen)
            got = mel.log_mel_spec(audio, N_MELS)
            again = mel.log_mel_spec(audio, N_MELS)
            want = mel.log_mel_spec_plain(audio, N_MELS)
            live = want > want.amax(dim=(1, 2), keepdim=True) - 8.0
            err = float((got - want).abs()[live].max())
            ref = stft_log_mel(audio.double(), fb.double(), window.double())
            f64 = [torch.quantile((v.double() - ref).abs()[live].cpu(),
                                  torch.tensor([1.0, 0.9999, 0.5],
                                               dtype=torch.float64)).tolist()
                   for v in (got, want)]
            ms, stft = queued_ms(mel.log_mel_spec, audio, fb, window)
            b2b = time_ms(lambda: mel.log_mel_spec(audio, N_MELS),
                          queued=False)
            plain = time_ms(lambda: mel.log_mel_spec_plain(audio, N_MELS))
            bound, by = mel_bound_ms(B, FRAMES, N_MELS)
            row = dict(B=B, frames=FRAMES, n_mels=N_MELS, ms=ms,
                       back_to_back_ms=b2b, plain_ms=plain, stft_ms=stft,
                       bound_ms=bound, bound_by=by, max_abs_err=err,
                       kernel_vs_f64=f64[0], plain_vs_f64=f64[1],
                       bit_identical=bool(torch.equal(got, again)), gpu=gpu)
            readings.append(row)
            print(f"K1 B={B} x {FRAMES} frames x {N_MELS} mels: "
                  f"{ms:.5f} ms queued ({bound / ms:.3f} of the bound), "
                  f"{b2b:.5f} back to back, plain {plain:.5f}, torch.stft + "
                  f"filterbank + log10 {stft:.5f} (information), bound "
                  f"{bound:.5f} ms ({by}); max_abs_err {err:.3e} above the "
                  f"clamp; from a float64 reference, largest / 99.99th "
                  f"percentile / median: kernel "
                  + " / ".join(f"{e:.3e}" for e in f64[0]) + ", plain "
                  + " / ".join(f"{e:.3e}" for e in f64[1])
                  + "; two launches bit-identical: "
                  f"{row['bit_identical']}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(readings, f, indent=1)


if __name__ == "__main__":
    main()
