"""Where the time of the flagship ``generate()`` goes, on one GPU.

    python -m desta25_audio_tpu_torch.profile_generate [--batch 2] \
        [--int8-encoder] [--int8-llm] [--speculative-k K] [--orca
        [--float-stack] [--perlayer]] [--asr]

Builds the flagship configuration (configs/desta25_llama31-8B_Qformer6L.yaml,
bf16, random weights from a seed, CharTokenizer; with ``--int8-encoder``
the encoder is switched to the JAX package's inference default, int8 W8A8;
with ``--int8-llm`` the LLM is quantized to int8, ``apply_llm_quant``),
warms up once, then runs three phases under ``torch.profiler``: perception
(host phases, mel, encoder, Q-Former, splice), prefill (``llm_generate``
with one new token), and prefill + 31 greedy decode steps (with
``--speculative-k K >= 2``: ``llm_generate_spec`` verifying K tokens a step,
32 new tokens, the n-gram history seeded with the prompt ids, as
``generate()`` seeds it).  ``--orca`` profiles the ORCA model
(configs/desta25_llama31-8B_ORCAHybrid.yaml) at the serving setting: int8
encoder, int8 LLM and int8 cross-attention stack
(``apply_orca_xattn_quant``); perception then includes the local branch, a
phase of its own times the audio K/V precompute, and the decode steps run
the injection kernels (K8i).  ``--orca --float-stack`` keeps the f32
stack (the injection in PyTorch between the layers of a torch layer loop);
``--orca --perlayer`` keeps it too and sets the per-layer opt-in
(``ops/fused_decode_tp.FUSED_PERLAYER``, the ``DESTA_FUSED_PERLAYER``
path): the decode steps run the per-layer pair K9 with the PyTorch
injection between layers (through the decode graph's per-layer stepper,
``generate/graph.PerLayerStep``, and eagerly).  For each phase it prints
the wall time (host clock, device synchronised), the device busy time
(sum of kernel times), the idle share, and the kernels by total device
time.  Needs CUDA;
the numbers belong to the card it runs on (nvidia-smi's name and power
limit are printed first).  Device time is the union of the kernels'
spans (``_device_ms``: a kernel launched with programmatic dependent launch
overlaps its predecessor), each kernel credited with what it adds.  The
plain decode runs twice, through the decode step's CUDA graph
(``generate/graph.py``) and eagerly (``decode_graph=False``); each prints
the decode phase's wall and device time a step and its idle share (the full
run's less the prefill's, over the 31 steps), then three unprofiled runs'
host time a step with the graph's capture time, and the idle share of
their mean against the profiled device time (the profiler's own host cost
stretches the profiled walls).  The prefill and decode phases add the
device time by kernel group (``DECODE_GROUPS``: the decode attention, the
skinny GEMMs (K8's, K9's and, at M <= 16, K7's head:
``skinny_gemm_kernel<signed char, 1, 3>``), RMSNorm (K8's and K9's), K7's
mma path (its wgmma kernel at 16 < M < 128: the b1 int8 prefill's layer
products and its head over the prompt's rows), K8i's attention and gate,
the W8A8 prefill, other).
Last, the launch counts over the profiled phases and the torch paths taken
there (``_build.fallback_counts()``: a model shape a kernel's predicate
refused).

``--asr`` profiles instead the ASR phase of ``generate()`` on the same clips
without transcriptions (``DeSTA25AudioModel._asr``: its mel, the encoder
pass, the cross K/V and the Whisper decoder's 128 eager steps, greedy, a
character detokenizer standing in for the hub's): the wall and device time,
the idle share and the top kernels, the device time by group (the encoder's
hand-written kernels K1-K6 by name; the rest by the torch op that launched
each kernel: the decoder's GEMMs ``aten::mm``/``addmm``, the attention's
products ``aten::bmm``, the cuDNN conv stem, elementwise and casts, and
kernels no op claims), then three unprofiled calls' ``asr_ms`` and ms a
decode step.
"""

from __future__ import annotations

import argparse
import inspect
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from .audio.io import AudioSegment, write_wav
from .config import config_from_yaml_file
from .data.tokenizer import CharTokenizer
from .generate.decode import build_injection, llm_generate
from .generate.speculative import left_aligned, llm_generate_spec
from .models.desta import DeSTA25AudioModel, _CharASR
from .ops import _build, fused_decode_tp
from .utils.profiling import trace

NEW_TOKENS = 32
UNPROFILED_RUNS = 3   # the decode's host-clock time, without the profiler
# the prefill's and the decode phases' device time by group (kernel-name
# substrings)
DECODE_GROUPS = {
    "decode attention": ("decode_attention",),
    "skinny GEMMs": ("skinny_gemm",),
    "RMSNorm": ("rms_norm",),
    # K7 at 16 < M < 128: qmm_wgmma_kernel (earlier checkouts: qmm_mma_kernel
    # and qmm_reduce_kernel); at M <= 16 (the decode heads) a skinny GEMM
    "K7 mma path": ("qmm_",),
    "K8i attention": ("inject_attention",),
    "K8i gate": ("inject_gate",),
    # the int8 GEMM of csrc/gemm_sm90.cuh (earlier checkouts: gemm_s8_kernel)
    "W8A8 prefill": ("gemm_kernel<signed char", "gemm_s8", "quant_rows"),
}
# the ASR phase's groups: the encoder's hand-written kernels (K1-K6) by name,
# the torch kernels by the op that launched them
ASR_ENCODER_KERNELS = ("log_mel", "enc_attention", "gemm_kernel",
                       "quant_rows")
ASR_OP_GROUPS = {
    "decoder GEMMs": ("aten::mm", "aten::addmm", "aten::matmul",
                      "aten::linear"),
    "attention products": ("aten::bmm", "aten::baddbmm"),
    "conv stem (cuDNN)": ("aten::cudnn_convolution", "aten::convolution",
                          "aten::_convolution"),
}
_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
CONFIG = os.path.join(_CONFIGS, "desta25_llama31-8B_Qformer6L.yaml")
ORCA_CONFIG = os.path.join(_CONFIGS, "desta25_llama31-8B_ORCAHybrid.yaml")


def _device_ms(prof):
    """{kernel name: (device ms, launches)} over the trace, each kernel
    taking the time it alone adds to the device's busy time: kernels in
    order of their start, each credited with the part of its span past
    every earlier kernel's end.  With programmatic dependent launch a
    kernel starts while the one before it drains and waits for it, so raw
    kernel durations overlap and their sum can exceed the wall; these
    times sum to the union of the spans, the time the device had a kernel
    running."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    out, covered = {}, float("-inf")
    for start, end, name in spans:
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + max(0.0, end - max(start, covered)) / 1e3, n + 1)
        covered = max(covered, end)
    return out


def report(name: str, fn, top: int = 12, groups=None, stats=None):
    """Run fn() under the profiler and print its wall time, device busy
    time (:func:`_device_ms`), idle share and top kernels; ``groups``
    ({label: name substrings}) adds the device time per group, the first
    matching group taking a kernel, the rest counted as "other".  A
    ``stats`` list gets (wall ms, busy ms) appended."""
    torch.cuda.synchronize()
    with trace() as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_ms(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    print(f"== {name}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    if stats is not None:
        stats.append((wall_ms, busy_ms))
    for key, (ms, n) in sorted(kernels.items(), key=lambda kv: kv[1][0],
                               reverse=True)[:top]:
        print(f"   {ms:9.3f} ms  x{n:<6d} {key[:100]}")
    if groups:
        sums = dict.fromkeys([*groups, "other"], 0.0)
        for key, (ms, _) in kernels.items():
            label = next((g for g, subs in groups.items()
                          if any(s in key for s in subs)), "other")
            sums[label] += ms
        print("   by group: " + "; ".join(f"{g} {ms:.2f} ms"
                                          for g, ms in sums.items()))
    return out


def _op_device_ms(prof):
    """{torch op name: device ms of the kernels the op launched itself}
    (the profiler links each kernel to its launching op)."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            out[e.name] = (out.get(e.name, 0.0)
                           + sum(k.duration for k in e.kernels) / 1e3)
    return out


def profile_asr(model, clips) -> None:
    """The ASR phase of generate() on ``clips`` [N, samples] under the
    profiler, grouped (module docstring), then unprofiled."""
    model._asr(clips)                       # warm-up
    timings = {}
    torch.cuda.synchronize()
    with trace() as prof:
        t0 = time.perf_counter()
        texts = model._asr(clips, timings=timings)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_ms(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    steps = timings["asr_steps"]
    print(f"== ASR b{clips.shape[0]} ({steps} decoder steps after the "
          f"prefix): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    for key, (ms, n) in sorted(kernels.items(), key=lambda kv: kv[1][0],
                               reverse=True)[:12]:
        print(f"   {ms:9.3f} ms  x{n:<6d} {key[:100]}")
    groups = {"encoder kernels (K1-K6)": sum(
        ms for key, (ms, _) in kernels.items()
        if any(s in key for s in ASR_ENCODER_KERNELS))}
    ops = _op_device_ms(prof)
    for label, names in ASR_OP_GROUPS.items():
        groups[label] = sum(ms for op, ms in ops.items() if op in names)
    claimed = {op for names in ASR_OP_GROUPS.values() for op in names}
    groups["elementwise and casts"] = sum(ms for op, ms in ops.items()
                                          if op not in claimed)
    groups["no op"] = busy_ms - sum(groups.values())
    print("   by group: " + "; ".join(f"{g} {ms:.2f} ms"
                                      for g, ms in groups.items())
          + (" (the profiler linked no kernel to an op: groups by op are "
             "empty)" if not ops else ""))
    print(f"   decode: {timings['asr_decode_ms'] / max(steps, 1):.3f} ms a "
          f"step (profiled); transcripts {[t[:24] for t in texts]}")
    for _ in range(UNPROFILED_RUNS):
        t = {}
        model._asr(clips, timings=t)
        print(f"   unprofiled: asr_ms {t['asr_ms']:.1f}, decode "
              f"{t['asr_decode_ms'] / max(t['asr_steps'], 1):.3f} ms a step "
              f"over {t['asr_steps']} steps, idle share "
              f"{1 - busy_ms / t['asr_ms']:.3f} against the profiled device "
              "time")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--int8-encoder", action="store_true",
                    help="the JAX package's inference encoder: "
                    "apply_inference_encoder_quant() (int8 FFN, dual "
                    "attention leaves) before the runs")
    ap.add_argument("--int8-llm", action="store_true",
                    help="quantize the LLM to int8 (apply_llm_quant) "
                    "before the runs")
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="decode phase: speculative decoding verifying K "
                    "tokens a step (K >= 2)")
    ap.add_argument("--orca", action="store_true",
                    help="the ORCA model at the serving setting (int8 "
                    "encoder, LLM and cross-attention stack)")
    ap.add_argument("--float-stack", action="store_true",
                    help="with --orca: keep the f32 cross-attention stack "
                    "(the injection in PyTorch, a torch layer loop)")
    ap.add_argument("--perlayer", action="store_true",
                    help="with --orca: keep the f32 stack and decode through "
                    "the per-layer pair K9 (DESTA_FUSED_PERLAYER)")
    ap.add_argument("--asr", action="store_true",
                    help="profile the ASR phase (Whisper's mel, encoder "
                    "pass and decoder) on the clips without transcriptions")
    args = ap.parse_args()
    if (args.perlayer or args.float_stack) and not args.orca:
        raise SystemExit("--float-stack and --perlayer profile the ORCA "
                         "float-stack decode: add --orca")
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = config_from_yaml_file(ORCA_CONFIG if args.orca else CONFIG)
    model = DeSTA25AudioModel(cfg, device="cuda", seed=0,
                              tokenizer=CharTokenizer("llama3"))
    if args.int8_encoder or args.orca:
        model.apply_inference_encoder_quant()
    if args.int8_llm or args.orca:
        model.apply_llm_quant()
    if args.perlayer:
        fused_decode_tp.FUSED_PERLAYER = True
    elif args.orca and not args.float_stack:
        model.apply_orca_xattn_quant()
        torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d, torch.no_grad():
        convs = []
        for i in range(args.batch):
            t = np.arange(int((3 + i) * 16000)) / 16000.0
            sig = (0.5 * np.sin(2 * np.pi * (300 + 50 * i) * t)
                   * (np.sin(6 * t) > 0) + 0.01 * rng.standard_normal(t.size))
            path = os.path.join(d, f"clip{i}.wav")
            write_wav(path, sig.astype(np.float32))
            convs.append([{"role": "user",
                           "content": f"Clip {i}: <|AUDIO|> What is it?",
                           "audios": [{"audio": path,
                                       "text": "a synthetic tone"}]}])
        if args.asr:
            model._whisper_tokenizer = _CharASR()
            clips = np.zeros((args.batch, cfg.encoder_config
                              .expected_mel_frames * 160), np.float32)
            for j, conv in enumerate(convs):
                seg = AudioSegment.from_file(conv[0]["audios"][0]["audio"])
                clips[j, :seg.num_samples] = seg.samples
            _build.reset_launch_counts()
            profile_asr(model, clips)
            print(f"launches: {_build.launch_counts()}; torch paths taken: "
                  f"{_build.fallback_counts()}")
            return
        model.generate(convs, do_sample=False, max_new_tokens=2,
                       speculative_k=args.speculative_k)  # warm-up
        _build.reset_launch_counts()
        embeds, mask, aux, _, _, prompt_ids = report(
            f"perception b{args.batch}",
            lambda: model._run_generation_phases(convs, {},
                                                 return_prompt_ids=True))
        common = dict(do_sample=False, eos_ids=(),
                      pad_id=model.tokenizer.pad_token_id)
        llm, cfg = model.params["llm"], model.llm_cfg
        tokens = model._orca_inject_tokens(aux)
        if tokens is not None:
            common.update(inject_params=model.params["orca_cross_attns"],
                          inject_tokens=tokens,
                          inject_scale=model.config.orca_audio_position_scale,
                          inject_heads=cfg.num_attention_heads)
            report(f"audio K/V precompute b{args.batch} (Ta="
                   f"{tokens.shape[1]}, {cfg.num_hidden_layers} layers)",
                   lambda: build_injection(
                       cfg, common["inject_params"], tokens,
                       common["inject_scale"], common["inject_heads"]))

        def gen(n, **kw):
            return lambda: llm_generate(llm, cfg, embeds, mask,
                                        model.generator, max_new_tokens=n,
                                        **common, **kw)
        pre = []
        report(f"prefill b{args.batch} (T={embeds.shape[1]})", gen(1),
               groups=DECODE_GROUPS, stats=pre)
        if args.speculative_k >= 2:
            lens = mask.sum(1).cpu().numpy()
            aligned = torch.as_tensor(left_aligned(prompt_ids, lens),
                                      device="cuda")
            stats = {}
            report(f"prefill + speculative decode (k={args.speculative_k}, "
                   f"{NEW_TOKENS} tokens) b{args.batch}",
                   lambda: llm_generate_spec(
                       llm, cfg, embeds, mask, model.generator,
                       max_new_tokens=NEW_TOKENS,
                       speculative_k=args.speculative_k, prompt_ids=aligned,
                       prompt_lens=torch.as_tensor(lens, device="cuda"),
                       timings=stats, **common), groups=DECODE_GROUPS)
            print(f"   {stats['decode_steps']} verify steps, "
                  f"{stats['spec_tokens']} tokens after the first")
        else:
            # the graph and the eager step (a checkout without the graph
            # has its one path)
            modes = ((("graph", {}), ("eager", {"decode_graph": False}))
                     if "decode_graph" in inspect.signature(
                         llm_generate).parameters else (("eager", {}),))
            for mode, kw in modes:
                full = []
                report(f"prefill + {NEW_TOKENS - 1} decode steps "
                       f"b{args.batch} ({mode})", gen(NEW_TOKENS, **kw),
                       groups=DECODE_GROUPS, stats=full)
                steps = NEW_TOKENS - 1
                wall = (full[0][0] - pre[0][0]) / steps
                busy = (full[0][1] - pre[0][1]) / steps
                print(f"   decode ({mode}): {wall:.3f} ms wall a step, "
                      f"{busy:.3f} ms device a step, idle share "
                      f"{1 - busy / wall:.3f} (the profiled runs' "
                      "difference)")
                walls = []
                for _ in range(UNPROFILED_RUNS):
                    timed = {}
                    gen(NEW_TOKENS, timings=timed, **kw)()
                    walls.append(timed["decode_ms"] / timed["decode_steps"])
                    print(f"   decode ({mode}), unprofiled: {walls[-1]:.3f}"
                          f" ms a step over {timed['decode_steps']} steps, "
                          f"graph capture "
                          f"{timed.get('graph_capture_ms', 0.0):.1f} ms "
                          "inside them")
                mean = sum(walls) / len(walls)
                print(f"   decode ({mode}): idle share {1 - busy / mean:.3f}"
                      f" of the unprofiled {mean:.3f} ms a step (mean) "
                      f"against the profiled device time")
        print(f"launches over the profiled phases: "
              f"{_build.launch_counts()}; torch paths taken: "
              f"{_build.fallback_counts()}")


if __name__ == "__main__":
    main()
