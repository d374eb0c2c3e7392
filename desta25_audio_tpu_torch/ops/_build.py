"""Build, load and count the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into one
shared library with a plain C interface, at first use, under
``build/desta25_audio_tpu_torch/`` at the repository root.  The output name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  The library is bound with ``ctypes``: tensors
go in as ``data_ptr()`` pointers and the stream as
``torch.cuda.current_stream().cuda_stream``, all ``c_void_p``.  Each C entry
point launches its kernel and returns ``cudaGetLastError()``; :func:`check`
raises on anything but 0.  The headers (``csrc/*.cuh``, among them
``attention_sm90.cuh``, the TMA / mbarrier / wgmma pieces of K2 and K11,
and ``gemm_sm90.cuh``, the GEMM of K3-K6)
are part of the hash.  The link needs no ``-lcuda``: the one libcuda
function used, ``cuTensorMapEncodeTiled``, is looked up at run time
(``cudaGetDriverEntryPoint``).

Launch counts: each kernel wrapper calls :func:`count_launch` once per kernel
it launches (never on the plain CPU path), so a caller can show that a run
went through the kernels (``reset_launch_counts`` / ``launch_counts``).  A
kernel that a wrapper launches among others under the wrapper's name (the
decode attention inside the decode step) is also counted by its own name
with :func:`count_kernel` (``kernel_counts``), apart from the wrappers'
counts, which keep their meaning.  A model that takes its torch path
because a kernel's predicate refuses the shape counts that with
:func:`count_fallback` (``fallback_counts``).  A CUDA graph capture
(``generate/graph.py``) records launches without running them: it takes
what it counted back out of the counters with :func:`take_counts` and adds
it again on every replay with :func:`add_counts`, so that the counts read
as the eager path's.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "desta25_audio_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)

# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES: Dict[str, Tuple] = {
    # q, k, v, out, part, part_ml, B, Tq, Tkv, H, scale, splits,
    # tiles per split, stream
    "desta_enc_attention": (_P,) * 6 + (_I,) * 4 + (_F, _I, _I, _P),
    # part, part_ml, out, B, Tq, H, splits, stream
    "desta_enc_attention_combine": (_P,) * 3 + (_I,) * 4 + (_P,),
    # a, w, bias, out, M, N, K, gelu, bm, bn, cluster, stream
    "desta_gemm_bias": (_P, _P, _P, _P) + (_I,) * 7 + (_P,),
    # x, w, out, rows, D, eps, stream (x bf16; _f32: x f32)
    "desta_rms_norm": (_P, _P, _P, _I, _I, _F, _P),
    "desta_rms_norm_f32": (_P, _P, _P, _I, _I, _F, _P),
    # x, w, scale, bias, out, M, N, K, epilogue, w_int8, stream
    "desta_skinny_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # rows, K, w_int8, out [4]: ranks, k-tiles a rank, k-tiles, row tiles
    "desta_skinny_gemm_plan": (_I, _I, _I, _P),
    # iq, ka, va, out, B, kd, Ta, ta_real, D, heads, scale, stream
    "desta_inject_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                               _P),
    # B, kd, ta_real, D, heads, out [4]: ranges, keys per range, shared
    # bytes, resident
    "desta_inject_attention_plan": (_I,) * 5 + (_P,),
    # h, ig, iao, wg2, bg2, ln scale, ln bias, on, R, kd, D, Dg, stream
    "desta_inject_gate": (_P,) * 8 + (_I, _I, _I, _I, _P),
    # qkv, k_cache, v_cache, cos, sin, mask, mask_stride, ci, q_norm,
    # k_norm, out, B, kd, S, H, Hkv, Dh, eps, scale, stream
    "desta_decode_attention": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # B, Hkv, kd, S, H, out [3]: ranges, keys per range, shared bytes
    "desta_decode_attention_plan": (_I,) * 5 + (_P,),
    # x, q, scale, M, K, seg, div127, stream
    "desta_quant_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, q, s, out, M, N, K, splits (0: the plan's), out_f32, stream
    "desta_qmm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # M, N, K, n_sm (0: the device's), out [5]: nx, splits, k-tiles a rank,
    # k-tiles, weight tiles
    "desta_qmm_plan": (_I, _I, _I, _I, _P),
    # nx, splits, out [1]: clusters the card runs at once
    "desta_qmm_max_clusters": (_I, _I, _P),
    # epi, a, sa, nproj, (w, s, bias, out) x 3, out scales, M, N, K, seg,
    # bm, bn, splits, cluster, stream
    "desta_gemm_s8": (_I, _P, _P, _I) + (_P,) * 13 + (_I,) * 8 + (_P,),
    # bm, bn, splits, out [1]: clusters the card runs at once
    "desta_gemm_max_clusters": (_I, _I, _I, _P),
    # q, k, v, seg, o, lse, B, T, H, Hkv, Dh, causal, scale, stream
    "desta_flash_fwd": (_P,) * 6 + (_I,) * 6 + (_F, _P),
    # o, dO, delta, B, T, H, Dh, stream
    "desta_flash_bwd_delta": (_P,) * 3 + (_I,) * 4 + (_P,),
    # q, k, v, seg, dO, lse, delta, dk, dv, B, T, H, Hkv, Dh, causal, scale,
    # stream
    "desta_flash_bwd_dkdv": (_P,) * 9 + (_I,) * 6 + (_F, _P),
    # q, k, v, seg, dO, lse, delta, dq, B, T, H, Hkv, Dh, causal, scale,
    # stream
    "desta_flash_bwd_dq": (_P,) * 8 + (_I,) * 6 + (_F, _P),
    # audio, window, twiddles, fb_index, fb_weights, out, B, n, frames,
    # n_mels, stream
    "desta_log_mel": (_P,) * 6 + (_I,) * 4 + (_P,),
    # qkv, k_cache, v_cache, cos, sin, mask, mask_stride, ci, q_norm,
    # k_norm, out, B, S, H, Hkv, Dh, eps, scale, stream
    "desta_tp_attention": (_P,) * 6 + (_I, _P, _P, _P, _P) + (_I,) * 5
                          + (_F, _F, _P),
    # x, w, scale, out, M, N, K, accumulate, stream
    "desta_tp_gemm": (_P,) * 4 + (_I,) * 4 + (_P,),
    # x, w, scale, w_int8, M, N, K, dst_table, flag_table, counter, offset,
    # p, flag, base, round, stream
    "desta_gemm_peer": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _L, _I, _I,
                        _P, _L, _P),
    # rbuf, flags, h, h_f32, p, slot, base, round, rows, D, norm_w, xn, eps,
    # err, stream
    "desta_tp_allreduce": (_P, _P, _P, _I, _I, _I, _P, _L, _I, _I, _P, _P, _F,
                           _P, _P),
    # dev, peer
    "desta_enable_peer_access": (_I, _I),
}

_launches: Dict[str, int] = {}
_kernels: Dict[str, int] = {}
_fallbacks: Dict[str, int] = {}


def count_launch(name: str, n: int = 1) -> None:
    _launches[name] = _launches.get(name, 0) + n


def count_kernel(name: str, n: int = 1) -> None:
    _kernels[name] = _kernels.get(name, 0) + n


def count_fallback(name: str) -> None:
    """A call that took the torch path because kernel ``name`` cannot take
    its shape or dtype (decided from them before any launch)."""
    _fallbacks[name] = _fallbacks.get(name, 0) + 1


def reset_launch_counts() -> None:
    _launches.clear()
    _kernels.clear()
    _fallbacks.clear()


class Counts(NamedTuple):
    """Launch and kernel counts (:func:`launch_counts`,
    :func:`kernel_counts`): a snapshot, or what was counted between two."""
    launches: Dict[str, int]
    kernels: Dict[str, int]


def count_snapshot() -> Counts:
    return Counts(dict(_launches), dict(_kernels))


def take_counts(since: Counts) -> Counts:
    """What was counted since the snapshot ``since``, taken back out of the
    counters: they read as they did at the snapshot."""
    taken = Counts(*({k: n - old.get(k, 0) for k, n in now.items()
                      if n != old.get(k, 0)}
                     for now, old in ((_launches, since.launches),
                                      (_kernels, since.kernels))))
    for now, old in ((_launches, since.launches), (_kernels, since.kernels)):
        now.clear()
        now.update(old)
    return taken


def add_counts(counts: Counts) -> None:
    """Count again what :func:`take_counts` took (a graph's replay)."""
    for name, n in counts.launches.items():
        count_launch(name, n)
    for name, n in counts.kernels.items():
        count_kernel(name, n)


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def kernel_counts() -> Dict[str, int]:
    return dict(_kernels)


def fallback_counts() -> Dict[str, int]:
    return dict(_fallbacks)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "desta25_audio_tpu_torch kernels are built from csrc/ at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdesta_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float]:
    """Compile csrc/*.cu (one nvcc process per file, in parallel) and link
    them into one shared library.  Returns (path, seconds spent)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    work = BUILD_DIR / f"obj_{out.stem}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, errors = [], []
    for src, obj, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"--- {src.name} ---\n{log}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library, with argtypes/restype declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.desta_error_string.argtypes = [ctypes.c_int]
    lib.desta_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, what: str) -> None:
    if status != 0:
        msg = library().desta_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _device_sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device=None) -> int:
    """The SM count of a CUDA device, read once per device; 132 (the H100
    SXM's) for a CPU device or None, where the kernels' planners only
    describe what the card would take."""
    import torch
    if device is None:
        return 132
    device = torch.device(device)
    if device.type != "cuda":
        return 132
    index = device.index
    return _device_sm_count(torch.cuda.current_device() if index is None
                            else index)


def require_cuda(name: str, *tensors, dtype=None) -> None:
    """Validate kernel inputs: one CUDA device, contiguous, 16-byte aligned,
    optionally one dtype.  Raises ValueError otherwise.

    A kernel called through ctypes returns a tensor with no autograd graph,
    so an input that requires grad while grad mode is on raises
    RuntimeError: the gradient would be cut silently.  Kernels with a
    backward (K2, K11) wrap their launches in an autograd function, whose
    forward runs with grad mode off."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no "
            "backward; call it under torch.no_grad()")
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} on {t.device}, expected "
                             f"the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: argument {i} is not 16-byte aligned")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: argument {i} is {t.dtype}, expected "
                             f"{dtype}")
