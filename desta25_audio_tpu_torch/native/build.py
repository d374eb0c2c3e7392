"""Build the port's native audio libraries with ``g++`` at first use.

Two shared objects, from this directory's sources, with the JAX package's
build flags (so that on one machine both packages' libraries compute the
same bits):

- ``libdesta_audio_*.so``: dependency-free WAV decode, mixdown and
  polyphase resample (``audio_native.cpp``; ``-O3 -march=native``);
- ``libdesta_ffmpeg_*.so``: universal decode and encode through the system
  FFmpeg libraries (``audio_ffmpeg.cpp``; ``-O3``, linked to libavformat,
  libavcodec, libavutil and libswresample), built only where the
  libavformat headers exist (:func:`have_ffmpeg_headers`).

Outputs go to ``build/desta25_audio_tpu_torch/`` at the repository root
(beside the CUDA kernels' library, ``ops/_build.py``), each named with a
hash of its source, flags and, for ``-march=native``, the host CPU's
feature flags: an edited source or another CPU builds anew, an unchanged
one loads at once.  A build holds an exclusive ``fcntl`` lock on
``.native.lock`` there, compiles to a temporary name and ``os.replace``\\ s
it into place, so test workers or loader threads that start together build
once and never load half a file.  A failed build raises RuntimeError with
the compiler's output.

    python -m desta25_audio_tpu_torch.native.build    # build both now
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Tuple

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "desta25_audio_tpu_torch"
LOCK = BUILD_DIR / ".native.lock"

# name -> (source, compiler flags, link libraries): native/build.py:25-36 of
# the JAX package
LIBS: Dict[str, Tuple[str, Tuple[str, ...], Tuple[str, ...]]] = {
    "audio": ("audio_native.cpp", ("-O3", "-march=native", "-shared",
                                   "-fPIC"), ()),
    "ffmpeg": ("audio_ffmpeg.cpp", ("-O3", "-shared", "-fPIC"),
               ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")),
}
HEADER_ROOTS = ("/usr/include", "/usr/include/x86_64-linux-gnu")


def have_ffmpeg_headers() -> bool:
    """Whether the libavformat development headers are installed."""
    return any(os.path.exists(os.path.join(r, "libavformat", "avformat.h"))
               for r in HEADER_ROOTS)


def gxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH); the "
                           "port's native audio libraries are built from "
                           "desta25_audio_tpu_torch/native/ at first use")
    return found


def _cpu_flags() -> str:
    """The host CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def library_path(name: str) -> Path:
    src, flags, libs = LIBS[name]
    h = hashlib.sha256(" ".join(flags + libs).encode())
    h.update((HERE / src).read_bytes())
    if "-march=native" in flags:
        h.update(_cpu_flags().encode())
    return BUILD_DIR / f"libdesta_{name}_{h.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Build library ``name`` ("audio" or "ffmpeg") unless it is built;
    returns its path.  Raises RuntimeError when g++ fails (its output in the
    message) and, for "ffmpeg", where the headers are missing."""
    out = library_path(name)
    if out.exists():
        return out
    if name == "ffmpeg" and not have_ffmpeg_headers():
        raise RuntimeError("the libavformat headers are not installed; the "
                           "FFmpeg codec cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():         # another process built it meanwhile
                return out
            src, flags, libs = LIBS[name]
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [gxx(), *flags, "-o", str(tmp), str(HERE / src), *libs]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed building {out.name}:\n{' '.join(cmd)}\n"
                    + proc.stdout.decode(errors="replace"))
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def compiler_version() -> str:
    return subprocess.run([gxx(), "--version"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]


def main() -> int:
    print(compiler_version())
    print(f"built {build_library('audio')}")
    if have_ffmpeg_headers():
        print(f"built {build_library('ffmpeg')}")
    else:
        print("libavformat headers not found; the FFmpeg codec is not built")
    return 0


if __name__ == "__main__":
    sys.exit(main())
