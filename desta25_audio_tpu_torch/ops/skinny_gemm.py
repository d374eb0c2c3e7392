"""The skinny weight-streaming GEMM on its own: ``out[m, n] = epi(s[n] *
(x[m, :] . w[n, :]))`` for a few token rows m (port of the weight ring of
``desta25_audio_tpu/ops/fused_decode.py::_make_kernel``, ``:405-443``, and
of ``ops/quant.py::_qmm_kernel`` at M <= 16).

x [M, K] bf16; w [N*NW, K] bf16, or int8 with one f32 scale per row
(``scale`` [N*NW]); NW = 2 for the SWIGLU epilogue, whose gate and up rows
are interleaved (row 2n gate n, row 2n+1 up n).  The f32 sum is scaled once,
after the whole K sum, then the epilogue rounds (``csrc/skinny_gemm.cuh``
lists the rounding points): STORE, STORE_F32, ADD_F32 and RESID (in place
into ``out``), SWIGLU, BIAS and BIAS_GELU (``bias`` [N] f32).  The decode
and verify steps (``ops/fused_decode.FusedStep``), K7 at M <= 16
(``ops/qmm.py``), K9's wo / down and K10's peer stores launch the same
kernel from C; each such launch is counted in ``_build.kernel_counts()`` as
``skinny_gemm``, one per pass of 16 rows.

On a CUDA tensor :func:`skinny_gemm` launches ``desta_skinny_gemm`` (counted
as ``skinny_gemm``); on a CPU tensor it runs :func:`skinny_gemm_plain`.
:func:`plan_skinny_gemm` is the kernel's planner (``plan_skinny``), the
split of K across a thread-block cluster, which reads the weight's shape
and the SM count and never the token rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import _build

(EPI_STORE, EPI_RESID, EPI_SWIGLU, EPI_STORE_F32, EPI_BIAS, EPI_BIAS_GELU,
 EPI_ADD_F32, EPI_PEER_F32) = range(8)
ROWS_PER_PASS = 16     # csrc/skinny_gemm.cuh SKINNY_ROWS
TILE_ROWS = 64         # weight rows a CTA (SG_BN)
ROW_BYTES = 128        # a weight row's bytes a ring stage (SG_ROW_BYTES)
SPLITS_MAX = 8         # CTAs of a cluster (SG_SPLITS_MAX)
CTAS_PER_SM = 2        # resident CTAs an SM the planner aims at
F32_OUT = (EPI_STORE_F32, EPI_ADD_F32)
IN_PLACE = (EPI_RESID, EPI_ADD_F32)


class SkinnyPlan(NamedTuple):
    """ns ranks of tps k-tiles each, nkt k-tiles of ROW_BYTES weight
    bytes, tiles row tiles of TILE_ROWS weight rows."""
    ns: int
    tps: int
    nkt: int
    tiles: int


def plan_skinny_gemm(rows: int, K: int, int8: bool, n_sm: int = 132
                     ) -> SkinnyPlan:
    """How the kernel splits a weight of ``rows`` rows (N, or 2N for
    SWIGLU) and K values: as many ranks as bring the CTAs to CTAS_PER_SM an
    SM, at most SPLITS_MAX and at most one a k-tile, then evened out so that
    no rank is empty.  The same rule as ``plan_skinny`` in
    ``csrc/skinny_gemm.cuh``."""
    if rows < 1 or K < 1:
        raise ValueError(f"weight [{rows}, {K}]")
    tiles = -(-rows // TILE_ROWS)
    nkt = -(-K * (1 if int8 else 2) // ROW_BYTES)
    ns = max(1, min(SPLITS_MAX, nkt, -(-CTAS_PER_SM * n_sm // tiles)))
    tps = -(-nkt // ns)
    return SkinnyPlan(-(-nkt // tps), tps, nkt, tiles)


def skinny_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                      scale: Optional[torch.Tensor] = None,
                      epi: int = EPI_STORE,
                      out: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function at its rounding points; the in-place
    epilogues read ``out`` and return the new value (``out`` untouched)."""
    v = x.float() @ w.float().t()
    if scale is not None:
        v = v * scale.float()
    bf = torch.bfloat16
    if epi == EPI_STORE:
        return v.to(bf)
    if epi == EPI_STORE_F32:
        return v
    if epi == EPI_ADD_F32:
        return out.float() + v
    if epi == EPI_RESID:
        return (out.float() + v.to(bf).float()).to(bf)
    if epi == EPI_SWIGLU:
        gt = v[:, 0::2].to(bf).float()
        up = v[:, 1::2].to(bf).float()
        act = (gt / (1.0 + torch.exp(-gt))).to(bf).float()
        return (act * up).to(bf)
    if epi == EPI_BIAS:
        return (v + bias.float()).to(bf)
    if epi == EPI_BIAS_GELU:
        y = (v + bias.float()).to(bf).float()
        return (0.5 * y * (1.0 + torch.erf(y * math.sqrt(0.5)))).to(bf)
    raise ValueError(f"epilogue {epi}")


def passes(M: int) -> int:
    """Launches of one call over M token rows."""
    return -(-M // ROWS_PER_PASS)


def skinny_gemm(x: torch.Tensor, w: torch.Tensor,
                scale: Optional[torch.Tensor] = None, epi: int = EPI_STORE,
                out: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [M, K] -> [M, N] through the epilogue ``epi``; RESID and ADD_F32
    update ``out`` in place on the card and return it."""
    if x.device.type == "cpu":
        return skinny_gemm_plain(x, w, scale, epi, out, bias)
    name = "skinny_gemm"
    M, K = x.shape
    nw = 2 if epi == EPI_SWIGLU else 1
    int8 = w.dtype == torch.int8
    if (w.dim() != 2 or w.shape[1] != K or w.shape[0] % nw
            or epi not in range(EPI_PEER_F32)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"epilogue {epi}")
    N = w.shape[0] // nw
    if K * w.element_size() % 16:
        raise ValueError(f"{name}: K={K} must fill whole 16-byte rows")
    if int8 != (scale is not None) or (scale is not None
                                       and scale.shape != (N * nw,)):
        raise ValueError(f"{name}: an int8 weight takes one scale a row, a "
                         "bf16 weight none")
    if (bias is None) == (epi in (EPI_BIAS, EPI_BIAS_GELU)):
        raise ValueError(f"{name}: a bias goes with the BIAS epilogues only")
    out_dtype = torch.float32 if epi in F32_OUT else torch.bfloat16
    if out is None:
        if epi in IN_PLACE:
            raise ValueError(f"{name}: epilogue {epi} updates `out` in place")
        out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    if tuple(out.shape) != (M, N) or out.dtype != out_dtype:
        raise ValueError(f"{name}: out {tuple(out.shape)} {out.dtype}, "
                         f"expected [{M}, {N}] {out_dtype}")
    _build.require_cuda(name, x, out, dtype=None)
    _build.require_cuda(name, x, dtype=torch.bfloat16)
    _build.require_cuda(name, w, dtype=torch.int8 if int8 else torch.bfloat16)
    if scale is not None:
        _build.require_cuda(name, scale, dtype=torch.float32)
    if bias is not None:
        _build.require_cuda(name, bias, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.check(_build.library().desta_skinny_gemm(
        x.data_ptr(), w.data_ptr(), ptr(scale), ptr(bias), out.data_ptr(), M,
        N, K, epi, int(int8), _build.stream_ptr(x.device)), name)
    _build.count_launch(name, passes(M))
    return out


def kernel_plan(rows: int, K: int, int8: bool):
    """The plan the C side takes on the current device (``desta_skinny_
    gemm_plan``), for comparison with :func:`plan_skinny_gemm`."""
    import ctypes
    buf = (ctypes.c_int * 4)()
    _build.check(_build.library().desta_skinny_gemm_plan(
        rows, K, int(int8), ctypes.addressof(buf)), "skinny_gemm_plan")
    return SkinnyPlan(*buf)
