"""The int8 LLM's matmul: x [..., K] against an int8 leaf ``{"q" [N, K],
"s" [N]}`` (counterpart of ``desta25_audio_tpu/ops/quant.py:93-231``,
``quant_matmul`` with the TPU dispatch of ``_qmm_dispatch``).

The rows M = prod(x.shape[:-1]) pick the path, as they do on the TPU:

- M < 128 (``W8A8_MIN_ROWS``): :func:`qmm`, kernel K7 (``_qmm_kernel``,
  ``quant.py:63-77``): weight-only, the f32 sum of bf16 x times the int8
  weight, times ``s`` after the sum, one rounding to the output dtype.  On
  the card ``csrc/qmm.cu``: the skinny GEMM at M <= 16, above it a wgmma
  kernel with the weight as the M side, K split across a thread-block
  cluster by :func:`plan_qmm` (its C twin ``plan_qmm``, entry point
  ``desta_qmm_plan``).
- M >= 128: :func:`w8a8_matmul`, the W8A8 prefill (``quant.py:116-130``,
  XLA on the TPU): x quantized per row with ``a = max(max|x|, 1e-8) / 127``,
  an exact int32 product, ``(f32(acc) * a) * s``.  On the card the row
  quantiser and the int8 GEMM of ``csrc/w8a8.cu`` (its LLM epilogue), bit
  for bit the plain version.

With ``w8a8=False`` (training, ``quant.py:107-135``: activations are never
quantized) the TPU dispatch runs K7 up to 256 rows and the dequant dot
above.  The port's K7 takes fewer than 128 rows, so 128 <= M <= 256 runs
K7's math as one library product, :func:`qmm_dot` (bf16 x against the
int8 weight cast to bf16, which is exact, f32 sums, times ``s`` after the
sum; cuBLAS on the card), counted off the CPU in
``_build.fallback_counts()`` as ``quant_matmul_dequant``.  From 257 rows
up it is the dequant dot, :func:`dequant_matmul`: ``w = (q * s)`` in f32
rounded to x's dtype, a product with f32 sums.  Every branch has the
straight-through backward of ``quant.py:193-209`` (:class:`_QuantMatmul`):
``dx = bf16(g * s) @ bf16(q)`` with f32 sums, in x's dtype; q and s get no
gradient.

On a CPU tensor each runs its ``*_plain`` version; on a CUDA tensor it
launches its kernel or raises.  :func:`quant_matmul` asks
:func:`quant_matmul_limits` first, on every device: x of another dtype than
bf16 below 128 rows goes to K7 cast to bf16 (the Pallas kernel's own
rounding, ``quant.py:71``); a call neither kernel takes (K % 64 below 128
rows; N % 128, K % 64 or a non-bf16 x from 128 rows up: the nano towers'
N = 64, f32 towers, a K = 32 mesh shard) runs the plain version of its
row regime, counted off the CPU in ``_build.fallback_counts()`` as
``quant_matmul`` or ``w8a8_matmul``.  Counts: ``quant_matmul`` one per K7 call,
``w8a8_matmul`` two per call (row quantiser, GEMM); a K7 call is also
counted in ``_build.kernel_counts()`` by its path, as ``skinny_gemm`` at
M <= 16 and as ``quant_matmul_prefill`` above.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import _build
from .core import matmul_f32
from .gemm import EPI_LLM_BF16, EPI_LLM_F32, cluster_ctas
from .quant import (
    QuantLeaf,
    int_dot,
    launch_gemm_s8,
    launch_quant_rows,
    quant_rows_llm,
    require_int8_leaf,
    w8a8_shape_limits,
)

W8A8_MIN_ROWS = 128   # the TPU dispatch's crossover (quant.py:107)
K7_TPU_MAX_ROWS = 256  # the TPU dispatch's K7 ceiling with w8a8 off (:112)
QMM_K_MULTIPLE = 64   # csrc/qmm.cu takes K % 64 == 0, on both paths
QMM_SKINNY_ROWS = 16  # csrc/skinny_gemm.cuh rows per pass: the skinny path
# csrc/qmm.cu's wgmma path (16 < M <= 128)
QMM_MAX_ROWS = 128    # the widest x side, m64n128
QMM_BW = 128          # weight rows (output columns) a CTA
QMM_K_BYTES = 128     # a k-tile's weight bytes a row (one TMA box)
QMM_SPLITS_MAX = 8    # CTAs of a cluster
QMM_RING = 229376     # the ring's shared memory
QMM_FIXED_KT = 2      # a CTA's fixed cost (ring fill, epilogue) in k-tiles
QMM_SPLIT_KT = 2      # a split rank's more: the cluster's partial-tile sum
SMEM_LIMIT = 232448   # the H100's dynamic shared memory a CTA, at most


class QmmPlan(NamedTuple):
    """A launch of the wgmma path: x side ``nx`` wide (m64n``nx``k16),
    K split into ``splits`` ranks (a cluster) of ``tps`` k-tiles each over
    ``nkt`` k-tiles of QMM_K_BYTES, ``tiles`` weight tiles of QMM_BW rows;
    ``grid`` CTAs; ``stages`` ring stages of ``stage_bytes`` (a QMM_BW x
    QMM_K_BYTES weight box and ``nx`` x QMM_K_BYTES bf16 of x); ``smem``
    the dynamic shared memory a CTA asks for."""
    nx: int
    splits: int
    tps: int
    nkt: int
    tiles: int
    grid: int
    stages: int
    stage_bytes: int
    smem: int


def plan_qmm(M: int, N: int, K: int, n_sm: int = 132) -> QmmPlan:
    """K7's wgmma launch for x [M, K] against q [N, K] on a card of
    ``n_sm`` SMs (the rule of ``plan_qmm`` in ``csrc/qmm.cu``): nx = 64 up
    to 64 rows, else 128; the split minimising waves x (tps + QMM_FIXED_KT
    [+ QMM_SPLIT_KT when split]), a wave being ``gemm.cluster_ctas``
    CTAs (one CTA an SM), among 1..QMM_SPLITS_MAX ranks that leave none
    empty, ties to fewer ranks.  The split reads N, K and n_sm, never M:
    every M of the path sums a column alike."""
    if not QMM_SKINNY_ROWS < M <= QMM_MAX_ROWS or N < 1 or K < 1:
        raise ValueError(f"K7 wgmma path: M={M} N={N} K={K} (takes "
                         f"{QMM_SKINNY_ROWS} < M <= {QMM_MAX_ROWS})")
    nx = 64 if M <= 64 else 128
    tiles = -(-N // QMM_BW)
    nkt = -(-K // QMM_K_BYTES)
    best = None
    for s in range(1, min(QMM_SPLITS_MAX, nkt) + 1):
        tps = -(-nkt // s)
        if -(-nkt // tps) != s:   # an empty rank
            continue
        waves = -(-tiles * s // cluster_ctas(s, n_sm))
        cost = waves * (tps + QMM_FIXED_KT + (QMM_SPLIT_KT if s > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, s, tps)
    _, s, tps = best
    stage = QMM_BW * QMM_K_BYTES + nx * 2 * QMM_K_BYTES
    stages = QMM_RING // stage
    return QmmPlan(nx, s, tps, nkt, tiles, s * tiles, stages, stage,
                   1024 + stages * stage + 16 * stages)


def qmm_plain(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
              out_dtype) -> torch.Tensor:
    """K7's math: bf16 x [M, K] . int8 q [N, K]^T summed in f32, times s
    after the sum (the products are exact in f32)."""
    acc = x2.to(torch.bfloat16).float() @ q.float().t()
    return (acc * s.float()).to(out_dtype)


def w8a8_matmul_plain(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype, row_amax=None) -> torch.Tensor:
    """The LLM's W8A8 formula (quant.py:123-130): per-row int8 x, exact
    integer product, ``(f32(acc) * a) * s``; ``row_amax`` as
    ``quant_rows_llm``'s ``amax``."""
    xq, a = quant_rows_llm(x2.float(), row_amax)
    return ((int_dot(xq, q) * a) * s.float()).to(out_dtype)


def _check_leaf(name: str, x2, q, s, out_dtype) -> None:
    M, K = x2.shape
    if q.dim() != 2 or q.shape[1] != K or s.shape != (q.shape[0],):
        raise ValueError(f"{name}: x [{M}, {K}] against q {tuple(q.shape)} "
                         f"s {tuple(s.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: output dtype {out_dtype} (bf16 or f32)")


def qmm(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
        out_dtype) -> torch.Tensor:
    """K7: x2 [M, K] (M < 128) -> [M, N] in out_dtype."""
    name = "quant_matmul"
    _check_leaf(name, x2, q, s, out_dtype)
    if x2.device.type == "cpu":
        return qmm_plain(x2, q, s, out_dtype)
    M, K = x2.shape
    N = q.shape[0]
    if not 1 <= M < W8A8_MIN_ROWS or K % QMM_K_MULTIPLE:
        raise ValueError(f"{name}: kernel takes 1 <= M < {W8A8_MIN_ROWS} "
                         f"rows and K % {QMM_K_MULTIPLE} == 0, got M={M} "
                         f"K={K}")
    _build.require_cuda(name, x2, dtype=torch.bfloat16)
    _build.require_cuda(name, q, dtype=torch.int8)
    _build.require_cuda(name, s, dtype=torch.float32)
    dev = x2.device
    out = torch.empty(M, N, dtype=out_dtype, device=dev)
    _build.check(_build.library().desta_qmm(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K,
        0, int(out_dtype == torch.float32), _build.stream_ptr(dev)), name)
    _build.count_launch(name)
    _build.count_kernel("skinny_gemm" if M <= QMM_SKINNY_ROWS
                        else "quant_matmul_prefill")
    return out


def w8a8_matmul(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype, row_amax=None) -> torch.Tensor:
    """The W8A8 prefill: x2 [M, K] -> [M, N] in out_dtype.  ``row_amax``
    [M, 1]: the rows' max|x| over an unsharded row (a tensor-parallel
    shard's product; ``quant_rows_llm``), the rows then quantized by the
    plain formula, which the row quantiser kernel matches bit for bit."""
    name = "w8a8_matmul"
    _check_leaf(name, x2, q, s, out_dtype)
    if x2.device.type == "cpu":
        return w8a8_matmul_plain(x2, q, s, out_dtype, row_amax)
    M, K = x2.shape
    N = q.shape[0]
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"{name}: kernel takes bfloat16 x, got {x2.dtype}")
    require_int8_leaf(name, q, s, None, N, K)
    _build.require_cuda(name, x2, dtype=torch.bfloat16)
    lib = _build.library()
    if row_amax is None:
        xq, a = launch_quant_rows(lib, x2, K, name, div127=True)
    else:
        xq, a = (t.contiguous() for t in quant_rows_llm(x2.float(), row_amax))
    out = torch.empty(M, N, dtype=out_dtype, device=x2.device)
    epi = EPI_LLM_F32 if out_dtype == torch.float32 else EPI_LLM_BF16
    launch_gemm_s8(lib, epi, xq, a, [(q, s, None, out)], N, K, name)
    return out


def quant_matmul_limits(M: int, N: int, K: int, x_dtype) -> List[str]:
    """What the kernels of :func:`quant_matmul` cannot take of x [M, K] in
    ``x_dtype`` against an [N, K] leaf (empty: a kernel takes it), the
    refusals of the wrapper its rows pick: below W8A8_MIN_ROWS :func:`qmm`
    (x cast to bf16 first, so any x dtype), from there :func:`w8a8_matmul`
    (``w8a8_shape_limits`` and bf16 x)."""
    if M < W8A8_MIN_ROWS:
        if M < 1 or K % QMM_K_MULTIPLE:
            return [f"K7 takes 1 <= M and K % {QMM_K_MULTIPLE} == 0, got "
                    f"M={M} K={K}"]
        return []
    bad = w8a8_shape_limits(N, K)
    if x_dtype != torch.bfloat16:
        bad.append(f"W8A8 GEMM takes bfloat16 x, got {x_dtype}")
    return bad


def qmm_dot(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            out_dtype) -> torch.Tensor:
    """K7's math (:func:`qmm_plain`) as one product with f32 sums: bf16
    x2 [M, K] @ bf16(q)^T, times s after the sum, one rounding to
    out_dtype.  The rows 128-256 of the training dispatch."""
    acc = matmul_f32(x2.to(torch.bfloat16), q.to(torch.bfloat16).t())
    return (acc * s.float()).to(out_dtype)


def dequant_matmul(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   out_dtype) -> torch.Tensor:
    """The dequant dot (``quant.py:131-135``): ``w = q * s`` in f32 rounded
    once to x2's dtype, then x2 [M, K] @ w^T with f32 sums, rounded once to
    out_dtype."""
    w = (q.float() * s.float()[:, None]).to(x2.dtype)
    return matmul_f32(x2, w.t()).to(out_dtype)


def _qmm_dispatch(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  out_dtype, w8a8: bool, amax,
                  row_scale: int = 1) -> torch.Tensor:
    """x2 [M, K] against the leaf, by rows (see :func:`quant_matmul`)."""
    M, K = x2.shape
    rows = M * row_scale
    if not w8a8 and rows > K7_TPU_MAX_ROWS:
        return dequant_matmul(x2, q, s, out_dtype)
    if not w8a8 and rows >= W8A8_MIN_ROWS:
        if x2.device.type != "cpu":
            _build.count_fallback("quant_matmul_dequant")
        return qmm_dot(x2, q, s, out_dtype)
    if quant_matmul_limits(M, q.shape[0], K, x2.dtype):
        if x2.device.type != "cpu":
            _build.count_fallback("quant_matmul" if M < W8A8_MIN_ROWS
                                  else "w8a8_matmul")
        return (qmm_plain(x2, q, s, out_dtype) if M < W8A8_MIN_ROWS
                else w8a8_matmul_plain(x2, q, s, out_dtype, amax))
    if M < W8A8_MIN_ROWS:
        return qmm(x2.to(torch.bfloat16), q, s, out_dtype)
    return w8a8_matmul(x2, q, s, out_dtype, amax)


class _QuantMatmul(torch.autograd.Function):
    """:func:`_qmm_dispatch` with the straight-through backward of
    ``_qmm_bwd`` (``quant.py:193-209``): one rule for every branch, the
    frozen int8 weight and its scales get no gradient."""

    @staticmethod
    def forward(ctx, x2, q, s, out_dtype, w8a8, amax, row_scale):
        ctx.save_for_backward(q, s)
        ctx.x_dtype = x2.dtype
        return _qmm_dispatch(x2, q, s, out_dtype, w8a8, amax, row_scale)

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        gs = (g.float() * s.float()).to(torch.bfloat16)
        dx = matmul_f32(gs, q.to(torch.bfloat16)).to(ctx.x_dtype)
        return dx, None, None, None, None, None, None


def quant_matmul(x: torch.Tensor, leaf: QuantLeaf, out_dtype=None,
                 row_amax=None, w8a8: bool = True,
                 row_scale: int = 1) -> torch.Tensor:
    """x [..., K] @ int8 leaf -> [..., N] in out_dtype (default x's).
    ``row_amax`` [..., 1]: :func:`w8a8_matmul`'s, for W8A8 rows.  Where
    :func:`quant_matmul_limits` refuses the call, the plain version of its
    row regime runs (counted as a fallback off the CPU).  ``w8a8=False``
    takes K7's math at 128-256 rows and the dequant dot above, counting
    ``row_scale`` times x's rows: x is one of that many equal parts of a
    training batch split over devices or processes, and each part takes
    the products the whole batch takes.  Differentiable with respect to x (the straight-through rule)."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    out_dtype = out_dtype or x.dtype
    amax = None if row_amax is None else row_amax.reshape(-1, 1)
    if torch.is_grad_enabled() and x2.requires_grad:
        y = _QuantMatmul.apply(x2, leaf["q"], leaf["s"], out_dtype, w8a8,
                               amax, row_scale)
    else:
        y = _qmm_dispatch(x2, leaf["q"], leaf["s"], out_dtype, w8a8, amax,
                          row_scale)
    return y.reshape(*x.shape[:-1], y.shape[-1])
