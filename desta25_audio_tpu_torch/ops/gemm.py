"""The planner of the Hopper GEMM of ``csrc/gemm_sm90.cuh`` (K3, K4, K5, K6
and the int8 LLM's W8A8 prefill): ``out[M, N] = epi(a[M, K] . w[N, K]^T)``
with a and w K-major, bf16 (f32 sums) or int8 (exact int32 sums).

A CTA owns a ``bm x bn`` output tile: two consumer warpgroups of ``bm / 2``
rows (``wgmma`` from shared memory) and a producer warpgroup that streams
128-byte k-tiles of A and W by TMA through an mbarrier ring.  Thread-block
clusters along the grid's columns serve two cases: int8 epilogues other
than SEG and GELU_Q8 may split K across ``splits`` CTAs, whose int32
partial tiles meet through distributed shared memory (an exact sum: the
outputs do not depend on the split); K4's fc1 (GELU_Q8) runs 128 x 256
tiles in clusters of ``Q8_CHUNK / 256 = 5`` CTAs, which span one
1280-column chunk of the hidden and quantize it per row together.

:func:`plan_gemm` picks the tile and the split from M, N, K, the epilogue and
the SM count: the fewest waves of equal CTAs times a CTA's time, one M tile
when M <= 256 (each weight byte is then read from device memory once), ties
to the earlier tile, then to fewer ranks.  A CTA's time is taken as its
k-tiles' bytes, (bm + bn) x 128 each, not its operations: that ranks the
tiles as the H100 does at the encoder's and the prefill's shapes
(bench_enc_gemm.py --sweep).  It is pure Python, so the CPU tests
hold it; ``csrc/enc_ffn.cu`` and ``csrc/w8a8.cu`` take its plan as given
and refuse one they cannot run.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

# epilogues (csrc/gemm_sm90.cuh gemm::Epi)
(EPI_BIAS, EPI_BIAS_GELU, EPI_PROJ, EPI_GELU_Q8, EPI_SEG, EPI_LLM_BF16,
 EPI_LLM_F32) = range(7)
BF16_EPIS = (EPI_BIAS, EPI_BIAS_GELU)

K_BYTES = 128          # a k-tile's bytes a row (gemm::K_BYTES)
SPLITS_MAX = 8         # CTAs of a cluster (gemm::SPLITS_MAX)
ONE_TILE_ROWS = 256    # up to this many rows, one M tile
Q8_CHUNK = 1280        # GELU_Q8: hidden columns quantized together
FIXED_KT = 4           # a CTA's fixed cost (ring fill, epilogue) in k-tiles
SPLIT_KT = 8           # a split rank's more: the cluster's partial-tile sum
# the tiles the kernel is built for, in order of preference ((256, 128)
# ran 2-10 % faster than (128, 256) at the encoder's shapes, M = 3000, on
# the H100; bench_enc_gemm.py --sweep)
TILES = ((256, 128), (128, 256), (128, 128))
SEG_TILES = ((128, 128), (256, 64))
Q8_TILES = ((128, 256),)
# CTAs the H100 SXM (132 SMs) runs at once in clusters of 3..8 of this
# kernel, one CTA an SM (cudaOccupancyMaxActiveClusters, the C entry
# desta_gemm_max_clusters; chip_smoke.py holds the card to it): a cluster
# lives in one GPC, and the GPCs' SM counts are not all multiples of 3..8
H100_CLUSTER_CTAS = {3: 117, 4: 120, 5: 110, 6: 102, 7: 105, 8: 120}


class GemmPlan(NamedTuple):
    """A launch: bm x bn tiles, K split into ``splits`` ranges of ``tps``
    k-tiles (of ``nkt``), the grid (x: rank fastest, then the column tile
    over all operand sets; y: the row tiles) in clusters of ``cluster``
    CTAs along x (the split's ranks, or GELU_Q8's chunk)."""
    bm: int
    bn: int
    splits: int
    tps: int
    nkt: int
    grid: Tuple[int, int]
    cluster: int


def cluster_ctas(splits: int, n_sm: int) -> int:
    """CTAs in flight at once in clusters of ``splits`` (one CTA an SM)."""
    if n_sm == 132 and splits in H100_CLUSTER_CTAS:
        return H100_CLUSTER_CTAS[splits]
    return n_sm // splits * splits


def plan_gemm(M: int, N: int, K: int, epi: int, nproj: int = 1,
              n_sm: int = 132) -> GemmPlan:
    """The launch of an [M, K] x [N, K]^T product (``nproj`` operand sets of
    N columns each) with epilogue ``epi`` on a card of ``n_sm`` SMs: the
    candidate minimising waves x (bm + bn) x (tps + FIXED_KT [+ SPLIT_KT]),
    where a wave is ``cluster_ctas`` CTAs, among the tiles that divide N
    and, at M <= ONE_TILE_ROWS, cover M in one row tile; there (and only
    there: above it the split's sum cost more than it saved on the H100)
    the int8 epilogues but SEG and GELU_Q8 also split K into 2..SPLITS_MAX
    non-empty ranges.  GELU_Q8 takes its one tile, in clusters that span a
    chunk (N a multiple of Q8_CHUNK), at any M."""
    if M < 1 or N < 1 or K < 1 or not 1 <= nproj <= 3:
        raise ValueError(f"GEMM M={M} N={N} K={K} nproj={nproj}")
    if epi == EPI_GELU_Q8 and (N % Q8_CHUNK or nproj > 1):
        raise ValueError(f"GELU_Q8 needs N % {Q8_CHUNK} == 0, got N={N}")
    int8 = epi not in BF16_EPIS
    nkt = -(-K * (1 if int8 else 2) // K_BYTES)
    splittable = (int8 and epi not in (EPI_SEG, EPI_GELU_Q8)
                  and M <= ONE_TILE_ROWS)
    tiles = (Q8_TILES if epi == EPI_GELU_Q8 else
             SEG_TILES if epi == EPI_SEG else TILES)
    best = None
    for order, (bm, bn) in enumerate(tiles):
        mt = -(-M // bm)
        if N % bn or (M <= ONE_TILE_ROWS and mt > 1
                      and epi != EPI_GELU_Q8):
            continue
        nt = nproj * N // bn
        for s in range(1, (SPLITS_MAX if splittable else 1) + 1):
            tps = -(-nkt // s)
            if -(-nkt // tps) != s:   # an empty rank
                continue
            cl = Q8_CHUNK // bn if epi == EPI_GELU_Q8 else s
            waves = -(-mt * nt * s // cluster_ctas(cl, n_sm))
            kts = tps + FIXED_KT + (SPLIT_KT if s > 1 else 0)
            key = (waves * (bm + bn) * kts, order, s)
            if best is None or key < best[0]:
                best = (key, GemmPlan(bm, bn, s, tps, nkt, (s * nt, mt), cl))
    if best is None:
        raise ValueError(f"no GEMM tile divides N={N}")
    return best[1]
