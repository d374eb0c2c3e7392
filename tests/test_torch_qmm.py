"""The planner of K7's wgmma path (``ops/qmm.plan_qmm``, the rule the C twin
``plan_qmm`` of ``csrc/qmm.cu`` launches the kernel with at 16 < M <= 128
rows): at Llama-3.1-8B's and Qwen3-4B's layer shapes and at ragged ones,
every rank of the split is non-empty, the cluster and the grid are ones the
card launches, the shared memory fits a CTA, the split does not read M,
and every shape the wrapper took before the wgmma path still plans; the
constants and the cluster table are the ones ``csrc/qmm.cu`` is built
with.  The kernel itself runs only on the card (``tests/test_torch_cuda.py``
``-k qmm``, ``chip_smoke.py`` phase 13a)."""

import re
from pathlib import Path

import pytest
import torch

from desta25_audio_tpu_torch.ops import gemm, qmm
from desta25_audio_tpu_torch.ops.skinny_gemm import plan_skinny_gemm

CSRC = Path(qmm.__file__).resolve().parent.parent / "csrc"
ROWS = (17, 33, 64, 65, 100, 121, 127)
# (label, N, K): Llama-3.1-8B's and Qwen3-4B's layer GEMMs, the head, and
# ragged ones (a last column tile of 104, K an odd multiple of 64)
SHAPES = (
    ("llama wqkv", 6144, 4096),
    ("llama wo", 4096, 4096),
    ("llama gate/up", 28672, 4096),
    ("llama down", 4096, 14336),
    ("llama head", 130560, 4096),
    ("qwen3-4b wqkv", 6144, 2560),
    ("qwen3-4b wo", 2560, 4096),
    ("qwen3-4b gate/up", 19456, 2560),
    ("qwen3-4b down", 2560, 9728),
    ("ragged", 1000, 512),
    ("ragged k", 200, 4160),
    ("one k-tile", 64, 64),
)
MAX_GRID = 2 ** 31 - 1   # gridDim.x


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("label,N,K", SHAPES)
def test_plan_qmm_covers_the_product(label, N, K, M):
    p = qmm.plan_qmm(M, N, K)
    assert p.nx in (64, 128) and p.nx >= M      # x's rows in one wgmma N side
    assert p.tiles * qmm.QMM_BW >= N > (p.tiles - 1) * qmm.QMM_BW
    assert p.nkt * qmm.QMM_K_BYTES >= K > (p.nkt - 1) * qmm.QMM_K_BYTES
    # `splits` ranks of tps k-tiles cover K, none empty
    assert 1 <= p.splits <= qmm.QMM_SPLITS_MAX
    assert p.splits * p.tps >= p.nkt > (p.splits - 1) * p.tps
    # a cluster of `splits` CTAs per weight tile, a grid the card launches
    assert p.grid == p.splits * p.tiles <= MAX_GRID
    assert p.grid % p.splits == 0
    # the ring (a stage: a 128-row x 128-byte weight box, nx x 128 bf16 of
    # x), its barriers and the 1024-byte alignment fit one CTA, and the f32
    # partial tile [nx, QMM_BW + 4] fits in the ring it reuses
    assert p.stage_bytes == (qmm.QMM_BW + 2 * p.nx) * qmm.QMM_K_BYTES
    ring = p.stages * p.stage_bytes
    assert p.stages >= 4 and ring <= qmm.QMM_RING
    assert p.smem == 1024 + ring + 16 * p.stages <= qmm.SMEM_LIMIT
    assert p.nx * (qmm.QMM_BW + 4) * 4 <= ring


@pytest.mark.parametrize("label,N,K", SHAPES)
def test_plan_qmm_split_does_not_read_the_rows(label, N, K):
    """Every M of the wgmma path splits K alike, so a column's f32 sum is
    taken in one order whatever the prompt's length; only the x side's
    width follows M."""
    plans = {M: qmm.plan_qmm(M, N, K) for M in range(17, 129)}
    assert len({(p.splits, p.tps, p.tiles, p.grid) for p in
                plans.values()}) == 1
    assert {p.nx for M, p in plans.items() if M <= 64} == {64}
    assert {p.nx for M, p in plans.items() if M > 64} == {128}


def test_plan_qmm_llama_splits():
    """The splits the H100 (132 SMs) takes at Llama-3.1-8B's four layer
    shapes, each the fastest of 1..8 at M = 17, 64 and 121 in
    ``bench_enc_gemm --k7-sweep``."""
    got = {label: qmm.plan_qmm(121, N, K).splits
           for label, N, K in SHAPES[:4]}
    assert got == {"llama wqkv": 2, "llama wo": 3, "llama gate/up": 1,
                   "llama down": 3}


@pytest.mark.parametrize("M,N,K", [(0, 64, 64), (16, 64, 64), (129, 64, 64),
                                   (17, 0, 64), (17, 64, 0)])
def test_plan_qmm_refuses(M, N, K):
    with pytest.raises(ValueError, match="K7 wgmma path"):
        qmm.plan_qmm(M, N, K)


def _old_rule_accepts(M, N, K):
    """The wrapper's shape rule before the wgmma path (a frozen copy):
    1 <= M < 128 rows, K % 64 == 0, any N."""
    return 1 <= M < 128 and K % 64 == 0 and N >= 1


OLD_SHAPES = [(M, N, K) for M in (1, 2, 16, 17, 64, 65, 100, 121, 127)
              for N, K in ((1000, 512), (1, 64), (64, 64), (6144, 4096),
                           (4096, 14336), (28672, 4096), (130560, 4096),
                           (200, 4160), (1000, 14336))]


@pytest.mark.parametrize("M,N,K", OLD_SHAPES)
def test_every_shape_the_old_rule_took_still_plans(M, N, K):
    assert _old_rule_accepts(M, N, K)
    if M <= qmm.QMM_SKINNY_ROWS:
        p = plan_skinny_gemm(N, K, int8=True)
        assert p.ns * p.tps >= p.nkt > (p.ns - 1) * p.tps
    else:
        p = qmm.plan_qmm(M, N, K)
        assert p.splits * p.tps >= p.nkt > (p.splits - 1) * p.tps
        assert p.smem <= qmm.SMEM_LIMIT
    # the wrapper passes its shape checks and stops only at the device
    x = torch.empty(M, K, dtype=torch.bfloat16, device="meta")
    q = torch.empty(N, K, dtype=torch.int8, device="meta")
    s = torch.empty(N, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        qmm.qmm(x, q, s, torch.float32)


def _c_int(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_constants_match_the_kernel():
    src = (CSRC / "qmm.cu").read_text()
    assert _c_int(src, "QMM_BW") == qmm.QMM_BW
    assert _c_int(src, "QMM_K_BYTES") == qmm.QMM_K_BYTES
    assert _c_int(src, "QMM_SPLITS_MAX") == qmm.QMM_SPLITS_MAX
    assert _c_int(src, "QMM_RING") == qmm.QMM_RING
    assert _c_int(src, "QMM_MAX_ROWS") == qmm.QMM_MAX_ROWS
    assert _c_int(src, "QMM_FIXED_KT") == qmm.QMM_FIXED_KT
    assert _c_int(src, "QMM_SPLIT_KT") == qmm.QMM_SPLIT_KT
    # the C twin's cluster table is ops/gemm's (the same occupancy)
    table = {int(a): int(b) for a, b in
             re.findall(r"case (\d+): return (\d+);", src)}
    assert table == gemm.H100_CLUSTER_CTAS
    # nx = 64 up to 64 rows, else 128; two kernels, one a width
    assert "M <= 64 ? 64 : 128" in src
    assert set(re.findall(r"launch_qmm_wgmma<(\d+)>\(xb", src)) == {"64",
                                                                   "128"}
