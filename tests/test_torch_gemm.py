"""The planner of the Hopper GEMM (``ops/gemm.plan_gemm``, which K3, K4, K5,
K6 and the int8 LLM's W8A8 prefill launch ``csrc/gemm_sm90.cuh`` with) at
every model shape and at ragged row counts: its tiles cover the output
exactly, K's ranges cover K with no empty rank, each weight is read by one
row tile at M <= 256 (but by K4's fc1, whose clusters span a 1280-column
chunk of the hidden each), bf16, SEG and GELU_Q8 never split K, and the
tile set and constants are the ones the C dispatch is built for."""

import re
from pathlib import Path

import pytest

from desta25_audio_tpu_torch.ops import gemm

CSRC = Path(gemm.__file__).resolve().parent.parent / "csrc"
ROWS = (1, 127, 129, 250, 1500, 3000, 6000)
# (label, N, K, epilogue, operand sets): whisper-large-v3's encoder (D=1280,
# F=5120), Llama-3.1-8B's and Qwen3-4B's prefill layer GEMMs and the
# padded int8 head
SHAPES = (
    ("K3 fc1", 5120, 1280, gemm.EPI_BIAS_GELU, 1),
    ("K3 fc2", 1280, 5120, gemm.EPI_BIAS, 1),
    ("K4 fc1", 5120, 1280, gemm.EPI_GELU_Q8, 1),
    ("K4 fc2", 1280, 5120, gemm.EPI_SEG, 1),
    ("K5", 1280, 1280, gemm.EPI_PROJ, 3),
    ("K6", 1280, 1280, gemm.EPI_PROJ, 1),
    ("llama wqkv", 6144, 4096, gemm.EPI_LLM_BF16, 1),
    ("llama wo", 4096, 4096, gemm.EPI_LLM_BF16, 1),
    ("llama gate/up", 28672, 4096, gemm.EPI_LLM_BF16, 1),
    ("llama down", 4096, 14336, gemm.EPI_LLM_BF16, 1),
    ("llama head", 130560, 4096, gemm.EPI_LLM_F32, 1),
    ("qwen3-4b wqkv", 6144, 2560, gemm.EPI_LLM_BF16, 1),
    ("qwen3-4b wo", 2560, 4096, gemm.EPI_LLM_BF16, 1),
    ("qwen3-4b gate/up", 19456, 2560, gemm.EPI_LLM_BF16, 1),
    ("qwen3-4b down", 2560, 9728, gemm.EPI_LLM_F32, 1),
)


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("label,N,K,epi,nproj", SHAPES)
def test_plan_covers_the_output(label, N, K, epi, nproj, M):
    p = gemm.plan_gemm(M, N, K, epi, nproj)
    tiles = (gemm.Q8_TILES if epi == gemm.EPI_GELU_Q8 else
             gemm.SEG_TILES if epi == gemm.EPI_SEG else gemm.TILES)
    assert (p.bm, p.bn) in tiles and N % p.bn == 0
    mt = -(-M // p.bm)               # row tiles: cover M, none past it
    assert mt * p.bm >= M > (mt - 1) * p.bm
    # every operand set's N columns once, in column tiles after the ranks
    assert p.grid == (p.splits * nproj * N // p.bn, mt)
    assert p.grid[0] % p.cluster == 0
    if epi == gemm.EPI_GELU_Q8:
        # a cluster spans one 1280-column chunk of the hidden
        assert p.cluster * p.bn == gemm.Q8_CHUNK
    else:
        assert p.cluster == p.splits
    if epi != gemm.EPI_GELU_Q8 and M <= gemm.ONE_TILE_ROWS:
        assert mt == 1                 # each weight byte read once
    # K: 128-byte k-tiles in `splits` ranges of tps, none empty
    kbytes = K * (2 if epi in gemm.BF16_EPIS else 1)
    assert p.nkt == -(-kbytes // gemm.K_BYTES)
    assert p.splits * p.tps >= p.nkt > (p.splits - 1) * p.tps
    assert 1 <= p.splits <= gemm.SPLITS_MAX
    if (epi in gemm.BF16_EPIS or epi in (gemm.EPI_SEG, gemm.EPI_GELU_Q8)
            or M > gemm.ONE_TILE_ROWS):
        assert p.splits == 1


@pytest.mark.parametrize("n_sm", [132, 114, 78, 16])
def test_plan_on_other_cards(n_sm):
    """On any SM count a split's waves x work is at most the same tile's
    unsplit."""
    for M in (250, 3000):
        for label, N, K, epi, nproj in SHAPES:
            p = gemm.plan_gemm(M, N, K, epi, nproj, n_sm)

            def cost(ctas, cl, kts):
                waves = -(-ctas // gemm.cluster_ctas(cl, n_sm))
                return waves * (p.bm + p.bn) * kts
            ctas = p.grid[0] * p.grid[1]
            kts = p.tps + gemm.FIXED_KT + (gemm.SPLIT_KT * (p.splits > 1))
            assert cost(ctas, p.cluster, kts) <= cost(
                ctas // p.splits, p.cluster // p.splits or 1,
                p.nkt + gemm.FIXED_KT), label


def test_plan_refuses_what_no_tile_divides():
    with pytest.raises(ValueError, match="divides"):
        gemm.plan_gemm(100, 96, 1280, gemm.EPI_PROJ)
    with pytest.raises(ValueError, match="1280"):
        gemm.plan_gemm(100, 2560 + 256, 1280, gemm.EPI_GELU_Q8)
    with pytest.raises(ValueError):
        gemm.plan_gemm(0, 1280, 1280, gemm.EPI_PROJ)
    with pytest.raises(ValueError):
        gemm.plan_gemm(10, 1280, 1280, gemm.EPI_PROJ, nproj=4)


def test_encoder_plans_at_m3000():
    """The encoder's b2 shapes take 256 x 128 tiles and no split (the tile
    the H100 ran fastest there), K4's fc1 the chunk clusters; the LLM's b2
    prefill splits K where its column tiles alone would leave most SMs
    idle."""
    for N, K, epi, nproj in ((5120, 1280, gemm.EPI_BIAS_GELU, 1),
                             (1280, 5120, gemm.EPI_BIAS, 1),
                             (1280, 1280, gemm.EPI_PROJ, 3)):
        p = gemm.plan_gemm(3000, N, K, epi, nproj)
        assert (p.bm, p.bn, p.splits, p.cluster) == (256, 128, 1, 1)
    q8 = gemm.plan_gemm(3000, 5120, 1280, gemm.EPI_GELU_Q8)
    assert q8.cluster == 5
    wo = gemm.plan_gemm(250, 4096, 4096, gemm.EPI_LLM_BF16)
    assert wo.splits > 1 and wo.grid[0] * wo.grid[1] > 64
    gu = gemm.plan_gemm(250, 28672, 4096, gemm.EPI_LLM_BF16)
    assert gu.splits == 1


def test_planner_matches_the_c_dispatch():
    """The tile lists, K_BYTES, SPLITS_MAX and Q8_CHUNK are the ones
    csrc/gemm_sm90.cuh is built for, and the epilogue numbers its enum's."""
    src = (CSRC / "gemm_sm90.cuh").read_text()
    body = src[src.index("cudaError_t dispatch("):]

    def pairs(text):
        return {(int(a), int(b)) for a, b in
                re.findall(r"bm == (\d+) && bn == (\d+)", text)}
    q8, rest = body.split("} else if constexpr (EPI == SEG) {", 1)
    seg, other = rest.split("} else {", 1)
    other = other[:other.index("return cudaErrorInvalidValue")]
    assert pairs(q8) == set(gemm.Q8_TILES)
    assert pairs(seg) == set(gemm.SEG_TILES)
    assert f"Q8_CHUNK = {gemm.Q8_CHUNK};" in src
    assert pairs(other) == set(gemm.TILES)
    assert f"K_BYTES = {gemm.K_BYTES};" in src
    assert f"SPLITS_MAX = {gemm.SPLITS_MAX};" in src
    enum = re.search(r"enum Epi \{([^}]*)\}", src).group(1)
    names = [n.split("=")[0].strip() for n in enum.split(",")]
    values = [int(n.split("=")[1]) for n in enum.split(",")]
    want = {"BIAS": gemm.EPI_BIAS, "BIAS_GELU": gemm.EPI_BIAS_GELU,
            "PROJ": gemm.EPI_PROJ, "GELU_Q8": gemm.EPI_GELU_Q8,
            "SEG": gemm.EPI_SEG, "LLM_BF16": gemm.EPI_LLM_BF16,
            "LLM_F32": gemm.EPI_LLM_F32}
    assert dict(zip(names, values)) == want
