"""The ORCA injection's key-split planner, its shared-memory limits and its
cluster algorithm, on the CPU.

``plan_inject_splits`` (``ops/fused_decode.py``) is the rule by which the
attention kernel of ``csrc/fused_inject.cu`` cuts each (batch row,
injection head)'s audio keys into ranges, one CTA of a thread-block cluster
each.  The kernel then meets the ranges in rank order: each range's
(maximum, sum of exp(s - m)) pair folded into one global maximum and
denominator, P normalised and rounded to the activation dtype, the ranges'
partial P.V sums added.  ``_cluster_emulation`` does the same in f32 on
``inject_attention_plain``'s inputs and must agree with it within 1e-6 of
the output scale (f32: the roundings are no-ops, the sums differ in order
only).  ``fused_inject_limits`` must take every shape the kernels took
before the key split (a frozen copy of that rule is below).  The kernels
themselves are held against their plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from desta25_audio_tpu_torch.ops.fused_decode import (
    INJECT_KEY_TILE,
    INJECT_SPLITS_MAX,
    KD_MAX,
    _inject_cap_keys,
    fused_inject_limits,
    inject_attention,
    inject_attention_plain,
    inject_attention_smem,
    inject_gate,
    inject_gate_plain,
    plan_inject_splits,
)

SMEM_LIMIT = 227 * 1024
# (injection heads, head dim): Llama-3.1-8B, Qwen3-4B, llama-nano
GEOMETRIES = {"llama8b": (32, 128), "qwen3_4b": (32, 80), "nano": (4, 16)}


# -- the planner -------------------------------------------------------------

@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("ta", [8, 37, 375])
def test_plan_inject_splits(geometry, B, ta):
    heads, dh = GEOMETRIES[geometry]
    got = plan_inject_splits(B, heads, ta, dh)
    ns = len(got) - 1
    assert got[0] == 0 and got[-1] == ta
    assert all(a < b for a, b in zip(got, got[1:]))             # none empty
    assert all(b % INJECT_KEY_TILE == 0 for b in got[1:-1])     # whole tiles
    assert len({b - a for a, b in zip(got[:-1], got[1:-1])}) <= 1
    assert 1 <= ns <= INJECT_SPLITS_MAX
    assert got[1] - got[0] <= _inject_cap_keys(dh)   # K and V fit
    # it fills the card where B * heads * 8 ranges of whole tiles allow
    tiles = -(-ta // INJECT_KEY_TILE)
    if B * heads * min(INJECT_SPLITS_MAX, tiles) >= 132:
        assert B * heads * ns >= 132
    else:
        assert ns == min(INJECT_SPLITS_MAX, tiles)


def test_plan_inject_splits_at_orca_shapes():
    """Llama-3.1-8B with Ta = 375: b2 3 ranges (192 CTAs), b1 5 (160)."""
    assert plan_inject_splits(2, 32, 375, 128) == (0, 128, 256, 375)
    assert plan_inject_splits(1, 32, 375, 128) == (0, 80, 160, 240, 320, 375)
    assert plan_inject_splits(2, 32, 375, 80) == (0, 128, 256, 375)
    # a long clip: 8 ranges, each past what shared memory holds of K and V
    long = plan_inject_splits(4, 32, 3000, 128)
    assert len(long) == 9 and long[1] > _inject_cap_keys(128)
    # a card of twice the SMs splits the b2 keys in five
    assert len(plan_inject_splits(2, 32, 375, 128, n_sm=264)) == 6


def test_plan_inject_splits_reads_shapes_only():
    """No Kd argument: the verify step's token 0 is summed as the decode
    step's.  Its shared memory grows with Kd through q, the scores and the
    partial outputs only, never through the plan."""
    for B, heads, ta, dh in ((2, 32, 375, 128), (1, 32, 37, 80),
                             (4, 4, 375, 16)):
        bounds = plan_inject_splits(B, heads, ta, dh)
        keys = bounds[1]
        for kd in range(2, KD_MAX + 1):
            for resident in (False, True):
                grow = (inject_attention_smem(kd, dh, keys, resident)
                        - inject_attention_smem(1, dh, keys, resident))
                assert grow >= 4 * (kd - 1) * (dh + keys)
                assert inject_attention_smem(kd, dh, keys, True) <= SMEM_LIMIT


# -- the limits --------------------------------------------------------------

def _old_limit_ok(dh: int, kd: int, ta: int) -> bool:
    """The attention's shared-memory rule before the key split, frozen: one
    512-thread block a (row, head), q, the scores and 512 / (dh / 4) key
    groups' partial outputs in f32."""
    groups = 512 // (dh // 4)
    return 4 * (kd * dh + kd * ta + groups * kd * dh) <= SMEM_LIMIT


def _stack():
    """A stack whose leaves pass the leaf checks (shapes do not matter to
    the limits)."""
    leaf = {"q": torch.zeros(1, 1, 1, dtype=torch.int8),
            "s": torch.zeros(1, 1), "b": torch.zeros(1, 1)}
    return {"layers": {"q": leaf, "o": leaf, "gate1": leaf,
                       "gate2": {"w": torch.zeros(1), "b": torch.zeros(1)},
                       "ln": {"scale": torch.zeros(1),
                              "bias": torch.zeros(1)}}}


class _Cfg:
    def __init__(self, hidden_size):
        self.hidden_size = hidden_size


@pytest.mark.parametrize("kd", range(1, KD_MAX + 1))
def test_inject_limits_take_what_the_old_rule_took(kd):
    """Every head dim the kernels take (a multiple of 4 up to 256) at every
    Kd: the longest audio the old rule took, and a grid below it, is taken
    by the new rule."""
    stack = _stack()
    for dh in range(4, 257, 4):
        cfg = _Cfg(4 * dh)                      # 4 heads: D % 16 == 0
        groups = 512 // (dh // 4)
        old_max = (SMEM_LIMIT // 4 - kd * dh * (1 + groups)) // kd
        assert _old_limit_ok(dh, kd, old_max)
        assert not _old_limit_ok(dh, kd, old_max + 1)
        for ta in (1, 8, 37, 375, old_max // 3, old_max // 2, old_max - 7,
                   old_max):
            assert fused_inject_limits(stack, cfg, 4, ta, kd) == [], \
                (dh, kd, ta)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("ta", [8, 37, 375])
def test_inject_limits_at_model_shapes(geometry, ta):
    heads, dh = GEOMETRIES[geometry]
    cfg = _Cfg(heads * dh)
    for kd in range(1, KD_MAX + 1):
        assert _old_limit_ok(dh, kd, ta)
        assert fused_inject_limits(_stack(), cfg, heads, ta, kd) == []
    assert fused_inject_limits(_stack(), cfg, heads, ta, KD_MAX + 1)
    assert fused_inject_limits(_stack(), cfg, heads, 60000, 8)


# -- the cluster algorithm -----------------------------------------------------

def _cluster_emulation(iq, ka, va, heads, kd, bounds, drop=None):
    """The kernel's algorithm in f32 on one layer's inputs: per range r the
    scores (summed as the plain version sums them, so that only the combine
    differs) and its (max, sum of exp(s - m_r)) pair; the pairs folded in
    rank order into (m, den); P = exp(s - m) / den; each range's partial
    P.V summed in rank order.  ``drop``: a range left out (the control)."""
    R, D = iq.shape
    B, ta, _ = ka.shape
    dh = D // heads
    v = va.reshape(B, ta, heads, dh)
    s = ((ka[:, None] * iq.reshape(B, kd, 1, D)).reshape(
        B, kd, ta, heads, dh).sum(-1) * dh ** -0.5).transpose(2, 3)
    ranges = [(lo, hi) for r, (lo, hi) in enumerate(zip(bounds, bounds[1:]))
              if r != drop]
    pairs = []
    for lo, hi in ranges:
        m = s[..., lo:hi].amax(-1)
        pairs.append((m, torch.exp(s[..., lo:hi] - m[..., None]).sum(-1)))
    m = pairs[0][0]
    for mr, _ in pairs[1:]:
        m = torch.maximum(m, mr)
    den = torch.zeros_like(m)
    for mr, dr in pairs:
        den = den + dr * torch.exp(mr - m)
    out = torch.zeros(B, kd, heads, dh)
    for lo, hi in ranges:
        p = torch.exp(s[..., lo:hi] - m[..., None]) / den[..., None]
        out = out + torch.einsum("bjht,bthd->bjhd", p, v[:, lo:hi])
    return out.reshape(R, D)


@pytest.mark.parametrize("B,kd,ta,heads,dh", [
    (2, 1, 375, 32, 128), (1, 4, 375, 32, 128), (2, 8, 37, 4, 16),
    (1, 1, 375, 32, 80), (4, 2, 3000, 8, 32)])
def test_cluster_algorithm_matches_plain(B, kd, ta, heads, dh):
    rng = np.random.default_rng(B * 100 + kd)
    D = heads * dh
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    iq, ka, va = f(B * kd, D) * 2, f(B, ta, D), f(B, ta, D)
    ka[:, 40:60] *= 6.0         # ranges whose maxima differ by tens
    bounds = plan_inject_splits(B, heads, ta, dh)
    want = inject_attention_plain(iq, ka, va, heads, kd)
    got = _cluster_emulation(iq, ka, va, heads, kd, bounds)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) / scale < 1e-6
    if len(bounds) > 2:         # the control: a range dropped reads far off
        bad = _cluster_emulation(iq, ka, va, heads, kd, bounds, drop=0)
        assert float((bad - want).abs().max()) / scale > 1e-2


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions (the first
    ta_real keys; a copy of h for the gate)."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).bfloat16()
    B, kd, Ta, D, heads = 2, 4, 40, 64, 4
    iq, ka, va = f(B * kd, D), f(B, Ta, D), f(B, Ta, D)
    assert torch.equal(inject_attention(iq, ka, va, 37, heads),
                       inject_attention_plain(iq, ka[:, :37], va[:, :37],
                                              heads, kd))
    h, ig, iao = f(B * kd, D), f(B * kd, D // 4), f(B * kd, D)
    g = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
         for n in (D // 4, 1, D, D)]
    on = torch.tensor([1.0, 0.0])
    got = inject_gate(h, ig, iao, *g, on, kd)
    assert torch.equal(got, inject_gate_plain(h, ig, iao, *g, on, kd))
    assert torch.equal(got[kd:], h[kd:])         # on = 0: h's bits
