"""The decode attention's key-split planner and its cluster algorithm, on
the CPU.

``plan_decode_splits`` (``ops/fused_decode.py``) is the rule by which the
kernel of ``csrc/decode_attention.cuh`` cuts each (row, kv head, draft
token)'s cached keys into ranges, one CTA of a thread-block cluster each.
The kernel then combines the ranges in rank order: per-range maxima folded
into one global maximum with the draft scores, per-range sums of
exp(s - m) added into one denominator with the draft terms, P normalised
and rounded to the cache dtype, per-range partial outputs summed with the
draft block's f32 terms.  ``_cluster_emulation`` does the same in f32 on
``decode_attention_plain``'s inputs, and must agree with it within 1e-6 of
the output scale (f32: the rounding of P is a no-op, the sums differ in
order only).  The kernel itself is held against ``decode_attention_plain``
on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops.fused_decode import (
    DECODE_KEY_TILE,
    DECODE_SPLITS_MAX,
    KERNEL_DH,
    decode_attention,
    decode_attention_plain,
    decode_attention_smem,
    kernel_limits,
    plan_decode_splits,
)
from desta25_audio_tpu_torch.config import llm_config_for


# -- the planner -------------------------------------------------------------

@pytest.mark.parametrize("B,Hkv,S,want", [
    # the b2 decode of Llama-3.1-8B: 16 clusters of 8 one-tile ranges
    (2, 8, 256, tuple(range(0, 257, 32))),
    (1, 8, 256, tuple(range(0, 257, 32))),                    # b1
    (32, 8, 256, (0, 256)),               # the clusters alone fill the card
    (17, 8, 4096, (0, 4096)),             # just past the SM count
    (2, 8, 20, (0, 20)),                  # S below one tile
    (2, 8, 300, (0, 64, 128, 192, 256, 300)),      # a ragged last range
    (2, 4, 256, tuple(range(0, 257, 32))),         # K9 at p=2: Hkv/2
    (2, 2, 256, tuple(range(0, 257, 32))),         # K9 at p=4: Hkv/4
    (2, 8, 4096, tuple(range(0, 4097, 512))),      # a long cache
    (8, 8, 1024, (0, 512, 1024)),                  # B=8: 64 clusters
    (5, 8, 100, (0, 64, 100)),            # 3 tiles over 2 ranges
])
def test_plan_decode_splits(B, Hkv, S, want):
    got = plan_decode_splits(B, Hkv, S)
    assert got == want
    ns = len(got) - 1
    assert got[0] == 0 and got[-1] == S
    assert all(a < b for a, b in zip(got, got[1:]))           # none empty
    assert all(b % DECODE_KEY_TILE == 0 for b in got[1:-1])   # whole tiles
    assert len({b - a for a, b in zip(got[:-1], got[1:-1])}) <= 1
    assert 1 <= ns <= DECODE_SPLITS_MAX
    clusters = B * Hkv
    if clusters >= 132:
        assert ns == 1
    else:
        assert ns * clusters <= 132 or ns == 1


@pytest.mark.parametrize("kd", [2, 4, 8])
def test_plan_decode_splits_verify_is_the_decode_plan(kd):
    """The verify step (Kd draft tokens) sums its token 0 as the decode step
    does: the plan does not depend on Kd, the kernel limits' shared memory
    only through the draft block."""
    cfg = llm_config_for("test/llama-nano128")
    Hkv = cfg.num_key_value_heads
    G = cfg.num_attention_heads // Hkv
    for B, S in ((2, 256), (8, 1024), (33, 96)):
        bounds = plan_decode_splits(B, Hkv, S)
        assert decode_attention_smem(G, kd, bounds[1]) - decode_attention_smem(
            G, 1, bounds[1]) == 4 * (8 - 1) * (128 + G)
        assert kernel_limits(cfg, B, kd, S, True) == []


def test_kernel_limits_bound_one_range():
    """The shared-memory limit is one key range's scores: a cache the old
    one-block kernel refused (S = 32768 at B = 1) is taken, one past the
    range limit is refused."""
    cfg = llm_config_for("test/llama-nano128")
    assert kernel_limits(cfg, 1, 1, 32768, True) == []
    bad = kernel_limits(cfg, 1, 1, 262144, True)
    assert len(bad) == 1 and "shared memory" in bad[0]
    G = cfg.num_attention_heads // cfg.num_key_value_heads
    bounds = plan_decode_splits(1, cfg.num_key_value_heads, 262144)
    assert decode_attention_smem(G, 1, bounds[1]) > 227 * 1024


# -- the cluster algorithm -----------------------------------------------------

def _inputs(seed, B, Kd, S, H, Hkv, ci, holes, peak, qk_norm):
    """decode_attention_plain's inputs in f32: qkv [B*Kd, (H+2Hkv)*128], a
    random cache [B, S, Hkv*128], RoPE tables, the mask (random holes), ci;
    ``peak`` scales the keys of the range [32, 64) by 20, so that the
    ranges' maxima differ by tens."""
    rng = np.random.default_rng(seed)
    Dh, R = KERNEL_DH, B * Kd
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    qkv = f(R, (H + 2 * Hkv) * Dh)
    kc, vc = f(B, S, Hkv * Dh), f(B, S, Hkv * Dh)
    if peak:
        kc[:, 32:64] *= 20.0
    ang = f(R, Dh // 2)
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    mask = torch.ones(B, S, dtype=torch.int32)
    if holes:
        mask = torch.from_numpy((rng.random((B, S)) > 0.3).astype(np.int32))
    norms = ((1.0 + 0.1 * f(Dh), 1.0 + 0.1 * f(Dh)) if qk_norm
             else (None, None))
    return (qkv, kc, vc, cos, sin, mask,
            torch.tensor(ci, dtype=torch.int32), *norms)


def _cluster_emulation(qkv, kc, vc, cos, sin, mask, ci, qn, kn, H, Hkv, eps,
                       scale, bounds):
    """The kernel's algorithm in the input dtype, on a cache copy that it
    does not write: per (row, kv head, draft token j) one CTA per key range,
    combined in rank order.  The scores are formed as the plain version
    forms them (the same products, summed in the same order), so that what
    differs is the combination across ranges alone."""
    dt = qkv.dtype
    B, S, KVD = kc.shape
    R = qkv.shape[0]
    Kd, Dh = R // B, KERNEL_DH
    G, HD = H // Hkv, H * Dh

    def norm_rope(x, w):                                   # [R, n, Dh]
        x = x.float()
        if w is not None:
            x = (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
                 * w.float())
        rot = torch.cat([-x[..., Dh // 2:], x[..., :Dh // 2]], -1)
        return (x * cos[:, None] + rot * sin[:, None]).to(dt).float()

    qb = norm_rope(qkv[:, :HD].reshape(R, H, Dh), qn).reshape(
        B, Kd, Hkv, G, Dh)
    kb = norm_rope(qkv[:, HD:HD + KVD].reshape(R, Hkv, Dh), kn).reshape(
        B, Kd, Hkv, Dh)
    vd_all = qkv[:, HD + KVD:].float().reshape(B, Kd, Hkv, Dh)
    s_all = torch.einsum("bjkgd,bskd->bjkgs", qb,
                         kc.float().reshape(B, S, Hkv, Dh)) * scale
    sd_all = torch.einsum("bjkgd,bikd->bjkgi", qb, kb) * scale
    ninf = torch.tensor(-np.inf)
    out = torch.zeros(R, HD)
    for b in range(B):
        nk = min(int(ci[b]), S)
        for kvh in range(Hkv):
            ks = slice(kvh * Dh, (kvh + 1) * Dh)
            for j in range(Kd):
                dsc = sd_all[b, j, kvh, :, :j + 1]              # [G, j+1]
                vd = vd_all[b, :j + 1, kvh]                     # [j+1, Dh]
                parts = []
                for lo, hi in zip(bounds[:-1], bounds[1:]):
                    hi = max(min(hi, nk), lo)    # a range at or past ci: empty
                    s = torch.where(mask[b, lo:hi] > 0,
                                    s_all[b, j, kvh, :, lo:hi], ninf)
                    parts.append((lo, hi, s))
                # (a) the maxima in rank order, then the draft scores
                m = torch.full((G,), -np.inf)
                for _, _, s in parts:
                    if s.shape[1]:
                        m = torch.maximum(m, s.amax(1))
                m = torch.maximum(m, dsc.amax(1))
                # (b) the denominators in rank order, then the draft terms
                den = torch.zeros(G)
                for _, _, s in parts:
                    den = den + torch.exp(s - m[:, None]).sum(1)
                ed = torch.exp(dsc - m[:, None])
                den = den + ed.sum(1)
                inv = 1.0 / den
                # (c) partial outputs in rank order, then the draft block
                o = torch.zeros(G, Dh)
                for lo, hi, s in parts:
                    p = (torch.exp(s - m[:, None]) * inv[:, None]).to(
                        dt).float()
                    o = o + p @ vc[b, lo:hi, ks].float()
                o = o + (ed * inv[:, None]) @ vd
                out[b * Kd + j, kvh * G * Dh:(kvh + 1) * G * Dh] = \
                    o.reshape(-1)
    return out.to(dt)


@pytest.mark.parametrize("case", [
    # B, Kd, S, H, Hkv, ci, mask holes, peaked range, qk-norm, n_sm
    dict(B=2, Kd=1, S=256, H=32, Hkv=8, ci=(100, 200)),   # the b2 decode
    dict(B=2, Kd=1, S=256, H=8, Hkv=2, ci=(150, 250), peak=True),
    dict(B=2, Kd=1, S=256, H=8, Hkv=2, ci=(40, 256)),     # ranges past ci
    dict(B=2, Kd=1, S=128, H=4, Hkv=2, ci=(0, 70)),       # a row with ci=0
    dict(B=2, Kd=1, S=256, H=8, Hkv=2, ci=(180, 230), holes=True),
    dict(B=2, Kd=4, S=256, H=8, Hkv=2, ci=(100, 252), holes=True),
    dict(B=1, Kd=4, S=200, H=16, Hkv=2, ci=(150,), peak=True, n_sm=40),
    dict(B=2, Kd=1, S=96, H=8, Hkv=1, ci=(60, 96), qk_norm=True),
])
def test_cluster_algorithm_matches_plain(case):
    c = {**dict(holes=False, peak=False, qk_norm=False, n_sm=132), **case}
    B, Kd, S, H, Hkv = c["B"], c["Kd"], c["S"], c["H"], c["Hkv"]
    qkv, kc, vc, cos, sin, mask, ci, qn, kn = _inputs(
        7, B, Kd, S, H, Hkv, c["ci"], c["holes"], c["peak"], c["qk_norm"])
    eps, scale = 1e-6, KERNEL_DH ** -0.5
    bounds = plan_decode_splits(B, Hkv, S, c["n_sm"])
    want_cache = (kc.clone(), vc.clone())
    want = decode_attention_plain(qkv, *want_cache, cos, sin, mask, ci, qn,
                                  kn, H, Hkv, eps, scale)
    got = _cluster_emulation(qkv, kc, vc, cos, sin, mask, ci, qn, kn, H, Hkv,
                             eps, scale, bounds)
    assert len(bounds) > 2 or S <= DECODE_KEY_TILE
    assert bool(want.isfinite().all())
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-6
    # the plain version wrote token j's k / v rows at ci + j (past S:
    # nothing) and no other row
    changed = ((want_cache[0] != kc).any(-1) | (want_cache[1] != vc).any(-1))
    expect = torch.zeros(B, S, dtype=torch.bool)
    for b in range(B):
        expect[b, int(ci[b]):min(int(ci[b]) + Kd, S)] = True
    assert torch.equal(changed, expect)


def test_cluster_control_dropped_range_reads_above_tolerance():
    """The emulation with one range's keys dropped misses by far more than
    the 1e-6 above: the comparison can see a lost range."""
    B, Kd, S, H, Hkv = 2, 1, 256, 8, 2
    qkv, kc, vc, cos, sin, mask, ci, qn, kn = _inputs(
        3, B, Kd, S, H, Hkv, (200, 230), False, False, False)
    eps, scale = 1e-6, KERNEL_DH ** -0.5
    want = decode_attention_plain(qkv, kc.clone(), vc.clone(), cos, sin,
                                  mask, ci, qn, kn, H, Hkv, eps, scale)
    bounds = plan_decode_splits(B, Hkv, S)
    holed = mask.clone()
    holed[:, bounds[2]:bounds[3]] = 0
    got = _cluster_emulation(qkv, kc, vc, cos, sin, holed, ci, qn, kn, H, Hkv,
                             eps, scale, bounds)
    assert float((got - want).abs().max() / want.abs().max()) > 1e-2


def test_decode_attention_cpu_runs_plain():
    """On CPU tensors the wrapper is the plain version and counts no
    launch."""
    B, Kd, S, H, Hkv = 2, 2, 64, 4, 2
    qkv, kc, vc, cos, sin, mask, ci, qn, kn = _inputs(
        5, B, Kd, S, H, Hkv, (10, 40), True, False, True)
    args = (cos, sin, mask, ci, qn, kn, H, Hkv, 1e-6, KERNEL_DH ** -0.5)
    _build.reset_launch_counts()
    got = decode_attention(qkv.bfloat16(), kc.bfloat16(), vc.bfloat16(),
                           *args)
    assert _build.launch_counts() == {} and _build.kernel_counts() == {}
    want = decode_attention_plain(qkv.bfloat16(), kc.bfloat16(),
                                  vc.bfloat16(), *args)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
