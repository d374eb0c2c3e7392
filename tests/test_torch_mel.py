"""K1, the log-mel frontend (``ops/mel.py``), against the JAX package on
the CPU.

- ``audio/mel.log_mel`` (through ``log_mel_spec``'s plain version) against
  ``log_mel_pallas`` in interpret mode on one 600-frame block of noise plus
  a tone (the signal of tests/test_mel_pallas.py), 80 and 128 mels, within
  1e-4 (that test's bound).
- ``log_mel`` at a ragged 300 frames, which the Pallas kernel's 600-frame
  block cannot take, against the JAX package's jnp ``log_mel`` (the same
  arithmetic at ``Precision.HIGHEST``), within 1e-4.
- The CUDA kernel's own arithmetic, emulated in numpy in float64 and in
  float32 with the kernel's tables (``kernel_tables``) and stage order:
  reflect padding by index, the window on the even / odd sample pairs, the
  200-point complex FFT by Stockham stages of radix 8, 5 and 5, the split
  into bins 0..200, the power, each mel's nonzero bins in ascending order.
  It must give the plain version's log10 mel energies, so the kernel's
  indexing, twiddles and tables are right before the card runs it.
- The sparse filterbank rebuilds ``mel_filter_bank`` exactly, with at most
  two filters a bin, and K1's bound (``bench_mel.mel_work``) counts the
  bytes of those tables, not of dense matrices.
- On a CPU tensor ``log_mel_spec`` is its plain version and launches
  nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.audio import mel as jmel
from desta25_audio_tpu.ops import mel_pallas
from desta25_audio_tpu_torch.audio.mel import (
    log_mel,
    mel_filter_bank,
    normalize_log_spec,
)
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops import mel as tmel


def _signal(n_frames, seed=0):
    """Noise plus a 523 Hz tone on row 0 (tests/test_mel_pallas.py:23-25)."""
    rng = np.random.default_rng(seed)
    n = n_frames * 160
    audio = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    t = np.arange(n) / 16000.0
    audio[0] += 0.5 * np.sin(2 * np.pi * 523.0 * t).astype(np.float32)
    return audio


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_pallas_interpret(n_mels):
    audio = _signal(mel_pallas.FRAME_BLOCK)
    want = np.asarray(mel_pallas.log_mel_pallas(jnp.asarray(audio), n_mels,
                                                interpret=True))
    got = log_mel(torch.from_numpy(audio), n_mels).numpy()
    assert got.shape == want.shape == (2, mel_pallas.FRAME_BLOCK, n_mels)
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("layout", ["btm", "bmt"])
def test_log_mel_ragged_frames_matches_jax(layout):
    audio = _signal(300, seed=1)
    want = np.asarray(jmel.log_mel(jnp.asarray(audio), 80, layout=layout))
    got = log_mel(torch.from_numpy(audio), 80, layout=layout).numpy()
    assert got.shape == want.shape
    assert got.shape[1 if layout == "btm" else 2] == 300
    assert np.abs(got - want).max() < 1e-4


def _turn(ar, ai, c, s):
    """(ar + i ai) e^{-i t}, (c, s) = (cos t, sin t)."""
    return ar * c + ai * s, ai * c - ar * s


def _dft8(v, h):
    """csrc/mel.cu's dft8 on 8 (re, im) pairs."""
    add = lambda a, b: (a[0] + b[0], a[1] + b[1])        # noqa: E731
    sub = lambda a, b: (a[0] - b[0], a[1] - b[1])        # noqa: E731
    mi = lambda a: (a[1], -a[0])                         # noqa: E731
    a0, a1 = add(v[0], v[4]), sub(v[0], v[4])
    a2, a3 = add(v[2], v[6]), sub(v[2], v[6])
    a4, a5 = add(v[1], v[5]), sub(v[1], v[5])
    a6, a7 = add(v[3], v[7]), sub(v[3], v[7])
    e0, e2 = add(a0, a2), sub(a0, a2)
    e1, e3 = add(a1, mi(a3)), sub(a1, mi(a3))
    o0, o2 = add(a4, a6), sub(a4, a6)
    o1, o3 = add(a5, mi(a7)), sub(a5, mi(a7))
    w1 = (h * (o1[0] + o1[1]), h * (o1[1] - o1[0]))
    w2 = mi(o2)
    w3 = (h * (o3[1] - o3[0]), -(h * (o3[0] + o3[1])))
    return [add(e0, o0), add(e1, w1), add(e2, w2), add(e3, w3),
            sub(e0, o0), sub(e1, w1), sub(e2, w2), sub(e3, w3)]


def _dft5(v, c1, s1, c2, s2):
    """csrc/mel.cu's dft5 on 5 (re, im) pairs."""
    (v0r, v0i), (v1r, v1i), (v2r, v2i), (v3r, v3i), (v4r, v4i) = v
    b1, d1 = (v1r + v4r, v1i + v4i), (v1r - v4r, v1i - v4i)
    b2, d2 = (v2r + v3r, v2i + v3i), (v2r - v3r, v2i - v3i)
    t1 = (v0r + c1 * b1[0] + c2 * b2[0], v0i + c1 * b1[1] + c2 * b2[1])
    t2 = (v0r + c2 * b1[0] + c1 * b2[0], v0i + c2 * b1[1] + c1 * b2[1])
    u1 = (s1 * d1[0] + s2 * d2[0], s1 * d1[1] + s2 * d2[1])
    u2 = (s2 * d1[0] - s1 * d2[0], s2 * d1[1] - s1 * d2[1])
    return [((v0r + b1[0]) + b2[0], (v0i + b1[1]) + b2[1]),
            (t1[0] + u1[1], t1[1] - u1[0]), (t2[0] + u2[1], t2[1] - u2[0]),
            (t2[0] - u2[1], t2[1] + u2[0]), (t1[0] - u1[1], t1[1] + u1[0])]


def _stage(zr, zi, R, ns, tw, dft):
    """One Stockham stage of the kernel over the last axis (200 points):
    butterfly j reads in[j + r * 200 / R], turns it by
    W200^(k r 200 / (ns R)) (k = j % ns), and writes its R-point DFT to
    out[(j / ns) ns R + k + r ns]."""
    q = 200 // R
    j = np.arange(q)
    k = j % ns
    v = []
    for r in range(R):
        vr, vi = zr[..., j + r * q], zi[..., j + r * q]
        if r and ns > 1:
            m = k * r * (200 // (ns * R))
            vr, vi = _turn(vr, vi, tw[m, 0], tw[m, 1])
        v.append((vr, vi))
    out_r, out_i = np.empty_like(zr), np.empty_like(zi)
    d = (j // ns) * ns * R + k
    for r, (vr, vi) in enumerate(dft(v)):
        out_r[..., d + r * ns], out_i[..., d + r * ns] = vr, vi
    return out_r, out_i


def _kernel_arithmetic(audio, n_mels, dt=np.float64):
    """csrc/mel.cu's function in numpy, every operation in ``dt``, with the
    kernel's tables: samples of the reflect-padded clip by index, frame f =
    samples [160 f, 160 f + 400), windowed, z[j] = x[2j] + i x[2j + 1], the
    200-point FFT in the kernel's stages, the split into bins 0..200 (bin k
    from Z[k], Z[200 - k] and W400^k), the power as two products and a sum,
    each mel's nonzero bins summed in ascending order, log10."""
    B, n = audio.shape
    frames = n // 160
    window, tw, index, weights = (t.numpy() for t in
                                  tmel.kernel_tables(n_mels, "cpu"))
    window, tw, weights = (a.astype(dt) for a in (window, tw, weights))
    p = np.arange(frames)[:, None] * 160 + np.arange(400)[None, :] - 200
    p = np.abs(p)
    p = np.where(p > n - 1, 2 * (n - 1) - p, p)
    x = audio.astype(dt)[:, p] * window                 # [B, frames, 400]
    h, c1, s1, c2, s2 = tw[25, 0], tw[40, 0], tw[40, 1], tw[80, 0], tw[80, 1]
    z = _stage(x[..., 0::2], x[..., 1::2], 8, 1, tw, lambda v: _dft8(v, h))
    for ns in (8, 40):
        z = _stage(*z, 5, ns, tw, lambda v: _dft5(v, c1, s1, c2, s2))
    zr, zi = z
    k = np.arange(201)
    m = (200 - k) % 200
    kr, ki, mr, mi = zr[..., k % 200], zi[..., k % 200], zr[..., m], zi[..., m]
    er, ei, dr, di = kr + mr, ki - mi, kr - mr, ki + mi
    c, s = tw[200 + k, 0], tw[200 + k, 1]
    half = dt(0.5)
    re = half * (er - (s * dr - c * di))
    im = half * (ei - (c * dr + s * di))
    power = re * re + im * im                           # [B, frames, 201]
    mel = np.zeros((B, frames, n_mels), dt)
    for j, (first, count, off) in enumerate(index):
        for t in range(count):
            mel[..., j] = mel[..., j] + power[..., first + t] * weights[off + t]
    # log10 rounded once to dt (numpy's float32 log10 is not: it takes
    # log10(1e-10f) to -10.000001)
    return np.log10(np.maximum(mel, dt(1e-10)).astype(np.float64)).astype(dt)


@pytest.mark.parametrize("frames,n_mels,dt", [
    pytest.param(300, 80, np.float64, id="300-80"),
    pytest.param(37, 128, np.float64, id="37-128"),
    pytest.param(300, 80, np.float32, id="f32-300-80"),
    pytest.param(37, 128, np.float32, id="f32-37-128")])
def test_kernel_arithmetic_matches_plain(frames, n_mels, dt):
    audio = _signal(frames, seed=2)
    audio[1, frames * 80:] = 0.0                       # a zero-padded tail
    want = tmel.log_mel_spec_plain(torch.from_numpy(audio), n_mels).numpy()
    got = _kernel_arithmetic(audio, n_mels, dt)
    assert got.shape == want.shape == (2, frames, n_mels)
    assert got.dtype == dt
    # above the clamp floor the f32 plain version is within f32 rounding of
    # the emulation; the zero tail sits exactly at log10(1e-10)
    live = want > -9.0
    assert np.abs(got - want)[live].max() < 1e-4
    np.testing.assert_array_equal(want[~live] == -10.0, got[~live] == -10.0)
    # what the model reads: within TOL_MEL after the clip-wide clamp
    err = normalize_log_spec(torch.from_numpy(got.astype(np.float32))) \
        - normalize_log_spec(torch.from_numpy(want))
    assert float(err.abs().max()) < 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_sparse_filterbank_rebuilds_the_dense_one(n_mels):
    index, weights = tmel.sparse_filterbank(n_mels)
    fb = mel_filter_bank(n_mels)
    dense = np.zeros_like(fb)
    off = 0
    for m, (first, count, at) in enumerate(index):
        assert at == off and count >= 1
        dense[first:first + count, m] = weights[at:at + count]
        off += count
    assert off == weights.size
    np.testing.assert_array_equal(dense, fb)
    assert np.count_nonzero(fb, axis=1).max() <= 2
    window, tw, t_index, t_weights = tmel.kernel_tables(n_mels, "cpu")
    np.testing.assert_array_equal(t_index.numpy(), index)
    np.testing.assert_array_equal(t_weights.numpy()[:off], weights)
    assert t_weights.shape == (tmel.FB_WEIGHTS,)
    assert float(t_weights[off:].abs().max()) == 0.0
    assert window.shape == (400,) and tw.shape == (401, 2)
    assert t_index.dtype == torch.int32


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_work_counts_the_kernel_tables(n_mels):
    """K1's bound counts the audio, the log-mels and the tables the kernel
    reads, no dense DFT or filterbank matrix."""
    from desta25_audio_tpu_torch.bench_mel import mel_work
    tables = sum(t.numel() * t.element_size()
                 for t in tmel.kernel_tables(n_mels, "cpu"))
    for B, frames in ((1, 3000), (2, 37)):
        nb, _ = mel_work(B, frames, n_mels)
        assert nb == 4 * B * frames * (160 + n_mels) + tables


def test_log_mel_spec_on_cpu_is_the_plain_version():
    audio = torch.from_numpy(_signal(50, seed=3))
    _build.reset_launch_counts()
    got = tmel.log_mel_spec(audio, 80)
    assert torch.equal(got, tmel.log_mel_spec_plain(audio, 80))
    assert _build.launch_counts() == {}
