"""K1, the log-mel frontend (``ops/mel.py``), against the JAX package on
the CPU.

- ``audio/mel.log_mel`` (through ``log_mel_spec``'s plain version) against
  ``log_mel_pallas`` in interpret mode on one 600-frame block of noise plus
  a tone (the signal of tests/test_mel_pallas.py), 80 and 128 mels, within
  1e-4 (that test's bound).
- ``log_mel`` at a ragged 300 frames, which the Pallas kernel's 600-frame
  block cannot take, against the JAX package's jnp ``log_mel`` (the same
  arithmetic at ``Precision.HIGHEST``), within 1e-4.
- The CUDA kernel's own arithmetic, emulated in float64 numpy: reflect
  padding by index, one 400-sample DFT per frame over the zero-padded
  224-bin matrices the kernel reads, the filterbank with zero rows past bin
  200.  It must give the plain version's log10 mel energies, so the
  kernel's indexing and padding are right before the card runs it.
- On a CPU tensor ``log_mel_spec`` is its plain version and launches
  nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.audio import mel as jmel
from desta25_audio_tpu.ops import mel_pallas
from desta25_audio_tpu_torch.audio.mel import log_mel
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


def _kernel_arithmetic(audio, n_mels):
    """csrc/mel.cu's function in float64: samples of the reflect-padded clip
    by index, frame f = samples [160 f, 160 f + 400), the padded
    matrices."""
    B, n = audio.shape
    frames = n // 160
    wc, ws, fb = (m.numpy().astype(np.float64)
                  for m in tmel._padded_matrices(n_mels, "cpu"))
    p = np.arange(frames)[:, None] * 160 + np.arange(400)[None, :] - 200
    p = np.abs(p)
    p = np.where(p > n - 1, 2 * (n - 1) - p, p)
    x = audio.astype(np.float64)[:, p]                  # [B, frames, 400]
    power = (x @ wc) ** 2 + (x @ ws) ** 2
    return np.log10(np.maximum(power @ fb, 1e-10))


@pytest.mark.parametrize("frames,n_mels", [(300, 80), (37, 128)])
def test_kernel_arithmetic_matches_plain(frames, n_mels):
    audio = _signal(frames, seed=2)
    audio[1, frames * 80:] = 0.0                       # a zero-padded tail
    want = tmel.log_mel_spec_plain(torch.from_numpy(audio), n_mels).numpy()
    got = _kernel_arithmetic(audio, n_mels)
    assert got.shape == want.shape == (2, frames, n_mels)
    # above the clamp floor the f32 plain version is within f32 rounding of
    # the float64 emulation; the zero tail sits exactly at log10(1e-10)
    live = want > -9.0
    assert np.abs(got - want)[live].max() < 1e-4
    np.testing.assert_array_equal(want[~live] == -10.0, got[~live] == -10.0)
    wc, ws, fb = tmel._padded_matrices(n_mels, "cpu")
    assert wc.shape == ws.shape == (400, tmel.BINS_PAD)
    assert float(wc[:, tmel.N_BINS:].abs().max()) == 0.0
    assert float(fb[tmel.N_BINS:].abs().max()) == 0.0


def test_log_mel_spec_on_cpu_is_the_plain_version():
    audio = torch.from_numpy(_signal(50, seed=3))
    _build.reset_launch_counts()
    got = tmel.log_mel_spec(audio, 80)
    assert torch.equal(got, tmel.log_mel_spec_plain(audio, 80))
    assert _build.launch_counts() == {}
