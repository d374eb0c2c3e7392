"""K11 and the attention dispatch of the port against the JAX package on the
CPU, and the autograd behaviour of the kernel wrappers.

- ``flash_attention_plain`` (K11's plain version) against the library
  Pallas flash kernel the JAX package calls, run through the real
  ``ops/attention.mha`` in TPU interpret mode (``_flash_available``
  monkeypatched to True; JAX's caches cleared around it): output and
  dq/dk/dv from ``jax.grad`` vs torch autograd, on all rows, pad rows
  included (the segment rule lets pad queries attend pad keys).
- ``mha`` below T = 512: the masked path against the JAX XLA path in f32,
  and the dispatch rule itself.
- K2's autograd function (backward recomputed through the plain version)
  and the grad-mode refusal of the kernels without a backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from desta25_audio_tpu.ops import attention as jatt
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops import attention as tatt
from desta25_audio_tpu_torch.ops import core
from desta25_audio_tpu_torch.ops import enc_attention as tenc
from desta25_audio_tpu_torch.ops.enc_ffn import encoder_ffn

TOL_FLASH = 2e-2   # bf16 outputs and gradients: max |port - JAX| / max |JAX|


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding identical values."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX dispatch on its TPU branch: the library flash kernel in
    interpret mode."""
    monkeypatch.setattr(jatt, "_flash_available", lambda: True)
    jax.clear_caches()
    with pltpu.force_tpu_interpret_mode():
        yield
    jax.clear_caches()


@pytest.mark.parametrize("dh,pad", [(64, "right"), (128, "left")])
def test_flash_plain_matches_library_kernel(jax_flash, dh, pad):
    B, T, H, Hkv = 2, 512, 4, 2
    rng = np.random.default_rng(dh)
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16(s * rng.standard_normal((B, T, h, dh)))
        for s, h in ((2.0, H), (1.0, Hkv), (1.0, Hkv)))
    do = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    am = np.ones((B, T), np.int32)
    if pad == "right":
        am[1, 400:] = 0
    else:
        am[1, :112] = 0

    def loss(q, k, v):
        o = jatt.mha(q, k, v, causal=True, attention_mask=jnp.asarray(am))
        return jnp.sum(o.astype(jnp.float32) * do), o

    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jq, jk, jv)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    got = tatt.mha(*leaves, causal=True, attention_mask=torch.from_numpy(am))
    (got.float() * torch.from_numpy(do)).sum().backward()
    assert _rel(got, want) < TOL_FLASH
    for t, g in zip(leaves, grads):
        assert _rel(t.grad, g) < TOL_FLASH
    # pad queries attend pad keys: their rows are not the masked path's
    masked = core.mha(
        tq, tk, tv, torch.from_numpy(am)[:, None, None, :].bool()
        & torch.ones(T, T, dtype=torch.bool).tril(), dh ** -0.5)
    pad_rows = torch.from_numpy(am == 0)
    assert not torch.allclose(got[pad_rows].float(), masked[pad_rows].float(),
                              atol=1e-2)
    real = ~pad_rows
    assert torch.allclose(got[real].float(), masked[real].float(), atol=3e-2)


def test_mha_below_512_matches_xla_path():
    B, T, H, Hkv, D = 2, 300, 4, 2, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    am = np.ones((B, T), np.int32)
    am[0, :37] = 0
    want = np.asarray(jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, attention_mask=jnp.asarray(am)))
    got = tatt.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                   attention_mask=torch.from_numpy(am)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_mha_dispatch_follows_the_jax_rule(monkeypatch):
    calls = []
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a: calls.append(a[0].shape[1]) or a[0])
    mk = lambda t, h: torch.zeros(1, t, h, 16)  # noqa: E731
    tatt.mha(mk(512, 4), mk(512, 2), mk(512, 2), causal=True)
    tatt.mha(mk(520, 4), mk(520, 2), mk(520, 2),
             attention_mask=torch.ones(1, 520, dtype=torch.int32))
    assert calls == [512, 520]
    tatt.mha(mk(511, 4), mk(511, 2), mk(511, 2), causal=True)
    tatt.mha(mk(512, 4), mk(600, 2), mk(600, 2))                 # Tq != Tkv
    tatt.mha(mk(512, 4), mk(512, 2), mk(512, 2),
             mask=torch.ones(1, 1, 512, 512, dtype=torch.bool))
    assert calls == [512, 520]


def test_flash_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 96, h, 64))
                                .astype(np.float32)).to(torch.bfloat16)
               for h in (4, 1, 1))
    seg = torch.ones(1, 96, dtype=torch.int32)
    seg[0, :10] = 0
    _build.reset_launch_counts()
    got = tatt.flash_attention(q, k, v, seg, True)
    assert torch.equal(got, tatt.flash_attention_plain(q, k, v, seg, True,
                                                       64 ** -0.5))
    assert _build.launch_counts() == {}


def test_k2_autograd_function_carries_gradients(monkeypatch):
    """The card's K2 path (``_PackedAttention``) with its launch replaced by
    the plain version: the backward, recomputed through the plain version,
    gives autograd's gradients through the plain version exactly."""
    launched = []

    def fake_launch(q, k, v, n_heads):
        launched.append(torch.is_grad_enabled())
        return tenc.packed_encoder_attention_plain(q, k, v, n_heads)

    monkeypatch.setattr(tenc, "_launch", fake_launch)
    rng = np.random.default_rng(3)
    mk = lambda t: torch.from_numpy(  # noqa: E731
        rng.standard_normal((2, t, 128)).astype(np.float32)
    ).to(torch.bfloat16).requires_grad_()
    q, k, v = mk(8), mk(40), mk(40)
    g = torch.from_numpy(rng.standard_normal((2, 8, 128)).astype(np.float32))
    out = tenc._PackedAttention.apply(q, k, v, 2)
    got = torch.autograd.grad(out, (q, k, v), g.to(out.dtype))
    assert launched == [False]          # the kernel runs outside grad mode
    want = torch.autograd.grad(
        tenc.packed_encoder_attention_plain(q, k, v, 2), (q, k, v),
        g.to(out.dtype))
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)


def test_kernels_without_backward_refuse_grad_mode():
    """A ctypes launch has no autograd graph: under grad mode an input that
    requires grad raises instead of cutting the gradient silently (meta
    tensors reach the launch path without a card)."""
    meta = lambda *s: torch.empty(*s, device="meta",  # noqa: E731
                                  dtype=torch.bfloat16)
    x = meta(1, 4, 128).requires_grad_()
    args = (meta(256, 128), meta(256), meta(128, 256), meta(128))
    with pytest.raises(RuntimeError, match="no backward"):
        encoder_ffn(x, *args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        encoder_ffn(x, *args)
