"""The plain versions of the port's kernels against the JAX package's Pallas
kernels run in interpret mode, on the same inputs made with numpy.

K2 ``packed_encoder_attention``, K3 ``encoder_ffn`` and K8
``fused_decode_layers`` (bf16 weight stream, one token per row).  The
plain version is what the port's wrapper runs for CPU tensors; the CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``.  Also K2's key-split planner, and the split it plans
(key ranges attended apart, then combined in f32, as the kernel's second
launch does) against the unsplit plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.config import LLMConfig
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops.core import tree_cast
from desta25_audio_tpu.ops.enc_attention import (
    packed_encoder_attention as jax_attention,
)
from desta25_audio_tpu.ops.enc_ffn import encoder_ffn as jax_ffn
from desta25_audio_tpu_torch.ckpt.bridge import llm_from_jax
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops.enc_attention import (
    KEY_TILE,
    packed_encoder_attention,
    packed_encoder_attention_plain,
    plan_key_splits,
)
from desta25_audio_tpu_torch.ops.enc_ffn import encoder_ffn
from desta25_audio_tpu_torch.ops.fused_decode import (
    KVCache,
    fused_decode_layers,
)


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding identical values."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- K2 ----------------------------------------------------------------------

@pytest.mark.parametrize("B,Tq,Tkv,H,Dh", [
    (2, 150, 150, 4, 64),    # T=150 is not a tile multiple: kv masking
    (1, 96, 96, 2, 128),     # one head per 128-lane group
    (2, 64, 64, 8, 32),      # four heads per lane group
    (2, 16, 150, 4, 64),     # Q-Former cross-attention: few q, long kv
])
def test_enc_attention_plain_matches_pallas(B, Tq, Tkv, H, Dh):
    rng = np.random.default_rng(0)
    DM = H * Dh
    jq, tq = _bf16(rng.standard_normal((B, Tq, DM)))
    jk, tk = _bf16(rng.standard_normal((B, Tkv, DM)))
    jv, tv = _bf16(rng.standard_normal((B, Tkv, DM)))
    want = jax_attention(jq, jk, jv, H, 64, True)
    got = packed_encoder_attention(tq, tk, tv, H)
    assert got.dtype == torch.bfloat16
    # bf16 outputs: both round P to bf16 and accumulate in f32; 2e-2 covers
    # one-ulp bf16 flips from the different summation order
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,H,Tq,Tkv,want", [
    (8, 20, 64, 1500, (0, 384, 768, 1152, 1500)),  # chip_smoke.py's cross
    (2, 20, 1500, 1500, (0, 1500)),                 # its self shape
    (16, 20, 64, 1500, (0, 384, 768, 1152, 1500)),  # the B=4 train step's
    (3, 4, 5, 130, (0, 128, 130)),                  # a 2-key last range
    (2, 1, 64, 1, (0, 1)),                          # one key
    (1, 2, 70, 70, (0, 70)),                        # Tq > 64: never split
    (2, 2, 64, 1500, tuple(range(0, 1500, 128)) + (1500,)),  # a small grid
])
def test_plan_key_splits(B, H, Tq, Tkv, want):
    bounds = plan_key_splits(B, H, Tq, Tkv)
    assert bounds == want
    assert bounds[0] == 0 and bounds[-1] == Tkv
    assert all(b % KEY_TILE == 0 for b in bounds[1:-1])
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))


def _split_combined(q, k, v, n_heads, bounds):
    """The plain version on each key range, combined in f32 as the kernel's
    second launch combines its ranges: each range's output weighted by its
    row sum of exponentials, rescaled to the largest range maximum."""
    B, Tq, DM = q.shape
    dh = DM // n_heads
    qh = q.reshape(B, Tq, n_heads, dh).transpose(1, 2) * dh ** -0.5
    outs, lses = [], []
    for lo, hi in zip(bounds, bounds[1:]):
        outs.append(packed_encoder_attention_plain(
            q, k[:, lo:hi], v[:, lo:hi], n_heads)
            .reshape(B, Tq, n_heads, dh).transpose(1, 2))
        kh = k[:, lo:hi].reshape(B, hi - lo, n_heads, dh).transpose(1, 2)
        lses.append(torch.logsumexp(qh @ kh.transpose(-1, -2), -1,
                                    keepdim=True))
    top = torch.stack(lses).amax(0)
    w = [torch.exp(lse - top) for lse in lses]
    o = sum(wi * oi for wi, oi in zip(w, outs)) / sum(w)
    return o.transpose(1, 2).reshape(B, Tq, DM)


@pytest.mark.parametrize("B,H,Tq,Tkv,plan_shape", [
    (3, 4, 5, 130, None),
    (2, 2, 64, 1500, None),
    (2, 2, 64, 1500, (8, 20, 64, 1500)),   # the cross shape's boundaries
])
def test_key_split_combine_matches_unsplit(B, H, Tq, Tkv, plan_shape):
    bounds = plan_key_splits(*(plan_shape or (B, H, Tq, Tkv)))
    assert len(bounds) > 2
    rng = np.random.default_rng(1)
    DM = H * 64
    # a peaked q and one range's keys scaled up: the ranges' maxima differ
    # by tens, so a wrong rescaling shows
    q = torch.from_numpy(6 * rng.standard_normal((B, Tq, DM),
                                                 dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Tkv, DM), dtype=np.float32))
    k[:, bounds[-2]:] *= 3
    v = torch.from_numpy(rng.standard_normal((B, Tkv, DM), dtype=np.float32))
    want = packed_encoder_attention_plain(q, k, v, H)
    got = _split_combined(q, k, v, H, bounds)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6


# -- K3 ----------------------------------------------------------------------

@pytest.mark.parametrize("B,T,D,F", [(1, 64, 128, 1280), (2, 40, 256, 1280)])
def test_enc_ffn_plain_matches_pallas(B, T, D, F):
    rng = np.random.default_rng(1)
    jx, tx = _bf16(rng.standard_normal((B, T, D)))
    jw1, tw1 = _bf16(0.05 * rng.standard_normal((D, F)))
    jb1, tb1 = _bf16(0.05 * rng.standard_normal(F))
    jw2, tw2 = _bf16(0.05 * rng.standard_normal((F, D)))
    jb2, tb2 = _bf16(0.05 * rng.standard_normal(D))
    want = _np(jax_ffn(jx, jw1, jb1, jw2, jb2, 64, True))
    # the port stores linear weights [out, in]
    got = _np(encoder_ffn(tx, tw1.t().contiguous(), tb1,
                          tw2.t().contiguous(), tb2))
    # the Pallas erf is A&S 7.1.26 (|err| <= 1.5e-7) and the port's is
    # exact; with bf16 rounding of the GELU output a flip of one bf16 ulp
    # is possible, so: within 2e-2 of the output scale
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-2


# -- K8 ----------------------------------------------------------------------

def _fused_cfg(qk_norm):
    return LLMConfig(
        model_id="test/fused-nano", vocab_size=512, hidden_size=512,
        intermediate_size=768, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, rope_scaling=None, tie_word_embeddings=False,
        qk_norm=qk_norm, bos_token_id=0, eos_token_id=1)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_fused_decode_plain_matches_pallas(qk_norm, monkeypatch):
    """bf16 tower, per-row cache indices with left padding, random cache."""
    from desta25_audio_tpu.ops.core import rms_norm as j_rms
    from desta25_audio_tpu.ops.fused_decode import (
        fused_decode_layers as jax_fused,
    )
    from desta25_audio_tpu_torch.ops.core import rms_norm as t_rms
    monkeypatch.setenv("DESTA_FUSED_INTERPRET", "1")
    cfg = _fused_cfg(qk_norm)
    B, S, L, KVD = 3, 128, 2, 256
    jp = tree_cast(jllm.init_llm(jax.random.PRNGKey(5), cfg,
                                 dtype=jnp.float32), jnp.bfloat16)
    tp = llm_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    jk, tk = _bf16(rng.standard_normal((L, B, S, KVD)))
    jv, tv = _bf16(rng.standard_normal((L, B, S, KVD)))
    ci = np.array([5, 9, 40], np.int32)
    pad = np.array([0, 2, 7])
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        mask[b, pad[b]:ci[b] + 1] = 1
    pos = (ci - pad)[:, None].astype(np.int32)
    ids = rng.integers(2, 500, size=(B, 1))
    jx = jp["embed"][jnp.asarray(ids)]

    jh, jcache = jax_fused(jp, cfg, jx, jnp.asarray(mask), jnp.asarray(pos),
                           jllm.KVCache(jk, jv), jnp.asarray(ci))
    want = _np(jllm._head_logits(jp, cfg, j_rms(jp["norm"], jh,
                                                cfg.rms_norm_eps)))
    tcache = KVCache(tk.clone(), tv.clone())
    th, tcache = fused_decode_layers(
        tp, cfg, tllm.embed_tokens(tp, torch.from_numpy(ids)),
        torch.from_numpy(mask), torch.from_numpy(pos), tcache,
        torch.from_numpy(ci))
    got = _np(tllm.head_logits(tp, t_rms(tp["norm"], th, cfg.rms_norm_eps)))
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-2
    # the cache: the rows at ci match the JAX kernel's, nothing else moved
    for new, ref, old in ((tcache.k, jcache.k, tk), (tcache.v, jcache.v, tv)):
        new, ref, old = _np(new), _np(ref), _np(old)
        rows = (slice(None), np.arange(B), ci)
        assert np.abs(new[rows] - ref[rows]).max() < 0.05
        keep = np.ones((L, B, S), bool)
        keep[rows] = False
        np.testing.assert_array_equal(new[keep], old[keep])
        assert (np.abs(new[rows] - old[rows]).max(-1) > 0).all()


def test_cpu_path_counts_no_launch():
    _build.reset_launch_counts()
    q = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    packed_encoder_attention(q, q, q, 2)
    assert _build.launch_counts() == {}
