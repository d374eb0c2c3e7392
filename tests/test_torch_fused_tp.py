"""K9, the per-layer decode pair (``ops/fused_decode_tp.py``), against the
JAX package on the CPU.

- p = 1: the port's plain per-layer step against JAX
  ``fused_decode_layers_perlayer`` in interpret mode, on the nano tower of
  tests/test_fused_tp.py:26-32 and a qk-norm variant (random norm scales),
  with its tanh injection between layers, per-row cache indices and left
  padding, 3 chained steps: logits within 5e-2 of their scale, identical
  argmax, the written cache rows within 5e-2 (the bounds of
  tests/test_fused_tp.py:138-145).
- p = 2: the two ranks' plain halves from ``shard_layers``, their partials
  summed, against JAX ``fused_decode_layers_tp`` on the 2-way CPU "model"
  mesh in interpret mode, with the same bounds.
- ``shard_layers`` at p = 2 and 4: the ranks' partials of each half sum to
  the unsharded half's within f32 reassociation.
- K9's q/k/v and gate/up products (the step's norm kernel on the f32
  residual, then the skinny GEMM): their plain versions against JAX
  ``_rmsn`` and the int8 product; the norm's refusals on ``meta`` tensors,
  which ``perlayer_limits`` reports.
- Nano ORCA ``generate()`` with the int8 LLM and the float stack: greedy
  ids identical to JAX's on its kernel dispatch, with the opt-in set (both
  sides through their per-layer pair; the port's steps through
  ``generate/graph.PerLayerStep``, each step's logits bit-identical to
  ``llm_apply``'s per-layer branch) and with it off (both through their
  layer loop, the JAX package's default).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu.config import DeSTA25Config as JConfig
from desta25_audio_tpu.config import LLMConfig as JLLMConfig
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops import fused_decode_tp as jtp
from desta25_audio_tpu.ops import quant as jq
from desta25_audio_tpu.ops.core import tree_cast
from desta25_audio_tpu.parallel.mesh import make_mesh, use_mesh
from desta25_audio_tpu.parallel.sharding import (
    apply_sharding,
    llm_partition_specs,
)
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.config import LLMConfig as TLLMConfig
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops import fused_decode_tp as ttp
from desta25_audio_tpu_torch.ops import quant as tq
from desta25_audio_tpu_torch.ops import skinny_gemm as tsg
from desta25_audio_tpu_torch.ops.fused_decode import RMS_D_MAX, decode_rms_norm
from desta25_audio_tpu_torch.ops.core import rms_norm as t_rms
from desta25_audio_tpu_torch.ops.fused_decode import KVCache
from test_torch_dispatch import _meta_tower
from test_torch_int8_llm import jax_tpu_dispatch

S, N_STEPS = 128, 3
TOL = 5e-2


def _cfgs(qk_norm=False, H=4, Hkv=2):
    kw = dict(model_id="test/fused-nano", vocab_size=512, hidden_size=512,
              intermediate_size=768, num_hidden_layers=2,
              num_attention_heads=H, num_key_value_heads=Hkv, head_dim=128,
              rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
              tie_word_embeddings=False, qk_norm=qk_norm, bos_token_id=0,
              eos_token_id=1)
    return JLLMConfig(**kw), TLLMConfig(**kw)


def _towers(qk_norm=False, H=4, Hkv=2):
    """The JAX int8 tower (norm scales random, so the norms show) and its
    bridge to the port."""
    jcfg, tcfg = _cfgs(qk_norm, H, Hkv)
    jp = jllm.init_llm(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    for k in ("ln1", "ln2", "q_norm", "k_norm"):
        if k in jp["layers"]:
            shape = jp["layers"][k]["scale"].shape
            jp["layers"][k]["scale"] = jnp.asarray(
                1.0 + 0.2 * rng.standard_normal(shape), jnp.float32)
    qp = jq.quantize_llm_params(tree_cast(jp, jnp.bfloat16))
    tp = bridge.llm_from_jax(jax.tree.map(np.asarray, qp), "cpu")
    return jcfg, tcfg, qp, tp


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding identical values."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _start(cfg, ci0, seed=0):
    """A random bf16 cache on both sides, a left-padded mask (row b: 1 + b
    pad positions), the first token ids."""
    B, L = len(ci0), cfg.num_hidden_layers
    KVD = cfg.num_key_value_heads * cfg.head_dim
    rng = np.random.default_rng(seed)
    jk, tk = _bf16(rng.standard_normal((L, B, S, KVD)))
    jv, tv = _bf16(rng.standard_normal((L, B, S, KVD)))
    pad = 1 + np.arange(B)
    mask = (np.arange(S)[None, :] >= pad[:, None]).astype(np.int32)
    ids = rng.integers(2, 500, size=(B, 1))
    return (jllm.KVCache(jk, jv), KVCache(tk, tv), mask, pad, ids)


def _jax_logits(qp, cfg, h):
    return _np(jllm._head_logits(qp, cfg, jllm.rms_norm(qp["norm"], h,
                                                        cfg.rms_norm_eps)))


def _port_logits(tp, cfg, h):
    return _np(tllm.head_logits(tp, t_rms(tp["norm"], h, cfg.rms_norm_eps)))


def _run_steps(jstep, tstep, qp, tp, jcfg, tcfg, ci0, jcache, tcache, mask,
               pad, ids):
    """N_STEPS chained steps on both sides (the JAX argmax fed back),
    checking logits and the written cache rows after each."""
    ci = np.asarray(ci0, np.int32)
    B = len(ci0)
    for _ in range(N_STEPS):
        pos = (ci - pad)[:, None]
        jh, jcache = jstep(qp["embed"][jnp.asarray(ids)], jnp.asarray(mask),
                           jnp.asarray(pos), jcache, jnp.asarray(ci))
        th, tcache = tstep(tllm.embed_tokens(tp, torch.from_numpy(ids)),
                           torch.from_numpy(mask), torch.from_numpy(pos),
                           tcache, torch.from_numpy(ci))
        want, got = _jax_logits(qp, jcfg, jh), _port_logits(tp, tcfg, th)
        assert got.shape == want.shape == (B, 1, jcfg.vocab_size)
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
        assert err < TOL, err
        assert (got.argmax(-1) == want.argmax(-1)).all()
        rows = (slice(None), np.arange(B), ci)
        for jc, tc in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
            np.testing.assert_allclose(_np(tc)[rows], _np(jc)[rows],
                                       rtol=TOL, atol=TOL)
            assert np.abs(_np(tc)[rows]).max() > 0
        ids = want.argmax(-1)
        ci = ci + 1


def _inject_jax(idx, h):
    # tests/test_fused_tp.py:102-105
    return h + (0.05 * (1.0 + idx.astype(jnp.float32))
                * jnp.tanh(h.astype(jnp.float32))).astype(h.dtype)


def _inject_port(idx, h):
    return h + (0.05 * (1.0 + idx) * torch.tanh(h.float())).to(h.dtype)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["llama", "qk_norm"])
def test_perlayer_plain_matches_jax(qk_norm, monkeypatch):
    monkeypatch.setenv("DESTA_FUSED_INTERPRET", "1")
    monkeypatch.setenv("DESTA_FUSED_PERLAYER", "1")
    jcfg, tcfg, qp, tp = _towers(qk_norm)
    ci0 = [16, 57]
    jcache, tcache, mask, pad, ids = _start(jcfg, ci0)
    assert jtp.fused_perlayer_supported(qp, jcfg, jcache)
    monkeypatch.setattr(ttp, "FUSED_PERLAYER", True)
    assert ttp.fused_perlayer_supported(tp, tcfg, tcache)

    def jstep(x, m, pos, cache, ci):
        return jtp.fused_decode_layers_perlayer(
            qp, jcfg, x, m, pos, cache, ci, extra_layer_fn=_inject_jax)

    def tstep(x, m, pos, cache, ci):
        return ttp.fused_decode_layers_perlayer(
            tp, tcfg, x, m, pos, cache, ci, extra_layer_fn=_inject_port)
    try:
        _build.reset_launch_counts()
        _run_steps(jstep, tstep, qp, tp, jcfg, tcfg, ci0, jcache, tcache,
                   mask, pad, ids)
        assert _build.launch_counts() == {}      # the CPU runs plain
    finally:
        jax.clear_caches()


def test_tp2_sharded_plain_matches_jax(monkeypatch):
    monkeypatch.setenv("DESTA_FUSED_INTERPRET", "1")
    jcfg, tcfg, qp, tp = _towers()
    p, ci0 = 2, [33, 57]
    B, D = len(ci0), tcfg.hidden_size
    jcache, tcache, mask, pad, ids = _start(jcfg, ci0, seed=1)
    mesh = make_mesh(n_data=1, n_model=p, devices=jax.devices()[:p])
    shards = [ttp.shard_layers(tp, tcfg, p, r) for r in range(p)]
    assert shards[0][1].num_attention_heads == 2

    def tstep(x, m, pos, cache, ci):
        caches = [ttp.shard_cache(cache, tcfg, p, r) for r in range(p)]
        step = ttp.decode_step_inputs(tcfg, m, pos, ci, B)
        h = x.reshape(B, D).to(torch.bfloat16).float()
        for l in range(tcfg.num_hidden_layers):
            h = h + sum(ttp.attn_half(sp, sc, h, step, c, l)
                        for (sp, sc), c in zip(shards, caches))
            h = h + sum(ttp.mlp_half(sp, sc, h, l) for sp, sc in shards)
        full = KVCache(torch.cat([c.k for c in caches], -1),
                       torch.cat([c.v for c in caches], -1))
        return h.to(torch.bfloat16).reshape(B, 1, D), full

    try:
        with use_mesh(mesh):
            sharded = apply_sharding(qp, llm_partition_specs(qp))

            def jstep(x, m, pos, cache, ci):
                return jtp.fused_decode_layers_tp(sharded, jcfg, x, m, pos,
                                                  cache, ci)
            _run_steps(jstep, tstep, qp, tp, jcfg, tcfg, ci0, jcache,
                       tcache, mask, pad, ids)
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("p", [2, 4])
def test_shard_partials_sum_to_the_unsharded_half(p):
    _, tcfg = _cfgs(qk_norm=True, H=8, Hkv=4)
    gen = torch.Generator().manual_seed(p)
    tp = tq.quantize_llm_params(tllm.init_llm(tcfg, torch.bfloat16, "cpu",
                                              gen))
    B = 3
    cache = tllm.init_kv_cache(tcfg, B, S, torch.bfloat16, "cpu")
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    h = torch.randn(B, tcfg.hidden_size, generator=gen)
    ci = torch.tensor([5, 70, 127])
    mask = torch.ones(B, S, dtype=torch.int32)
    step = ttp.decode_step_inputs(tcfg, mask, ci[:, None], ci, B)
    full = KVCache(cache.k.clone(), cache.v.clone())
    for l in range(tcfg.num_hidden_layers):
        want_a = ttp.attn_half(tp, tcfg, h, step, full, l)
        want_m = ttp.mlp_half(tp, tcfg, h, l)
        parts_a, parts_m, caches = [], [], []
        for r in range(p):
            sp, sc = ttp.shard_layers(tp, tcfg, p, r)
            assert sp["layers"]["wo"]["q"].is_contiguous()
            assert sp["layers"]["w_down"]["q"].shape[-1] == \
                tcfg.intermediate_size // p
            c = ttp.shard_cache(cache, tcfg, p, r)
            parts_a.append(ttp.attn_half(sp, sc, h, step, c, l))
            parts_m.append(ttp.mlp_half(sp, sc, h, l))
            caches.append(c)
        # the MLP's partials differ from the whole sum by reassociation
        # only; the attention's rounds P to bf16 after f32 scores that the
        # shard's smaller products may sum in another order, so a weight
        # can flip by one bf16 ulp (2^-8 of itself)
        for got, want, tol in ((sum(parts_a), want_a, 1e-3),
                               (sum(parts_m), want_m, 1e-5)):
            assert float((got - want).abs().max()) <= tol * float(
                want.abs().max())
        for side in ("k", "v"):
            got = torch.cat([getattr(c, side)[l] for c in caches], -1)
            assert torch.equal(got, getattr(full, side)[l])
    with pytest.raises(ValueError, match="split 3 ways"):
        ttp.shard_layers(tp, tcfg, 3, 0)


def test_perlayer_predicate_and_refusals(monkeypatch):
    _, tcfg, _, tp = _towers()
    cache = tllm.init_kv_cache(tcfg, 2, S, torch.bfloat16, "cpu")
    monkeypatch.setattr(ttp, "FUSED_PERLAYER", False)
    assert not ttp.fused_perlayer_supported(tp, tcfg, cache)   # opt-in
    monkeypatch.setattr(ttp, "FUSED_PERLAYER", True)
    assert ttp.fused_perlayer_supported(tp, tcfg, cache)
    assert ttp.perlayer_limits(tp, tcfg, cache, 2) == []
    bf = tllm.init_llm(tcfg, torch.bfloat16, "cpu",
                       torch.Generator().manual_seed(0))
    assert not ttp.fused_perlayer_supported(bf, tcfg, cache)
    assert "not int8" in ttp.perlayer_limits(bf, tcfg, cache, 2)[0]
    f32 = tllm.init_kv_cache(tcfg, 2, S, torch.float32, "cpu")
    assert not ttp.fused_perlayer_supported(tp, tcfg, f32)
    wide = dataclasses.replace(tcfg, head_dim=64)
    assert any("head_dim" in r for r in ttp.perlayer_limits(
        tp, wide, tllm.init_kv_cache(wide, 2, S, torch.bfloat16, "cpu"), 2))
    # the norm kernel's width on the f32 residual, and nothing else: 16
    # rows of a 16384-wide model (which PRs 6-17's fused-norm GEMV refused
    # for its shared memory) pass, a 40960-wide one does not (meta
    # tensors: shapes only)
    for D, refused in ((16384, False), (40960, True)):
        big = dataclasses.replace(tcfg, hidden_size=D, intermediate_size=D,
                                  num_hidden_layers=1)
        cache = tllm.init_kv_cache(big, 16, S, torch.bfloat16, "meta")
        why = ttp.perlayer_limits(_meta_tower(big, True), big, cache, 16)
        assert any("norm kernel" in r for r in why) == refused, why
        assert len(why) == refused, why


# -- K9's q/k/v and gate/up products ------------------------------------------

@pytest.mark.parametrize("M", [1, 2, 3, 16, 17])
@pytest.mark.parametrize("swiglu", [False, True], ids=["store", "swiglu"])
def test_norm_and_product_plain_match_jax_rmsn(M, swiglu):
    """The half's ln then int8 product on the f32 residual (the norm on its
    bf16 cast, the skinny GEMM's plain version): x = JAX ``_rmsn`` (the
    Pallas kernels' norm) of bf16(h), identical, then the product with its
    scale after the f32 sum and the epilogue."""
    K, rows = 256, 96
    rng = np.random.default_rng(M)
    h = (3 * rng.standard_normal((M, K))).astype(np.float32)
    lw = _bf16(1 + 0.2 * rng.standard_normal(K))
    q = rng.integers(-127, 128, (rows, K)).astype(np.int8)
    sc = (1e-2 * rng.random(rows)).astype(np.float32)
    xn = jtp._rmsn(jnp.asarray(h).astype(jnp.bfloat16), lw[0][None], 1e-5)
    got_x = decode_rms_norm(torch.from_numpy(h), lw[1], 1e-5)
    assert got_x.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got_x), _np(xn))
    v = (_np(xn) @ q.T.astype(np.float32)) * sc
    if swiglu:
        bf = lambda a: _np(jnp.asarray(a).astype(jnp.bfloat16))  # noqa: E731
        gt, up = bf(v[:, 0::2]), bf(v[:, 1::2])
        want = bf(bf(gt / (1 + np.exp(-gt))) * up)
    else:
        want = _np(jnp.asarray(v).astype(jnp.bfloat16))
    got = tsg.skinny_gemm(got_x, torch.from_numpy(q), torch.from_numpy(sc),
                          tsg.EPI_SWIGLU if swiglu else tsg.EPI_STORE)
    assert got.shape == (M, rows // (2 if swiglu else 1))
    err = np.abs(_np(got) - want).max() / (np.abs(want).max() + 1e-6)
    assert err < 1e-2, err


@pytest.mark.parametrize("D", [4096, 2560, 512, 100, 32768, 32776])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_refusals_on_meta(D, dtype):
    """The step's norm kernel, on K9's f32 rows and K8's bf16 rows, takes
    what ``kernel_limits`` takes: its wrapper on meta tensors stops at the
    device check exactly where D is a multiple of 8 up to RMS_D_MAX."""
    x = torch.empty(2, D, dtype=dtype, device="meta")
    w = torch.empty(D, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError) as e:
        decode_rms_norm(x, w, 1e-5)
    took = "expected the CUDA device" in str(e.value)
    assert took == (D % 8 == 0 and D <= RMS_D_MAX)
    cfg = dataclasses.replace(_cfgs()[1], hidden_size=D)
    assert any("norm kernel" in r for r in ttp.kernel_limits(
        cfg, 2, 1, S, True)) == (D > RMS_D_MAX)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from desta25_audio_tpu_torch.audio.io import write_wav
    t = np.arange(12000) / 16000.0
    sig = (0.5 * np.sin(2 * np.pi * 640 * t)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("audio") / "tone.wav")
    write_wav(path, sig)
    return path


def _orca_models():
    """The nano ORCA model on both sides: int8 LLM, f32 cross-attention
    stack."""
    from test_torch_orca import ORCA_NANO
    jm = JaxModel(JConfig(**ORCA_NANO, dtype="bfloat16"), seed=2)
    jm.params["llm"] = jq.quantize_llm_params(jm.params["llm"])
    cfg = DeSTA25Config(**ORCA_NANO, dtype="bfloat16")
    tm = DeSTA25AudioModel(cfg, device="cpu", params=bridge.from_jax_params(
        jax.tree.map(np.asarray, jm.params), cfg, "cpu"))
    assert not tq.is_quantized(tm.params["orca_cross_attns"]["layers"]["q"])
    return jm, tm


def _count_perlayer_calls(monkeypatch):
    calls = {"jax": 0, "port": 0}
    jreal, treal = (jtp.fused_decode_layers_perlayer,
                    tllm.fused_decode_layers_perlayer)

    def counted(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(jtp, "fused_decode_layers_perlayer",
                        counted("jax", jreal))
    monkeypatch.setattr(tllm, "fused_decode_layers_perlayer",
                        counted("port", treal))
    return calls


def _count_stepper_runs(monkeypatch):
    from desta25_audio_tpu_torch.generate import graph as tgraph
    runs = [0]
    real = tgraph.PerLayerStep.run

    def counted(self, *a, **k):
        runs[0] += 1
        return real(self, *a, **k)
    monkeypatch.setattr(tgraph.PerLayerStep, "run", counted)
    return runs


def test_nano_orca_generate_perlayer_matches_jax(wav, monkeypatch):
    """int8 LLM, f32 cross-attention stack, the opt-in on both sides: JAX's
    decode steps run its per-layer pair in interpret mode with the XLA
    injection between layers, the port's the plain pair with the PyTorch
    injection, through the decode graph's per-layer stepper (eager on the
    CPU)."""
    from test_torch_orca import _msgs
    jax_tpu_dispatch(monkeypatch)
    monkeypatch.setenv("DESTA_FUSED_PERLAYER", "1")
    monkeypatch.setattr(ttp, "FUSED_PERLAYER", True)
    calls = _count_perlayer_calls(monkeypatch)
    stepper = _count_stepper_runs(monkeypatch)
    try:
        jm, tm = _orca_models()
        want = jm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
        got = tm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
        assert got.generated_ids == want.generated_ids
        assert calls["jax"] > 0
        assert calls["port"] == tm.last_timings["decode_steps"] >= 1
        assert stepper[0] == calls["port"]
        # a float stack falls back from speculation to this same loop
        spec = tm.generate(_msgs(wav), max_new_tokens=5, do_sample=False,
                           speculative_k=3)
        assert spec.generated_ids == got.generated_ids
        assert tm.last_spec_fallback
    finally:
        jax.clear_caches()


def test_nano_orca_generate_layer_loop_matches_jax_default(wav, monkeypatch):
    """The same model with the opt-in off on both sides (the JAX package's
    default): the hooked decode steps take the layer loop, whose bf16
    residual between layers is JAX's default numerics, and the per-layer
    pair never runs."""
    from test_torch_orca import _msgs
    jax_tpu_dispatch(monkeypatch)
    monkeypatch.delenv("DESTA_FUSED_PERLAYER", raising=False)
    monkeypatch.setattr(ttp, "FUSED_PERLAYER", False)
    calls = _count_perlayer_calls(monkeypatch)
    try:
        jm, tm = _orca_models()
        want = jm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
        got = tm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
        assert got.generated_ids == want.generated_ids
        assert tm.last_timings["decode_steps"] >= 1
        assert calls == {"jax": 0, "port": 0}
    finally:
        jax.clear_caches()


def test_nano_orca_perlayer_stepper_logits_match_llm_apply(wav, monkeypatch):
    """The opt-in's decode steps through ``generate/graph.PerLayerStep``
    (one run a step) against the same ``generate()`` with the stepper
    turned away, whose steps take ``llm_apply``'s per-layer branch with the
    hook: every sampled step's logits bit-identical, the same ids."""
    from desta25_audio_tpu_torch.generate import decode as tdecode
    from test_torch_orca import _msgs
    monkeypatch.setattr(ttp, "FUSED_PERLAYER", True)
    _, tm = _orca_models()
    real_sample = tdecode.sample_token
    runs = {}
    for stepper in (True, False):
        seen = []
        monkeypatch.setattr(
            tdecode, "sample_token",
            lambda lg, *a: seen.append(lg.clone()) or real_sample(lg, *a))
        if not stepper:
            monkeypatch.setattr(tdecode, "fused_perlayer_supported",
                                lambda *a: False)
        used = _count_stepper_runs(monkeypatch)
        calls = _count_perlayer_calls(monkeypatch)
        out = tm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
        steps = tm.last_timings["decode_steps"]
        assert calls["port"] == steps >= 1
        assert used[0] == (steps if stepper else 0)
        runs[stepper] = (out.generated_ids, seen)
    (g_ids, g_lg), (e_ids, e_lg) = runs[True], runs[False]
    assert g_ids == e_ids
    assert len(g_lg) == len(e_lg) == steps + 1
    assert all(torch.equal(a, b) for a, b in zip(g_lg, e_lg))
