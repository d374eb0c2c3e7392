"""The port's ORCA hybrid path against the JAX package on the CPU.

- ``fractional_rope_apply``, ``orca_connector_apply`` (local branch on and
  off), ``gated_cross_attention_apply`` (float and int8 leaves, with and
  without cached K/V) and ``precompute_cross_kv`` in f32 on identical
  weights (the JAX init converted by ``ckpt/bridge.py``): 1e-4 of the output
  scale for f32 math in other summation orders; the int8 leaves go through
  the JAX package's TPU dispatch (K7 in interpret mode, the W8A8 formula),
  where the same bf16 rounding of the activations happens on both sides.
- ``quantize_orca_cross_attns`` and the bridge of an int8 stack identical to
  JAX's.
- K8i: the plain version of the decode / verify step with the in-kernel
  injection against the JAX fused kernel in interpret mode, within 3e-2 of
  the logit scale (the bound of tests/test_fused_inject.py): injection head
  dims 128 and 64, audio tokens not a multiple of 8 (the port does not
  pad), ``on = [1, 0]`` rows, per-row cache indices, 1 and 3 tokens per row.
  Rows with ``on = 0`` equal the injection-free step exactly.
- The slice: nano ORCA ``generate()`` greedy ids identical to JAX's with the
  int8 tower and stack on JAX's kernel dispatch and with the float stack on
  its XLA path; ``speculative_k=3`` ids equal the plain loop's, with the
  float stack too, which the verify kernel cannot take (the plain loop
  runs, as in the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.config import DeSTA25Config as JConfig
from desta25_audio_tpu.config import LLMConfig
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.models import orca as jorca
from desta25_audio_tpu.ops import quant as jq
from desta25_audio_tpu.ops.core import (
    init_layer_norm,
    init_linear,
    stack_layers,
    tree_cast,
)
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.models import orca as torca
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops import quant as tq
from desta25_audio_tpu_torch.ops.core import index_tree
from desta25_audio_tpu_torch.ops.core import rms_norm as t_rms
from desta25_audio_tpu_torch.ops.fused_decode import (
    KVCache,
    fused_decode_layers,
    fused_inject_limits,
    fused_verify_layers,
)
from desta25_audio_tpu_torch.ops.rope import fractional_rope_apply
from test_torch_int8_llm import jax_tpu_dispatch

ORCA_NANO = dict(llm_model_id="test/llama-nano128",
                 encoder_model_id="test/whisper-nano",
                 connector_mode="orca_hybrid", qformer_num_hidden_layers=2,
                 orca_global_num_tokens=4, orca_local_downsample=4,
                 orca_local_kernel_size=5, orca_audio_position_scale=2.5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding identical values."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _jax_stack(key, cfg, gate_w=0.2):
    """The JAX init of the cross-attention stack (models/orca.py
    init_orca_cross_attns) with a random gate2 weight: the zero init would
    leave the gate path untested (tests/test_fused_inject.py:51-69)."""
    d = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_hidden_layers):
        key, kq, kk, kv, ko, kg1, kg2 = jax.random.split(key, 7)
        layers.append({
            "q": init_linear(kq, d, d), "k": init_linear(kk, d, d),
            "v": init_linear(kv, d, d), "o": init_linear(ko, d, d),
            "gate1": init_linear(kg1, d, d // 4),
            "gate2": {"w": jax.random.normal(kg2, (d // 4, 1)) * gate_w,
                      "b": jnp.full((1,), 0.25, jnp.float32)},
            "ln": {"scale": 1.0 + 0.1 * jax.random.normal(kq, (d,)),
                   "bias": 0.1 * jax.random.normal(kk, (d,))},
        })
    return {"layers": stack_layers(layers)}


def _port(tree):
    return jax.tree.map(np.asarray, tree)


# -- the modules in f32 ---------------------------------------------------------

def test_fractional_rope_matches_jax():
    from desta25_audio_tpu.ops.rope import fractional_rope_apply as jrope
    x = np.random.default_rng(0).standard_normal((2, 37, 512)).astype(
        np.float32)
    want = jrope(jnp.asarray(x), 2.5, 500000.0)
    got = fractional_rope_apply(torch.from_numpy(x), 2.5, 500000.0)
    assert _rel(got, want) < 1e-5
    # position 0 is the identity rotation
    np.testing.assert_allclose(_np(got)[:, 0], x[:, 0], atol=1e-6)


@pytest.mark.parametrize("local", [True, False])
def test_orca_connector_matches_jax(local):
    cfg = JConfig(**ORCA_NANO, dtype="float32", orca_local_enabled=local)
    jp = jorca.init_orca_connector(jax.random.PRNGKey(1), cfg, jnp.float32)
    rng = np.random.default_rng(3)
    # non-zero fusion logits, so both softmaxes are exercised
    for k in ("global_layer_weights", "local_layer_weights"):
        if k in jp:
            jp[k] = jnp.asarray(rng.standard_normal(jp[k].shape), jnp.float32)
    tp = bridge.orca_connector_from_jax(_port(jp), "cpu")
    assert ("local_conv" in tp) == local
    d = cfg.encoder_config.d_model
    taps = rng.standard_normal((4, 2, 150, d)).astype(np.float32)
    jg, jl = jorca.orca_connector_apply(jp, jnp.asarray(taps), cfg)
    tg, tl = torca.orca_connector_apply(tp, torch.from_numpy(taps),
                                        DeSTA25Config(**ORCA_NANO,
                                                      dtype="float32",
                                                      orca_local_enabled=local))
    assert _rel(tg, jg) < 1e-4
    if local:
        # 150 frames -> ceil(150 / 4) local tokens at the LLM width
        assert tl.shape == (2, 38, 512)
        assert _rel(tl, jl) < 1e-4
    else:
        assert tl is None and jl is None


@pytest.fixture(scope="module")
def stacks():
    cfg = JConfig(**ORCA_NANO).llm_config
    jx = _jax_stack(jax.random.PRNGKey(7), cfg)
    jx8 = jq.quantize_orca_cross_attns(jx)
    return cfg, jx, jx8


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_gated_cross_attention_matches_jax(stacks, int8, cached,
                                           monkeypatch):
    """One layer on f32 hidden rows (M = 6 < 128: K7 for int8 q/o/gate1)
    over 80 audio tokens per row (M = 160 >= 128: W8A8 for int8 k/v), and
    precompute_cross_kv against JAX's."""
    cfg, jx, jx8 = stacks
    if int8:
        jax_tpu_dispatch(monkeypatch)
    jstack = jx8 if int8 else jx
    tstack = bridge.orca_cross_attns_from_jax(_port(jstack), "cpu")
    rng = np.random.default_rng(int(int8) * 2 + int(cached))
    hidden = rng.standard_normal((2, 3, cfg.hidden_size)).astype(np.float32)
    audio = (0.5 * rng.standard_normal((2, 80, cfg.hidden_size))
             ).astype(np.float32)
    H = cfg.num_attention_heads
    try:
        jroped = jorca.fractional_rope_apply(jnp.asarray(audio), 2.5,
                                             cfg.rope_theta)
        troped = fractional_rope_apply(torch.from_numpy(audio), 2.5,
                                       cfg.rope_theta)
        jkv = tkv = None
        if cached:
            jkv = jorca.precompute_cross_kv(jstack, jroped)
            tkv = torca.precompute_cross_kv(tstack, troped)
            assert tkv[0].shape == (cfg.num_hidden_layers, 2, 80,
                                    cfg.hidden_size)
            for g, w in zip(tkv, jkv):
                assert _rel(g, w) < 1e-4
        for l in range(cfg.num_hidden_layers):
            want = jorca.gated_cross_attention_apply(
                jax.tree.map(lambda a: a[l], jstack["layers"]),
                jnp.asarray(hidden), None if cached else jroped, H,
                cached_kv=None if jkv is None else (jkv[0][l], jkv[1][l]))
            got = torca.gated_cross_attention_apply(
                index_tree(tstack["layers"], l), torch.from_numpy(hidden),
                None if cached else troped, H,
                cached_kv=None if tkv is None else (tkv[0][l], tkv[1][l]))
            assert _rel(got, want) < 1e-4
    finally:
        jax.clear_caches()


def test_quantize_orca_cross_attns_and_bridge_match_jax(stacks):
    _, jx, jx8 = stacks
    want = bridge.orca_cross_attns_from_jax(_port(jx8), "cpu")
    plain = bridge.orca_cross_attns_from_jax(_port(jx), "cpu")
    got = tq.quantize_orca_cross_attns(plain)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)]
    for (path, g), (_, w) in zip(flat(got), flat(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    lay = got["layers"]
    L, D = lay["ln"]["scale"].shape
    assert lay["q"]["q"].dtype == torch.int8 and lay["q"]["q"].shape == (L, D, D)
    assert lay["gate1"]["q"].shape == (L, D // 4, D)
    # gate2 and the LayerNorm stay float; gate2's weight is [L, 1, D/4]
    assert lay["gate2"]["w"].shape == (L, 1, D // 4)
    assert lay["gate2"]["b"].shape == (L, 1)
    np.testing.assert_array_equal(
        lay["gate1"]["q"].numpy(),
        np.swapaxes(np.asarray(jx8["layers"]["gate1"]["q"]), 1, 2))
    assert lay["ln"]["scale"] is plain["layers"]["ln"]["scale"]
    assert fused_inject_limits(got, _llm_cfg(D, 4, 2), 4, 375) == []
    assert "q is not an int8 leaf" in fused_inject_limits(
        plain, _llm_cfg(D, 4, 2), 4, 375)[0]


# -- K8i: the plain step against the JAX kernel in interpret mode --------------

def _llm_cfg(D, H, Hkv):
    return LLMConfig(
        model_id="test/fused-inj-nano", vocab_size=512, hidden_size=D,
        intermediate_size=768, num_hidden_layers=2, num_attention_heads=H,
        num_key_value_heads=Hkv, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, rope_scaling=None, tie_word_embeddings=False,
        qk_norm=False, bos_token_id=0, eos_token_id=1)


@pytest.mark.parametrize("H,Hkv,ta,ci,on,kd", [
    (4, 2, 24, [5, 9], [1, 0], 1),             # injection head dim 128
    (8, 4, 20, [5, 9, 14], [1, 0, 1], 1),      # dh 64, per-row ci, Ta % 8
    (8, 4, 20, [8, 30], [1, 1], 3),            # the verify step
], ids=["dh128", "dh64-rows", "verify-kd3"])
def test_fused_inject_plain_matches_pallas(H, Hkv, ta, ci, on, kd,
                                           monkeypatch):
    from desta25_audio_tpu.ops.fused_decode import fused_decode_layers as jd
    from desta25_audio_tpu.ops.fused_decode import fused_verify_layers as jv
    from desta25_audio_tpu.ops.fused_decode import pad_audio_kv
    monkeypatch.setenv("DESTA_FUSED_INTERPRET", "1")
    D, B, S, L = 512, len(ci), 128, 2
    cfg = _llm_cfg(D, H, Hkv)
    jp = jq.quantize_llm_params(tree_cast(
        jllm.init_llm(jax.random.PRNGKey(5), cfg, dtype=jnp.float32),
        jnp.bfloat16))
    tp = bridge.llm_from_jax(_port(jp), "cpu")
    jx8 = jq.quantize_orca_cross_attns(_jax_stack(jax.random.PRNGKey(6), cfg))
    tx8 = bridge.orca_cross_attns_from_jax(_port(jx8), "cpu")
    rng = np.random.default_rng(H + kd)
    jk, tk = _bf16(rng.standard_normal((L, B, S, Hkv * 128)))
    jv_, tv = _bf16(rng.standard_normal((L, B, S, Hkv * 128)))
    jka, tka = _bf16(rng.standard_normal((L, B, ta, D)))
    jva, tva = _bf16(rng.standard_normal((L, B, ta, D)))
    ci = np.asarray(ci, np.int32)
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        mask[b, 1 + b:ci[b] + kd] = 1       # left padding of 1 + b
    pos = (ci - 1 - np.arange(B))[:, None] + np.arange(kd)[None, :]
    ids = rng.integers(2, 500, size=(B, kd))
    onv = np.asarray(on, np.float32)
    jspec = dict(params=jx8, k=pad_audio_kv(jka), v=pad_audio_kv(jva),
                 ta_real=ta, heads=H, on=jnp.asarray(onv))
    tspec = dict(params=tx8, k=tka, v=tva, ta_real=ta, heads=H,
                 on=torch.from_numpy(onv))
    jfn, tfn = (jd, fused_decode_layers) if kd == 1 else (
        jv, fused_verify_layers)
    jh, _ = jfn(jp, cfg, jp["embed"][jnp.asarray(ids)], jnp.asarray(mask),
                jnp.asarray(pos), jllm.KVCache(jk, jv_), jnp.asarray(ci),
                inject=jspec)
    want = jllm._head_logits(jp, cfg, jllm.rms_norm(jp["norm"], jh,
                                                    cfg.rms_norm_eps))
    args = (tp, cfg, tllm.embed_tokens(tp, torch.from_numpy(ids)),
            torch.from_numpy(mask), torch.from_numpy(pos))
    th, tcache = tfn(*args, KVCache(tk.clone(), tv.clone()),
                     torch.from_numpy(ci), inject=tspec)
    got = tllm.head_logits(tp, t_rms(tp["norm"], th, cfg.rms_norm_eps))
    assert got.shape == (B, kd, cfg.vocab_size)
    assert _rel(got, want) < 3e-2
    # injection moved the rows with on = 1 and left the others alone
    plain, _ = tfn(*args, KVCache(tk.clone(), tv.clone()),
                   torch.from_numpy(ci))
    for b in range(B):
        same = torch.equal(th[b], plain[b])
        assert same == (on[b] == 0), b


def test_inject_off_rows_equal_the_injection_free_step():
    cfg = _llm_cfg(512, 4, 2)
    gen = torch.Generator().manual_seed(0)
    tp = tq.quantize_llm_params(tllm.init_llm(cfg, torch.bfloat16, "cpu",
                                              gen))
    conf = DeSTA25Config(**ORCA_NANO)
    stack = tq.quantize_orca_cross_attns(torca.init_orca_cross_attns(
        conf, torch.float32, "cpu", gen))
    B, S, ta = 2, 128, 16
    cache = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cpu")
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    kv = torch.randn(2, 2, B, ta, 512, generator=gen).bfloat16()
    spec = dict(params=stack, k=kv[0], v=kv[1], ta_real=ta, heads=4,
                on=torch.zeros(B))
    x = tllm.embed_tokens(tp, torch.tensor([[7], [9]]))
    mask = torch.ones(B, S, dtype=torch.int32)
    pos, ci = torch.tensor([[20], [30]]), torch.tensor([20, 30])
    want, wc = fused_decode_layers(tp, cfg, x, mask, pos,
                                   KVCache(cache.k.clone(), cache.v.clone()),
                                   ci)
    got, gc = fused_decode_layers(tp, cfg, x, mask, pos,
                                  KVCache(cache.k.clone(), cache.v.clone()),
                                  ci, inject=spec)
    assert torch.equal(got, want)
    assert torch.equal(gc.k, wc.k) and torch.equal(gc.v, wc.v)


# -- the slice: nano ORCA generate() -------------------------------------------

@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from desta25_audio_tpu_torch.audio.io import write_wav
    t = np.arange(12000) / 16000.0
    sig = (0.5 * np.sin(2 * np.pi * 640 * t)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("audio") / "tone.wav")
    write_wav(path, sig)
    return path


def _msgs(wav):
    return [[{"role": "user", "content": "Echo echo echo: <|AUDIO|>",
              "audios": [{"audio": wav, "text": "echo echo echo"}]}]]


def _models(quant: bool, seed: int):
    from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
    jm = JaxModel(JConfig(**ORCA_NANO, dtype="bfloat16"), seed=seed)
    if quant:
        jm.params["llm"] = jq.quantize_llm_params(jm.params["llm"])
        jm.params["orca_cross_attns"] = jq.quantize_orca_cross_attns(
            jm.params["orca_cross_attns"])
    cfg = DeSTA25Config(**ORCA_NANO, dtype="bfloat16")
    tm = DeSTA25AudioModel(cfg, device="cpu", params=bridge.from_jax_params(
        _port(jm.params), cfg, "cpu"))
    return jm, tm


def test_nano_orca_generate_int8_matches_jax_kernel_path(wav, monkeypatch):
    jax_tpu_dispatch(monkeypatch)
    try:
        jm, tm = _models(quant=True, seed=4)
        assert tq.is_quantized(tm.params["orca_cross_attns"]["layers"]["o"])
        want = jm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
        _build.reset_launch_counts()
        got = tm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
        assert got.generated_ids == want.generated_ids
        assert _build.launch_counts() == {}      # the CPU runs plain
        spec = tm.generate(_msgs(wav), max_new_tokens=5, do_sample=False,
                           speculative_k=3)
        assert spec.generated_ids == got.generated_ids
        assert tm.last_timings["decode_steps"] >= 1
    finally:
        jax.clear_caches()


def test_nano_orca_generate_float_stack_matches_jax_xla_path(wav):
    jm, tm = _models(quant=False, seed=1)
    assert not tq.is_quantized(tm.params["orca_cross_attns"]["layers"]["q"])
    want = jm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
    got = tm.generate(_msgs(wav), max_new_tokens=5, do_sample=False)
    assert got.generated_ids == want.generated_ids
    assert got.text == want.text
    # the verify step injects inside its kernel, which needs the int8
    # stack: a float stack decodes one token a step, as JAX's falls back
    spec = tm.generate(_msgs(wav), max_new_tokens=5, do_sample=False,
                       speculative_k=3)
    assert spec.generated_ids == got.generated_ids
    assert any("int8 leaf" in r for r in tm.last_spec_fallback)


def test_model_quantizes_its_orca_stack_in_place():
    cfg = DeSTA25Config(**ORCA_NANO, dtype="bfloat16")
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    stack = model.params["orca_cross_attns"]
    assert stack["layers"]["q"]["w"].dtype == torch.float32  # orca_xattn_dtype
    assert torch.equal(stack["layers"]["gate2"]["w"],
                       torch.zeros_like(stack["layers"]["gate2"]["w"]))
    want = tq.quantize_orca_cross_attns(stack)
    model.apply_orca_xattn_quant()
    got = model.params["orca_cross_attns"]
    assert model.config.orca_xattn_quant == "int8"
    for k in ("q", "k", "v", "o", "gate1"):
        assert torch.equal(got["layers"][k]["q"], want["layers"][k]["q"])
        assert "w" not in got["layers"][k]
    model.apply_orca_xattn_quant()                  # already int8: a no-op
    assert model.params["orca_cross_attns"] is got
