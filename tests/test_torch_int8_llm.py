"""The port's int8 LLM against the JAX package on the CPU.

- ``quantize_llm_params`` and the bridge of a JAX-quantized LLM: identical
  int8 values and scales after the layout map (fused ``wqkv``,
  row-interleaved ``w_gu``, ``[out, in]``, the padded head), untied and
  tied.
- The plain version of K7 (``ops/qmm.qmm``) against ``_qmm_kernel`` run
  through ``pl.pallas_call`` in interpret mode with the BlockSpecs of the
  JAX dispatch; the plain W8A8 prefill against the JAX formula.
- The plain int8 decode step against the JAX fused kernel in interpret mode.
- The slice: a nano ``generate()`` with ``llm_quant="int8"`` against the
  JAX package on its kernel path (K7 below 128 rows, W8A8 above, the fused
  decode kernel), greedy ids identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from desta25_audio_tpu.config import LLMConfig
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops import quant as jq
from desta25_audio_tpu.ops.core import tree_cast
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops import qmm as tqmm
from desta25_audio_tpu_torch.ops import quant as tq
from desta25_audio_tpu_torch.ops.core import rms_norm as t_rms
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


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


def _jax_llm(model_id, seed=3):
    from desta25_audio_tpu.config import llm_config_for
    cfg = llm_config_for(model_id)
    return cfg, tree_cast(jllm.init_llm(jax.random.PRNGKey(seed), cfg,
                                        dtype=jnp.float32), jnp.bfloat16)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# -- quantize_llm_params and the bridge ---------------------------------------

@pytest.mark.parametrize("model_id", ["test/llama-nano128",   # untied
                                      "test/qwen3-nano"])     # tied, qk-norm
def test_quantize_llm_params_matches_jax(model_id):
    _, jp = _jax_llm(model_id)
    want = bridge.llm_from_jax(jax.tree.map(np.asarray,
                                            jq.quantize_llm_params(jp)), "cpu")
    plain = bridge.llm_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got = tq.quantize_llm_params(plain)
    assert [p for p, _ in _flat(got)] == [p for p, _ in _flat(want)]
    for (path, g), (_, w) in zip(_flat(got), _flat(want)):
        assert g.dtype == w.dtype, path
        assert torch.equal(g, w), path
    V = plain["embed"].shape[0]
    assert got["lm_head"]["q"].shape[0] % tq.HEAD_PAD == 0
    assert (got["lm_head"]["s"][V:] == 1).all()
    assert (got["lm_head"]["q"][V:] == 0).all()
    # embed and the norms are carried as they are
    assert got["embed"] is plain["embed"]
    assert got["layers"]["ln1"] is plain["layers"]["ln1"]


def test_bridge_carries_a_jax_int8_llm():
    _, jp = _jax_llm("test/llama-nano128")
    jqp = jax.tree.map(np.asarray, jq.quantize_llm_params(jp))
    got = bridge.llm_from_jax(jqp, "cpu")
    lay, jl = got["layers"], jqp["layers"]
    T = lambda a: np.swapaxes(a, -1, -2)  # noqa: E731
    qkv = got["layers"]["wqkv"]
    assert qkv["q"].dtype == torch.int8 and qkv["s"].dtype == torch.float32
    np.testing.assert_array_equal(
        qkv["q"].numpy(),
        np.concatenate([T(jl[k]["q"]) for k in ("wq", "wk", "wv")], 1))
    np.testing.assert_array_equal(
        qkv["s"].numpy(),
        np.concatenate([jl[k]["s"] for k in ("wq", "wk", "wv")], 1))
    gu = lay["w_gu"]
    np.testing.assert_array_equal(gu["q"].numpy()[:, 0::2],
                                  T(jl["w_gate"]["q"]))
    np.testing.assert_array_equal(gu["q"].numpy()[:, 1::2],
                                  T(jl["w_up"]["q"]))
    np.testing.assert_array_equal(gu["s"].numpy()[:, 1::2],
                                  jl["w_up"]["s"])
    np.testing.assert_array_equal(lay["w_down"]["q"].numpy(),
                                  T(jl["w_down"]["q"]))
    np.testing.assert_array_equal(got["lm_head"]["q"].numpy(),
                                  T(jqp["lm_head"]["q"]))
    np.testing.assert_array_equal(got["lm_head"]["s"].numpy(),
                                  jqp["lm_head"]["s"])


# -- K7 and the W8A8 prefill: plain versions against the JAX ones --------------

def _pallas_qmm(x2, q, s, bn, bk):
    """``_qmm_kernel`` in interpret mode with the JAX dispatch's BlockSpecs
    (desta25_audio_tpu/ops/quant.py:137-180): M padded to a multiple of
    16, a (N // bn, K // bk) grid, f32 out."""
    M, K = x2.shape
    N = q.shape[1]
    Mp = max(-(-M // 16) * 16, 16)
    x2 = jnp.pad(x2, ((0, Mp - M), (0, 0)))
    vm = pltpu.VMEM
    out = pl.pallas_call(
        jq._qmm_kernel,
        out_shape=jax.ShapeDtypeStruct((Mp, N), jnp.float32),
        grid=(N // bn, K // bk),
        in_specs=[
            pl.BlockSpec((Mp, bk), lambda n, k: (0, k), memory_space=vm),
            pl.BlockSpec((bk, bn), lambda n, k: (k, n), memory_space=vm),
            pl.BlockSpec((1, bn), lambda n, k: (0, n), memory_space=vm),
        ],
        out_specs=pl.BlockSpec((Mp, bn), lambda n, k: (0, n),
                               memory_space=vm),
        scratch_shapes=[pltpu.VMEM((Mp, bn), jnp.float32)],
        interpret=True,
    )(x2, q, s[None, :])
    return out[:M]


def _pallas_blocks(K, N):
    """The JAX dispatch's block policy (quant.py:145-159)."""
    def divisors_desc(dim, limit, mult):
        return [b for b in range(min(limit, dim), 0, -mult)
                if dim % b == 0 and b % mult == 0]
    bn = (divisors_desc(N, 2560, 128) or [N])[0]
    bk = K
    if K * bn > 6 * 1024 * 1024:
        bk = next((b for b in divisors_desc(K, K, 128)
                   if b * bn <= 6 * 1024 * 1024), 128)
    return bn, bk


def _leaf(rng, k, n):
    """A JAX int8 leaf [k, n] and the port's [n, k] view of it."""
    jl = jq.quantize_weight(_bf16(0.05 * rng.standard_normal((k, n)))[0])
    return jl, bridge._linear(jax.tree.map(np.asarray, jl), "cpu")


@pytest.mark.parametrize("M,x_dtype", [
    *[pytest.param(M, "bf16", id=str(M)) for M in (1, 3, 16, 17, 64, 100,
                                                   127)],
    pytest.param(100, "f32", id="f32-100")])
def test_qmm_plain_matches_pallas(M, x_dtype):
    rng = np.random.default_rng(M)
    K, N = 1024, 1024
    jl, tl = _leaf(rng, K, N)
    if x_dtype == "bf16":
        jx, tx = _bf16(rng.standard_normal((M, K)))

        def run(out_dtype):
            return tqmm.qmm(tx, tl["q"], tl["s"], out_dtype)
    else:
        # f32 x: the Pallas kernel casts it to bf16 inside (quant.py:71),
        # quant_matmul before K7
        a = rng.standard_normal((M, K)).astype(np.float32)
        jx, tx = jnp.asarray(a), torch.from_numpy(a)

        def run(out_dtype):
            return tqmm.quant_matmul(tx, tl, out_dtype)
    # 2 x 2 blocks: the k-axis accumulator and the n-axis tiling both run
    want = _pallas_qmm(jx, jl["q"], jl["s"], bn=512, bk=512)
    got = run(torch.float32)
    assert got.dtype == torch.float32
    # f32 sums in another order: within 1e-5 of the output scale
    assert _rel(got, want) < 1e-5
    # the bf16 output is the f32 value rounded once
    np.testing.assert_array_equal(_np(run(torch.bfloat16)),
                                  _np(got.to(torch.bfloat16)))


def _jax_w8a8(x2, q, s):
    """The W8A8 branch of _qmm_dispatch (quant.py:123-130), f32 out."""
    xf = x2.astype(jnp.float32)
    a = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                    1e-8) / 127.0
    qx = jnp.round(xf / a).astype(jnp.int8)
    y = jax.lax.dot_general(qx, q, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    return qx, y.astype(jnp.float32) * a * s[None, :].astype(jnp.float32)


@pytest.mark.parametrize("M", [128, 257])
def test_w8a8_plain_matches_jax_formula(M):
    rng = np.random.default_rng(M)
    K, N = 512, 384
    jl, tl = _leaf(rng, K, N)
    x = rng.standard_normal((M, K)) * rng.uniform(0.01, 30, (M, 1))
    x[5] = 0.0                                      # the 1e-8 floor
    jx, tx = _bf16(x)
    jqx, want = _jax_w8a8(jx, jl["q"], jl["s"])
    tqx, _ = tq.quant_rows_llm(tx.float())
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    got = tqmm.w8a8_matmul(tx, tl["q"], tl["s"], torch.float32)
    assert _rel(got, want) < 1e-6
    # int8_act_matmul computes the same formula
    assert _rel(got, jq.int8_act_matmul(jx.astype(jnp.float32), jl)) < 1e-6


def test_quant_matmul_dispatch_follows_the_rows(monkeypatch):
    calls = []
    for name in ("qmm", "w8a8_matmul"):
        fn = getattr(tqmm, name)
        monkeypatch.setattr(tqmm, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    leaf = tq.quantize_weight(torch.randn(256, 64))
    for M in (1, 127, 128, 300):
        y = tqmm.quant_matmul(torch.randn(M, 64).bfloat16(), leaf)
        assert y.shape == (M, 256) and y.dtype == torch.bfloat16
    assert calls == ["qmm", "qmm", "w8a8_matmul", "w8a8_matmul"]


# -- K8 with the int8 stream ----------------------------------------------------

def _fused_cfg(qk_norm):
    return LLMConfig(
        model_id="test/fused-nano", vocab_size=512, hidden_size=512,
        intermediate_size=768, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, rope_scaling=None, tie_word_embeddings=False,
        qk_norm=qk_norm, bos_token_id=0, eos_token_id=1)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_fused_decode_int8_plain_matches_pallas(qk_norm, monkeypatch):
    """int8 tower, per-row cache indices with left padding, random cache;
    logits through the int8 head (plain K7)."""
    from desta25_audio_tpu.ops.core import rms_norm as j_rms
    from desta25_audio_tpu.ops.fused_decode import (
        fused_decode_layers as jax_fused,
    )
    monkeypatch.setenv("DESTA_FUSED_INTERPRET", "1")
    cfg = _fused_cfg(qk_norm)
    B, S, L, KVD = 3, 128, 2, 256
    jp = jq.quantize_llm_params(tree_cast(
        jllm.init_llm(jax.random.PRNGKey(5), cfg, dtype=jnp.float32),
        jnp.bfloat16))
    tp = bridge.llm_from_jax(jax.tree.map(np.asarray, jp), "cpu")
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
    assert got.shape == want.shape == (B, 1, cfg.vocab_size)
    # the bound of tests/test_fused_decode.py:77
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-2
    for new, ref, old in ((tcache.k, jcache.k, tk), (tcache.v, jcache.v, tv)):
        new, ref, old = _np(new), _np(ref), _np(old)
        rows = (slice(None), np.arange(B), ci)
        assert np.abs(new[rows] - ref[rows]).max() < 0.05
        keep = np.ones((L, B, S), bool)
        keep[rows] = False
        np.testing.assert_array_equal(new[keep], old[keep])


# -- the slice: nano int8 generate() against JAX's kernel path ------------------

def jax_tpu_dispatch(monkeypatch):
    """Route the JAX int8 LLM through its TPU dispatch on the CPU: K7 as
    ``_qmm_kernel`` in interpret mode below 128 rows, the W8A8 formula at
    128 and above, and the fused decode kernel in interpret mode.  Clears
    JAX's trace caches so no earlier CPU-dispatch trace is reused; counts
    the calls."""
    hits = {"qmm": 0, "w8a8": 0}

    def dispatch(x2, q, s, w8a8):
        M, K = x2.shape
        if M >= 128 and w8a8:
            hits["w8a8"] += 1
            return _jax_w8a8(x2, q, s)[1]
        hits["qmm"] += 1
        bn, bk = _pallas_blocks(K, q.shape[1])
        return _pallas_qmm(x2, q, s, bn, bk)

    monkeypatch.setattr(jq, "_qmm_dispatch", dispatch)
    monkeypatch.setenv("DESTA_FUSED_INTERPRET", "1")
    monkeypatch.setenv("DESTA_FUSED_DECODE", "1")
    jax.clear_caches()
    return hits


NANO = dict(llm_model_id="test/llama-nano128",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="bfloat16",
            llm_quant="int8")


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from desta25_audio_tpu_torch.audio.io import write_wav
    t = np.arange(16000) / 16000.0
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)
           * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("audio") / "tone.wav")
    write_wav(path, sig)
    return path


def test_nano_int8_generate_matches_jax_kernel_path(wav, monkeypatch):
    from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
    from desta25_audio_tpu import DeSTA25Config as JaxConfig
    hits = jax_tpu_dispatch(monkeypatch)
    try:
        jm = JaxModel(JaxConfig(**NANO), seed=0)
        cfg = DeSTA25Config(**NANO)
        tm = DeSTA25AudioModel(cfg, device="cpu", params=bridge.from_jax_params(
            jax.tree.map(np.asarray, jm.params), cfg, "cpu"))
        assert tq.is_quantized(tm.params["llm"]["layers"]["wqkv"])
        one = [{"role": "user", "content": "What is it? <|AUDIO|>",
                "audios": [{"audio": wav, "text": "a tone"}]}]
        two = [{"role": "user", "content": "Name <|AUDIO|> in one word.",
                "audios": [{"audio": wav, "text": "the same tone"}]}]
        for msgs in ([one], [one, two]):   # prefill M < 128, then M >= 128
            want = jm.generate(msgs, max_new_tokens=5, do_sample=False)
            _build.reset_launch_counts()
            got = tm.generate(msgs, max_new_tokens=5, do_sample=False)
            assert got.generated_ids == want.generated_ids
            assert got.text == want.text
            assert _build.launch_counts() == {}   # the CPU runs plain
        # the JAX side took both prefill branches and K7 at decode
        assert hits["w8a8"] > 0 and hits["qmm"] > 0
    finally:
        jax.clear_caches()


def test_model_quantizes_its_llm_in_place():
    cfg = DeSTA25Config(**{**NANO, "llm_quant": "none"})
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    want = tq.quantize_llm_params(model.params["llm"])
    embed = model.params["llm"]["embed"]
    model.apply_llm_quant()
    got = model.params["llm"]
    assert model.config.llm_quant == "int8"
    assert got["embed"] is embed
    assert [p for p, _ in _flat(got)] == [p for p, _ in _flat(want)]
    for (path, g), (_, w) in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w), path
    model.apply_llm_quant()                    # already int8: a no-op
    assert model.params["llm"]["lm_head"] is got["lm_head"]
    # init with llm_quant="int8" quantizes the same random draw
    q8 = DeSTA25AudioModel(DeSTA25Config(**NANO), device="cpu", seed=0)
    for (path, g), (_, w) in zip(_flat(q8.params["llm"]), _flat(got)):
        assert torch.equal(g, w), path
