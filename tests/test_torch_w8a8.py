"""The port's int8 (W8A8) Whisper encoder against the JAX package on the CPU.

- The plain versions of K5 ``qkv_w8a8``, K6 ``proj_w8a8`` and K4
  ``encoder_ffn_w8a8`` against the Pallas kernels run in interpret mode, on
  the same int8 weights and the same bf16 inputs made with numpy.
- ``quantize_weight`` / ``quantize_encoder_params`` against the JAX ones,
  the bridge of a JAX-quantized encoder, and the row quantiser: identical.
- The slice as a whole: the port's int8 ``whisper_encoder_apply`` against
  the JAX one on its kernel path (interpret mode) at both attention arms.
- The port's dispatch: a nano ``generate()`` with ``encoder_quant="int8"``
  and ``apply_inference_encoder_quant()``.

Nothing here needs a file outside the repository.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.config import WhisperConfig as JWhisperConfig
from desta25_audio_tpu.ops import quant as jq
from desta25_audio_tpu.ops.enc_ffn import _quant_rows as jax_quant_rows
from desta25_audio_tpu.ops.enc_ffn import encoder_ffn_w8a8 as jax_ffn_w8a8
from desta25_audio_tpu.ops.w8a8_proj import proj_w8a8 as jax_proj
from desta25_audio_tpu.ops.w8a8_proj import qkv_w8a8 as jax_qkv
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.config import WhisperConfig as TWhisperConfig
from desta25_audio_tpu_torch.models import whisper as tw
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops import quant as tq
from desta25_audio_tpu_torch.ops.enc_ffn import encoder_ffn_w8a8
from desta25_audio_tpu_torch.ops.w8a8_proj import proj_w8a8, qkv_w8a8


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


def _jax_leaf(rng, d, n, bias=True, mult=1.0):
    """A JAX int8 leaf {"q" [d, n], "s" [n], "b"? bf16 [n]} from bf16
    weights (times ``mult``), as quantize_encoder_params makes it."""
    w, _ = _bf16(0.05 * rng.standard_normal((d, n)) * mult)
    leaf = dict(jq.quantize_weight(w))
    if bias:
        leaf["b"] = _bf16(0.05 * rng.standard_normal(n))[0]
    return leaf


def _port_leaf(jleaf):
    return bridge._linear(jax.tree.map(np.asarray, jleaf), "cpu")


# -- the row quantiser --------------------------------------------------------

@pytest.mark.parametrize("src", ["bf16", "f32"])
def test_quant_rows_matches_jax(src):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 256)) * rng.uniform(0.01, 30, (40, 1))
    a[3] = 0.0                                   # the 1e-8 floor
    a = a.astype(np.float32)
    if src == "bf16":
        a = np.array(_np(_bf16(a)[0]))
    jqv, jsv = jax_quant_rows(jnp.asarray(a))
    tqv, tsv = tq.quant_rows(torch.from_numpy(a))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))


# -- K5, K6, K4: plain versions against Pallas interpret mode ------------------

SHAPES = [(1, 150, 128), (2, 150, 256), (2, 64, 128)]


@pytest.mark.parametrize("B,T,D", SHAPES)
def test_qkv_w8a8_plain_matches_pallas(B, T, D):
    rng = np.random.default_rng(1)
    jx, tx = _bf16(rng.standard_normal((B, T, D)))
    jl = [_jax_leaf(rng, D, D, bias=k != "k") for k in "qkv"]
    want = jax_qkv(jx, *jl, 64, True)
    got = qkv_w8a8(tx, *[_port_leaf(l) for l in jl])
    # the same row quantisation and exact integer products on both sides:
    # only the f32 epilogue's rounding and the bf16 output can differ, so
    # 1e-2 of the output scale is ample
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g, w) < 1e-2


@pytest.mark.parametrize("B,T,D", SHAPES)
def test_proj_w8a8_plain_matches_pallas(B, T, D):
    rng = np.random.default_rng(2)
    jx, tx = _bf16(rng.standard_normal((B, T, D)))
    jl = _jax_leaf(rng, D, D, bias=D != 128)     # with and without a bias
    want = jax_proj(jx, jl, 64, True)
    got = proj_w8a8(tx, _port_leaf(jl))
    assert _rel(got, want) < 1e-2                # as for K5


@pytest.mark.parametrize("B,T,D,F", [
    (1, 150, 128, 1280), (2, 150, 256, 1280),
    (2, 64, 128, 2560),   # two GELU chunks, each with its own row scale
])
def test_encoder_ffn_w8a8_plain_matches_pallas(B, T, D, F):
    # JAX's ffn_w8a8_supported needs F % 1280 == 0
    rng = np.random.default_rng(3)
    jx, tx = _bf16(rng.standard_normal((B, T, D)))
    # the GELU chunks differ in scale by 64x (fc2 makes up for it), so a
    # quantisation over the whole hidden row instead of per 1280-column
    # chunk would lose the second chunk
    mult = np.where(np.arange(F) >= 1280, 1 / 64, 1.0)
    l1, l2 = (_jax_leaf(rng, D, F, mult=mult[None, :]),
              _jax_leaf(rng, F, D, mult=1 / mult[:, None]))
    want = jax_ffn_w8a8(jx, l1["q"], l1["s"], l1["b"], l2["q"], l2["s"],
                        l2["b"], 64, True)
    p1, p2 = _port_leaf(l1), _port_leaf(l2)
    got = encoder_ffn_w8a8(tx, p1["q"], p1["s"], p1["b"], p2["q"], p2["s"],
                           p2["b"])
    # the Pallas erf is A&S 7.1.26 (|err| <= 1.5e-7), the port's exact: a
    # GELU value on a rounding boundary can quantize one int8 step apart,
    # so 2e-2 of the output scale
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 2e-2


# -- weight quantisation and the bridge ----------------------------------------

@pytest.mark.parametrize("shape", [(256, 384), (3, 128, 256)])
def test_quantize_weight_matches_jax(shape):
    jw, tw_ = _bf16(0.05 * np.random.default_rng(4).standard_normal(shape))
    want = (jax.vmap(jq.quantize_weight)(jw) if len(shape) == 3
            else jq.quantize_weight(jw))
    got = tq.quantize_weight(tw_.transpose(-1, -2))   # the port's [out, in]
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].transpose(-1, -2).numpy(),
                                  np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert tq.is_quantized(got) and not tq.is_quantized({"w": tw_})
    np.testing.assert_array_equal(
        _np(tq.dequantize_weight(got)).swapaxes(-1, -2),
        _np(jq.dequantize_weight(want) if len(shape) == 2
            else jax.vmap(jq.dequantize_weight)(want)))


def _small_whisper(layers=2):
    kw = dict(model_id="test/whisper-w8a8", num_mel_bins=80, d_model=128,
              encoder_layers=layers, encoder_attention_heads=2,
              encoder_ffn_dim=1280, decoder_layers=1,
              decoder_attention_heads=2, decoder_ffn_dim=128, vocab_size=64,
              max_source_positions=512, max_target_positions=16)
    return JWhisperConfig(**kw), TWhisperConfig(**kw)


def _jax_encoder(cfg, seed=0):
    from desta25_audio_tpu.models import whisper as jw
    return jw.init_whisper_encoder(jax.random.PRNGKey(seed), cfg,
                                   jnp.bfloat16)


@pytest.mark.parametrize("mode", ["dual", "int8", "none"])
def test_quantize_encoder_params_matches_jax(mode):
    jcfg, _ = _small_whisper(layers=2)
    jenc = _jax_encoder(jcfg)
    want = bridge.whisper_encoder_from_jax(
        jax.tree.map(np.asarray, jq.quantize_encoder_params(
            jenc, attention=mode)), "cpu")
    plain = bridge.whisper_encoder_from_jax(jax.tree.map(np.asarray, jenc),
                                            "cpu")
    got = tq.quantize_encoder_params(plain, attention=mode)
    lay, wlay = got["layers"], want["layers"]
    for name in ("fc1", "fc2"):
        assert set(lay[name]) == {"q", "s", "b"}
    for name in ("q", "k", "v", "o"):
        leaf = lay["attn"][name]
        expect = {"none": {"w"}, "int8": {"q", "s"},
                  "dual": {"w", "q", "s"}}[mode] | (
                      set() if name == "k" else {"b"})
        assert set(leaf) == expect
        if "w" in leaf:       # the dual (or untouched) bf16 weight is kept
            assert leaf["w"] is plain["layers"]["attn"][name]["w"]
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)]
    for (path, g), (_, w) in zip(flat(got), flat(want)):
        assert g.dtype == w.dtype, path
        assert torch.equal(g, w), path


def test_bridge_carries_a_jax_quantized_encoder():
    jcfg, _ = _small_whisper(layers=2)
    jenc = jq.quantize_encoder_params(_jax_encoder(jcfg))   # dual
    got = bridge.whisper_encoder_from_jax(jax.tree.map(np.asarray, jenc),
                                          "cpu")
    for src, leaf in ((jenc["layers"]["attn"]["q"], got["layers"]["attn"]["q"]),
                      (jenc["layers"]["fc2"], got["layers"]["fc2"])):
        assert leaf["q"].dtype == torch.int8
        assert leaf["s"].dtype == torch.float32
        np.testing.assert_array_equal(
            leaf["q"].numpy(), np.swapaxes(np.asarray(src["q"]), -1, -2))
        np.testing.assert_array_equal(leaf["s"].numpy(), np.asarray(src["s"]))
        np.testing.assert_array_equal(_np(leaf["b"]), _np(src["b"]))
    assert got["layers"]["attn"]["q"]["w"].shape == (2, 128, 128)
    assert "w" not in got["layers"]["fc1"]
    assert "b" not in got["layers"]["attn"]["k"]


# -- the slice: the int8 encoder against JAX's kernel path --------------------

def _jax_kernels_in_interpret_mode(monkeypatch):
    """Route the JAX encoder through its Pallas kernels, in interpret mode
    on the CPU (as tests/test_w8a8_proj.py does); counts their calls."""
    from desta25_audio_tpu.models import whisper as jw
    from desta25_audio_tpu.ops import enc_attention as ea
    from desta25_audio_tpu.ops import enc_ffn as ef
    from desta25_audio_tpu.ops import w8a8_proj as wp
    hits = {"qkv": 0, "o": 0, "attn": 0, "ffn": 0}
    o_qkv, o_one, o_attn, o_ffn = (wp.qkv_w8a8, wp.proj_w8a8,
                                   ea.packed_encoder_attention,
                                   ef.encoder_ffn_w8a8)

    def qkv(x, lq, lk, lv, block_m=512, interpret=False):
        hits["qkv"] += 1
        return o_qkv(x, lq, lk, lv, block_m, True)

    def one(x, leaf, block_m=512, interpret=False):
        hits["o"] += 1
        return o_one(x, leaf, block_m, True)

    def attn(q, k, v, h, block_q=512, interpret=False):
        hits["attn"] += 1
        return o_attn(q, k, v, h, block_q=block_q, interpret=True)

    def ffn(x, q1, s1, b1, q2, s2, b2, block_m=256, interpret=False):
        hits["ffn"] += 1
        return o_ffn(x, q1, s1, b1, q2, s2, b2, block_m, True)

    monkeypatch.setattr(jw, "_packed_attn_enabled", lambda: True)
    monkeypatch.setattr(wp, "qkv_w8a8", qkv)
    monkeypatch.setattr(wp, "proj_w8a8", one)
    monkeypatch.setattr(ea, "packed_encoder_attention", attn)
    monkeypatch.setattr(ef, "encoder_ffn_w8a8", ffn)
    return hits


@pytest.mark.parametrize("B,mode,int8_arm", [
    (1, "dual", True),     # B <= 2: K5 -> K2 -> K6
    (3, "dual", False),    # B > 2: bf16 linear -> K2 -> bf16 linear
    (3, "int8", True),     # no bf16 w: the int8 arm at any batch
])
def test_int8_encoder_matches_jax(B, mode, int8_arm, monkeypatch):
    from desta25_audio_tpu.models import whisper as jw
    monkeypatch.delenv("DESTA_ENC_ATTN_INT8_MAXB", raising=False)
    monkeypatch.setattr(tw, "INT8_ATTN_MAXB", 2)       # the JAX default
    hits = _jax_kernels_in_interpret_mode(monkeypatch)
    jcfg, tcfg = _small_whisper(layers=2)
    jenc = jq.quantize_encoder_params(_jax_encoder(jcfg, seed=1),
                                      attention=mode)
    tenc = bridge.whisper_encoder_from_jax(jax.tree.map(np.asarray, jenc),
                                           "cpu")
    mel = np.random.default_rng(5).standard_normal(
        (B, jcfg.expected_mel_frames, jcfg.num_mel_bins))
    jmel, tmel = _bf16(mel)
    jf, jt = jax.jit(lambda p, m: jw.whisper_encoder_apply(
        p, m, jcfg, (0, 1)))(jenc, jmel)
    # the JAX package took the arm under test, through its kernels
    assert hits["ffn"] == 1 and hits["attn"] == 1
    assert hits["qkv"] == hits["o"] == int(int8_arm)
    tf_, tt = tw.whisper_encoder_apply(tenc, tmel, tcfg, (0, 1))
    assert tw.int8_attention(tenc["layers"]["attn"], B) == int8_arm
    # bf16 activations through int8 products: a value on a rounding
    # boundary (the A&S vs exact erf, the conv stem's summation order) can
    # quantize one int8 step apart, and bf16 rounds the residual stream:
    # 2e-2 of the output scale, the bound of the K4 test
    assert _rel(tt, jt) < 2e-2
    assert _rel(tf_, jf) < 2e-2


# -- the port's dispatch --------------------------------------------------------

@pytest.mark.parametrize("mode,batch,maxb,want", [
    ("dual", 1, 2, True), ("dual", 2, 2, True),
    ("dual", 3, 2, False), ("dual", 1, 0, False),
    ("int8", 3, 2, True), ("none", 1, 2, False),
])
def test_attention_arm_follows_the_jax_rule(mode, batch, maxb, want,
                                            monkeypatch):
    monkeypatch.setattr(tw, "INT8_ATTN_MAXB", maxb)
    w = torch.zeros(2, 128, 128, dtype=torch.bfloat16)
    enc = {"layers": {"attn": {k: {"w": w} for k in "qkvo"},
                      "fc1": {"w": w}, "fc2": {"w": w}}}
    attn = tq.quantize_encoder_params(enc, attention=mode)["layers"]["attn"]
    assert tw.int8_attention(attn, batch) is want


NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from desta25_audio_tpu_torch.audio.io import write_wav
    t = np.arange(16000) / 16000.0
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)
           * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("audio") / "tone.wav")
    write_wav(path, sig)
    return path


@pytest.mark.parametrize("n_conv,int8_arm", [(1, True), (3, False)])
def test_nano_generate_takes_the_int8_encoder(wav, n_conv, int8_arm,
                                              monkeypatch):
    monkeypatch.setattr(tw, "INT8_ATTN_MAXB", 2)
    # no encoder kernel takes the nano shapes (150 frames, Dh 32, F 128), so
    # the kernels' predicates are forced true here, as the JAX tests force
    # _packed_attn_enabled: the dispatch below them is what is under test
    monkeypatch.setattr(tw, "ENC_KERNEL_MIN_T", 0)
    for pred in ("enc_attention_supported", "w8a8_proj_supported",
                 "enc_ffn_supported", "enc_ffn_w8a8_supported"):
        monkeypatch.setattr(tw, pred, lambda *a: True)
    model = DeSTA25AudioModel(DeSTA25Config(**NANO, encoder_quant="int8"),
                              device="cpu", seed=0)
    fc1 = model.params["whisper"]["encoder"]["layers"]["fc1"]
    assert set(fc1) == {"q", "s", "b"}
    calls = {}

    def spy(name):
        fn = getattr(tw, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    for name in ("qkv_w8a8", "proj_w8a8", "encoder_ffn_w8a8",
                 "encoder_ffn"):
        monkeypatch.setattr(tw, name, spy(name))
    conv = [{"role": "user", "content": "What is this? <|AUDIO|>",
             "audios": [{"audio": wav, "text": "a tone"}]}]
    _build.reset_launch_counts()
    out = model.generate([conv] * n_conv, do_sample=False, max_new_tokens=4)
    ids = np.asarray(out.generated_ids)
    assert ids.shape == (n_conv, 4)
    assert ((ids >= 0) & (ids < model.llm_cfg.vocab_size)).all()
    L = model.enc_cfg.encoder_layers
    assert calls.get("encoder_ffn_w8a8") == L and "encoder_ffn" not in calls
    n = L if int8_arm else None
    assert calls.get("qkv_w8a8") == n and calls.get("proj_w8a8") == n
    assert _build.launch_counts() == {}      # the CPU runs plain versions


@pytest.mark.parametrize("quant,quantized_after", [
    ("none", False), ("auto", True), ("int8", True)])
def test_apply_inference_encoder_quant(quant, quantized_after):
    cfg = DeSTA25Config(**NANO, encoder_quant=quant)
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    before = model.params["whisper"]["encoder"]
    # direct construction resolves "auto" to none, as in the JAX package
    assert ("q" in before["layers"]["fc1"]) == (quant == "int8")
    model.apply_inference_encoder_quant()
    after = model.params["whisper"]["encoder"]
    assert ("q" in after["layers"]["fc1"]) == quantized_after
    if quant != "auto":
        assert after is before    # no-op: "none", or already int8 leaves
    else:
        assert set(after["layers"]["attn"]["q"]) == {"w", "q", "s", "b"}
        model.apply_inference_encoder_quant()
        assert model.params["whisper"]["encoder"] is after
