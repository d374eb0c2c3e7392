"""The port's modules against their JAX counterparts on the CPU, in f32 at
nano sizes, on identical inputs made with numpy and identical weights
(the JAX init converted by ``ckpt/bridge.py``).

Tolerances: the two sides run the same f32 math in different summation
orders, so agreement is to f32 rounding grown through the stack (1e-4
relative to the output scale unless stated).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.config import DeSTA25Config as JConfig
from desta25_audio_tpu.config import llm_config_for as j_llm_cfg
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.config import llm_config_for as t_llm_cfg

NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32")


def _close(got, want, tol=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() / scale < tol, \
        np.abs(got - want).max() / scale


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_whisper_encoder_taps_match():
    from desta25_audio_tpu.models import whisper as jw
    from desta25_audio_tpu_torch.models import whisper as tw
    cfg = JConfig(**NANO)
    enc = cfg.encoder_config
    jp = jw.init_whisper_encoder(jax.random.PRNGKey(0), enc, jnp.float32)
    tp = bridge.whisper_encoder_from_jax(_np_tree(jp), "cpu")
    mel = np.random.default_rng(0).standard_normal(
        (2, enc.expected_mel_frames, enc.num_mel_bins)).astype(np.float32)
    taps_ids = cfg.target_layer_ids
    jf, jt = jw.whisper_encoder_apply(jp, jnp.asarray(mel), enc, taps_ids)
    tf, tt = tw.whisper_encoder_apply(tp, torch.from_numpy(mel), enc,
                                      taps_ids)
    _close(tt, jt)
    _close(tf, jf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qformer_connector_matches(dtype):
    """f32 connector params; taps in f32 (tol 1e-4) or bf16 (the flagship
    mix: bf16 activations against f32 weights, f32 products; tol 2e-2 for
    bf16 rounding of the activations)."""
    from desta25_audio_tpu.models import qformer as jq
    from desta25_audio_tpu_torch.models import qformer as tq
    cfg = JConfig(**NANO)
    jp = jq.init_qformer_connector(jax.random.PRNGKey(1), cfg, jnp.float32)
    # a non-zero tap fusion, so the softmax weights are exercised
    jp["layer_weights"] = jnp.asarray(np.random.default_rng(3).standard_normal(
        jp["layer_weights"].shape), jnp.float32)
    tp = bridge.connector_from_jax(_np_tree(jp), "cpu")
    d = cfg.encoder_config.d_model
    taps = np.random.default_rng(1).standard_normal(
        (4, 2, 150, d)).astype(np.float32)
    jt = jnp.asarray(taps).astype(jnp.dtype(dtype))
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = jq.qformer_connector_apply(jp, jt, cfg)
    got = tq.qformer_connector_apply(tp, tt, cfg)
    assert got.dtype == tt.dtype
    _close(got, want.astype(jnp.float32),
           tol=1e-4 if dtype == "float32" else 2e-2)


def _tone(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return ((0.5 * np.sin(2 * np.pi * 440 * t) * (np.sin(6 * t) > 0)
             + 0.05 * rng.standard_normal(n))).astype(np.float32)


def test_log_mel_matches_jnp():
    from desta25_audio_tpu.audio import mel as jm
    from desta25_audio_tpu_torch.audio import mel as tm
    audio = np.stack([_tone(48000), _tone(48000, 1) * (np.arange(48000) < 20000)]
                     ).astype(np.float32)
    ja = jm.pad_or_trim(jnp.asarray(audio))
    ta = tm.pad_or_trim(torch.from_numpy(audio))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for layout in ("btm", "bmt"):
        want = np.asarray(jm.log_mel(ja, 128, layout=layout))
        got = tm.log_mel(ta, 128, layout=layout).numpy()
        # normalised log-mel units; f32 DFT products in another order
        assert np.abs(got - want).max() < 2e-3
        assert np.abs(got - want).mean() < 1e-5


def test_log_mel_golden_fixtures():
    """The real-clip sketches of tests/test_mel_golden.py (HF
    WhisperFeatureExtractor, f64) against the port's f32 frontend."""
    audio_dir = os.environ.get("DESTA_REFERENCE_AUDIO",
                               "/root/reference/assets/audios")
    if not os.path.isdir(audio_dir):
        pytest.skip("reference audio assets not present on this machine")
    from desta25_audio_tpu_torch.audio.io import AudioSegment
    from desta25_audio_tpu_torch.audio.mel import log_mel, pad_or_trim
    from tests.test_mel_golden import FIXTURE, _sketch
    ref = np.load(FIXTURE)
    for key in sorted({k.split("/")[0] for k in ref.files}):
        name = key[::-1].replace("_", ".", 1)[::-1]
        path = os.path.join(audio_dir, name)
        if not path.lower().endswith(".wav") or not os.path.exists(path):
            continue
        seg = AudioSegment.from_file(path, target_sr=16000)
        x = pad_or_trim(torch.from_numpy(seg.samples)[None])
        mel = log_mel(x, 128, layout="bmt")[0].numpy()
        want = ref[f"{key}/sketch"]
        # f32 against the f64 reference: near-floor bins move (mel.py notes
        # up to ~0.1 there); the sketch and moments stay close
        assert np.abs(_sketch(mel) - want).max() / np.abs(want).max() < 1e-2
        assert abs(float(mel.mean()) - float(ref[f"{key}/mean"])) < 1e-3


def test_apply_splice_matches():
    from desta25_audio_tpu.models import splice as js
    from desta25_audio_tpu_torch.models import splice as ts
    rng = np.random.default_rng(4)
    entries = [js.SpliceEntry(0, 2, 0, 3, 2), js.SpliceEntry(1, 0, 1, 3, 1)]
    kind, aidx, pos = js.build_splice_maps(2, 8, entries)
    text = rng.standard_normal((2, 8, 4)).astype(np.float32)
    audio = rng.standard_normal((2, 3, 4)).astype(np.float32)
    trans = rng.standard_normal((2, 8, 4)).astype(np.float32)
    want = js.apply_splice(*(jnp.asarray(a) for a in (text, audio, trans,
                                                      kind, aidx, pos)))
    got = ts.apply_splice(*(torch.from_numpy(a) for a in (text, audio, trans,
                                                         kind, aidx, pos)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rope_tables_match():
    from desta25_audio_tpu.ops import rope as jr
    from desta25_audio_tpu_torch.ops import rope as tr
    cfg = j_llm_cfg("meta-llama/Llama-3.1-8B-Instruct")
    pos = np.array([[0, 1, 7, 4000], [9, 8191, 8192, 100000]])
    jc, js_ = jr.llm_rope_cos_sin(cfg, jnp.asarray(pos))
    tc, ts_ = tr.llm_rope_cos_sin(t_llm_cfg(cfg.model_id),
                                  torch.from_numpy(pos))
    # f32 trig of large angles: both sides round the angle in f32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-4)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), atol=2e-4)


def _llm_pair(model_id, seed=0):
    from desta25_audio_tpu.models import llm as jl
    cfg = j_llm_cfg(model_id)
    jp = jl.init_llm(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    return cfg, jp, bridge.llm_from_jax(_np_tree(jp), "cpu")


@pytest.mark.parametrize("model_id", ["test/llama-nano", "test/qwen3-nano"])
def test_llm_prefill_and_decode_match(model_id):
    """Prefill logits (no cache, and into a cache with left padding), then
    one cached decode step (the fused-decode dispatch, plain on the CPU)
    against the JAX XLA path."""
    from desta25_audio_tpu.models import llm as jl
    from desta25_audio_tpu_torch.models import llm as tl
    cfg, jp, tp = _llm_pair(model_id)
    tcfg = t_llm_cfg(model_id)
    rng = np.random.default_rng(5)
    B, T, S = 2, 12, 128
    ids = rng.integers(3, cfg.vocab_size, size=(B, T))
    am = np.ones((B, T), np.int32)
    am[1, :3] = 0                                   # left padding
    want, _, _ = jl.llm_apply(jp, cfg, input_ids=jnp.asarray(ids),
                              attention_mask=jnp.asarray(am))
    got, _ = tl.llm_apply(tp, tcfg, input_ids=torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(am))
    _close(got, want)

    full = np.zeros((B, S), np.int32)
    full[:, :T] = am
    pos = np.maximum(np.cumsum(am, 1) - 1, 0)
    jcache = jl.init_kv_cache(cfg, B, S, dtype=jnp.float32)
    tcache = tl.init_kv_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    want, jcache, _ = jl.llm_apply(
        jp, cfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(full),
        positions=jnp.asarray(pos), cache=jcache, cache_index=0)
    got, tcache = tl.llm_apply(
        tp, tcfg, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(full),
        positions=torch.from_numpy(pos), cache=tcache, cache_index=0)
    _close(got, want)
    _close(tcache.k, jcache.k)

    full[:, T] = 1
    nxt = rng.integers(3, cfg.vocab_size, size=(B, 1))
    step_pos = pos[:, -1:] + 1
    want, jcache, _ = jl.llm_apply(
        jp, cfg, input_ids=jnp.asarray(nxt), attention_mask=jnp.asarray(full),
        positions=jnp.asarray(step_pos), cache=jcache, cache_index=T)
    got, tcache = tl.llm_apply(
        tp, tcfg, input_ids=torch.from_numpy(nxt),
        attention_mask=torch.from_numpy(full),
        positions=torch.from_numpy(step_pos), cache=tcache, cache_index=T)
    _close(got, want)
    _close(tcache.v, jcache.v)


def test_bridge_carries_the_whisper_decoder():
    """Every leaf of the JAX model's Whisper decoder reaches the port: the
    linears as [L, out, in], the embeddings, norms and biases as they are;
    the port's own init draws a tree of the same structure and shapes."""
    from desta25_audio_tpu import DeSTA25AudioModel as JModel
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    jm = JModel(JConfig(**NANO), seed=0)
    cfg = DeSTA25Config(**NANO)
    tree = bridge.from_jax_params(_np_tree(jm.params), cfg, "cpu")
    jdec = _np_tree(jm.params["whisper"]["decoder"])
    tdec = tree["whisper"]["decoder"]
    jflat = jax.tree_util.tree_flatten_with_path(jdec)[0]
    assert len(jflat) == len(jax.tree.leaves(tdec)) == 28
    for path, want in jflat:
        keys = [p.key for p in path]
        got = tdec
        for k in keys:
            got = got[k]
        if keys[-1] == "w":       # [L, in, out] -> [L, out, in]
            want = np.swapaxes(want, -1, -2)
        np.testing.assert_array_equal(got.numpy(), want)
    from desta25_audio_tpu_torch.models.whisper import init_whisper
    own = DeSTA25AudioModel(cfg, device="cpu", seed=0).params["whisper"]
    drawn = init_whisper(cfg.encoder_config, torch.float32, "cpu",
                         torch.Generator().manual_seed(0))
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(own) == shapes(drawn) == shapes(tree["whisper"])
