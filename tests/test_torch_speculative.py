"""The port's speculative decoding against the JAX package on the CPU.

- ``ngram_propose`` equal to JAX's on random histories (short histories,
  rows without a match).
- The verify step's plain version against JAX ``fused_verify_layers`` in
  interpret mode, int8 and bf16 towers, 2 and 4 tokens per row, per-row
  cache indices.
- Greedy ``llm_generate_spec`` equal to the port's plain greedy loop and to
  JAX's spec loop (the nano config and seed of tests/test_speculative.py);
  tiny-temperature sampling equal to greedy.
- ``generate(speculative_k=4)`` equal to ``speculative_k=0`` on the audio and
  the text-only paths, and the request limits of the verify kernel: past
  them ``generate()`` decodes one token a step and keeps the reasons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.config import LLMConfig
from desta25_audio_tpu.generate import speculative as jspec
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops.core import tree_cast
from desta25_audio_tpu.ops.quant import quantize_llm_params as jquant
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.ckpt.bridge import llm_from_jax
from desta25_audio_tpu_torch.generate.decode import llm_generate
from desta25_audio_tpu_torch.generate.speculative import (
    llm_generate_spec,
    ngram_propose,
    spec_generate_supported,
)
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops.core import rms_norm as t_rms
from desta25_audio_tpu_torch.ops.fused_decode import (
    KVCache,
    fused_verify_layers,
)


def _bf16(a):
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- drafting -------------------------------------------------------------------

def test_ngram_propose_matches_jax():
    rng = np.random.default_rng(0)
    B, Th, k = 64, 24, 3
    hist = rng.integers(0, 4, size=(B, Th))          # small vocab: matches
    hist[:8] = np.arange(Th)[None, :] + 100 * np.arange(8)[:, None]  # none
    hlen = rng.integers(4, Th + 1, size=B)
    hlen[8:12] = [0, 1, 2, 3]                         # short histories
    want = jspec.ngram_propose(jnp.asarray(hist, jnp.int32),
                               jnp.asarray(hlen, jnp.int32), k)
    got = ngram_propose(torch.from_numpy(hist), torch.from_numpy(hlen), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the fixed cases of tests/test_speculative.py
    h = torch.tensor([[5, 7, 9, 5, 7, 11, 3, 5, 7, 0, 0, 0],
                      [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
                      [4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0]])
    assert ngram_propose(h, torch.tensor([9, 12, 5]), 3).tolist() == [
        [11, 3, 5], [12, 12, 12], [4, 4, 4]]
    h = torch.tensor([[5, 2, 3, 7, 1, 2, 3, 9, 5, 2, 3, 0]])
    assert ngram_propose(h, torch.tensor([11]), 2).tolist() == [[7, 1]]


# -- the verify step --------------------------------------------------------------

def _nano_cfg():
    """tests/test_speculative.py's config."""
    return LLMConfig(
        model_id="test/fused-nano", vocab_size=512, hidden_size=512,
        intermediate_size=768, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, rope_scaling=None, tie_word_embeddings=False,
        qk_norm=False, bos_token_id=0, eos_token_id=1)


def _towers(seed):
    """(jax tree, port tree) for the bf16 and the int8 tower."""
    cfg = _nano_cfg()
    jp = tree_cast(jllm.init_llm(jax.random.PRNGKey(seed), cfg,
                                 dtype=jnp.float32), jnp.bfloat16)
    out = {}
    for name, tree in (("bf16", jp), ("int8", jquant(jp))):
        out[name] = (tree, llm_from_jax(jax.tree.map(np.asarray, tree), "cpu"))
    return cfg, out


@pytest.fixture(scope="module")
def towers():
    return _towers(7)


@pytest.mark.parametrize("tower,kd", [("int8", 2), ("int8", 4), ("bf16", 4),
                                      ("bf16", 2)])
def test_verify_plain_matches_pallas(towers, tower, kd, monkeypatch):
    from desta25_audio_tpu.ops.fused_decode import (
        fused_verify_layers as jax_verify,
    )
    monkeypatch.setenv("DESTA_FUSED_INTERPRET", "1")
    cfg, trees = towers
    jp, tp = trees[tower]
    B, S, L, KVD = 3, 128, 2, 256
    rng = np.random.default_rng(kd)
    jk, tk = _bf16(rng.standard_normal((L, B, S, KVD)))
    jv, tv = _bf16(rng.standard_normal((L, B, S, KVD)))
    ci = np.array([5, 17, S - kd], np.int32)        # the last: block at S
    pad = np.array([0, 3, 9])
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        mask[b, pad[b]:] = 1
    pos = ((ci - pad)[:, None] + np.arange(kd)[None, :]).astype(np.int32)
    ids = rng.integers(2, 500, size=(B, kd))
    jh, jcache = jax_verify(jp, cfg, jp["embed"][jnp.asarray(ids)],
                            jnp.asarray(mask), jnp.asarray(pos),
                            jllm.KVCache(jk, jv), jnp.asarray(ci))
    want = _np(jllm._head_logits(jp, cfg, jllm.rms_norm(
        jp["norm"], jh, cfg.rms_norm_eps)))
    tcache = KVCache(tk.clone(), tv.clone())
    th, tcache = fused_verify_layers(
        tp, cfg, tllm.embed_tokens(tp, torch.from_numpy(ids)),
        torch.from_numpy(mask), torch.from_numpy(pos), tcache,
        torch.from_numpy(ci))
    got = _np(tllm.head_logits(tp, t_rms(tp["norm"], th, cfg.rms_norm_eps)))
    assert got.shape == want.shape == (B, kd, cfg.vocab_size)
    # the bound of tests/test_fused_decode.py:77
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-2
    # all kd rows written at ci..ci+kd-1, as the JAX kernel writes them
    new, ref, old = _np(tcache.k), _np(jcache.k), _np(tk)
    keep = np.ones((L, B, S), bool)
    for b in range(B):
        rows = slice(ci[b], ci[b] + kd)
        assert np.abs(new[:, b, rows] - ref[:, b, rows]).max() < 0.05
        keep[:, b, rows] = False
    np.testing.assert_array_equal(new[keep], old[keep])


# -- the loop ---------------------------------------------------------------------

@pytest.mark.parametrize("kd,eos", [(2, False), (4, True)])
def test_spec_greedy_equals_plain_and_jax(towers, kd, eos, monkeypatch):
    """tests/test_speculative.py:66-98 on the port: the same int8 nano
    params, prompt and budget; the spec ids equal the plain greedy loop's
    and JAX's spec loop's."""
    monkeypatch.setenv("DESTA_FUSED_DECODE", "1")
    monkeypatch.setenv("DESTA_FUSED_INTERPRET", "1")
    cfg, trees = towers
    jp, tp = trees["int8"]
    B, T, MAX_NEW = 2, 12, 10
    ids = np.random.default_rng(0).integers(2, 500, size=(B, T))
    eos_ids = (int(ids[0, 0]),) if eos else ()
    tids = torch.from_numpy(ids)
    emb = tllm.embed_tokens(tp, tids)
    amask = torch.ones(B, T, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    ref, ref_n = llm_generate(tp, cfg, emb, amask, gen,
                              max_new_tokens=MAX_NEW, eos_ids=eos_ids)
    got, got_n, steps, emitted = llm_generate_spec(
        tp, cfg, emb, amask, gen, max_new_tokens=MAX_NEW, eos_ids=eos_ids,
        speculative_k=kd, prompt_ids=tids,
        prompt_lens=torch.full((B,), T), return_stats=True)
    want, want_n = jspec.llm_generate_spec(
        jp, cfg, jp["embed"][jnp.asarray(ids)], jnp.ones((B, T), jnp.int32),
        max_new_tokens=MAX_NEW, eos_ids=eos_ids, pad_id=0,
        speculative_k=kd, prompt_ids=jnp.asarray(ids, jnp.int32),
        prompt_lens=jnp.full((B,), T, jnp.int32))
    assert got_n.tolist() == ref_n.tolist() == np.asarray(want_n).tolist()
    assert got.tolist() == ref.tolist() == np.asarray(want).tolist()
    assert emitted == int(got_n.sum()) - B      # tok0 comes from prefill
    assert 1 <= steps <= MAX_NEW - 1


def test_spec_sampled_tiny_temperature_equals_greedy(towers):
    cfg, trees = towers
    _, tp = trees["int8"]
    B, T = 2, 12
    ids = torch.from_numpy(np.random.default_rng(1).integers(2, 500, (B, T)))
    emb = tllm.embed_tokens(tp, ids)
    amask = torch.ones(B, T, dtype=torch.int32)
    kw = dict(max_new_tokens=10, speculative_k=4, prompt_ids=ids,
              prompt_lens=torch.full((B,), T))
    ref, _ = llm_generate_spec(tp, cfg, emb, amask,
                               torch.Generator().manual_seed(0), **kw)
    got, _ = llm_generate_spec(tp, cfg, emb, amask,
                               torch.Generator().manual_seed(11),
                               do_sample=True, temperature=1e-4, top_p=1.0,
                               **kw)
    assert torch.equal(got, ref)
    nuc, _ = llm_generate_spec(tp, cfg, emb, amask,
                               torch.Generator().manual_seed(2),
                               do_sample=True, temperature=0.8, top_p=0.9,
                               **kw)
    assert nuc.shape == (B, 10) and ((nuc >= 0) & (nuc < 512)).all()


def test_spec_accepts_several_tokens_a_step_on_repetitive_text():
    """tests/test_speculative.py:145-174: a cyclic context decodes in
    fewer verify steps than tokens."""
    cfg, trees = _towers(9)
    _, tp = trees["int8"]
    ids = torch.tensor([[3, 9, 3, 9, 3, 9, 3, 9]])
    out, n, steps, emitted = llm_generate_spec(
        tp, cfg, tllm.embed_tokens(tp, ids),
        torch.ones(1, 8, dtype=torch.int32), torch.Generator(),
        max_new_tokens=16, speculative_k=4, prompt_ids=ids,
        prompt_lens=torch.tensor([8]), return_stats=True)
    assert int(n[0]) == 16 and emitted == 15
    assert steps < 15, (steps, out.tolist())


# -- generate() ---------------------------------------------------------------------

NANO = dict(llm_model_id="test/llama-nano128",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="bfloat16")


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from desta25_audio_tpu_torch.audio.io import write_wav
    t = np.arange(12000) / 16000.0
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("audio") / "tone.wav")
    write_wav(path, sig)
    return path


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_generate_speculative_equals_plain(wav, quant):
    """tests/test_speculative.py:177-211 on the port, both towers."""
    model = DeSTA25AudioModel(DeSTA25Config(**NANO, llm_quant=quant),
                              device="cpu", seed=0)
    msgs = [{"role": "user", "content": "Describe: <|AUDIO|>",
             "audios": [{"audio": wav, "text": "a tone"}]}]
    tmsgs = [{"role": "user", "content": "hello hello hello hello"}]
    _build.reset_launch_counts()
    for m, n in ((msgs, 5), ([msgs, tmsgs], 6), (tmsgs, 6)):
        ref = model.generate(m, do_sample=False, max_new_tokens=n)
        got = model.generate(m, do_sample=False, max_new_tokens=n,
                             speculative_k=4)
        assert got.generated_ids == ref.generated_ids, (quant, m)
        t = model.last_timings
        assert t["spec_tokens"] >= t["decode_steps"] >= 1
    got_s = model.generate(msgs, do_sample=True, temperature=1e-4,
                           top_p=1.0, max_new_tokens=5, speculative_k=4)
    assert got_s.generated_ids == model.generate(
        msgs, do_sample=False, max_new_tokens=5).generated_ids
    assert _build.launch_counts() == {}        # the CPU runs plain versions


def test_spec_request_limits(wav):
    f32 = DeSTA25AudioModel(DeSTA25Config(**{**NANO, "dtype": "float32"}),
                            device="cpu", seed=0)
    msgs = [{"role": "user", "content": "hi"}]
    # a request the verify kernel cannot take decodes one token a step, as
    # the JAX package's _spec_eligible falls back, with the reasons kept
    plain = f32.generate(msgs, do_sample=False, max_new_tokens=3)
    assert f32.last_spec_fallback == []
    got = f32.generate(msgs, do_sample=False, max_new_tokens=3,
                       speculative_k=4)
    assert got.generated_ids == plain.generated_ids
    assert "spec_tokens" not in f32.last_timings
    assert any("bfloat16" in r for r in f32.last_spec_fallback)
    assert len(f32.generate(msgs, max_new_tokens=2, speculative_k=1)
               .generated_ids[0]) == 2                  # < 2: plain loop
    assert f32.last_spec_fallback == []
    model = DeSTA25AudioModel(DeSTA25Config(**NANO), device="cpu", seed=0)
    got = model.generate(msgs, do_sample=False, max_new_tokens=2,
                         speculative_k=9)
    assert got.generated_ids == model.generate(
        msgs, do_sample=False, max_new_tokens=2).generated_ids
    model.generate(msgs, do_sample=False, max_new_tokens=2, speculative_k=9)
    assert any("tokens per row" in r for r in model.last_spec_fallback)
    cfg, p = model.llm_cfg, model.params["llm"]
    assert spec_generate_supported(p, cfg, 2, 256, 4)
    assert not spec_generate_supported(p, cfg, 2, 256, 4, torch.float32)
    # B*Kd*H*S*4 <= 6 MB, as the JAX verify step
    assert not spec_generate_supported(p, cfg, 64, 1024, 8)
