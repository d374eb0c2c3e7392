"""The port's continuous-batching engine (``serve/engine.py``) on the CPU at
nano scale (f32), on the WAVs of tests/test_serving.py, with the JAX
package's params carried across by the bridge.

- Against the JAX engine: greedy ``results()`` (tokens, finish_reason,
  truncated, prompt_tokens, text) identical for three audio requests through
  two slots with pipelining on and off, an audio request beside a text-only
  one, the ORCA nano model of ``test_engine_orca_deep_injection_matches_
  generate`` and a burst that spans several context buckets.  Each JAX
  engine runs once for the module.
- The cases of tests/test_serving.py that hold the engine against the
  one-shot ``generate()``, ported by name against the port's own
  ``generate()`` (the non-speculative ones).
- The engine's fused decode path (the kept ``DecodeGraph`` over the plain
  K8-int8 and K8i on a bf16 nano tower with 128-wide heads): ticks of 1
  and 3 steps, pipelined and sequential, ``submit`` and ``submit_many``
  give the same greedy ids, ORCA's text-only slot runs with ``on`` = 0.
- The repair of ``models/llm.py`` (a per-row cache write past the end,
  clamped as JAX's ``dynamic_update_slice`` clamps, against JAX
  ``llm_apply``), and ``sample_token_dynamic`` (greedy rows the exact
  argmax, sampled rows in their nucleus and reproducible for a seed).

Speculative ticks: tests/test_torch_serving_spec.py; the engine under a
mesh: tests/test_torch_serving_mesh.py; HTTP: tests/test_torch_http.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.config import LLMConfig as JLLMConfig
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.serve.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt.bridge import from_jax_params, llm_from_jax
from desta25_audio_tpu_torch.config import LLMConfig as TLLMConfig
from desta25_audio_tpu_torch.generate.decode import sample_token_dynamic
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine

NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", prompt_size=8,
            qformer_num_hidden_layers=2, dtype="float32")
ORCA_NANO = dict(llm_model_id="test/llama-nano",
                 encoder_model_id="test/whisper-nano",
                 connector_mode="orca_hybrid", qformer_num_hidden_layers=2,
                 orca_global_num_tokens=4, orca_local_downsample=4,
                 orca_local_kernel_size=5, orca_audio_position_scale=2.5,
                 dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many tiny eager ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(kw, seed):
    jm = JaxModel(JaxConfig(**kw), seed=seed)
    cfg = DeSTA25Config(**kw)
    params = from_jax_params(jax.tree.map(np.asarray, jm.params), cfg, "cpu")
    return jm, DeSTA25AudioModel(cfg, device="cpu", params=params)


@pytest.fixture(scope="module")
def models():
    """(the JAX nano model of tests/test_serving.py, the port's on the same
    weights)."""
    return _pair(NANO, seed=0)


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("srv")
    paths = []
    for i in range(3):
        t = np.arange(12000) / 16000.0
        sig = (0.5 * np.sin(2 * np.pi * (300 + 80 * i) * t)
               * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
        p = str(d / f"w{i}.wav")
        write_wav(p, sig)
        paths.append(p)
    return paths


def _msgs(path, i):
    return [{"role": "user",
             "content": f"Describe sound number {i}: <|AUDIO|>",
             "audios": [{"audio": path, "text": f"tone {i}"}]}]


def _bucket_msgs(wavs):
    return [[{"role": "user",
              "content": "word " * (2 + 20 * i) + f"describe {i}: <|AUDIO|>",
              "audios": [{"audio": p, "text": f"tone {i}"}]}]
            for i, p in enumerate(wavs)]


TEXT = [{"role": "user", "content": "Say hello."}]


# -- against the JAX engine ---------------------------------------------------

# case -> (model kind, engine arguments, requests as (messages, submit kw))
def _cases(wavs):
    three = [(_msgs(p, i), {}) for i, p in enumerate(wavs)]
    return {
        "pipelined": ("nano", dict(n_slots=2, max_ctx=128, max_new_tokens=6,
                                   ctx_bucket=128), three),
        "sequential": ("nano", dict(n_slots=2, max_ctx=128, max_new_tokens=6,
                                    ctx_bucket=128, pipeline_ticks=False),
                       three),
        "audio_and_text": ("nano", dict(n_slots=2, max_ctx=128,
                                        max_new_tokens=6, ctx_bucket=128),
                           [(TEXT, {}), (_msgs(wavs[0], 0), {})]),
        "orca": ("orca", dict(n_slots=2, max_ctx=128, max_new_tokens=6,
                              ctx_bucket=128), three),
        "mixed_buckets": ("nano", dict(n_slots=4, max_ctx=320,
                                       max_new_tokens=5, ctx_bucket=32,
                                       steps_per_tick=3),
                          [(m, {}) for m in _bucket_msgs(wavs)]),
    }


def _drive(engine_cls, model, kw, requests):
    eng = engine_cls(model, **kw)
    rids = [eng.submit(m, **skw) for m, skw in requests]
    eng.run_until_done()
    res = eng.results()
    return [res[r] for r in rids], eng


@pytest.fixture(scope="module")
def orca_models():
    return _pair(ORCA_NANO, seed=1)


@pytest.fixture(scope="module")
def jax_results(models, orca_models, wavs):
    """Each case's JAX engine results, run once for the module."""
    done = {}

    def get(case):
        if case not in done:
            kind, kw, reqs = _cases(wavs)[case]
            jm = (models if kind == "nano" else orca_models)[0]
            done[case] = _drive(JaxEngine, jm, kw, reqs)[0]
        return done[case]

    return get


@pytest.mark.parametrize("case", ["pipelined", "sequential",
                                  "audio_and_text", "orca",
                                  "mixed_buckets"])
def test_engine_greedy_results_match_jax(models, orca_models, wavs,
                                         jax_results, case):
    kind, kw, reqs = _cases(wavs)[case]
    tm = (models if kind == "nano" else orca_models)[1]
    got, eng = _drive(ContinuousBatchingEngine, tm, kw, reqs)
    want = jax_results(case)
    assert got == want
    if case == "orca":
        assert eng._inject_len > 0 and eng.graph is None
    if case == "mixed_buckets":
        assert len({len(r["tokens"]) for r in got}) >= 1
        assert eng.n_slots == 4


# -- the cases of tests/test_serving.py against the port's generate() --------

def test_engine_cache_length_is_128_multiple(model):
    for max_ctx, max_new in ((256, 48), (128, 10), (100, 28)):
        eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=max_ctx,
                                       max_new_tokens=max_new, ctx_bucket=64)
        assert eng.t_max % 128 == 0 and eng.t_max >= max_ctx + max_new
        assert eng.cache.k.shape[2] == eng.t_max
        assert tuple(eng._mask.shape) == (2, eng.t_max)


def _one_shot(model, msgs, new):
    return model.generate(msgs, max_new_tokens=new, do_sample=False).text[0]


def test_engine_matches_one_shot_generate(model, wavs):
    expected = {i: _one_shot(model, _msgs(p, i), 6)
                for i, p in enumerate(wavs)}
    eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                   max_new_tokens=6, ctx_bucket=128)
    rids = {i: eng.submit(_msgs(p, i)) for i, p in enumerate(wavs)}
    results = eng.run_until_done()
    assert set(results) == set(rids.values())
    for i, rid in rids.items():
        assert results[rid] == expected[i]


def test_engine_text_only_and_mixed_batches(model, wavs):
    expected_text = _one_shot(model, TEXT, 6)
    expected_audio = _one_shot(model, _msgs(wavs[0], 0), 6)
    eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                   max_new_tokens=6, ctx_bucket=128)
    rid_t = eng.submit(TEXT)
    rid_a = eng.submit(_msgs(wavs[0], 0))
    results = eng.run_until_done()
    assert results[rid_t] == expected_text
    assert results[rid_a] == expected_audio


def test_engine_per_request_sampling(model, wavs):
    """Sampled and greedy requests share a batch; the greedy row equals the
    one-shot path and a seed gives one sampled trajectory."""
    expected = _one_shot(model, _msgs(wavs[1], 1), 8)

    def run(seed):
        eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                       max_new_tokens=8, ctx_bucket=128,
                                       seed=seed)
        rid_g = eng.submit(_msgs(wavs[1], 1))
        rid_s = eng.submit(_msgs(wavs[2], 2), temperature=1.2, top_p=0.9,
                           do_sample=True)
        rid_f = eng.submit(TEXT, temperature=0.8, do_sample=True)
        eng.run_until_done()
        res = eng.results()
        return [res[r]["tokens"] for r in (rid_g, rid_s, rid_f)], res[rid_g]

    (g0, s0, f0), info = run(seed=7)
    (g1, s1, f1), _ = run(seed=7)
    (_, s2, f2), _ = run(seed=8)
    assert info["text"] == expected and g0 == g1
    assert s0 == s1 and f0 == f1
    assert len(s2) == len(s0) or s2[-1] in model._terminators()
    assert all(0 <= t < model.llm_cfg.vocab_size for t in s2 + f2)


def test_engine_batched_prefill_mixed_buckets(model, wavs):
    reqs = _bucket_msgs(wavs)
    expected = [_one_shot(model, m, 5) for m in reqs]
    eng = ContinuousBatchingEngine(model, n_slots=4, max_ctx=320,
                                   max_new_tokens=5, ctx_bucket=32)
    rids = [eng.submit(m) for m in reqs]
    assert len({int(r.embeds.shape[1]) for r in eng.queue}) > 1
    results = eng.run_until_done()
    assert [results[r] for r in rids] == expected


def test_engine_slot_reuse_and_mixed_lengths(model, wavs):
    eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                   max_new_tokens=8, ctx_bucket=128)
    rids = [eng.submit(_msgs(wavs[j % 3], j), max_new_tokens=2 + (j % 3))
            for j in range(5)]
    results = eng.run_until_done()
    info = eng.results()
    assert sorted(results) == sorted(rids)
    for j, rid in enumerate(rids):
        assert (len(info[rid]["tokens"]) == 2 + (j % 3)
                or info[rid]["finish_reason"] == "eos")


def test_engine_steps_per_tick_invariant(model, wavs):
    results = []
    for k in (1, 4, 7):
        eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                       max_new_tokens=7, ctx_bucket=128,
                                       steps_per_tick=k)
        rids = [eng.submit(_msgs(wavs[i], i)) for i in range(3)]
        res = eng.run_until_done()
        results.append([res[r] for r in rids])
    assert results[0] == results[1] == results[2]


def test_engine_submit_many_matches_submit(model, wavs):
    eng1 = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                    max_new_tokens=6, ctx_bucket=128)
    r1 = [eng1.submit(_msgs(wavs[i], i)) for i in range(3)]
    res1 = eng1.run_until_done()
    eng2 = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                    max_new_tokens=6, ctx_bucket=128)
    r2 = eng2.submit_many([_msgs(wavs[i], i) for i in range(3)])
    res2 = eng2.run_until_done()
    assert [res1[r] for r in r1] == [res2[r] for r in r2]


def test_engine_on_token_streaming(model, wavs):
    streamed = {}
    eng = ContinuousBatchingEngine(
        model, n_slots=2, max_ctx=128, max_new_tokens=6, ctx_bucket=128,
        on_token=lambda rid, t: streamed.setdefault(rid, []).append(t))
    rids = eng.submit_many([_msgs(wavs[i], i) for i in range(3)])
    eng.run_until_done()
    for rid in rids:
        assert streamed[rid] == eng.finished[rid]


def test_engine_admission_does_not_stall_active_slots(model, wavs):
    expected = {i: _one_shot(model, _msgs(p, i), 6)
                for i, p in enumerate(wavs)}
    eng = ContinuousBatchingEngine(model, n_slots=3, max_ctx=128,
                                   max_new_tokens=6, ctx_bucket=128,
                                   steps_per_tick=2)
    rid0 = eng.submit(_msgs(wavs[0], 0))
    eng.step()
    eng.step()
    rid1 = eng.submit(_msgs(wavs[1], 1))
    rid2 = eng.submit(_msgs(wavs[2], 2))
    res = eng.run_until_done()
    assert [res[r] for r in (rid0, rid1, rid2)] == [expected[i]
                                                    for i in range(3)]


def test_engine_overflow_rejected_or_flagged(model):
    long_msgs = [{"role": "user", "content": "word " * 200}]
    eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=64,
                                   max_new_tokens=4, ctx_bucket=64)
    with pytest.raises(ValueError, match="max_ctx"):
        eng.submit(long_msgs)
    eng2 = ContinuousBatchingEngine(model, n_slots=2, max_ctx=64,
                                    max_new_tokens=4, ctx_bucket=64,
                                    on_overflow="truncate")
    rid = eng2.submit(long_msgs)
    rid_ok = eng2.submit([{"role": "user", "content": "hi"}])
    eng2.run_until_done()
    res = eng2.results()
    assert res[rid]["truncated"] is True
    assert res[rid_ok]["truncated"] is False
    assert res[rid]["finish_reason"] in ("eos", "length")
    assert res[rid]["prompt_tokens"] == 64
    assert isinstance(res[rid]["text"], str)


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_cache_full_surfaced(model, wavs, pipeline):
    """A slot forced within 3 positions of the cache's end runs its whole
    tick (the writes past the end do not raise) and finishes cache_full,
    keeping the 3 tokens whose writes landed."""
    eng = ContinuousBatchingEngine(model, n_slots=1, max_ctx=128,
                                   max_new_tokens=64, ctx_bucket=128,
                                   steps_per_tick=8, pipeline_ticks=pipeline)
    rid = eng.submit(_msgs(wavs[0], 0))
    eng.step()
    s = next(s for s in range(eng.n_slots) if eng.slot_req[s] is not None)
    n0 = len(eng.slot_req[s].tokens)
    eng.slot_pos[s] = eng.t_max - 3
    eng.step()
    res = eng.results()
    assert res[rid]["finish_reason"] == "cache_full"
    assert res[rid]["truncated"] is True
    # pipelined: the tick queued before the cursor moved counts too
    assert len(res[rid]["tokens"]) == n0 + 3 + (8 if pipeline else 0)


def test_engine_cancel_and_deadline(model, wavs):
    ref = ContinuousBatchingEngine(model, n_slots=1, max_ctx=128,
                                   max_new_tokens=6, ctx_bucket=128)
    keep_ref = ref.submit(_msgs(wavs[0], 0))
    ref_text = ref.run_until_done()[keep_ref]

    eng = ContinuousBatchingEngine(model, n_slots=1, max_ctx=128,
                                   max_new_tokens=6, ctx_bucket=128)
    keep = eng.submit(_msgs(wavs[0], 0))
    cancel_queued = eng.submit(_msgs(wavs[1], 1))
    eng.step()
    assert eng.cancel(cancel_queued) is True
    assert eng.cancel(cancel_queued) is False
    assert eng.cancel(10 ** 9) is False
    res = eng.run_until_done()
    info = eng.results()
    assert info[cancel_queued]["finish_reason"] == "cancelled"
    assert info[cancel_queued]["tokens"] == []
    assert res[keep] == ref_text
    assert info[keep]["finish_reason"] in ("eos", "length")

    # a running request: its tokens so far are kept, its slot reused
    eng2 = ContinuousBatchingEngine(model, n_slots=1, max_ctx=128,
                                    max_new_tokens=64, ctx_bucket=128,
                                    steps_per_tick=2)
    run = eng2.submit(_msgs(wavs[2], 2))
    eng2.step()
    eng2.step()
    assert eng2.cancel(run) is True
    info2 = eng2.results()
    assert info2[run]["finish_reason"] == "cancelled"
    assert 0 < len(info2[run]["tokens"]) < 64
    nxt = eng2.submit(_msgs(wavs[0], 0), max_new_tokens=6)
    res2 = eng2.run_until_done()
    assert res2[nxt] == ref_text

    eng3 = ContinuousBatchingEngine(model, n_slots=1, max_ctx=128,
                                    max_new_tokens=6, ctx_bucket=128)
    dead = eng3.submit(_msgs(wavs[1], 1), deadline_s=0.0)
    live = eng3.submit(_msgs(wavs[0], 0))
    res3 = eng3.run_until_done()
    info3 = eng3.results()
    assert info3[dead]["finish_reason"] == "deadline"
    assert res3[live] == ref_text


def test_engine_stop_sequences_and_stop_tokens(model, wavs):
    msgs = _msgs(wavs[0], 0)
    eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                   max_new_tokens=8, ctx_bucket=128)
    rid = eng.submit(msgs)
    eng.run_until_done()
    base = eng.results()[rid]
    assert base["finish_reason"] in ("eos", "length")
    base_text, base_toks = base["text"], base["tokens"]
    assert len(base_toks) >= 3
    tk = model.tokenizer
    stop_str = tk.decode(base_toks[1:3], skip_special_tokens=True)
    assert stop_str and stop_str in base_text
    eng2 = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                    max_new_tokens=8, ctx_bucket=128)
    rid2 = eng2.submit(msgs, stop=[stop_str])
    eng2.run_until_done()
    r2 = eng2.results()[rid2]
    assert r2["finish_reason"] == "stop"
    assert stop_str not in r2["text"]
    assert base_text.startswith(r2["text"])
    eng3 = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                    max_new_tokens=8, ctx_bucket=128)
    rid3 = eng3.submit(msgs, stop_token_ids=[int(base_toks[0])])
    eng3.run_until_done()
    r3 = eng3.results()[rid3]
    assert r3["finish_reason"] == "stop"
    assert r3["tokens"] == base_toks[:1] and r3["text"] == ""


def test_engine_pipelined_ticks_match_sequential(model, wavs):
    reqs = [_msgs(wavs[j % 3], j) for j in range(5)]

    def run(pipeline):
        eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=64,
                                       max_new_tokens=6, ctx_bucket=64,
                                       steps_per_tick=3,
                                       pipeline_ticks=pipeline)
        rids = [eng.submit(m) for m in reqs]
        eng.run_until_done()
        info = eng.results()
        return [(info[r]["tokens"], info[r]["finish_reason"]) for r in rids]

    assert run(True) == run(False)


# -- the fused decode path: the kept DecodeGraph on plain K8-int8 / K8i -------

FUSED_NANO = dict(llm_model_id="test/llama-nano128",
                  encoder_model_id="test/whisper-nano",
                  qformer_num_hidden_layers=2, prompt_size=8,
                  dtype="bfloat16", llm_quant="int8")


@pytest.fixture(scope="module")
def fused_models():
    """The int8 bf16 nano128 Q-Former model and an ORCA one with its int8
    stack: the engine's decode step is the kept graph's."""
    q = DeSTA25AudioModel(DeSTA25Config(**FUSED_NANO), device="cpu", seed=3)
    orca = DeSTA25AudioModel(
        DeSTA25Config(**{**ORCA_NANO, **FUSED_NANO,
                         "connector_mode": "orca_hybrid"}),
        device="cpu", seed=4)
    orca.apply_orca_xattn_quant()
    return q, orca


@pytest.mark.parametrize("kind", ["int8", "orca"])
def test_engine_fused_step_invariants(fused_models, wavs, kind):
    """One engine configuration's greedy ids are the same with 1- and
    3-step ticks, pipelined or not, through submit or submit_many; the
    decode runs through the kept graph's step (the fused plain versions on
    the CPU, no counted launch); ORCA's text-only slot has on = 0."""
    model = fused_models[kind == "orca"]
    audio = [_msgs(p, i) for i, p in enumerate(wavs)]

    def run(k, pipeline, many):
        eng = ContinuousBatchingEngine(model, n_slots=4, max_ctx=128,
                                       max_new_tokens=7, ctx_bucket=64,
                                       steps_per_tick=k,
                                       pipeline_ticks=pipeline)
        assert eng.graph is not None
        assert (eng._fspec is not None) == (kind == "orca")
        rids = (eng.submit_many(audio) if many
                else [eng.submit(m) for m in audio])
        rids.append(eng.submit(TEXT))
        _build.reset_launch_counts()
        eng.step()
        if kind == "orca":
            on = {r.rid: eng.inject_on[s]
                  for s, r in enumerate(eng.slot_req) if r is not None}
            assert on.get(rids[-1], 0.0) == 0.0
            assert all(on.get(r, 1.0) == 1.0 for r in rids[:-1])
        eng.run_until_done()
        assert _build.launch_counts() == {}
        assert _build.fallback_counts() == {}
        info = eng.results()
        return [info[r]["tokens"] for r in rids]

    base = run(3, True, False)
    assert all(len(t) >= 1 for t in base)
    assert run(1, True, False) == base
    assert run(3, False, True) == base


# -- the cache-write repair, the sampler ----------------------------------------

def _nano_llm():
    kw = dict(model_id="test/srv-nano", vocab_size=512, hidden_size=64,
              intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
              tie_word_embeddings=False, qk_norm=False, bos_token_id=0,
              eos_token_id=1)
    jcfg = JLLMConfig(**kw)
    jp = jllm.init_llm(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    return jcfg, jp, TLLMConfig(**kw), llm_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("T,ci", [(4, (5, 14)), (1, (3, 16)), (2, (15, 0))])
def test_cache_write_past_the_end_matches_jax(T, ci):
    """llm_apply with a [B] cache index whose row writes straddle (or lie
    past) the cache's end: no raise, the start clamped to S - T as JAX's
    dynamic_update_slice clamps it; every cache row and the logits equal
    JAX llm_apply's."""
    jcfg, jp, tcfg, tp = _nano_llm()
    B, S = 2, 16
    rng = np.random.default_rng(T)
    ids = rng.integers(2, 500, size=(B, T))
    kv = rng.standard_normal((2, jcfg.num_hidden_layers, B, S,
                              jcfg.num_key_value_heads * jcfg.head_dim)
                             ).astype(np.float32)
    mask = (rng.random((B, S)) > 0.2).astype(np.int32)
    want_lg, want_c = jllm.llm_apply(
        jp, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        cache=jllm.KVCache(jnp.asarray(kv[0]), jnp.asarray(kv[1])),
        cache_index=jnp.asarray(ci, jnp.int32))[:2]
    cache = tllm.KVCache(torch.from_numpy(kv[0].copy()),
                         torch.from_numpy(kv[1].copy()))
    got_lg, got_c = tllm.llm_apply(
        tp, tcfg, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(mask), cache=cache,
        cache_index=torch.tensor(ci, dtype=torch.int32))
    np.testing.assert_allclose(got_c.k.numpy(), np.asarray(want_c.k),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_c.v.numpy(), np.asarray(want_c.v),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg),
                               rtol=1e-4, atol=1e-4)
    # the untouched rows are the cache's own
    start = min(max(ci[0], 0), S - T)
    keep = [s for s in range(S) if not start <= s < start + T]
    assert np.array_equal(got_c.k[:, 0, keep].numpy(), kv[0][:, 0, keep])


def test_sample_token_dynamic_rows():
    """Greedy rows are the exact argmax; nucleus rows stay inside their
    nucleus; full-vocab rows follow the softmax; the same generator seed
    draws the same tokens."""
    g = torch.Generator().manual_seed(0)
    B, V = 6, 300
    logits = torch.randn(B, V, generator=g) * 3
    temp = torch.tensor([0.0, 1.0, 0.7, 1.0, 1.3, 0.5])
    top_p = torch.tensor([1.0, 0.5, 0.9, 1.0, 1.0, 0.3])
    do_sample = torch.tensor([False, True, True, True, True, False])

    def draw(seed, n=400):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([sample_token_dynamic(logits, gen, temp, top_p,
                                                 do_sample)
                            for _ in range(n)])

    a, b = draw(1), draw(1)
    assert torch.equal(a, b) and a.dtype == torch.long
    assert not torch.equal(a, draw(2))
    assert (a[:, 0] == logits[0].argmax()).all()
    assert (a[:, 5] == logits[5].argmax()).all()
    for row in (1, 2):
        scaled = logits[row] / temp[row]
        order = torch.argsort(scaled, descending=True)
        p = torch.softmax(scaled, -1)[order]
        n_keep = int(((torch.cumsum(p, 0) - p) < top_p[row]).sum())
        assert set(a[:, row].tolist()) <= set(order[:n_keep].tolist())
    # row 3: full-vocab categorical at temperature 1
    freq = torch.bincount(a[:, 3], minlength=V).float() / a.shape[0]
    p3 = torch.softmax(logits[3], -1)
    assert float((freq - p3).abs().sum()) < 0.35
