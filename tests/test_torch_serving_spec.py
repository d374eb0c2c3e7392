"""The port's serving engine with speculative ticks (``serve/engine.py``,
``speculative_k >= 2``) on the CPU at nano scale: the geometry of the
speculative cases of tests/test_serving.py (``test/llama-nano128``, bf16,
the int8 tower, 2 slots, max_ctx 64, 2-3 steps a tick, ``speculative_k=3``),
the JAX package's params carried across by the bridge.

- Each speculative case of tests/test_serving.py, by name, against the
  port's own plain-tick trajectory (held against JAX by
  tests/test_torch_serving.py): greedy results equal exactly.
- Against the JAX engine: one forced speculative run (sequential) and one
  adaptive run with forced mode flips (pipelined), the JAX side through its
  TPU dispatch (the verify and decode kernels in interpret mode, K7 and
  W8A8 as on the TPU): equal ``results()`` and tick counts; the adaptive
  controller fed one table of (acceptance, tick durations) on both engines:
  equal state after every call.
- Multi-token acceptance: a drafter that proposes the plain trajectory's
  own ids accepts more than one token a step and gives the same ids.
"""

import jax
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.serve.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt.bridge import from_jax_params
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.serve import engine as tengine
from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine

SPEC = dict(llm_model_id="test/llama-nano128",
            encoder_model_id="test/whisper-nano", prompt_size=8,
            qformer_num_hidden_layers=2, dtype="bfloat16", llm_quant="int8")
F32 = dict(llm_model_id="test/llama-nano",
           encoder_model_id="test/whisper-nano", prompt_size=8,
           qformer_num_hidden_layers=2, dtype="float32")
SPEC_MAX_NEW = 6
ENG = dict(n_slots=2, max_ctx=64, ctx_bucket=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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
def spec_models():
    """(the JAX spec_model of tests/test_serving.py, the port's on its
    weights)."""
    return _pair(SPEC, seed=0)


@pytest.fixture(scope="module")
def spec_model(spec_models):
    return spec_models[1]


@pytest.fixture(scope="module")
def f32_model():
    return DeSTA25AudioModel(DeSTA25Config(**F32), device="cpu", seed=0)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
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


def _drive(eng, reqs):
    rids = [eng.submit(q, **kw) for q, kw in reqs]
    eng.run_until_done()
    res = eng.results()
    return [res[r] for r in rids]


@pytest.fixture(scope="module")
def plain_runs(spec_model, wavs):
    """The port's greedy plain-tick results for the first n standard
    requests, submitted together (the admissions' prefill batch decides
    the int8 tower's product path, K7 below 128 rows and W8A8 from 128, so
    each case is held against plain ticks on the same submissions)."""
    done = {}

    def get(n):
        if n not in done:
            eng = ContinuousBatchingEngine(
                spec_model, max_new_tokens=SPEC_MAX_NEW, steps_per_tick=3,
                **ENG)
            done[n] = _drive(eng, [(_msgs(wavs[i], i), {})
                                   for i in range(n)])
        return done[n]

    return get


@pytest.fixture(scope="module")
def plain_spec_baseline(plain_runs):
    return plain_runs(3)


def _texts(results):
    return [r["text"] for r in results]


# -- the speculative cases of tests/test_serving.py -------------------------

def test_engine_cache_length_is_128_multiple(spec_model):
    for max_ctx, max_new, spec in ((256, 48, 0), (128, 10, 0),
                                   (256, 48, 4), (100, 28, 0), (124, 4, 3)):
        eng = ContinuousBatchingEngine(
            spec_model, n_slots=2, max_ctx=max_ctx, max_new_tokens=max_new,
            ctx_bucket=64, speculative_k=spec)
        assert eng.t_max % 128 == 0, (max_ctx, max_new, spec, eng.t_max)
        assert eng.t_max >= max_ctx + max_new + spec
        assert eng.cache.k.shape[2] == eng.t_max
        assert eng.speculative_k == spec
    # the slack crosses a 128 boundary: 124 + 4 fits 128, + 3 does not
    assert eng.t_max == 256
    assert eng.hist.shape[1] == eng.t_max + eng.steps_per_tick * 3 + 8


def test_engine_speculative_matches_plain_ticks(spec_model, wavs,
                                                plain_spec_baseline):
    spec = ContinuousBatchingEngine(spec_model, max_new_tokens=SPEC_MAX_NEW,
                                    speculative_k=3, steps_per_tick=3,
                                    spec_quiet_ticks=0, **ENG)
    assert spec.speculative_k == 3 and spec.vgraph is not None
    got = _drive(spec, [(_msgs(wavs[i], i), {}) for i in range(3)])
    assert got == plain_spec_baseline
    assert spec._n_spec_ticks >= 1
    assert all(r["finish_reason"] in ("eos", "length") for r in got)
    assert _build.fallback_counts().get("fused_verify_layers", 0) == 0


def test_engine_speculative_mixed_sampling(spec_model, wavs, plain_runs):
    """A sampled slot beside a greedy one: every verify position runs the
    sampler; the greedy row keeps its plain trajectory; a seed gives one
    sampled trajectory."""
    def run(seed):
        spec = ContinuousBatchingEngine(
            spec_model, max_new_tokens=SPEC_MAX_NEW, speculative_k=3,
            seed=seed, steps_per_tick=3, spec_quiet_ticks=0,
            adaptive_spec=False, **ENG)
        return _drive(spec, [(_msgs(wavs[0], 0), {}),
                             (_msgs(wavs[1], 1),
                              dict(temperature=1.1, top_p=0.9,
                                   do_sample=True))]), spec

    (g, s), eng = run(3)
    assert g == plain_runs(2)[0]
    assert 1 <= len(s["tokens"]) <= SPEC_MAX_NEW
    assert all(0 <= t < spec_model.llm_cfg.vocab_size for t in s["tokens"])
    assert eng._n_spec_ticks >= 1 and eng._n_plain_ticks == 0
    (g2, s2), _ = run(3)
    assert (g2, s2) == (g, s)


def test_engine_speculative_sampled_tiny_temp_matches_greedy(
        spec_model, wavs, plain_runs):
    spec = ContinuousBatchingEngine(spec_model, max_new_tokens=SPEC_MAX_NEW,
                                    speculative_k=3, seed=5,
                                    steps_per_tick=3, spec_quiet_ticks=0,
                                    adaptive_spec=False, **ENG)
    got = _drive(spec, [(_msgs(wavs[0], 0),
                         dict(temperature=1e-4, top_p=1.0, do_sample=True))])
    assert _texts(got) == _texts(plain_runs(1))
    assert got[0]["tokens"] == plain_runs(1)[0]["tokens"]


def _adaptive_run(model, adaptive, pipeline, reqs, engine_cls):
    eng = engine_cls(model, max_new_tokens=8, speculative_k=3,
                     steps_per_tick=2, adaptive_spec=adaptive,
                     spec_quiet_ticks=0, pipeline_ticks=pipeline, **ENG)
    assert eng.speculative_k == 3
    if adaptive:
        # nothing passes these bars: off after the first tick, a probe
        # every 2 ticks (duration sampling off: the static bars rule)
        eng._spec_off = eng._spec_on = eng._spec_ema = 10.0
        eng._spec_reprobe = 2
        eng._record_tick_dur = lambda *a, **k: None
    return _drive(eng, reqs), eng


def test_engine_adaptive_spec_mode_flips_preserve_trajectory(spec_model,
                                                             wavs):
    reqs = [(_msgs(wavs[j % 3], j), {}) for j in range(3)]
    base, beng = _adaptive_run(spec_model, False, False, reqs,
                               ContinuousBatchingEngine)
    assert beng._n_plain_ticks == 0
    for pipeline in (True, False):
        got, eng = _adaptive_run(spec_model, True, pipeline, reqs,
                                 ContinuousBatchingEngine)
        assert got == base, pipeline
        assert eng._n_plain_ticks > 0 and eng._n_spec_ticks > 0
        assert eng._spec_probing or not eng._spec_live


def test_engine_adaptive_spec_cost_aware_break_even(f32_model):
    eng = ContinuousBatchingEngine(f32_model, n_slots=2, max_ctx=64,
                                   max_new_tokens=4, ctx_bucket=64)
    eng.adaptive_spec = True  # the decision math is model-independent
    eng._spec_live, eng._spec_probing = True, False
    eng._spec_ema = 1.5
    eng._dur_ema = {"spec": None, "plain": None}
    for _ in range(10):
        eng._spec_controller_update(1.5)
    assert eng._spec_live
    eng._dur_ema = {"spec": 0.020, "plain": 0.010}  # be = 2.0
    for _ in range(10):
        eng._spec_controller_update(1.5)
    assert not eng._spec_live
    eng._spec_probing = True
    eng._spec_controller_update(2.5)
    assert eng._spec_live
    eng._spec_live, eng._spec_probing = False, True
    eng._spec_controller_update(1.8)
    assert not eng._spec_live


def test_engine_adaptive_spec_probe_backoff(f32_model):
    eng = ContinuousBatchingEngine(f32_model, n_slots=2, max_ctx=64,
                                   max_new_tokens=4, ctx_bucket=64)
    eng.adaptive_spec = True
    assert eng._reprobe_backoff == 1
    eng._spec_live, eng._spec_probing = True, True
    eng._spec_controller_update(1.0)
    assert not eng._spec_live and eng._reprobe_backoff == 2
    for expect in (4, 8, 16, 16):
        eng._spec_probing = True
        eng._spec_controller_update(1.0)
        assert eng._reprobe_backoff == expect
    eng._spec_probing = True
    eng._spec_controller_update(3.0)
    assert eng._spec_live and eng._reprobe_backoff == 1
    eng._reprobe_backoff = 8
    eng._spec_ema = 1.0
    eng._spec_controller_update(0.0)
    assert not eng._spec_live and eng._reprobe_backoff == 1


def test_engine_spec_quiet_gate(spec_model, wavs, plain_runs):
    eng = ContinuousBatchingEngine(spec_model, max_new_tokens=SPEC_MAX_NEW,
                                   speculative_k=3, steps_per_tick=1,
                                   spec_quiet_ticks=1, **ENG)
    got = _drive(eng, [(_msgs(wavs[0], 0), {})])
    assert got == plain_runs(1)
    # the admission tick and one quiet warm-up ran plain, later ticks spec
    assert eng._n_plain_ticks >= 2, eng._n_plain_ticks
    assert eng._n_spec_ticks >= 1, eng._n_spec_ticks


def test_engine_speculative_fallback_when_unsupported(f32_model):
    """f32 weights and cache: the verify step cannot take the engine, which
    warns, counts the refusal and runs plain ticks."""
    _build.reset_launch_counts()
    eng = ContinuousBatchingEngine(f32_model, n_slots=2, max_ctx=64,
                                   max_new_tokens=4, ctx_bucket=64,
                                   speculative_k=4)
    assert eng.speculative_k == 0 and eng.vgraph is None
    assert not eng.adaptive_spec
    assert _build.fallback_counts().get("fused_verify_layers") == 1
    rid = eng.submit([{"role": "user", "content": "hi"}])
    res = eng.run_until_done()
    assert isinstance(res[rid], str) and eng._n_spec_ticks == 0


def test_engine_pipelined_spec_matches_sequential(spec_model, wavs,
                                                  plain_spec_baseline):
    reqs = [(_msgs(wavs[j % 3], j), {}) for j in range(3)]

    def run(pipeline):
        eng = ContinuousBatchingEngine(
            spec_model, max_new_tokens=SPEC_MAX_NEW, speculative_k=3,
            steps_per_tick=2, spec_quiet_ticks=0, adaptive_spec=False,
            pipeline_ticks=pipeline, **ENG)
        return _drive(eng, reqs), eng

    pip, eng = run(True)
    seq, _ = run(False)
    assert pip == seq == plain_spec_baseline
    assert eng._n_plain_ticks == 0 and eng._n_spec_ticks >= 3


# -- more of the spec tick ----------------------------------------------------

def test_engine_spec_oracle_drafts_accept_several_tokens(
        spec_model, wavs, plain_runs, monkeypatch):
    """A drafter that proposes each row's own plain-trajectory ids (found
    by the row's history length) accepts more than one token a verify step
    and emits the same ids: the tick's multi-token advance of cursors,
    positions, histories and the host's bookkeeping."""
    ids = [r["tokens"] for r in plain_runs(2)]
    starts = {}

    def oracle(hist, hlen, k):
        out = torch.zeros(hist.shape[0], k, dtype=torch.long)
        for b in range(hist.shape[0]):
            n = int(hlen[b])
            row = hist[b, :n].tolist()
            for j, want in enumerate(ids):
                # the row whose generated ids so far are a prefix of want
                s = starts.get(j)
                if s is not None and row[s:] == want[:n - s]:
                    out[b] = torch.tensor((want + [0] * k)[n - s:n - s + k])
        return out

    eng = ContinuousBatchingEngine(spec_model, max_new_tokens=SPEC_MAX_NEW,
                                   speculative_k=3, steps_per_tick=2,
                                   adaptive_spec=False, pipeline_ticks=False,
                                   **ENG)
    accepted = []
    consume = eng._consume_spec_tick

    def spy(slot_reqs, outs, write_pos):
        B, Kd = eng.n_slots, eng.speculative_k
        ms = outs.numpy()[:, B * Kd:]
        accepted.extend(int(ms[:, s].max()) for s, _ in slot_reqs)
        return consume(slot_reqs, outs, write_pos)

    eng._consume_spec_tick = spy
    monkeypatch.setattr(tengine, "ngram_propose", oracle)
    rids = [eng.submit(_msgs(wavs[i], i)) for i in range(2)]
    eng.step()       # admissions alone: the prompts' lengths are known
    assert eng._n_spec_ticks == 0
    for j, rid in enumerate(rids):
        req = next(r for r in eng.slot_req if r is not None and r.rid == rid)
        starts[j] = len(req.prompt_ids)
    eng.run_until_done()
    res = eng.results()
    assert [res[r] for r in rids] == plain_runs(2)
    assert max(accepted) == eng.speculative_k, accepted


def test_engine_spec_cache_full_surfaced(spec_model, wavs):
    """A slot forced within Kd positions of the cache's end: the verify
    block does not fit, the row freezes, and the request finishes
    cache_full and truncated."""
    eng = ContinuousBatchingEngine(spec_model, max_new_tokens=SPEC_MAX_NEW,
                                   speculative_k=3, steps_per_tick=2,
                                   adaptive_spec=False, pipeline_ticks=False,
                                   **ENG)
    rid = eng.submit(_msgs(wavs[0], 0))
    eng.step()
    s = next(s for s in range(eng.n_slots) if eng.slot_req[s] is not None)
    n0 = len(eng.slot_req[s].tokens)
    eng.slot_pos[s] = eng.t_max - 2
    eng.step()
    res = eng.results()[rid]
    assert res["finish_reason"] == "cache_full" and res["truncated"] is True
    assert len(res["tokens"]) == n0


# -- against the JAX engine ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_spec_runs(spec_models, wavs):
    """The JAX engine's forced sequential spec run and its adaptive run with
    forced flips, through its TPU dispatch on the CPU (interpret mode)."""
    from test_torch_int8_llm import jax_tpu_dispatch
    jm = spec_models[0]
    reqs = [(_msgs(wavs[j % 3], j), {}) for j in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        jax_tpu_dispatch(mp)
        try:
            forced = JaxEngine(jm, max_new_tokens=SPEC_MAX_NEW,
                               speculative_k=3, steps_per_tick=3,
                               adaptive_spec=False, pipeline_ticks=False,
                               **ENG)
            f_res = _drive(forced, reqs)
            a_res, adaptive = _adaptive_run(jm, True, True, reqs, JaxEngine)
        finally:
            jax.clear_caches()
    return {"forced": (f_res, forced), "adaptive": (a_res, adaptive)}


def _same_inputs(monkeypatch, spec_models):
    """The port model takes the JAX model's spliced embeddings: the two
    perceptions in bf16 part by a last bit (held within tolerance by the
    model tests), which random weights turn into other ids; here the engine
    alone is compared."""
    jm, tm = spec_models

    def prepare(messages_list):
        emb, mask, inject, ids = jm._prepare_generation_inputs(messages_list)
        f32 = np.array(jax.numpy.asarray(emb, jax.numpy.float32))
        return (torch.from_numpy(f32).to(tm.dtype),
                torch.from_numpy(np.array(mask)).int(), inject,
                None if ids is None else np.asarray(ids))

    monkeypatch.setattr(tm, "_prepare_generation_inputs", prepare)


def test_spec_engine_matches_jax_forced(spec_models, wavs, jax_spec_runs,
                                        monkeypatch):
    want, jeng = jax_spec_runs["forced"]
    _same_inputs(monkeypatch, spec_models)
    spec_model = spec_models[1]
    eng = ContinuousBatchingEngine(spec_model, max_new_tokens=SPEC_MAX_NEW,
                                   speculative_k=3, steps_per_tick=3,
                                   adaptive_spec=False, pipeline_ticks=False,
                                   **ENG)
    got = _drive(eng, [(_msgs(wavs[j % 3], j), {}) for j in range(3)])
    assert jeng.speculative_k == eng.speculative_k == 3
    assert got == want
    assert (eng._n_spec_ticks, eng._n_plain_ticks) == (
        jeng._n_spec_ticks, jeng._n_plain_ticks)


def test_spec_engine_matches_jax_adaptive_flips(spec_models, wavs,
                                                jax_spec_runs, monkeypatch):
    want, jeng = jax_spec_runs["adaptive"]
    _same_inputs(monkeypatch, spec_models)
    spec_model = spec_models[1]
    reqs = [(_msgs(wavs[j % 3], j), {}) for j in range(3)]
    got, eng = _adaptive_run(spec_model, True, True, reqs,
                             ContinuousBatchingEngine)
    assert got == want
    assert (eng._n_spec_ticks, eng._n_plain_ticks) == (
        jeng._n_spec_ticks, jeng._n_plain_ticks)
    assert eng._n_spec_ticks > 0 and eng._n_plain_ticks > 0


def _controller_table(case):
    """(acceptance, T_spec, T_plain, probe) a call; durations None are the
    static bars; probe sets ``_spec_probing`` before the call."""
    if case == "static":
        return ([(1.0, None, None, True)] * 5 + [(3.0, None, None, True)]
                + [(1.3, None, None, False)] * 4
                + [(0.2, None, None, False)] * 3)
    if case == "cost_aware":
        return ([(1.5, None, None, False)] * 3
                + [(1.5, 0.020, 0.010, False)] * 6
                + [(2.5, 0.020, 0.010, True), (1.8, 0.020, 0.012, True),
                   (2.3, 0.011, 0.010, False), (1.0, 0.009, 0.010, False)])
    rng = np.random.default_rng(7)
    rows = []
    for _ in range(40):
        ds = None if rng.random() < 0.2 else float(rng.uniform(0.005, 0.03))
        dp = None if rng.random() < 0.2 else float(rng.uniform(0.005, 0.02))
        rows.append((float(rng.uniform(0.5, 3.5)), ds, dp,
                     bool(rng.random() < 0.3)))
    return rows


_STATE = ("_spec_live", "_spec_probing", "_spec_ema", "_reprobe_backoff",
          "_ticks_since_probe")


@pytest.mark.parametrize("case", ["static", "cost_aware", "random"])
def test_spec_controller_matches_jax(spec_models, f32_model, case):
    """Both engines' ``_spec_controller_update`` fed the same table: the
    controller's state equal after every call."""
    jm = JaxModel(JaxConfig(**F32), seed=0)
    engines = [JaxEngine(jm, n_slots=2, max_ctx=64, max_new_tokens=4),
               ContinuousBatchingEngine(f32_model, n_slots=2, max_ctx=64,
                                        max_new_tokens=4)]
    for e in engines:
        e.adaptive_spec = True
        e._ticks_since_probe = 3
    for i, (rate, ds, dp, probe) in enumerate(_controller_table(case)):
        states = []
        for e in engines:
            e._dur_ema = {"spec": ds, "plain": dp}
            if probe:
                e._spec_probing = True
            e._spec_controller_update(rate)
            states.append(tuple(getattr(e, k) for k in _STATE))
        assert states[0] == states[1], (case, i, states)
