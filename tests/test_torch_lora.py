"""LoRA in the port against the JAX package on the CPU, at nano scale.

The JAX nano model is drawn with ``use_lora`` (r = 4, alpha = 8: scale 2)
and its adapters' B moved off zero (N(0, 0.02) added to A and B, as the JAX
tests do), so that the LoRA path computes something the base path does not;
the port takes the JAX params through the bridge.  Parity runs without
dropout (the sides' random streams differ); dropout is held by its
statistics, by same-seed determinism and by the gradient under ``remat``.

- ``_lora_delta`` within 1e-5 of JAX relative to its largest element, and
  ``llm_apply`` (cache-less, and prefill then a cached step) within 1e-5 of
  JAX, in f32.
- The nano LoRA train step (T = 96, the masked attention path) at dropout
  0: loss and grad_norm within 1e-4 rel of JAX for two steps, the
  adapters' gradients within 1e-5 of their largest element.
- At dropout 0.5 the gradient with ``remat`` equals the one without.
- Greedy ``generate()`` ids identical to JAX with LoRA, bf16 LLM and int8
  LLM (the JAX side on its TPU dispatch, as tests/test_torch_int8_llm.py
  runs it); speculation is refused under LoRA and the plain loop runs.
- ``merge_lora`` within 1e-7 of JAX's (f32; the rank sum runs in another
  order), merged ids equal the adapter ids, a failed merge keeps the
  adapters, ``merge_lora_for_serving(quantize=True)`` gives int8 leaves.
- ``lora_io`` gives JAX's keys and values and reads them back; JAX reads
  the port's ``save_pretrained`` adapters and ``from_pretrained`` carries
  them.
- The engine with LoRA gives the JAX engine's greedy results, with no kept
  graph; ``speculative_k`` is refused with plain ticks.
- LoRA under a CPU mesh (two model ranks) equals the unsharded forward.
- The trainer with LoRA and ``num_workers=2`` moves the adapters' B.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.ckpt import desta_io as jio
from desta25_audio_tpu.ckpt import lora_io as jlora_io
from desta25_audio_tpu.data import dataset as jdata
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.serve.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from desta25_audio_tpu.train import optimizer as jopt
from desta25_audio_tpu.train import step as jstep
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.ckpt import lora_io as tlora_io
from desta25_audio_tpu_torch.data.dataset import (
    AudioTextDataset,
    CollateFn,
    DataConfig,
)
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops.quant import is_quantized
from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train import step as tstep
from desta25_audio_tpu_torch.train.trainer import (
    DeSTA25Trainer,
    TrainerConfig,
)

NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32",
            use_lora=True, lora_rank=4, lora_alpha=8.0, lora_dropout=0.0)
SCALE = 2.0           # alpha / r
TOL_F32 = 1e-5        # LoRA forward vs JAX, f32
TOL_MERGE = 1e-7      # merged f32 weights vs JAX (the rank sum's order)
# the decode kernels whose refusal llm_apply counts as a fallback
LLM_KERNELS = ("fused_decode_layers", "fused_decode_inject",
               "fused_verify_layers")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small eager ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moved(lora, key=9):
    """The adapters with N(0, 0.02) added to every A and B (B leaves
    zero)."""
    return jax.tree.map(lambda x: x + 0.02 * jax.random.normal(
        jax.random.PRNGKey(key), x.shape, x.dtype), lora)


def _pair(**over):
    kw = dict(NANO, **over)
    jm = JaxModel(JaxConfig(**kw), seed=0)
    jm.params["lora"] = _moved(jm.params["lora"])
    cfg = DeSTA25Config(**kw)
    tm = DeSTA25AudioModel(cfg, device="cpu", params=bridge.from_jax_params(
        jax.tree.map(np.asarray, jm.params), cfg, "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    paths = []
    for i in range(2):
        t = np.arange(12000) / 16000.0
        sig = (0.5 * np.sin(2 * np.pi * (300 + 80 * i) * t)
               * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
        paths.append(str(d / f"w{i}.wav"))
        write_wav(paths[-1], sig)
    return paths


def _msgs(path, i):
    return [{"role": "user", "content": f"Describe sound {i}: <|AUDIO|>",
             "audios": [{"audio": path, "text": f"tone {i}"}]}]


# -- the delta and the forward ------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_lora_delta_matches_jax(scale):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    lp = {"a": rng.standard_normal((32, 4)).astype(np.float32),
          "b": rng.standard_normal((4, 16)).astype(np.float32)}
    want = jllm._lora_delta(jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                            scale=scale)
    got = tllm._lora_delta(torch.as_tensor(x),
                           {k: torch.as_tensor(v) for k, v in lp.items()},
                           scale)
    # products of N(0, 1) values reach ~60: the bound scales with the output
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= TOL_F32 * np.abs(want).max()
    # without a generator the dropout rate is ignored (eval)
    got_eval = tllm._lora_delta(torch.as_tensor(x),
                                {k: torch.as_tensor(v) for k, v in
                                 lp.items()}, scale, dropout=0.5)
    assert torch.equal(got_eval, got)


@pytest.mark.parametrize("path", ["cacheless", "prefill_then_step"])
def test_llm_apply_with_lora_matches_jax(models, path):
    jm, tm = models
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 500, size=(2, 6))
    jp, tp = jm.params["llm"], tm.params["llm"]
    jl, tl = jm.params["lora"], tm.params["lora"]
    cfg = jm.llm_cfg
    if path == "cacheless":
        want, _, _ = jllm.llm_apply(jp, cfg, input_ids=jnp.asarray(
            ids, jnp.int32), lora=jl, lora_scale=SCALE)
        got, _ = tllm.llm_apply(tp, tm.llm_cfg, input_ids=torch.as_tensor(
            ids), lora=tl, lora_scale=SCALE)
        base, _ = tllm.llm_apply(tp, tm.llm_cfg,
                                 input_ids=torch.as_tensor(ids))
        assert float((base - got).abs().max()) > 1e-3   # B is not zero
    else:
        S = 16
        jc = jllm.init_kv_cache(cfg, 2, S, jnp.float32)
        tc = tllm.init_kv_cache(tm.llm_cfg, 2, S, torch.float32, "cpu")
        mask = np.zeros((2, S), np.int32)
        mask[:, :7] = 1
        _, jc, _ = jllm.llm_apply(jp, cfg, input_ids=jnp.asarray(
            ids, jnp.int32), attention_mask=jnp.asarray(mask), cache=jc,
            cache_index=0, lora=jl, lora_scale=SCALE)
        _, tc = tllm.llm_apply(tp, tm.llm_cfg, input_ids=torch.as_tensor(ids),
                               attention_mask=torch.as_tensor(mask),
                               cache=tc, cache_index=0, lora=tl,
                               lora_scale=SCALE)
        nxt = ids[:, -1:]
        want, _, _ = jllm.llm_apply(jp, cfg, input_ids=jnp.asarray(
            nxt, jnp.int32), attention_mask=jnp.asarray(mask), cache=jc,
            cache_index=6, lora=jl, lora_scale=SCALE)
        _build.reset_launch_counts()
        got, _ = tllm.llm_apply(tp, tm.llm_cfg, input_ids=torch.as_tensor(nxt),
                                attention_mask=torch.as_tensor(mask),
                                cache=tc, cache_index=6, lora=tl,
                                lora_scale=SCALE)
        # the layer loop by rule: no fallback is counted
        assert not set(_build.fallback_counts()) & set(LLM_KERNELS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_F32)


def test_lora_dropout_statistics_and_seeds(models):
    """Dropout needs a seed (no seed: eval, equal to dropout 0); one seed
    gives one output, another seed another; the inverted scaling keeps the
    mean."""
    _, tm = models
    ids = torch.as_tensor(np.random.default_rng(2).integers(2, 500, (2, 6)))
    run = lambda **kw: tllm.llm_apply(  # noqa: E731
        tm.params["llm"], tm.llm_cfg, input_ids=ids, lora=tm.params["lora"],
        lora_scale=SCALE, **kw)[0]
    ref = run()
    assert torch.equal(run(lora_dropout=0.5), ref)
    a, b = run(lora_dropout=0.5, lora_seed=3), run(lora_dropout=0.5,
                                                   lora_seed=3)
    assert torch.equal(a, b)
    assert not torch.allclose(a, ref, atol=1e-4)
    assert not torch.allclose(a, run(lora_dropout=0.5, lora_seed=4),
                              atol=1e-4)
    rng = np.random.default_rng(3)
    xs = torch.as_tensor(rng.standard_normal((512, 32)).astype(np.float32))
    lp = {"a": torch.as_tensor(rng.standard_normal((32, 4)), dtype=torch.float32),
          "b": torch.as_tensor(rng.standard_normal((4, 16)), dtype=torch.float32)}
    base = tllm._lora_delta(xs, lp, 1.0)
    d = tllm._lora_delta(xs, lp, 1.0, 0.5, torch.Generator().manual_seed(0))
    assert not torch.allclose(d, base)
    assert abs(float(d.mean() - base.mean())) < 0.25 * (
        abs(float(base.mean())) + 1.0)


def test_remat_dropout_gradient_equals_plain(models):
    """The layer's dropout generator is seeded inside the layer from (seed,
    layer), so the recompute under ``remat`` draws the forward's masks: the
    adapters' gradients with and without remat are equal."""
    _, tm = models
    ids = torch.as_tensor(np.random.default_rng(4).integers(2, 500, (2, 8)))

    def grads(remat):
        lora = {"layers": {t: {k: v.detach().clone().requires_grad_(True)
                               for k, v in ab.items()}
                           for t, ab in tm.params["lora"]["layers"].items()}}
        logits, _ = tllm.llm_apply(tm.params["llm"], tm.llm_cfg,
                                   input_ids=ids, lora=lora,
                                   lora_scale=SCALE, lora_dropout=0.5,
                                   lora_seed=11, remat=remat)
        leaves = topt.flatten_tree(lora)
        g = torch.autograd.grad(logits.square().mean(), list(leaves.values()))
        return dict(zip(leaves, g))

    plain, rem = grads(False), grads(True)
    for k in plain:
        assert float(plain[k].abs().max()) > 0, k
        torch.testing.assert_close(rem[k], plain[k], rtol=0, atol=0)


# -- training -----------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    os.makedirs(root / "clips")
    rows = []
    for i in range(6):
        t = np.arange(8000) / 16000.0
        rel = f"clips/a{i}.wav"
        write_wav(str(root / rel), (0.4 * np.sin(
            2 * np.pi * (200 + 40 * i) * t)).astype(np.float32))
        rows.append({"id": rel, "dataset": "synthetic",
                     "prompt": f"Describe sound {i} <|AUDIO|>",
                     "response": f"tone {i}"})
    manifest = root / "train.jsonl"
    with open(manifest, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(manifest), str(root)


class _Recording:
    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads.append({k: g.clone() for k, g in grads.items()})
        return self.tx.update(grads, state, params)


def test_nano_lora_train_step_matches_jax(models, corpus):
    """Two steps of the JAX train step and the port's (remat on) on one
    collated batch at dropout 0: loss and grad_norm within 1e-4 rel; every
    adapter gradient element within 1e-5 of the step's largest."""
    import optax
    jm, tm = models
    manifest, root = corpus
    kw = dict(manifest_filepaths=[manifest], data_root=root, batch_size=2,
              max_seq_length=96, num_audio_samples=48000, trans_max_tokens=8)
    jds = jdata.AudioTextDataset(jm.config, jdata.DataConfig(**kw),
                                 jm.tokenizer, shard_by_process=False)
    batch = jdata.CollateFn(jm.config, jdata.DataConfig(**kw), jm.tokenizer)(
        list(jds.iter_valid())[:2])
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=20)

    inner = jopt.make_optimizer(jopt.OptimizerConfig(**okw))

    def update(grads, state, params=None):
        updates, new = inner.update(grads, state[0], params)
        return updates, (new, grads)

    tx = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    jtr, jfr = jm.split_params()
    jtr = jax.tree.map(jnp.array, jtr)        # the step donates its inputs
    assert "lora" in jtr
    st = tx.init(jtr)
    step = jstep.make_train_step(jm.config, tx, remat=False)
    db = {k: jnp.asarray(v) for k, v in batch.items()
          if isinstance(v, np.ndarray)}
    jms, jgrads = [], []
    for _ in range(2):
        jtr, st, m = step(jtr, jfr, st, db)
        jms.append({k: float(v) for k, v in m.items()})
        jgrads.append(jax.tree.map(np.array, st[1]["lora"]))

    # a model of its own: the step updates the trainable leaves in place
    tm = DeSTA25AudioModel(tm.config, device="cpu",
                           params=bridge.from_jax_params(
                               jax.tree.map(np.asarray, jm.params),
                               tm.config, "cpu"))
    ttx = _Recording(topt.make_optimizer(topt.OptimizerConfig(**okw)))
    ttr, tfr = tm.split_params()
    for t in topt.flatten_tree(ttr).values():
        t.requires_grad_(True)
    tst = ttx.init(topt.flatten_tree(ttr))
    tstep_fn = tstep.make_train_step(tm.config, ttx, remat=True)
    tlay = tstep.TrainLayout(None, tfr, tm.config)
    tb = {k: (torch.as_tensor(v) if v.dtype.kind == "f"
              else torch.as_tensor(v).long())
          for k, v in batch.items() if isinstance(v, np.ndarray)}
    tms = []
    for _ in range(2):
        ttr, tst, m = tstep_fn(ttr, tlay, tst, tb)
        tms.append({k: float(v) for k, v in m.items()})
    for j, t in zip(jms, tms):
        for k in ("lm_loss", "loss", "grad_norm"):
            assert abs(t[k] - j[k]) <= 1e-4 * abs(j[k]), (k, t[k], j[k])
    for jg, pg in zip(jgrads, ttx.grads):
        want = {f"lora/layers/{t}/{ab}": torch.as_tensor(jg["layers"][t][ab])
                for t in ("q", "k", "v") for ab in ("a", "b")}
        top = max(float(w.abs().max()) for w in want.values())
        assert top > 0
        for k, w in want.items():
            assert float((pg[k] - w).abs().max()) <= 1e-5 * top, k


def test_trainer_with_lora_and_prefetch_moves_b(corpus, tmp_path):
    """The port's trainer with LoRA (dropout 0.1, a seed a step) and the
    prefetching loader: the adapters train with the connector (B leaves
    zero) and evaluate() generates with them."""
    manifest, root = corpus
    cfg = DeSTA25Config(**dict(NANO, lora_dropout=0.1))
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    assert float(model.params["lora"]["layers"]["q"]["b"].abs().max()) == 0
    assert "lora" in model.trainable_keys()
    dcfg = DataConfig(manifest_filepaths=[manifest], data_root=root,
                      batch_size=2, max_seq_length=64,
                      num_audio_samples=16000, trans_max_tokens=8,
                      shuffle=False)
    ds = AudioTextDataset(cfg, dcfg, model.tokenizer)
    tr = DeSTA25Trainer(
        model, ds, ds, CollateFn(cfg, dcfg, model.tokenizer),
        topt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10),
        TrainerConfig(exp_dir=str(tmp_path / "exp"), max_steps=2,
                      eval_before_train=False, val_check_interval=1e9,
                      eval_max_batches=1, eval_max_new_tokens=2,
                      num_workers=2, remat=True, keep_checkpoints=1))
    tr.train()
    assert tr.global_step == 2
    b = model.params["lora"]["layers"]["q"]["b"]
    assert float(b.detach().abs().max()) > 0
    report = tr.evaluate(tag="lora")
    assert np.isfinite(report["loss"])


# -- generate -----------------------------------------------------------------

@pytest.mark.parametrize("llm", ["bfloat16", "int8"])
def test_greedy_generate_ids_match_jax(wavs, llm, monkeypatch):
    over = dict(dtype="bfloat16")
    if llm == "int8":
        from test_torch_int8_llm import jax_tpu_dispatch
        hits = jax_tpu_dispatch(monkeypatch)
        over.update(llm_model_id="test/llama-nano128", llm_quant="int8")
    try:
        jm, tm = _pair(**over)
        if llm == "int8":
            assert is_quantized(tm.params["llm"]["layers"]["wqkv"])
        msgs = [_msgs(wavs[0], 0), _msgs(wavs[1], 1)]
        # the JAX int8 side runs K7 in interpret mode: few decode steps
        new = 3 if llm == "int8" else 5
        want = jm.generate(msgs, max_new_tokens=new, do_sample=False)
        _build.reset_launch_counts()
        got = tm.generate(msgs, max_new_tokens=new, do_sample=False)
        assert got.generated_ids == want.generated_ids
        assert got.text == want.text
        # the layer loop by rule: no decode-step fallback is counted
        assert not set(_build.fallback_counts()) & set(LLM_KERNELS)
        if llm == "int8":
            assert hits["qmm"] > 0
    finally:
        jax.clear_caches()


def test_speculation_is_refused_under_lora(models, wavs):
    _, tm = models
    msgs = _msgs(wavs[0], 0)
    plain = tm.generate(msgs, max_new_tokens=5, do_sample=False)
    spec = tm.generate(msgs, max_new_tokens=5, do_sample=False,
                       speculative_k=4)
    assert spec.generated_ids == plain.generated_ids
    assert tm.last_spec_fallback and "LoRA" in tm.last_spec_fallback[0]


# -- merging and checkpoints --------------------------------------------------

def test_merge_lora_matches_jax_and_keeps_ids(models, wavs):
    jm, tm = models
    want = bridge.llm_from_jax(jax.tree.map(np.asarray, jllm.merge_lora(
        jm.params["llm"], jm.params["lora"], SCALE)), "cpu")
    got = tllm.merge_lora(tm.params["llm"], tm.params["lora"], SCALE)
    torch.testing.assert_close(got["layers"]["wqkv"],
                               want["layers"]["wqkv"], rtol=0,
                               atol=TOL_MERGE)
    assert got["layers"]["wo"] is tm.params["llm"]["layers"]["wo"]
    # the merged tree without adapters decodes the adapter model's ids
    cfg = DeSTA25Config(**NANO)
    m = DeSTA25AudioModel(cfg, device="cpu", params=dict(tm.params))
    msgs = [_msgs(wavs[0], 0), _msgs(wavs[1], 1)]
    ref = m.generate(msgs, max_new_tokens=6, do_sample=False)
    m.merge_lora_for_serving(quantize=False)
    assert "lora" not in m.params
    assert m.generate(msgs, max_new_tokens=6,
                      do_sample=False).generated_ids == ref.generated_ids
    # merge, then quantize: int8 leaves, the fused step takes the decode
    m2 = DeSTA25AudioModel(cfg, device="cpu", params=dict(tm.params))
    m2.merge_lora_for_serving(quantize=True)
    assert is_quantized(m2.params["llm"]["layers"]["wqkv"])
    assert m2.config.llm_quant == "int8" and "lora" not in m2.params
    out = m2.generate(msgs, max_new_tokens=4, do_sample=False)
    assert np.asarray(out.generated_ids).shape == (2, 4)


def test_failed_merge_keeps_the_adapters():
    cfg = DeSTA25Config(**dict(NANO, llm_quant="int8"))
    m = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="merge first"):
        m.merge_lora_for_serving(quantize=False)
    assert "lora" in m.params


def test_lora_draw_leaves_the_seed_tree():
    """The adapters come last, from their own generator: the rest of a
    seed's tree is the one drawn without LoRA."""
    a = DeSTA25AudioModel(DeSTA25Config(**NANO), device="cpu", seed=5)
    b = DeSTA25AudioModel(DeSTA25Config(**dict(NANO, use_lora=False)),
                          device="cpu", seed=5)
    fa, fb = topt.flatten_tree(a.params), topt.flatten_tree(b.params)
    assert set(fa) - set(fb) == {f"lora/layers/{t}/{ab}" for t in "qkv"
                                 for ab in "ab"}
    for k, v in fb.items():
        assert torch.equal(fa[k], v), k


def test_lora_io_round_trips_jax_keys(models, tmp_path):
    jm, tm = models
    want = jlora_io.lora_to_ref(jm.params["lora"], jm.config)
    got = tlora_io.lora_to_ref(tm.params["lora"], tm.config)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    back = tlora_io.lora_from_ref(tm.params["lora"], {
        k: torch.as_tensor(np.array(v)) for k, v in want.items()})
    for k, v in topt.flatten_tree(back).items():
        assert torch.equal(v, topt.flatten_tree(tm.params["lora"])[k]), k
    # the port's checkpoint: JAX reads its adapters, from_pretrained too
    tm.save_pretrained(str(tmp_path / "ck"))
    jp = jio.load_trainable_safetensors(
        {**jm.params, "lora": jax.tree.map(jnp.zeros_like,
                                           jm.params["lora"])},
        jm.config, str(tmp_path / "ck" / "model.safetensors"))
    for t in ("q", "k", "v"):
        for ab in ("a", "b"):
            np.testing.assert_array_equal(
                np.asarray(jp["lora"]["layers"][t][ab]),
                np.asarray(jm.params["lora"]["layers"][t][ab]))
    loaded = DeSTA25AudioModel.from_pretrained(str(tmp_path / "ck"), "cpu",
                                               seed=3)
    for k, v in topt.flatten_tree(tm.params["lora"]).items():
        assert torch.equal(topt.flatten_tree(loaded.params["lora"])[k], v), k


# -- serving ------------------------------------------------------------------

def test_engine_with_lora_matches_jax_engine(models, wavs, caplog):
    jm, tm = models
    kw = dict(n_slots=2, max_ctx=128, max_new_tokens=5, ctx_bucket=128)
    reqs = [_msgs(p, i) for i, p in enumerate(wavs)] + [_msgs(wavs[0], 2)]

    def drive(cls, model, **extra):
        eng = cls(model, **kw, **extra)
        rids = [eng.submit(m) for m in reqs]
        eng.run_until_done()
        res = eng.results()
        return [res[r] for r in rids], eng

    want, _ = drive(JaxEngine, jm)
    got, eng = drive(ContinuousBatchingEngine, tm)
    assert got == want
    assert eng.graph is None and eng.vgraph is None
    _build.reset_launch_counts()
    with caplog.at_level("WARNING"):
        got_spec, eng = drive(ContinuousBatchingEngine, tm, speculative_k=4)
    assert eng.speculative_k == 0 and "LoRA" in caplog.text
    assert got_spec == want
    assert not set(_build.fallback_counts()) & set(LLM_KERNELS)


def test_lora_under_a_cpu_mesh_matches_unsharded(models):
    """Two model ranks on the CPU: each rank adds its heads' columns of the
    deltas; prefill logits and a cached step within 1e-5 of the unsharded
    forward."""
    _, tm = models
    cfg = tm.llm_cfg
    ids = torch.as_tensor(np.random.default_rng(5).integers(2, 500, (2, 6)))
    mask = torch.zeros(2, 16, dtype=torch.int32)
    mask[:, :7] = 1
    lora = dict(lora=tm.params["lora"], lora_scale=SCALE)

    def run(params, cache):
        a, cache = tllm.llm_apply(params, cfg, input_ids=ids,
                                  attention_mask=mask, cache=cache,
                                  cache_index=0, **lora)
        b, _ = tllm.llm_apply(params, cfg, input_ids=ids[:, -1:],
                              attention_mask=mask, cache=cache,
                              cache_index=6, **lora)
        return a, b

    want = run(tm.params["llm"], tllm.init_kv_cache(cfg, 2, 16,
                                                    torch.float32, "cpu"))
    from desta25_audio_tpu_torch.parallel.sharding import apply_llm_sharding
    mesh = make_mesh(n_model=2, devices=["cpu"] * 2)
    sharded = apply_llm_sharding(tm.params["llm"], cfg, mesh)
    with use_mesh(mesh):
        got = run(sharded, tllm.init_kv_cache(cfg, 2, 16, torch.float32,
                                              "cpu"))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL_F32)
