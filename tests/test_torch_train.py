"""The port's training slice against the JAX package on the CPU, and the
port's trainer on its own.

- ``masked_lm_loss`` and the chunked CE against JAX (1e-6 rel).
- The port's clip + Adafactor + schedule (and ``MultiSteps(2)``) against
  optax over 5 steps, factored and unfactored leaves (1e-6 rel).
- ``CollateFn`` against the JAX collate on a tiny WAV corpus (equal).
- The nano train step: f32 nano towers at ``max_seq_length=512``, so both
  sides take K11 (JAX: the library flash kernel in TPU interpret mode;
  port: its plain version): loss and ``grad_norm`` within 1e-4 rel for 3
  steps; every gradient element on equal parameters within 1e-6 of the
  step's largest; every trainable leaf after 3 steps within 1e-4 of its
  scale, where an element whose JAX gradient lies within the sides'
  disagreement of zero is bounded by 2 * lr per step instead; bf16: loss
  within 2e-2.
- The trainer: loss decreases and eval writes its report, a checkpoint
  round trip resumes, the OOM back-off, the CLI, and the refusals (ORCA and
  the int8 tower train: ``tests/test_torch_train_orca.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.data import dataset as jdata
from desta25_audio_tpu.ops import attention as jatt
from desta25_audio_tpu.train import losses as jlosses
from desta25_audio_tpu.train import optimizer as jopt
from desta25_audio_tpu.train import step as jstep
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.data import dataset as tdata
from desta25_audio_tpu_torch.ops import attention as tatt
from desta25_audio_tpu_torch.train import losses as tlosses
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train import step as tstep
from desta25_audio_tpu_torch.train.trainer import (
    DeSTA25Trainer,
    TrainerConfig,
)

NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32")
# a key bias shifts every score of a query row alike, so softmax cancels it:
# its gradient is zero in exact arithmetic and Adafactor normalises
# rounding noise into its update (see test_nano_train_step_matches_jax)
KEY_BIASES = ("qformer/layers/self/k/b", "qformer/layers/cross/k/b")
# a gradient element this far below the step's largest one is rounding noise
NOISE = 1e-6
# the gradients of one batch on equal parameters: max |port - JAX| over the
# step's largest element (4.1e-7 here)
GRAD_TOL = 1e-6
# an element is free when its JAX gradient is within FREE_K times its leaf's
# disagreement of zero; at most FREE_SHARE of the elements may be free
FREE_K = 2.0
FREE_SHARE = 0.025
# the most one Adafactor step moves an element, per unit of lr: every nano
# leaf is unfactored, where |u| <= (1 - beta2_t)^-1/2, 1.55 at step 2
STEP_BOUND = 2.0


def _recording(tx):
    """An optax transformation that keeps the gradients of its last update
    in its state: (inner state, gradients)."""

    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


class _Recording:
    """The port's optimizer, recording the gradients it is given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads.append({k.removeprefix("connector/"): g.clone()
                           for k, g in grads.items()})
        return self.tx.update(grads, state, params)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    os.makedirs(root / "clips")
    rows = []
    for i in range(12):
        t = np.arange(8000) / 16000.0
        sig = (0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(
            np.float32)
        rel = f"clips/a{i}.wav"
        write_wav(str(root / rel), sig)
        rows.append({"id": rel, "dataset": "synthetic",
                     "prompt": f"Describe sound {i} <|AUDIO|>",
                     "response": f"tone {i}"})
    # skipped with reasons, not fatal: a missing file and an empty prompt
    rows.append({"id": "clips/missing.wav", "prompt": "x <|AUDIO|>",
                 "response": "y"})
    rows.append({"id": rows[0]["id"], "prompt": "", "response": "y"})
    manifest = root / "train.jsonl"
    with open(manifest, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(manifest), str(root)


def _data_kwargs(corpus, **kw):
    manifest, root = corpus
    return dict(dict(manifest_filepaths=[manifest], data_root=root,
                     batch_size=4, max_seq_length=96,
                     num_audio_samples=48000, trans_max_tokens=8), **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


# -- losses ------------------------------------------------------------------

def test_masked_lm_losses_match_jax():
    from desta25_audio_tpu.config import llm_config_for
    from desta25_audio_tpu.models import llm as jllm
    cfg = llm_config_for("test/llama-nano")
    jp = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = bridge.llm_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    B, T = 3, 150                                  # not a multiple of 64
    labels = rng.integers(0, cfg.vocab_size, (B, T))
    labels[rng.random((B, T)) < 0.4] = -100
    logits = rng.standard_normal((B, T, cfg.vocab_size)).astype(np.float32)
    hidden = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    want = jlosses.masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tlosses.masked_lm_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    want_c = jlosses.masked_lm_loss_chunked(jp, cfg, jnp.asarray(hidden),
                                            jnp.asarray(labels))
    got_c = tlosses.masked_lm_loss_chunked(tp, cfg, torch.from_numpy(hidden),
                                           torch.from_numpy(labels))
    for g, w in ((got, want), (got_c, want_c)):
        assert int(g["n_tokens"]) == int(w["n_tokens"])
        for k in ("lm_loss", "ppl"):
            assert _rel(g[k], w[k]) <= 1e-6


def test_aux_losses_match_jax():
    rng = np.random.default_rng(4)
    tok = rng.standard_normal((3, 8, 32)).astype(np.float32)
    loc = rng.standard_normal((3, 150, 32)).astype(np.float32)
    trans, tgt = (rng.standard_normal((3, 32)).astype(np.float32)
                  for _ in range(2))
    layer = rng.random(4).astype(np.float32)
    kw = dict(NANO, orca_enabled=True, orca_ortho_diversity_weight=0.3,
              orca_align_weight_local=0.7, orca_ortho_weight_qformer_local=2.0)
    jc, tc = JaxConfig(**kw), DeSTA25Config(**kw)
    j, t = jnp.asarray, torch.from_numpy
    want = {**jlosses.qformer_aux_losses(jc, j(tok), j(trans), j(tgt)),
            **{f"orca/{k}": v for k, v in jlosses.orca_aux_losses(
                jc, j(tok), j(loc), j(layer)).items()}}
    got = {**tlosses.qformer_aux_losses(tc, t(tok), t(trans), t(tgt)),
           **{f"orca/{k}": v for k, v in tlosses.orca_aux_losses(
               tc, t(tok), t(loc), t(layer)).items()}}
    assert sorted(got) == sorted(want) and len(got) == 9
    # the cosine-type terms are sums of f32 products of unit vectors, which
    # the two sides add in another order: a cosine near 0 (sim_trans here
    # is 0.0125) keeps that rounding (1.6e-8 seen) as a relative error past
    # 1e-6, so they are held to an absolute error on the scale of their
    # [-1, 1] range instead
    cosine = ("sim_trans", "sim_target", "L_align", "L_align_contrastive",
              "L_align_target")
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        if k in cosine:
            assert np.abs(g - w).max() <= 1e-6 * max(1.0, np.abs(w).max()), k
        else:
            assert _rel(got[k], want[k]) <= 1e-6, k
    lm = np.float32(2.5)
    assert _rel(tlosses.total_loss_from_dict(torch.tensor(lm), got),
                jlosses.total_loss_from_dict(jnp.asarray(lm), want)) <= 1e-6


# -- optimizer ----------------------------------------------------------------

LEAVES = {"a": (256, 384), "b": (3, 128, 64), "c": (64,), "d": (5, 7),
          "e": (2, 128, 160)}


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_adafactor_matches_optax(accumulate, schedule):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6,
              accumulate_grad_batches=accumulate)
    jtx = jopt.make_optimizer(jopt.OptimizerConfig(schedule=schedule, **kw))
    ttx = topt.make_optimizer(topt.OptimizerConfig(schedule=schedule, **kw))
    rng = np.random.default_rng(accumulate)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in LEAVES.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    jupdate = jax.jit(jtx.update)
    assert topt.factored_dims(LEAVES["a"]) == (0, 1)
    assert topt.factored_dims(LEAVES["e"]) == (1, 2)
    assert topt.factored_dims(LEAVES["b"]) is None
    for step in range(5 * accumulate):
        # steps 0 and 3 clip by the global norm, the others do not
        s = 10.0 if step % 3 == 0 else 1e-2
        grads = {k: (s * rng.standard_normal(v)).astype(np.float32)
                 for k, v in LEAVES.items()}
        ju, jstate = jupdate({k: jnp.asarray(g) for k, g in grads.items()},
                             jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = ttx.update({k: torch.from_numpy(g)
                                 for k, g in grads.items()}, tstate, tp)
        topt.apply_updates(tp, tu)
        for k in LEAVES:
            if np.abs(np.asarray(ju[k])).max() > 0:
                assert _rel(tu[k], ju[k]) <= 1e-6, (step, k)
            else:
                assert float(tu[k].abs().max()) == 0.0, (step, k)
            assert _rel(tp[k], jp[k]) <= 1e-6, (step, k)


def test_schedule_matches_optax():
    for sched in ("linear", "cosine", "constant"):
        kw = dict(lr=3e-4, warmup_steps=5, total_steps=20, schedule=sched)
        want = jopt.make_schedule(jopt.OptimizerConfig(**kw))
        got = topt.make_schedule(topt.OptimizerConfig(**kw))
        for c in (0, 1, 4, 5, 6, 13, 20, 25):
            assert abs(got(c) - float(want(c))) <= 1e-6 * 3e-4, (sched, c)
    assert got(0) == 0.0            # the first update has lr 0


# -- data ---------------------------------------------------------------------

def test_collate_matches_jax(corpus):
    jm = JaxModel(JaxConfig(**NANO), seed=0)
    cfg = DeSTA25Config(**NANO)
    tm = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    kw = _data_kwargs(corpus)
    jds = jdata.AudioTextDataset(jm.config, jdata.DataConfig(**kw),
                                 jm.tokenizer, shard_by_process=False)
    tds = tdata.AudioTextDataset(cfg, tdata.DataConfig(**kw), tm.tokenizer)
    titems, jitems = list(tds.iter_valid()), list(jds.iter_valid())
    assert len(titems) == 12 and tds.skip_reasons == jds.skip_reasons
    jb = jdata.CollateFn(jm.config, jdata.DataConfig(**kw), jm.tokenizer)(
        jitems[:4])
    tb = tdata.CollateFn(cfg, tdata.DataConfig(**kw), tm.tokenizer)(
        titems[:4])
    assert sorted(jb) == sorted(tb)
    for k, v in jb.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == tb[k].dtype, k
            np.testing.assert_array_equal(tb[k], v, err_msg=k)
        else:
            assert tb[k] == v, k


# -- the nano train step against JAX's make_train_step -------------------------

def _step_pair(corpus, dtype, monkeypatch, max_seq_length=512, **extra):
    """Three train steps of the JAX package (K11 in interpret mode) and of
    the port (remat on) on the same collated batch and bridged params, with
    ``extra`` config fields.  Returns (JAX metrics, port metrics, JAX
    trainable, port trainable, JAX connector before the steps, the
    connector gradients of each step on each side as (JAX, port), K11 uses
    on each side)."""
    nano = dict(NANO, dtype=dtype, **extra)
    kw = _data_kwargs(corpus, batch_size=2, max_seq_length=max_seq_length)
    jm = JaxModel(JaxConfig(**nano), seed=0)
    init = jax.tree.map(np.array, jm.params["connector"])  # steps donate it
    cfg = DeSTA25Config(**nano)
    tm = DeSTA25AudioModel(cfg, device="cpu", params=bridge.from_jax_params(
        jax.tree.map(np.asarray, jm.params), cfg, "cpu"))
    jds = jdata.AudioTextDataset(jm.config, jdata.DataConfig(**kw),
                                 jm.tokenizer, shard_by_process=False)
    batch = jdata.CollateFn(jm.config, jdata.DataConfig(**kw), jm.tokenizer)(
        list(jds.iter_valid())[:2])
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=20)

    uses = {"jax": 0, "port": 0}
    flash = jatt._flash
    monkeypatch.setattr(jatt, "_flash_available", lambda: True)
    monkeypatch.setattr(jatt, "_flash", lambda: uses.update(
        jax=uses["jax"] + 1) or flash())
    tflash = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention", lambda *a: uses.update(
        port=uses["port"] + 1) or tflash(*a))
    jax.clear_caches()
    try:
        with pltpu.force_tpu_interpret_mode():
            tx = _recording(jopt.make_optimizer(jopt.OptimizerConfig(**okw)))
            jtr, jfr = jm.split_params()
            st = tx.init(jtr)
            # interpret-mode Pallas cannot run under jax.checkpoint
            step = jstep.make_train_step(jm.config, tx, remat=False)
            db = {k: jnp.asarray(v) for k, v in batch.items()
                  if isinstance(v, np.ndarray)}
            jms, jgrads = [], []
            for _ in range(3):
                jtr, st, m = step(jtr, jfr, st, db)
                jms.append({k: float(v) for k, v in m.items()})
                jgrads.append(jax.tree.map(np.array, st[1]["connector"]))
            jtr = jax.tree.map(np.asarray, jtr)
    finally:
        jax.clear_caches()

    ttx = _Recording(topt.make_optimizer(topt.OptimizerConfig(**okw)))

    ttr, tfr = tm.split_params()
    for t in topt.flatten_tree(ttr).values():
        t.requires_grad_(True)
    tst = ttx.init(topt.flatten_tree(ttr))
    tstep_fn = tstep.make_train_step(cfg, ttx, remat=True)
    tlay = tstep.TrainLayout(None, tfr, cfg)
    tb = {k: (torch.as_tensor(v) if v.dtype.kind == "f"
              else torch.as_tensor(v).long())
          for k, v in batch.items() if isinstance(v, np.ndarray)}
    tms = []
    for _ in range(3):
        ttr, tst, m = tstep_fn(ttr, tlay, tst, tb)
        tms.append({k: float(v) for k, v in m.items()})
    return jms, tms, jtr, ttr, init, (jgrads, ttx.grads), uses


def test_nano_train_step_matches_jax(corpus, monkeypatch):
    jms, tms, jtr, ttr, init, (jgrads, pgrads), uses = _step_pair(
        corpus, "float32", monkeypatch)
    assert uses["jax"] > 0 and uses["port"] > 0     # both took K11
    for j, t in zip(jms, tms):
        for k in ("lm_loss", "loss", "grad_norm"):
            assert abs(t[k] - j[k]) <= 1e-4 * abs(j[k]), (k, t[k], j[k])
        assert t["n_tokens"] == j["n_tokens"]
    assert jms[2]["lm_loss"] < jms[0]["lm_loss"]
    assert tms[0]["lm_loss"] == tms[1]["lm_loss"]   # lr 0 at count 0

    sched = topt.make_schedule(topt.OptimizerConfig(
        lr=1e-3, warmup_steps=2, total_steps=20))
    want = topt.flatten_tree(bridge.connector_from_jax(jtr["connector"],
                                                       "cpu"))
    got = topt.flatten_tree(ttr["connector"])
    init = topt.flatten_tree(bridge.connector_from_jax(init, "cpu"))
    jgrads = [topt.flatten_tree(bridge.connector_from_jax(g, "cpu"))
              for g in jgrads]
    tops = [max(float(g.abs().max()) for g in jg.values()) for jg in jgrads]
    # each leaf's largest gradient disagreement at each step
    gerr = [{k: float((pg[k] - jg[k]).abs().max()) for k in want}
            for jg, pg in zip(jgrads, pgrads)]
    # Steps 0 and 1 run on the same parameters on both sides (lr 0 at
    # count 0): every gradient element of every leaf agrees.
    for c in (0, 1):
        assert max(gerr[c].values()) <= GRAD_TOL * tops[c], (c, gerr[c])
    # A key bias shifts every score of a query row alike: its gradient is
    # rounding noise on both sides.
    for k in KEY_BIASES:
        for jg, pg, top in zip(jgrads, pgrads, tops):
            assert float(jg[k].abs().max()) <= NOISE * top, k
            assert float(pg[k].abs().max()) <= NOISE * top, k

    # Adafactor's first updates are about sign(g) * lr per element, so an
    # element whose JAX gradient at a step with lr > 0 is within FREE_K
    # times its leaf's disagreement at that step (or NOISE of the step's
    # largest element) of zero takes a step of undetermined size and sign:
    # such a free element is only bounded, by STEP_BOUND * lr per step on
    # both sides.  Every other element must agree.  After the first update
    # the sides differ by the free elements' steps, so the gradients of step
    # 2 differ more than those of steps 0 and 1 (up to 1.4e-4 of the
    # largest element here, in the FFN's output weight).
    lr_sum = sum(sched(c) for c in range(3))
    n_free = n_all = 0
    for k, w in want.items():
        free = torch.zeros_like(w, dtype=torch.bool)
        for c, jg in enumerate(jgrads):
            if sched(c) > 0:
                free |= jg[k].abs() <= FREE_K * max(gerr[c][k],
                                                     NOISE * tops[c])
        d = torch.where(free, 0.0, (got[k].detach() - w).abs())
        assert float(d.max()) <= 1e-4 * float(w.abs().max()), k
        for side in (got[k].detach(), w):
            moved = torch.where(free, (side - init[k]).abs(), 0.0)
            assert float(moved.max()) <= STEP_BOUND * lr_sum, k
        if k in KEY_BIASES:
            assert bool(free.all()), k
        else:
            n_free += int(free.sum())
            n_all += w.numel()
    assert n_free <= FREE_SHARE * n_all, (n_free, n_all)     # 1.95 % here


def test_nano_qformer_ablation_step_matches_jax(corpus, monkeypatch):
    """The Q-Former ablation (``qformer_1`` with ``orca_enabled``) trains
    with its aux losses, as JAX's ``make_train_step`` does; T = 96 takes the
    masked attention path on both sides."""
    aux = ("L_ortho_diversity", "L_align", "L_align_contrastive",
           "L_align_target", "sim_trans", "sim_target")
    jms, tms, *_, uses = _step_pair(
        corpus, "float32", monkeypatch, max_seq_length=96, orca_enabled=True,
        orca_ortho_diversity_weight=0.3, orca_align_weight_local=0.7)
    assert uses == {"jax": 0, "port": 0}
    for j, t in zip(jms, tms):
        assert sorted(t) == sorted(j)
        assert all(k in t for k in aux), sorted(t)
        for k in ("lm_loss", "loss", "grad_norm") + aux:
            assert abs(t[k] - j[k]) <= 1e-4 * abs(j[k]), (k, t[k], j[k])
        assert t["loss"] > t["lm_loss"]          # the aux losses count
    assert tms[0]["loss"] == tms[1]["loss"]      # lr 0 at count 0


def test_nano_train_step_bf16_matches_jax(corpus, monkeypatch):
    jms, tms, *_, uses = _step_pair(corpus, "bfloat16", monkeypatch)
    assert uses["jax"] > 0 and uses["port"] > 0
    for j, t in zip(jms, tms):
        assert abs(t["lm_loss"] - j["lm_loss"]) <= 2e-2, (t, j)


# -- the port's trainer --------------------------------------------------------

def _trainer(corpus, tmp_path, data_kw=None, **tkw):
    cfg = DeSTA25Config(**NANO)
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    dcfg = tdata.DataConfig(**_data_kwargs(corpus, **(data_kw or {})))
    ds = tdata.AudioTextDataset(cfg, dcfg, model.tokenizer)
    collate = tdata.CollateFn(cfg, dcfg, model.tokenizer)
    tcfg = TrainerConfig(**dict(dict(
        exp_dir=str(tmp_path / "exp"), max_epochs=1, log_every_n_steps=1,
        eval_max_new_tokens=4, eval_before_train=False,
        val_check_interval=1e9, eval_max_batches=1), **tkw))
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    return model, DeSTA25Trainer(model, ds, ds, collate, ocfg, tcfg)


def test_trainer_loss_decreases_and_eval_writes_report(corpus, tmp_path):
    model, trainer = _trainer(corpus, tmp_path, max_epochs=2)
    trainer.train()
    recs = [json.loads(line) for line in
            open(os.path.join(trainer.tcfg.exp_dir, "metrics.jsonl"))]
    losses = [r["train/lm_loss"] for r in recs if "train/lm_loss" in r]
    assert len(losses) == 6
    assert losses[-1] < losses[0], losses
    assert all(r["train/grad_norm"] > 0 for r in recs
               if "train/grad_norm" in r)
    report = trainer.evaluate(tag="final")
    assert report["n_samples"] == 4 and "accuracy/synthetic" in report
    base = os.path.join(trainer.tcfg.exp_dir, "val@final")
    assert len(open(base + ".jsonl").readlines()) == 4
    full = json.load(open(base + "-report.json"))
    assert full["step"] == 6 and full["config"]["connector_mode"] == \
        "qformer_1"
    # frozen towers: no gradient state, untouched by training
    _, frozen = model.split_params()
    assert not any(t.requires_grad or t.grad is not None
                   for t in topt.flatten_tree(frozen).values())


def test_checkpoint_round_trip_resumes(corpus, tmp_path):
    model, trainer = _trainer(corpus, tmp_path, max_steps=2,
                              eval_before_train=True)
    trainer.train()
    exp = trainer.tcfg.exp_dir
    assert trainer.global_step == 2
    assert os.path.exists(os.path.join(exp, "checkpoint-0", "state.pt"))
    assert os.path.exists(os.path.join(exp, "val@initial-report.json"))
    saved = {k: v.detach().clone() for k, v in
             topt.flatten_tree(model.split_params()[0]).items()}

    model2, trainer2 = _trainer(corpus, tmp_path, max_steps=3)
    from desta25_audio_tpu_torch.ckpt.checkpoint import restore_train_state
    tr, st, step = restore_train_state(
        exp, model2.split_params()[0],
        trainer2.optimizer.init(topt.flatten_tree(
            model2.split_params()[0])))
    assert step == 2 and st["count"] == 2
    for k, v in topt.flatten_tree(tr).items():
        assert torch.equal(v, saved[k]), k
    trainer2.train(resume_from_checkpoint=exp)
    assert trainer2.global_step == 3
    assert trainer2.opt_state["count"] == 3
    ckpts = sorted(n for n in os.listdir(exp) if n.startswith("checkpoint-"))
    assert ckpts == ["checkpoint-0", "checkpoint-2", "checkpoint-3",
                     "checkpoint-latest"]


def test_auto_find_batch_size_halves_on_oom(corpus, tmp_path):
    model, trainer = _trainer(corpus, tmp_path, max_steps=2)
    real = trainer.train_step

    def oom_step(trainable, frozen, opt_state, batch):
        if batch["input_ids"].shape[0] > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(trainable, frozen, opt_state, batch)

    trainer.train_step = oom_step
    trainer.train()
    assert trainer.collate_fn.data_cfg.batch_size == 2
    assert trainer.global_step == 2

    model, trainer = _trainer(corpus, tmp_path, max_steps=1,
                              auto_find_batch_size=False)
    trainer.train_step = oom_step
    with pytest.raises(torch.cuda.OutOfMemoryError):
        trainer.train()


def test_cli_trains_the_debug_config(corpus, tmp_path):
    from desta25_audio_tpu_torch.cli.train import apply_overrides, main
    manifest, root = corpus
    exp = tmp_path / "exp"
    main(["--config", "configs/desta25_debug.yaml", "--device", "cpu",
          f"exp_dir={exp}", f"dataset.manifest_filepaths=[{manifest}]",
          f"dataset.data_root={root}", "trainer.max_steps=2"])
    for name in ("config.yaml", "metrics.jsonl", "checkpoint-latest"):
        assert os.path.exists(exp / name), name
    out = apply_overrides({}, ["+dataset=debug", "trainer.max_steps=3"],
                          config_dir="configs")
    assert out["dataset"]["validation_ds"]["max_seq_length"] == 512
    # a warm start reads the donor's model.safetensors, and excludes resume
    with pytest.raises(FileNotFoundError):
        main(["--config", "configs/desta25_debug.yaml", "--device", "cpu",
              f"exp_dir={exp}", f"init_from_pretrained_weights={tmp_path}"])
    with pytest.raises(ValueError, match="Cannot provide both"):
        main(["--config", "configs/desta25_debug.yaml", "--device", "cpu",
              f"exp_dir={exp}", "init_from_pretrained_weights=/x",
              f"resume_from_checkpoint={exp}"])


@pytest.mark.parametrize("what", ["mesh_pipe", "pipeline_microbatches",
                                  "sequence_parallel"])
def test_outside_the_training_slice_raises(corpus, tmp_path, what):
    """The options once outside the training slice train now:
    DeSTA25Trainer and cli/train.py each take a step with ``what`` on a
    mesh of "cpu" ranks, the trainer's loss the one-device trainer's
    (1e-5); what still raises is a bad value (stages that do not divide the
    layers, microbatches that do not divide a data row's rows).
    (num_workers > 0 trains through data/prefetch.PrefetchLoader:
    tests/test_torch_native.py and tests/test_torch_lora.py; a mesh and
    fsdp train: tests/test_torch_train_mesh.py; GPipe and sequence
    parallelism against JAX: tests/test_torch_pipeline.py and
    tests/test_torch_seq_parallel.py)"""
    from desta25_audio_tpu_torch.cli.train import main
    kw, cli, bad = {
        "mesh_pipe": (dict(mesh_pipe=2, mesh_devices=["cpu"] * 2),
                      ["trainer.mesh_pipe=2", "trainer.mesh_devices=[cpu,cpu]"],
                      (dict(mesh_pipe=4, mesh_devices=["cpu"] * 4),
                       "do not split into 4")),
        "pipeline_microbatches": (
            dict(mesh_pipe=2, pipeline_microbatches=2,
                 mesh_devices=["cpu"] * 4),
            ["trainer.mesh_pipe=2", "trainer.pipeline_microbatches=2",
             "trainer.mesh_devices=[cpu,cpu,cpu,cpu]"],
            (dict(mesh_pipe=2, pipeline_microbatches=3,
                  mesh_devices=["cpu"] * 2), "not divisible by n_micro")),
        "sequence_parallel": (
            dict(mesh_model=2, sequence_parallel=True,
                 mesh_devices=["cpu"] * 2),
            ["trainer.mesh_model=2", "trainer.sequence_parallel=true",
             "trainer.mesh_devices=[cpu,cpu]"], None)}[what]
    losses = []
    for name, extra in (("one", {}), ("mesh", dict(mesh="on", **kw))):
        _, trainer = _trainer(corpus, tmp_path / name, max_steps=1, **extra)
        trainer.train()
        recs = [json.loads(line) for line in open(os.path.join(
            trainer.tcfg.exp_dir, "metrics.jsonl"))]
        losses.append([r["train/lm_loss"] for r in recs
                       if "train/lm_loss" in r])
    assert trainer.mesh.n_pipe == kw.get("mesh_pipe", 1)
    assert len(losses[1]) == 1
    assert abs(losses[1][0] - losses[0][0]) <= 1e-5 * abs(losses[0][0])
    manifest, root = corpus
    exp = tmp_path / "cli"
    main(["--config", "configs/desta25_debug.yaml", "--device", "cpu",
          f"exp_dir={exp}", f"dataset.manifest_filepaths=[{manifest}]",
          f"dataset.data_root={root}", "trainer.max_steps=1",
          "trainer.mesh=on"] + cli)
    recs = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert any(np.isfinite(r.get("train/lm_loss", np.nan)) for r in recs)
    if bad is not None:
        _, trainer = _trainer(corpus, tmp_path / "bad", max_steps=1,
                              mesh="on", **bad[0])
        with pytest.raises(ValueError, match=bad[1]):
            trainer.train()
