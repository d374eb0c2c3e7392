"""ORCA training and training through the int8 tower: the port against the
JAX package on the CPU.

- ``make_deep_injection_fn`` layer by layer (hidden and the alignment sums
  within 1e-5), with and without transcription positions, the injection
  tokens with ``orca_global_cross_attn`` on and off.
- The nano ORCA train step against JAX ``make_train_step`` over 3 steps on
  ``test/llama-nano128`` and ``test/qwen3-nano`` (qk-norm under autograd, a
  tied head), B=2, L=48 (the masked attention path), 3 transcription
  positions a row: the loss terms and ``grad_norm`` within 1e-4 rel, the
  gradients of the two steps on equal parameters within GRAD_TOL of the
  step's largest.
- A batch without transcription positions (prompt-only training): the
  alignment term 0, every gradient finite and equal to JAX's.
- Remat on equals remat off (the hook's aux carried through the
  checkpoint, not added again by the recompute).
- The trainer and the CLI on an ORCA config: checkpoint round trip with
  the cross-attention stack, resume, evaluate().
- ``quant_matmul(w8a8=False)`` and its straight-through backward against
  the JAX package on its TPU dispatch (K7 in interpret mode up to 256 rows,
  the dequant dot above), and the nano int8-tower train step against JAX
  (K7, the dequant dot, K11 in interpret mode): loss within 2e-2, no W8A8
  product on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.models import orca as jorca
from desta25_audio_tpu.ops import quant as jq
from desta25_audio_tpu.train import optimizer as jopt
from desta25_audio_tpu.train import step as jstep
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.ckpt.checkpoint import restore_train_state
from desta25_audio_tpu_torch.data import dataset as tdata
from desta25_audio_tpu_torch.models import orca as torca
from desta25_audio_tpu_torch.ops import qmm as tqmm
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train import step as tstep
from desta25_audio_tpu_torch.train.trainer import (
    DeSTA25Trainer,
    TrainerConfig,
)
from test_torch_int8_llm import _bf16, _leaf, _pallas_blocks, _pallas_qmm
from test_torch_orca import _jax_stack
from test_torch_train import _data_kwargs, _recording, _step_pair
from test_torch_train import corpus  # noqa: F401  (a fixture)

ORCA = dict(encoder_model_id="test/whisper-nano",
            connector_mode="orca_hybrid", qformer_num_hidden_layers=2,
            orca_global_num_tokens=4, orca_local_downsample=4,
            orca_local_kernel_size=5, orca_audio_position_scale=2.5,
            dtype="float32")
# the gradients of one batch on equal parameters: max |port - JAX| over the
# step's largest element
GRAD_TOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _port(tree):
    return jax.tree.map(np.asarray, tree)


def _hand_batch(seed, B=2, L=48, K=4, n_trans=3):
    """The batch of JAX ``tests/test_orca.py:172-195``: K audio tokens and
    ``n_trans`` transcription positions a row after two text tokens, the
    first half of the labels ignored.  Returns (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 500, size=(B, L))
    labels = ids.copy()
    labels[:, :L // 2] = -100
    kind = np.zeros((B, L), np.int64)
    kind[:, 2:2 + K] = 1
    kind[:, 2 + K:2 + K + n_trans] = 2
    aidx = np.zeros((B, L), np.int64)
    pos = np.zeros((B, L), np.int64)
    for b in range(B):
        aidx[b, 2:2 + K + n_trans] = b
    pos[:, 2:2 + K] = np.arange(K)
    pos[:, 2 + K:2 + K + n_trans] = np.arange(n_trans)
    batch = {"input_ids": ids, "attention_mask": np.ones((B, L), np.int64),
             "labels": labels, "kind": kind, "aidx": aidx, "pos": pos,
             "audio": (0.1 * rng.standard_normal((B, 16000))).astype(
                 np.float32),
             "trans_ids": rng.integers(10, 200, size=(B, 8)),
             "trans_mask": np.ones((B, 8), np.int64)}
    jb = {k: jnp.asarray(v if v.dtype.kind == "f" else v.astype(np.int32))
          for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jb, tb


def _models(**kw):
    """The JAX nano ORCA model and the port's on the same (bridged)
    parameters."""
    jm = JaxModel(JaxConfig(**dict(ORCA, **kw)), seed=0)
    cfg = DeSTA25Config(**dict(ORCA, **kw))
    tm = DeSTA25AudioModel(cfg, device="cpu", params=bridge.from_jax_params(
        _port(jm.params), cfg, "cpu"))
    return jm, tm


def _port_trainable(tree):
    """A JAX trainable tree (connector, cross-attention stack) -> the port's
    flat {path: tensor}."""
    return topt.flatten_tree({
        "connector": bridge.orca_connector_from_jax(_port(tree["connector"]),
                                                    "cpu"),
        "orca_cross_attns": bridge.orca_cross_attns_from_jax(
            _port(tree["orca_cross_attns"]), "cpu")})


# -- make_deep_injection_fn ------------------------------------------------------

@pytest.mark.parametrize("global_xattn", [False, True])
@pytest.mark.parametrize("trans", [True, False])
def test_deep_injection_fn_matches_jax(trans, global_xattn):
    kw = dict(ORCA, llm_model_id="test/llama-nano",
              orca_global_cross_attn=global_xattn)
    jcfg, tcfg = JaxConfig(**kw), DeSTA25Config(**kw)
    llm = jcfg.llm_config
    stack = _jax_stack(jax.random.PRNGKey(1), llm)
    tstack = bridge.orca_cross_attns_from_jax(_port(stack), "cpu")
    rng = np.random.default_rng(2)
    B, T, D = 3, 20, llm.hidden_size
    glob = rng.standard_normal((B, 4, D)).astype(np.float32)
    local = rng.standard_normal((B, 9, D)).astype(np.float32)
    mask = np.zeros((B, T), np.int32)
    if trans:
        mask[0, 5:8] = 1
        mask[2, 10:11] = 1          # row 1 has none: its row is not counted
    # the JAX step's rule for the injection tokens (train/step.py:84-88)
    jtok = (jnp.concatenate([jnp.asarray(glob), jnp.asarray(local)], 1)
            if global_xattn else jnp.asarray(local))
    ttok = torca.orca_inject_tokens(tcfg, {"orca_cross_attns": tstack},
                                    torch.from_numpy(glob),
                                    torch.from_numpy(local))
    assert _rel(ttok, jtok) == 0.0
    jfn, jaux = jorca.make_deep_injection_fn(
        stack, jcfg, jtok, trans_pos_mask=jnp.asarray(mask), training=True)
    tfn, taux = torca.make_deep_injection_fn(
        tstack, tcfg, ttok, trans_pos_mask=torch.from_numpy(mask),
        training=True)
    for l in range(llm.num_hidden_layers):
        h = rng.standard_normal((B, T, D)).astype(np.float32)
        jh, jaux = jfn(l, jnp.asarray(h), jaux)
        th, taux = tfn(l, torch.from_numpy(h), taux)
        assert _rel(th, jh) <= 1e-5, l
        for t, j in zip(taux, jaux):
            assert abs(float(t) - float(j)) <= 1e-5, (l, taux, jaux)
    assert float(taux[1]) == (llm.num_hidden_layers if trans else 0.0)
    assert (float(taux[0]) > 0) == trans


# -- the nano ORCA train step against JAX's make_train_step ----------------------

class _Recording:
    """The port's optimizer, recording the gradients it is given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads.append({k: g.clone() for k, g in grads.items()})
        return self.tx.update(grads, state, params)


ORCA_METRICS = ("loss", "lm_loss", "grad_norm", "L_ortho_diversity",
                "L_ortho_qformer_local", "L_align_layerwise")


@pytest.mark.parametrize("model_id", ["test/llama-nano128",
                                      "test/qwen3-nano"])
def test_nano_orca_train_step_matches_jax(model_id):
    jm, tm = _models(llm_model_id=model_id)
    jb, tb = _hand_batch(0)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    tx = _recording(jopt.make_optimizer(jopt.OptimizerConfig(**okw)))
    jtr, jfr = jm.split_params()
    assert set(jtr) == {"connector", "orca_cross_attns"}
    st = tx.init(jtr)
    step = jstep.make_train_step(jm.config, tx, remat=False)
    jms, jgrads = [], []
    for _ in range(3):
        jtr, st, m = step(jtr, jfr, st, jb)
        jms.append({k: float(v) for k, v in m.items()})
        jgrads.append(_port_trainable(st[1]))

    ttx = _Recording(topt.make_optimizer(topt.OptimizerConfig(**okw)))
    ttr, tfr = tm.split_params()
    for t in topt.flatten_tree(ttr).values():
        t.requires_grad_(True)
    tst = ttx.init(topt.flatten_tree(ttr))
    tstep_fn = tstep.make_train_step(tm.config, ttx, remat=True)
    tlay = tstep.TrainLayout(None, tfr, tm.config)
    tms = []
    for _ in range(3):
        ttr, tst, m = tstep_fn(ttr, tlay, tst, tb)
        tms.append({k: float(v) for k, v in m.items()})

    for j, t in zip(jms, tms):
        assert sorted(t) == sorted(j)
        for k in ORCA_METRICS:
            assert abs(t[k] - j[k]) <= 1e-4 * abs(j[k]), (k, t[k], j[k])
        assert t["L_align_layerwise"] > 0 and t["loss"] > t["lm_loss"]
    assert tms[0]["loss"] == tms[1]["loss"]          # lr 0 at count 0
    assert jms[2]["lm_loss"] != jms[0]["lm_loss"]
    # steps 0 and 1 run on the same parameters on both sides
    for c in (0, 1):
        jg, pg = jgrads[c], ttx.grads[c]
        assert sorted(jg) == sorted(pg)
        top = max(float(g.abs().max()) for g in jg.values())
        err = max(float((pg[k] - jg[k]).abs().max()) for k in jg)
        assert err <= GRAD_TOL * top, (c, err, top)
        # every layer of the stack gets a gradient (gate1's is 0 while
        # gate2's weight is at its zero init)
        for k in ("orca_cross_attns/layers/q/w",
                  "orca_cross_attns/layers/gate2/w"):
            assert all(float(g.abs().max()) > 0 for g in pg[k]), k


def test_prompt_only_batch_grads_finite_and_match_jax():
    """No transcription positions (every trainer batch: the dataset gives
    empty transcriptions): the alignment term is 0 and no gradient is NaN
    (JAX ``tests/test_orca.py:245-290``)."""
    jm, tm = _models(llm_model_id="test/llama-nano")
    jb, tb = _hand_batch(1, n_trans=0)
    assert not bool((tb["kind"] == 2).any())
    jtr, jfr = jm.split_params()

    def lf(tr):
        return jstep._forward({**jfr, **tr}, jb, jm.config, remat=False,
                              training=True)

    (_, jmet), jg = jax.jit(jax.value_and_grad(lf, has_aux=True))(jtr)
    jg = _port_trainable(jg)
    ttr, tfr = tm.split_params()
    leaves = topt.flatten_tree(ttr)
    for t in leaves.values():
        t.requires_grad_(True)
    total, tmet = tstep.forward_loss({**tfr, **ttr}, tb, tm.config,
                                     remat=True)
    tg = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()),
                                              allow_unused=True)))
    tmet = {k: v.detach() for k, v in tmet.items()}
    assert float(tmet["L_align_layerwise"]) == 0.0
    assert float(jmet["L_align_layerwise"]) == 0.0
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-4 * abs(
        float(jmet["loss"]))
    top = max(float(g.abs().max()) for g in jg.values())
    for k, g in tg.items():
        assert g is not None and bool(torch.isfinite(g).all()), k
        assert float((g - jg[k]).abs().max()) <= GRAD_TOL * top, k


def test_remat_on_equals_off():
    _, tm = _models(llm_model_id="test/llama-nano")
    _, tb = _hand_batch(2)
    ttr, tfr = tm.split_params()
    leaves = topt.flatten_tree(ttr)
    for t in leaves.values():
        t.requires_grad_(True)
    out = {}
    for remat in (False, True):
        total, met = tstep.forward_loss({**tfr, **ttr}, tb, tm.config,
                                        remat=remat)
        out[remat] = ({k: v.detach() for k, v in met.items()},
                      torch.autograd.grad(total, list(leaves.values())))
    (m0, g0), (m1, g1) = out[False], out[True]
    assert float(m0["L_align_layerwise"]) > 0
    for k in ORCA_METRICS[:2] + ORCA_METRICS[3:]:
        assert abs(float(m1[k]) - float(m0[k])) <= 1e-6 * abs(float(m0[k])), k
    for k, a, b in zip(leaves, g0, g1):
        assert _rel(b, a) <= 1e-6, k


# -- the trainer and the CLI on an ORCA config -------------------------------------

def test_orca_trainer_checkpoint_round_trip_resumes(corpus, tmp_path):  # noqa: F811
    cfg = DeSTA25Config(**dict(ORCA, llm_model_id="test/llama-nano"))

    def trainer(max_steps):
        model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
        dcfg = tdata.DataConfig(**_data_kwargs(corpus))
        ds = tdata.AudioTextDataset(cfg, dcfg, model.tokenizer)
        tcfg = TrainerConfig(
            exp_dir=str(tmp_path / "exp"), max_steps=max_steps,
            log_every_n_steps=1, eval_max_new_tokens=4,
            eval_before_train=False, val_check_interval=1e9,
            eval_max_batches=1, remat=True)
        return model, DeSTA25Trainer(
            model, ds, ds, tdata.CollateFn(cfg, dcfg, model.tokenizer),
            topt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=20),
            tcfg)

    model, tr = trainer(2)
    tr.train()
    assert tr.global_step == 2
    saved = {k: v.detach().clone() for k, v in
             topt.flatten_tree(model.split_params()[0]).items()}
    assert any(k.startswith("orca_cross_attns/") for k in saved)
    report = tr.evaluate(tag="orca")
    assert report["n_samples"] == 4 and np.isfinite(report["loss"])

    model2, tr2 = trainer(3)
    restored, st, step = restore_train_state(
        tr2.tcfg.exp_dir, model2.split_params()[0],
        tr2.optimizer.init(topt.flatten_tree(model2.split_params()[0])))
    assert step == 2 and st["count"] == 2
    for k, v in topt.flatten_tree(restored).items():
        assert torch.equal(v, saved[k]), k
    tr2.train(resume_from_checkpoint=tr2.tcfg.exp_dir)
    assert tr2.global_step == 3 and tr2.opt_state["count"] == 3
    moved = topt.flatten_tree(model2.split_params()[0])
    assert float((moved["orca_cross_attns/layers/q/w"].detach()
                  - saved["orca_cross_attns/layers/q/w"]).abs().max()) > 0


@pytest.mark.parametrize("extra", [["model.connector.mode=orca_hybrid"],
                                   ["model.llm.model_id=test/llama-nano128",
                                    "model.llm.quant=int8",
                                    "model.dtype=bfloat16"]],
                         ids=["orca", "int8"])
def test_cli_trains_orca_and_int8_towers(corpus, tmp_path, extra):  # noqa: F811
    import json
    import os

    from desta25_audio_tpu_torch.cli.train import main
    manifest, root = corpus
    exp = tmp_path / "exp"
    main(["--config", "configs/desta25_debug.yaml", "--device", "cpu",
          f"exp_dir={exp}", f"dataset.manifest_filepaths=[{manifest}]",
          f"dataset.data_root={root}", "trainer.max_steps=2", *extra])
    recs = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    steps = [r for r in recs if "train/loss" in r]
    assert len(steps) == 2
    assert all(np.isfinite(r["train/grad_norm"]) and r["train/grad_norm"] > 0
               for r in steps)
    if extra[0].endswith("orca_hybrid"):
        # prompt-only batches: the alignment term is 0
        assert all(r["train/L_align_layerwise"] == 0.0 for r in steps)
    # the trainable params are written once, as the reference-format
    # model.safetensors beside state.pt (the optimizer state and step)
    from desta25_audio_tpu_torch.ckpt.flat_io import read_header
    ckpt = os.path.join(exp, "checkpoint-latest")
    state = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    assert set(state) == {"opt_state", "step"}
    keys = read_header(os.path.join(ckpt, "model.safetensors"))[0]
    assert any(k.startswith("orca_cross_attns.") for k in keys) == (
        extra[0].endswith("orca_hybrid"))


# -- training through the int8 tower ------------------------------------------------

def jax_train_dispatch(monkeypatch, pallas=True):
    """The JAX package's TPU dispatch (``quant.py:93-180``) on the CPU: W8A8
    from 128 rows when asked, else K7 up to 256 rows and the dequant dot
    above.  K7 is ``_qmm_kernel`` in interpret mode, or with ``pallas``
    False its math in jnp (bf16 x and weight, f32 sums, times s after the
    sum), which can run under ``jax.checkpoint`` (the chunked CE's).
    Counts the branches."""
    hits = {"k7": 0, "dequant": 0, "w8a8": 0}
    real = jq._qmm_dispatch

    def dispatch(x2, q, s, w8a8):
        M, K = x2.shape
        if M >= 128 and w8a8:
            hits["w8a8"] += 1
            return real(x2, q, s, w8a8)
        if M > 256:
            hits["dequant"] += 1
            return real(x2, q, s, False)    # the CPU's branch: the dot
        hits["k7"] += 1
        if pallas:
            return _pallas_qmm(x2, q, s, *_pallas_blocks(K, q.shape[1]))
        return jnp.dot(x2.astype(jnp.bfloat16), q.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32) * s[None, :]

    monkeypatch.setattr(jq, "_qmm_dispatch", dispatch)
    jax.clear_caches()
    return hits


def _port_paths(monkeypatch):
    """Record which of the port's products ``quant_matmul`` runs."""
    calls = []
    for name in ("qmm", "qmm_plain", "qmm_dot", "dequant_matmul",
                 "w8a8_matmul", "w8a8_matmul_plain"):
        fn = getattr(tqmm, name)
        monkeypatch.setattr(tqmm, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    return calls


@pytest.mark.parametrize("M", [8, 100, 200, 300])
def test_quant_matmul_w8a8_off_matches_jax_tpu_dispatch(M, monkeypatch):
    hits = jax_train_dispatch(monkeypatch)
    calls = _port_paths(monkeypatch)
    rng = np.random.default_rng(M)
    K, N = 1024, 1024
    jl, tl = _leaf(rng, K, N)
    jx, tx = _bf16(rng.standard_normal((M, K)))
    g = rng.standard_normal((M, N)).astype(np.float32)
    # f32 out, as the CE's head: the products compare before any rounding
    try:
        jy, vjp = jax.vjp(lambda x: jq.quant_matmul(
            x, jl, out_dtype=jnp.float32, w8a8=False), jx)
        (jdx,) = vjp(jnp.asarray(g))
    finally:
        jax.clear_caches()
    tx.requires_grad_(True)
    ty = tqmm.quant_matmul(tx, tl, torch.float32, w8a8=False)
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    assert ty.dtype == torch.float32 and tdx.dtype == torch.bfloat16
    assert hits["w8a8"] == 0
    assert hits["dequant" if M > 256 else "k7"] == 1
    if M < 128:
        assert calls[0] == "qmm" and "dequant_matmul" not in calls
    else:
        assert calls == ["qmm_dot" if M <= 256 else "dequant_matmul"]
    # K7's math on both sides up to 256 rows (the port's K7 below 128, one
    # library product from 128) and the same dot above: f32 sums in another
    # order
    assert _rel(ty, jy) <= 1e-5
    # the same straight-through rule on both sides, one rounding to bf16
    assert _rel(tdx, jdx) <= 2 ** -8
    assert tl["q"].grad is None and not tl["q"].requires_grad


def test_nano_int8_tower_train_step_matches_jax(corpus, monkeypatch):  # noqa: F811
    """The JAX package's training setting at nano width: the LLM in
    weight-only int8, bf16, T = 512 (K11), so the layer products take the
    dequant dot (M = 1024) and the CE's head chunks the 128-256 band (K7 on
    the TPU, K7's math as one product in the port)."""
    hits = jax_train_dispatch(monkeypatch, pallas=False)
    calls = _port_paths(monkeypatch)
    jms, tms, *_, uses = _step_pair(corpus, "bfloat16", monkeypatch,
                                    llm_model_id="test/llama-nano128",
                                    llm_quant="int8")
    assert uses["jax"] > 0 and uses["port"] > 0     # both took K11
    assert hits["w8a8"] == 0 and hits["k7"] > 0 and hits["dequant"] > 0
    assert "dequant_matmul" in calls and "qmm_dot" in calls
    assert not any(c.startswith("w8a8") for c in calls)
    for j, t in zip(jms, tms):
        assert abs(t["lm_loss"] - j["lm_loss"]) <= 2e-2, (t, j)
        assert np.isfinite(t["grad_norm"]) and t["grad_norm"] > 0
