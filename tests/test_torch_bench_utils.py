"""``train/bench_utils.py`` and ``utils/fast_init.py`` against the JAX
package on the CPU, and Adafactor on bf16 leaves against optax.

- ``flagship_config`` field for field equal to JAX's, both modes.
- ``synth_train_batch``: its arrays equal JAX's bit for bit, in every key,
  shape and dtype (Q-Former and ORCA nano configs, and the flagship's own);
  the tensors hold them with the integers as int64, as the trainer's.
- ``random_tree_like`` against the real init: the same structure, shapes
  and dtypes; int8 leaves in [-127, 127] and float leaves of >= 4096
  elements with a std within 5 % of ``scale`` (JAX's stream is not
  torch's, so this compares statistics, not bits); one seed, one tree.
- The setup end to end: JAX's ``build_flagship_train_setup`` at a nano
  config (``flagship_config`` patched; JAX's ``random_tree_like`` patched
  to fill its leaves from numpy, which keeps the structure the setup
  asks for and spares the test compiling XLA's random programs), its trees
  bridged, then three steps of JAX's step (on its TPU dispatch, K7's math
  in jnp) and of the port's on the same batch.  lm_loss and loss within
  1e-4 rel, as ``test_nano_orca_train_step_matches_jax``; grad_norm within
  GRAD_NORM_TOL; step 3's fall in loss and the trained leaves' moves
  (two updates, the first at lr 0) within the bounds stated there.  ``qformer_1``, and ``orca_hybrid`` with the
  stack in bf16 (the other ORCA train tests run f32).  The
  port's own ``build_train_setup`` gives trees of the bridged ones'
  structure and dtypes.
- Adafactor on bf16 leaves: the port's update rounds as optax's does
  (the decay's blend in f32, the learning rate rounded to the leaf's
  dtype, each leaf's sum of squares in its dtype).
- ``hbm_analysis`` on the CPU returns the error key; the bytes its
  ``argument_gb`` adds up (``tree_bytes``) are exact; without CUDA the
  setup's default device raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.train import bench_utils as jbu
from desta25_audio_tpu.train import optimizer as jopt
from desta25_audio_tpu.utils import fast_init as jfast
from desta25_audio_tpu_torch import DeSTA25Config
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.models.orca import init_orca_cross_attns
from desta25_audio_tpu_torch.models.whisper import init_whisper_encoder
from desta25_audio_tpu_torch.ops.quant import quantize_llm_params
from desta25_audio_tpu_torch.train import bench_utils as tbu
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train.step import TrainLayout
from desta25_audio_tpu_torch.utils.fast_init import random_tree_like
from test_torch_train_orca import jax_train_dispatch

MODES = ("qformer_1", "orca_hybrid")


def nano(mode):
    """The flagship's fields at nano width: bf16 towers (the setup makes
    them bf16 whatever ``dtype`` says), the ORCA stack in bf16."""
    kw = dict(llm_model_id="test/qwen3-nano",
              encoder_model_id="test/whisper-nano", connector_mode=mode,
              qformer_num_hidden_layers=2, prompt_size=8, dtype="bfloat16")
    if mode == "orca_hybrid":
        kw.update(orca_global_num_tokens=4, orca_local_downsample=4,
                  orca_local_kernel_size=5, orca_audio_position_scale=2.5,
                  orca_gate_init=0.1, orca_xattn_dtype="bfloat16")
    return kw


def _flat(tree):
    return topt.flatten_tree(tree)


# -- flagship_config and synth_train_batch ------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_flagship_config_matches_jax(mode):
    got, want = tbu.flagship_config(mode), jbu.flagship_config(mode)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.llm_config) == dataclasses.asdict(
        want.llm_config)
    assert dataclasses.asdict(got.encoder_config) == dataclasses.asdict(
        want.encoder_config)
    if mode == "orca_hybrid":
        assert got.llm_model_id == "Qwen/Qwen3-4B-Instruct-2507"
        assert got.orca_xattn_dtype == "bfloat16"


@pytest.mark.parametrize("which", ["qformer_1", "orca_hybrid", "flagship"])
def test_synth_train_batch_matches_jax(which):
    if which == "flagship":
        tcfg, jcfg, B, L = (tbu.flagship_config(), jbu.flagship_config(), 2,
                            300)
    else:
        tcfg, jcfg, B, L = (DeSTA25Config(**nano(which)),
                            JaxConfig(**nano(which)), 3, 40)
    want = {k: np.asarray(v)
            for k, v in jbu.synth_train_batch(jcfg, B, L, seed=7).items()}
    got = tbu.synth_train_arrays(tcfg, B, L, seed=7)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    tens = tbu.synth_train_batch(tcfg, B, L, seed=7)
    for k, v in want.items():
        t = tens[k]
        assert t.dtype == (torch.float32 if v.dtype == np.float32
                           else torch.int64), k
        np.testing.assert_array_equal(t.numpy(), v, err_msg=k)
    assert int((tens["kind"] == 1).sum(1)[0]) == tcfg.audio_token_size
    assert tens["audio"].shape == (B, tcfg.encoder_config.expected_mel_frames
                                   * 160)


# -- random_tree_like ---------------------------------------------------------

def _inits():
    """The real init functions of the setup's four trees at nano width."""
    cfg = DeSTA25Config(**nano("orca_hybrid"))
    return {
        "llm_int8": lambda d, g: quantize_llm_params(tllm.init_llm(
            cfg.llm_config, torch.bfloat16, d, g)),
        "encoder": lambda d, g: init_whisper_encoder(
            cfg.encoder_config, torch.bfloat16, d, g),
        "stack": lambda d, g: init_orca_cross_attns(cfg, torch.bfloat16, d,
                                                    g),
    }


def test_random_tree_like_follows_the_init():
    for name, init in _inits().items():
        real = _flat(init("cpu", torch.Generator().manual_seed(0)))
        trees = [_flat(random_tree_like(
            init, torch.Generator().manual_seed(s), "cpu", scale=0.05))
            for s in (3, 3, 4)]
        got = trees[0]
        assert list(got) == list(real), name
        n_big = 0
        for k, r in real.items():
            t = got[k]
            assert t.shape == r.shape and t.dtype == r.dtype, (name, k)
            assert t.device.type == "cpu"
            assert torch.equal(t, trees[1][k]), (name, k)     # one seed
            if t.dtype == torch.int8:
                assert int(t.min()) >= -127 and int(t.max()) <= 127, k
                assert t.numel() < 4096 or (
                    abs(float(t.float().std()) - 73.6) <= 0.05 * 73.6), k
            elif t.dtype.is_floating_point and t.numel() >= 4096:
                n_big += 1
                std = float(t.float().std())
                assert abs(std - 0.05) <= 0.05 * 0.05, (name, k, std)
                assert abs(float(t.float().mean())) <= 0.05 * 0.05, k
        assert n_big > 0, name
        assert any(not torch.equal(got[k], trees[2][k]) for k in got), name


# -- the setup end to end, against JAX's --------------------------------------

# The towers are bf16 (8 significant bits) on both sides, so every product
# of the backward rounds to bf16, in an order that differs between XLA:CPU
# and PyTorch; the bf16 stack's own gradients are bf16 numbers, and the
# global norm adds each leaf's sum of squares rounded to bf16, as optax's
# does.  grad_norm read 6.4e-4 (qformer_1) and 4.1e-3 (orca_hybrid) of
# JAX's; 1e-2 is about 2.5 times the worse.
GRAD_NORM_TOL = 1e-2
LOSS_TOL = 1e-4
# Two updates' worth of training (lr 0 at count 0, then lr 1e-4, no
# parameter scale): Adafactor's second step divides each gradient by the
# root of its own square blended with step 1's (the same batch, the same
# parameters), so it moves every element by about +-lr, by the sign of its
# gradient.  Where a gradient sits within the towers' bf16 noise the two
# packages' signs differ: the attention key biases (gradient zero in exact
# arithmetic) flip about half their elements, the other leaves 0-11 %.  The
# moves' cosine read 0.9975 / 0.9951 (f32 connector, qformer_1 /
# orca_hybrid) and 0.949 (bf16 stack); 12.5 % of the stack's elements land
# on another bf16 number than JAX's (a move of about one ulp, so a flipped
# sign or a half-ulp rounding shows); the loss's fall from step 2 to step 3
# read 8.0 % / 7.6 % off JAX's.  Each bound is about twice the worse reading's
# distance from agreement.
LOSS_FALL_TOL = 0.15
MOVE_COS_MIN = {"connector": 0.99, "orca_cross_attns": 0.9}
STACK_MISMATCH_MAX = 0.25


def _numpy_tree_like(key, init_fn, scale=0.02):
    """JAX's ``random_tree_like`` contract (``jax.eval_shape`` of
    ``init_fn``, N(0, 1) * scale in f32 cast to the leaf's dtype, int8
    uniform in [-127, 127], zeros else), filled from numpy."""
    shapes = jax.eval_shape(init_fn, key)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**30)))
    out = []
    for leaf in leaves:
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            x = (rng.standard_normal(leaf.shape).astype(np.float32)
                 * np.float32(scale)).astype(leaf.dtype)
        elif leaf.dtype == jnp.int8:
            x = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        else:
            x = np.zeros(leaf.shape, leaf.dtype)
        out.append(jnp.asarray(x))
    return jax.tree_util.tree_unflatten(treedef, out)


def _P(tree):
    return jax.tree.map(np.asarray, tree)


def _bridged_trainable(mode, jtr):
    """JAX's trainable tree in the port's layout."""
    conn = (bridge.orca_connector_from_jax if mode == "orca_hybrid"
            else bridge.connector_from_jax)
    tr = {"connector": conn(_P(jtr["connector"]), "cpu")}
    if mode == "orca_hybrid":
        tr["orca_cross_attns"] = bridge.orca_cross_attns_from_jax(
            _P(jtr["orca_cross_attns"]), "cpu")
    return tr


def _bridged(mode, jtr, jfr):
    """JAX's trainable and frozen trees in the port's layout."""
    fr = {"llm": bridge.llm_from_jax(_P(jfr["llm"]), "cpu"),
          "whisper": {"encoder": bridge.whisper_encoder_from_jax(
              _P(jfr["whisper"]["encoder"]), "cpu")}}
    return _bridged_trainable(mode, jtr), fr


def _same_structure(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k


@pytest.mark.parametrize("mode", MODES)
def test_flagship_setup_step_matches_jax(mode, monkeypatch):
    torch.set_num_threads(1)
    hits = jax_train_dispatch(monkeypatch, pallas=False)
    monkeypatch.setattr(jbu, "flagship_config",
                        lambda m: JaxConfig(**nano(m)))
    monkeypatch.setattr(jfast, "random_tree_like", _numpy_tree_like)
    B, L = 2, 32
    try:
        jcfg, jstep, jtr, jfr, jst, jb = jbu.build_flagship_train_setup(
            B, L, seed=0, warmup_steps=1, connector_mode=mode)
        if mode == "orca_hybrid":
            assert jax.tree.leaves(jtr["orca_cross_attns"])[0].dtype \
                == jnp.bfloat16
        ttr, tfr = _bridged(mode, jtr, jfr)
        jms = []
        for _ in range(3):
            jtr, jst, m = jstep(jtr, jfr, jst, jb)
            jms.append({k: float(v) for k, v in m.items()})
        jtrained = _flat(_bridged_trainable(mode, jtr))
    finally:
        jax.clear_caches()
    assert hits["k7"] > 0 and hits["w8a8"] == 0

    # the port's build_train_setup: the bridged trees' structure and dtypes
    cfg, step, own_tr, layout, st, batch = tbu.build_train_setup(
        DeSTA25Config(**nano(mode)), B, L, seed=0, warmup_steps=1,
        device="cpu")
    _same_structure(own_tr, ttr)
    _same_structure(layout.frozen[0], tfr)
    # its step and fresh state (zeros of those shapes) on JAX's trees and
    # its own batch (JAX's bit for bit)
    tlay = TrainLayout(None, tfr, cfg)
    init = {k: v.clone() for k, v in _flat(ttr).items()}
    tms = []
    for _ in range(3):
        ttr, st, m = step(ttr, tlay, st, batch)
        tms.append({k: float(v) for k, v in m.items()})
    for j, t in zip(jms, tms):
        assert sorted(t) == sorted(j)
        assert t["n_tokens"] == j["n_tokens"]
        for k in ("lm_loss", "loss"):
            assert abs(t[k] - j[k]) <= LOSS_TOL * abs(j[k]), (k, t[k], j[k])
        assert abs(t["grad_norm"] - j["grad_norm"]) <= GRAD_NORM_TOL * abs(
            j["grad_norm"]), (t["grad_norm"], j["grad_norm"])
    assert tms[0]["loss"] == tms[1]["loss"]       # lr 0 at count 0
    # step 3 reads step 2's update: the loss falls by as much as JAX's
    fall_t, fall_j = (tms[1]["loss"] - tms[2]["loss"],
                      jms[1]["loss"] - jms[2]["loss"])
    assert fall_j > 0 and abs(fall_t - fall_j) <= LOSS_FALL_TOL * fall_j, (
        fall_t, fall_j)
    # the trained leaves: each part's move from the bridged start points
    # JAX's way, and the bf16 stack's elements mostly land on JAX's
    trained = _flat(ttr)
    for part in ("connector", "orca_cross_attns"):
        ks = [k for k in init if k.startswith(part + "/")]
        if not ks:
            continue
        mt, mj = (torch.cat([(t[k].float() - init[k].float()).flatten()
                             for k in ks]) for t in (trained, jtrained))
        cos = float((mt @ mj) / (mt.norm() * mj.norm()))
        assert cos >= MOVE_COS_MIN[part], (part, cos)
        if part == "orca_cross_attns":
            assert trained[ks[0]].dtype == torch.bfloat16
            assert float((mt != 0).float().mean()) >= 0.5
            share = float((mt != mj).float().mean())
            assert share <= STACK_MISMATCH_MAX, share


# -- Adafactor on bf16 leaves against optax -----------------------------------

def _bits(x):
    return np.asarray(x).astype(np.float32)


def test_adafactor_bf16_leaves_round_as_optax():
    """An ORCA-like trainable tree, the f32 connector's leaves first (as in
    both packages' order) and bf16 stack leaves, four steps of the same
    gradients through optax's chain (update and apply_updates in one jit,
    as JAX's train step) and the port's.  The bf16 parameters agree
    element for element but for a few that XLA rounds otherwise (<= 2 %
    of each leaf of >= 1024 elements: 0.1-0.9 % here; 16-45 % when the
    blend, the learning rate or the sums of squares round otherwise); the
    f32 leaf within 1e-6 of its largest value."""
    rng = np.random.default_rng(0)
    BF = ml_dtypes.bfloat16
    shapes = {"connector/w": ((128, 128), np.float32),
              "stack/q": ((256, 130), BF), "stack/k": ((3, 200, 150), BF),
              "stack/b": ((64,), BF), "stack/g": ((5, 7), BF)}
    params = {k: (0.02 * rng.standard_normal(s)).astype(d)
              for k, (s, d) in shapes.items()}
    okw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**okw))
    ttx = topt.make_optimizer(topt.OptimizerConfig(**okw))

    @jax.jit
    def jstep(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    def tt(v):
        t = torch.from_numpy(np.asarray(v).astype(np.float32))
        return t.bfloat16() if v.dtype == BF else t

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: tt(v) for k, v in params.items()}
    ts = ttx.init(tp)
    for step in range(4):
        # step 2's gradients are large: the global-norm clip scales them
        grads = {k: (rng.standard_normal(s) * (3.0 if step == 2 else 0.1)
                     ).astype(d) for k, (s, d) in shapes.items()}
        try:
            jp, js = jstep({k: jnp.asarray(v) for k, v in grads.items()}, js,
                           jp)
        finally:
            jax.clear_caches()
        tu, ts = ttx.update({k: tt(v) for k, v in grads.items()}, ts, tp)
        topt.apply_updates(tp, tu)
        for k, (shape, d) in shapes.items():
            got, want = tp[k].float().numpy(), _bits(jp[k])
            assert tp[k].dtype == (torch.bfloat16 if d == BF
                                   else torch.float32)
            if d == np.float32:
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
            elif want.size >= 1024:
                share = float((got != want).mean())
                assert share <= 0.02, (step, k, share)


# -- hbm_analysis, tree_bytes and the device ----------------------------------

def test_hbm_analysis_on_cpu_and_argument_bytes():
    cfg = DeSTA25Config(**nano("orca_hybrid"))
    _, step, tr, layout, st, batch = tbu.build_train_setup(
        cfg, 2, 16, device="cpu")
    got = tbu.hbm_analysis(step, tr, layout, st, batch)
    assert set(got) == {"error"} and "CUDA" in got["error"]
    assert len(got["error"]) <= 120

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in _flat(tree).values()
                   if isinstance(t, torch.Tensor))
    want = (nbytes(tr) + nbytes(layout.frozen[0])
            + sum(nbytes(st[k]) for k in ("v_row", "v_col", "v"))
            + nbytes(batch))
    assert tbu.tree_bytes(tr, layout.frozen, st, batch) == want
    # a storage is counted once: the layout's frozen tree holds the
    # setup's tensors, and a view adds nothing
    w = tr["orca_cross_attns"]["layers"]["q"]["w"]
    assert tbu.tree_bytes(tr, tr, [w[0]]) == nbytes(tr)
    assert tbu.tree_bytes({"n": 3}) == 0


def test_build_flagship_train_setup_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbu.build_flagship_train_setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbu.build_train_setup(DeSTA25Config(**nano("qformer_1")), 2, 16)
