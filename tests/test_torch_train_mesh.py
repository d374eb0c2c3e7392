"""The port's multi-device training on the CPU: a mesh of ``"cpu"`` ranks,
against the one-device port and against the JAX package's mesh trainer on
its 8-device CPU mesh (the counterpart of ``tests/test_trainer_mesh.py`` and
of the train-step cases of ``tests/test_sharding.py``).

- ``DeSTA25Trainer`` with ``mesh="on"``, ``mesh_model=2``, ``fsdp=True`` on a
  ``(4, 2)`` mesh: per-step ``lm_loss`` within 1e-5 relative of the
  one-device port and within 1e-4 of JAX's trainer with the same options
  (the nano train tolerance of ``tests/test_torch_train.py``); the corpus's
  responses differ in length, so the rows hold unequal numbers of target
  tokens.
- fsdp cuts the large leaves and keeps them cut after a step; an
  indivisible leaf stays whole; the divisibility error; mesh off by default.
- The ``(2, 4)`` dp x tp step (``test_sharding.py:52-124``) with a bf16 and
  an int8 tower, and the ORCA step with fsdp (``:230-327``), against the
  one-device step.
- A batch whose data rows hold unequal target tokens gives the whole
  batch's loss, not a mean of the rows' losses.
- Adafactor and MultiSteps on shards against the same rule whole (1e-6).
- A checkpoint saved under fsdp resumes with no mesh.
- LoRA dropout under a split draws the whole batch's masks.
- The cache-less LLM forward on a ``1 x 2`` group at T = 512 (K11 per rank
  at H/2, Hkv/2) against the one-device forward, values and gradients.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.data import dataset as jdata
from desta25_audio_tpu.train.optimizer import OptimizerConfig as JaxOptConfig
from desta25_audio_tpu.train.trainer import DeSTA25Trainer as JaxTrainer
from desta25_audio_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.data import dataset as tdata
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import attention as tatt
from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
from desta25_audio_tpu_torch.parallel.sharding import (
    Shards,
    apply_llm_sharding,
    fsdp_partition_specs,
    gather_trainable,
    row_llm,
    shard_trainable,
)
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train import step as tstep
from desta25_audio_tpu_torch.train.trainer import (
    DeSTA25Trainer,
    TrainerConfig,
)

NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32")
DRYRUN = dict(llm_model_id="test/llama-dryrun",
              encoder_model_id="test/whisper-dryrun", dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20, gradient_clip_val=1.0)
MESH_TOL = 1e-5      # the mesh against the one-device port, relative
# an int8 tower cut over "model": the straight-through backward rounds
# g * s to bf16 (ops/qmm._QuantMatmul), so an f32 sum taken in rank parts
# upstream moves a few of those roundings by a bf16 ulp (2^-8); the
# connector's gradient then differs by ~2e-4 of its largest element in the
# tap weights, grad_norm by 1.3e-5 (bf16 tower: 1.2e-6)
INT8_TP_TOL = 1e-4
JAX_TOL = 1e-4       # the port against the JAX package (nano train tolerance)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``tests/test_trainer_mesh.py``'s corpus, with responses of different
    lengths (unequal target tokens per row)."""
    root = tmp_path_factory.mktemp("corpus")
    os.makedirs(root / "clips")
    rows = []
    for i in range(8):
        t = np.arange(8000) / 16000.0
        sig = (0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(
            np.float32)
        rel = f"clips/a{i}.wav"
        write_wav(str(root / rel), sig)
        rows.append({"id": rel, "dataset": "synthetic",
                     "prompt": f"Describe sound {i} <|AUDIO|>",
                     "response": f"tone {i}" + " and more" * (i % 4)})
    manifest = root / "train.jsonl"
    with open(manifest, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(manifest), str(root)


def _data_kw(corpus, **kw):
    manifest, root = corpus
    return dict(dict(manifest_filepaths=[manifest], data_root=root,
                     batch_size=4, max_seq_length=96,
                     num_audio_samples=48000, trans_max_tokens=8), **kw)


def _tcfg(path, **kw):
    return dict(dict(exp_dir=str(path), max_epochs=1, max_steps=2,
                     log_every_n_steps=1, eval_before_train=False,
                     val_check_interval=1e9, auto_find_batch_size=False),
                **kw)


def _losses(exp_dir, key="train/lm_loss"):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r[key] for r in recs if key in r]


def _port_trainer(corpus, path, params=None, data_kw=None, cfg_kw=None,
                  **tkw):
    cfg = DeSTA25Config(**dict(NANO, **(cfg_kw or {})))
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0, params=params)
    dcfg = tdata.DataConfig(**_data_kw(corpus, **(data_kw or {})))
    ds = tdata.AudioTextDataset(cfg, dcfg, model.tokenizer)
    collate = tdata.CollateFn(cfg, dcfg, model.tokenizer)
    return DeSTA25Trainer(model, ds, None, collate,
                          topt.OptimizerConfig(**OPT),
                          TrainerConfig(**_tcfg(path, **tkw)))


MESH_ON = dict(mesh="on", mesh_model=2, fsdp=True, mesh_devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """JAX's mesh trainer on its 8-device CPU mesh (once), the one-device
    port and the port on a (4, 2) mesh, from the same JAX-drawn params."""
    assert len(jax.devices()) >= 8
    tmp = tmp_path_factory.mktemp("runs")
    jm = JaxModel(JaxConfig(**NANO), seed=0)
    np_params = jax.tree.map(np.array, jm.params)
    dcfg = jdata.DataConfig(**_data_kw(corpus))
    jt = JaxTrainer(jm, jdata.AudioTextDataset(jm.config, dcfg, jm.tokenizer),
                    None, jdata.CollateFn(jm.config, dcfg, jm.tokenizer),
                    JaxOptConfig(**OPT), JaxTrainerConfig(**_tcfg(
                        tmp / "jax", mesh="on", mesh_model=2, fsdp=True)))
    assert dict(jt.mesh.shape) == {"data": 4, "model": 2}
    jt.train()
    cfg = DeSTA25Config(**NANO)
    out = {"jax": _losses(jt.tcfg.exp_dir)}
    for name, kw in (("one", {}), ("mesh", MESH_ON)):
        tr = _port_trainer(corpus, tmp / name,
                           bridge.from_jax_params(np_params, cfg, "cpu"),
                           **kw)
        tr.train()
        out[name] = _losses(tr.tcfg.exp_dir)
        out[name + "_gn"] = _losses(tr.tcfg.exp_dir, "train/grad_norm")
        out[name + "_trainer"] = tr
    return out


def test_mesh_trainer_matches_one_device(runs):
    tr = runs["mesh_trainer"]
    assert (tr.mesh.n_data, tr.mesh.n_model) == (4, 2)
    assert runs["one_trainer"].mesh.devices == [[torch.device("cpu")]]
    assert len(runs["one"]) == len(runs["mesh"]) == 2
    for a, b in ((runs["mesh"], runs["one"]),
                 (runs["mesh_gn"], runs["one_gn"])):
        for g, w in zip(a, b):
            assert abs(g - w) <= MESH_TOL * abs(w), (a, b)


def test_mesh_trainer_matches_jax(runs):
    assert len(runs["jax"]) == 2
    for g, w in zip(runs["mesh"], runs["jax"]):
        assert abs(g - w) <= JAX_TOL * abs(w), (runs["mesh"], runs["jax"])


def test_mesh_trainer_fsdp_shards_state(corpus, tmp_path):
    tr = _port_trainer(corpus, tmp_path / "fsdp", **MESH_ON)
    trainable, _ = tr.model.split_params()
    owners = tr._shard_state(trainable)
    cut = {k: v.dim for k, v in owners.items() if isinstance(v, Shards)}
    assert cut, "no trainable leaf cut"
    for k, v in owners.items():
        if isinstance(v, Shards):
            assert len(v.parts) == 4 and v.numel() >= 8192
    layout = tr._layout()
    batch = tr._device_batch(next(iter(tdata.data_loader(
        tr.train_dataset, tr.collate_fn, 4))))
    rows = tstep.split_batch(batch, layout.devices)
    assert [r["input_ids"].shape[0] for r in rows] == [1] * 4
    state = tr.optimizer.init(owners)
    new, _, metrics = tr.train_step(owners, layout, state, batch)
    assert np.isfinite(float(metrics["lm_loss"]))
    assert {k: v.dim for k, v in new.items()
            if isinstance(v, Shards)} == cut, "the step dropped the layout"
    # a leaf no data count divides, or too small, stays whole
    specs = fsdp_partition_specs({"odd": torch.zeros(3, 4099),
                                  "small": torch.zeros(8, 8)}, 4)
    assert specs == {"odd": None, "small": None}
    assert fsdp_partition_specs({"x": torch.zeros(8, 2048)}, 4) == {"x": 1}
    assert fsdp_partition_specs({"x": torch.zeros(2048, 2048)}, 4) == {
        "x": 1}       # a tie takes the later dim, as the JAX package's max


def test_mesh_trainer_batch_divisibility_error(corpus, tmp_path):
    with pytest.raises(ValueError, match="not divisible"):
        _port_trainer(corpus, tmp_path / "bad", mesh="on",
                      mesh_devices=["cpu"] * 8)   # batch 4 over data=8


def test_mesh_trainer_off_by_default(corpus, tmp_path, monkeypatch):
    """Mesh off by default: the 1 x 1 mesh of the model's device, as is
    "auto" over one device in one process.  Under two processes "auto"
    takes the mesh (the run's devices are every process's, as JAX counts
    them) and "off" raises: each process would train a model of its own."""
    tr = _port_trainer(corpus, tmp_path / "off")
    assert tr.mesh.devices == [[torch.device("cpu")]]
    assert tr.tcfg.mesh == "off"
    auto = _port_trainer(corpus, tmp_path / "auto", mesh="auto",
                         mesh_devices=["cpu"] * 2)
    assert (auto.mesh.n_data, auto.mesh.n_model) == (2, 1)
    from desta25_audio_tpu_torch.train import trainer as ttrainer
    from desta25_audio_tpu_torch.train.trainer import trainer_mesh
    monkeypatch.setattr(ttrainer, "world", lambda: (1, 2))
    tcfg = TrainerConfig(mesh="auto", mesh_devices=["cpu"])
    assert trainer_mesh(tcfg, "cpu").devices == [[torch.device("cpu")]]
    with pytest.raises(ValueError, match="a model a process"):
        trainer_mesh(TrainerConfig(), "cpu")


# -- the dp x tp and ORCA steps (tests/test_sharding.py) ----------------------

def _step_batch(cfg, rng, B=4, L=64, trans=0):
    """``test_sharding.py``'s synthetic batch (one clip a row), with
    ``trans`` transcription positions after each row's audio tokens and a
    different answer length a row."""
    K = cfg.audio_token_size
    ids = rng.integers(0, 500, size=(B, L))
    labels = ids.copy()
    for b in range(B):
        labels[b, :L // 2 + 6 * b] = -100
    kind = np.zeros((B, L), np.int64)
    kind[:, 2:2 + K] = 1
    kind[:, 2 + K:2 + K + trans] = 2
    aidx = np.tile(np.arange(B)[:, None], (1, L)) * (kind > 0)
    pos = np.zeros((B, L), np.int64)
    pos[:, 2:2 + K] = np.arange(K)
    pos[:, 2 + K:2 + K + trans] = np.arange(trans)
    t = torch.from_numpy
    return {"input_ids": t(ids), "attention_mask": torch.ones(B, L).long(),
            "labels": t(labels),
            "audio": t((0.1 * rng.standard_normal((B, 16000))).astype(
                np.float32)),
            "trans_ids": t(rng.integers(10, 200, size=(B, 8))),
            "trans_mask": torch.ones(B, 8).long(),
            "kind": t(kind), "aidx": t(aidx), "pos": t(pos)}


def _steps(model, batch, mesh=None, fsdp=False, n=3, min_size=8192,
           opt=None):
    """n train steps on one device (mesh None: the 1 x 1 layout, the
    leaves as a nested tree) or on ``mesh``, on a copy of the model's
    trainable leaves -> (metrics, final leaves)."""
    cfg = model.config
    optimizer = topt.make_optimizer(topt.OptimizerConfig(
        **(opt or dict(lr=1e-3, warmup_steps=1, total_steps=10))))
    trainable, frozen = model.split_params()
    flat = {k: v.detach().clone()
            for k, v in topt.flatten_tree(trainable).items()}
    out = []
    step = tstep.make_train_step(cfg, optimizer, remat=True)
    if mesh is None:
        tree = topt.unflatten_tree(flat)
        state = optimizer.init(flat)
        layout = tstep.TrainLayout(None, frozen, cfg)
        for _ in range(n):
            tree, state, m = step(tree, layout, state, batch)
            out.append({k: float(v) for k, v in m.items()})
        return out, {k: v.detach() for k, v in flat.items()}
    layout = tstep.TrainLayout(mesh, frozen, cfg)
    owners = shard_trainable(flat, mesh, fsdp=fsdp, min_size=min_size)
    state = optimizer.init(owners)
    for _ in range(n):
        owners, state, m = step(owners, layout, state, batch)
        out.append({k: float(v) for k, v in m.items()})
    return out, gather_trainable(owners)


def _close(got, want, keys, tol=MESH_TOL):
    for g, w in zip(got, want):
        for k in keys:
            assert abs(g[k] - w[k]) <= tol * abs(w[k]), (k, g[k], w[k])


@pytest.mark.parametrize("tower", ["bf16", "int8"])
def test_dp_tp_train_step(tower, rng):
    """The (2 data, 4 model) step against the one-device step: the towers
    cut 4 ways (H=8, Hkv=4 -> 2, 1 a rank), the batch 2 ways."""
    cfg = DeSTA25Config(**DRYRUN, connector_mode="qformer_1",
                        qformer_num_hidden_layers=2, prompt_size=8)
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    if tower == "int8":
        model.apply_llm_quant()
    batch = _step_batch(cfg, rng)
    want, wl = _steps(model, batch)
    got, gl = _steps(model, batch, make_mesh(2, 4, ["cpu"] * 8))
    tol = MESH_TOL if tower == "bf16" else INT8_TP_TOL
    _close(got, want, ("lm_loss", "loss", "grad_norm"), tol)
    assert got[-1]["lm_loss"] < got[0]["lm_loss"]
    if tower == "int8":
        # Adafactor's first updates are about sign(g) * lr an element, so
        # the ulp flips above move small leaves (the tap weights) by ~lr:
        # the int8 case holds the loss and grad_norm only
        return
    for k in wl:
        if k.endswith("/k/b"):
            # a key bias shifts a query row's scores alike: its gradient is
            # rounding noise, which Adafactor's first updates normalise to
            # about lr per element (tests/test_torch_train.py, KEY_BIASES)
            continue
        assert float((gl[k] - wl[k]).abs().max()) <= 1e-4 * (
            float(wl[k].abs().max()) + 1e-6), k


def test_orca_fsdp_train_step(rng):
    """ORCA with deep injection under (2 data, 2 model) with fsdp (leaves of
    128 elements and up cut): total loss, its aux terms (the alignment term
    from 3 transcription positions a row) and grad_norm as one device."""
    cfg = DeSTA25Config(**DRYRUN, connector_mode="orca_hybrid",
                        orca_global_num_tokens=4, orca_local_downsample=4,
                        orca_local_kernel_size=5)
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    batch = _step_batch(cfg, rng, L=48, trans=3)
    want, _ = _steps(model, batch, n=2)
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    trainable = topt.flatten_tree(model.split_params()[0])
    owners = shard_trainable(trainable, mesh, min_size=128)
    assert sum(isinstance(v, Shards) for v in owners.values()) > 10
    # the stack stays cut in each row's forward, gathered a layer at a time
    k = next(k for k, v in owners.items()
             if k.startswith("orca_cross_attns/") and isinstance(v, Shards))
    assert isinstance(tstep._replica(k, owners[k], "cpu", True), Shards)
    got, _ = _steps(model, batch, mesh, fsdp=True, n=2, min_size=128)
    keys = ("lm_loss", "loss", "grad_norm", "L_ortho_diversity",
            "L_ortho_qformer_local", "L_align_layerwise")
    assert got[0]["L_align_layerwise"] > 0
    _close(got, want, keys)


def test_unequal_tokens_give_the_whole_batch_loss(rng):
    """Rows 0-1 and 2-3 (the two data rows) hold 32 + 26 and 20 + 14 target
    tokens: the (2, 1) step's loss is the whole batch's (1e-6), which the
    mean of the two rows' own losses misses by far more."""
    cfg = DeSTA25Config(**NANO)
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    batch = _step_batch(cfg, rng)
    want, _ = _steps(model, batch, n=1)
    got, _ = _steps(model, batch, make_mesh(2, 1, ["cpu"] * 2), n=1)
    assert abs(got[0]["lm_loss"] - want[0]["lm_loss"]) <= 1e-6 * abs(
        want[0]["lm_loss"])
    assert got[0]["n_tokens"] == want[0]["n_tokens"] == 92
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        part = {k: v[rows] for k, v in batch.items()}
        part["aidx"] = part["aidx"] - rows.start * (part["kind"] > 0)
        halves.append(_steps(model, part, n=1)[0][0]["lm_loss"])
    assert abs(np.mean(halves) - want[0]["lm_loss"]) > 100 * 1e-6 * abs(
        want[0]["lm_loss"])


# -- Adafactor on shards --------------------------------------------------------

@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("shape,dim", [
    ((256, 384), 0),           # cut along the second-largest (factored) dim
    ((256, 384), 1),           # along the largest
    ((4, 160, 256), 0),        # along a dim neither factor averages
    ((4, 160, 256), 2),
    ((8192,), 0),              # unfactored
])
def test_adafactor_on_shards_matches_whole(shape, dim, accumulate):
    gen = torch.Generator().manual_seed(0)
    opt = topt.make_optimizer(topt.OptimizerConfig(
        lr=1e-2, warmup_steps=1, total_steps=10, gradient_clip_val=0.5,
        accumulate_grad_batches=accumulate, weight_decay=0.01))
    whole = {"w": torch.randn(shape, generator=gen),
             "b": torch.randn(64, generator=gen)}
    dims = {"w": dim, "b": None}

    def lay(flat):          # "w" cut 4 ways along dim, "b" whole
        return {k: v.clone() if dims[k] is None else Shards(
            [c.clone() for c in torch.chunk(v, 4, dims[k])], dims[k])
            for k, v in flat.items()}

    cut = lay(whole)
    sw, sc = opt.init(whole), opt.init(cut)
    for _ in range(4):
        g = {k: torch.randn(v.shape, generator=gen) for k, v in whole.items()}
        gc = lay(g)
        assert float(topt.global_norm(gc)) == pytest.approx(
            float(topt.global_norm(g)), rel=1e-6)
        uw, sw = opt.update(g, sw, whole)
        uc, sc = opt.update(gc, sc, cut)
        topt.apply_updates(whole, uw)
        topt.apply_updates(cut, uc)
        got = gather_trainable(cut)
        for k in whole:
            err = float((got[k] - whole[k]).abs().max())
            assert err <= 1e-6 * float(whole[k].abs().max()), (k, err)


# -- checkpoints, LoRA, the group forward -----------------------------------------

def test_checkpoint_saved_under_fsdp_resumes_without_mesh(corpus, tmp_path):
    from desta25_audio_tpu_torch.ckpt.checkpoint import restore_train_state
    tr = _port_trainer(corpus, tmp_path / "exp", **MESH_ON)
    tr.train()
    exp = tr.tcfg.exp_dir
    saved = topt.flatten_tree(tr.model.split_params()[0])
    want_state = gather_trainable(tr.opt_state["v"])
    plain = _port_trainer(corpus, tmp_path / "exp", max_steps=3)
    trainable = plain.model.split_params()[0]
    tree, state, step = restore_train_state(
        exp, trainable, plain.optimizer.init(topt.flatten_tree(trainable)))
    assert step == 2 and state["count"] == 2
    for k, v in topt.flatten_tree(tree).items():
        assert torch.equal(v, saved[k]), k
    for k, v in want_state.items():
        assert torch.equal(state["v"][k], v), k
    plain.train(resume_from_checkpoint=exp)
    assert plain.global_step == 3


def test_lora_dropout_split_draws_the_whole_batch_masks(rng):
    cfg = DeSTA25Config(**dict(NANO, use_lora=True, lora_rank=4,
                               lora_alpha=8, lora_dropout=0.3))
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    with torch.no_grad():       # B off zero, so the adapters count
        for t in model.params["lora"]["layers"].values():
            t["b"].normal_(0.0, 0.05, generator=torch.Generator()
                           .manual_seed(1))
    batch = dict(_step_batch(cfg, rng), lora_seed=7)
    want, _ = _steps(model, batch, n=1)
    got, _ = _steps(model, batch, make_mesh(2, 1, ["cpu"] * 2), n=1)
    _close(got, want, ("lm_loss", "grad_norm"), tol=1e-6)
    again, _ = _steps(model, batch, make_mesh(2, 1, ["cpu"] * 2), n=1)
    assert again[0]["lm_loss"] == got[0]["lm_loss"]
    other, _ = _steps(model, dict(batch, lora_seed=8), n=1)
    assert abs(other[0]["lm_loss"] - want[0]["lm_loss"]) > 1e-5


@pytest.mark.parametrize("remat", ["layer", "parts"])
def test_group_forward_matches_one_device_at_t512(monkeypatch, remat):
    """llm_apply without a cache on a 1 x 2 group, with remat, LoRA and an
    aux hook: K11 per rank at H/2, Hkv/2; hidden state, aux and gradients
    (inputs, LoRA) as the one-device forward.  "parts": the group taken as
    spanning cards, each device's share of a layer checkpointed alone."""
    from desta25_audio_tpu_torch.config import llm_config_for
    cfg = llm_config_for("test/llama-nano")
    gen = torch.Generator().manual_seed(0)
    params = tllm.init_llm(cfg, torch.float32, "cpu", gen)
    lora = tllm.init_lora(cfg, 4, "cpu", gen)
    for t in lora["layers"].values():
        t["b"].normal_(0.0, 0.05, generator=gen)
    B, T = 2, 512
    x0 = torch.randn(B, T, cfg.hidden_size, generator=gen) * 0.5
    mask = torch.ones(B, T, dtype=torch.long)
    mask[1, :37] = 0
    heads = []
    real = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention", lambda q, *a: heads.append(
        q.shape[2]) or real(q, *a))

    def hook(l, h, aux):
        return h * 1.01, (aux[0] + h.float().pow(2).mean(), aux[1] + 1.0)

    def run(tree, mesh):
        x = x0.clone().requires_grad_(True)
        lo = {k: {n: v.clone().requires_grad_(True) for n, v in t.items()}
              for k, t in lora["layers"].items()}
        with use_mesh(mesh):
            out = tllm.llm_apply(
                tree, cfg, inputs_embeds=x, attention_mask=mask,
                extra_layer_fn=hook, extra_aux_init=(torch.zeros(()),
                                                     torch.zeros(())),
                remat=True, return_hidden=True, skip_head=True,
                lora={"layers": lo}, lora_scale=2.0)
        h, aux = out[2], out[3]
        (h.pow(2).mean() + aux[0]).backward()
        return h.detach(), aux[0].detach(), x.grad, lo["q"]["a"].grad

    want = run(params, None)
    n_one = len(heads)
    monkeypatch.setattr(tllm, "_spans_cards", lambda p: remat == "parts")
    group = row_llm(apply_llm_sharding(params, cfg, make_mesh(
        1, 2, ["cpu"] * 2)), 0)
    got = run(group, group.mesh)
    assert set(heads[:n_one]) == {4} and set(heads[n_one:]) == {2}
    assert len(heads) - n_one == 2 * n_one          # each rank, its heads
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    with pytest.raises(ValueError, match="1 x p group"):
        sp = apply_llm_sharding(params, cfg, make_mesh(2, 1, ["cpu"] * 2))
        with use_mesh(sp.mesh):
            tllm.llm_apply(sp, cfg, inputs_embeds=x0)


def test_mesh_evaluate_matches_one_device(corpus, tmp_path):
    """evaluate() under the mesh: the loss on the mesh equals the one-device
    one, and the report is written (generation on the model's device)."""
    reports = []
    for name, kw in (("one", {}), ("mesh", MESH_ON)):
        tr = _port_trainer(corpus, tmp_path / name, eval_max_new_tokens=2,
                           eval_max_batches=1, **kw)
        tr.eval_dataset = tr.train_dataset
        reports.append(tr.evaluate(tag="t"))
        assert os.path.exists(tmp_path / name / "val@t-report.json")
    one, mesh = reports
    assert mesh["n_samples"] == one["n_samples"] == 4
    assert abs(mesh["loss"] - one["loss"]) <= MESH_TOL * abs(one["loss"])


def test_cli_trains_on_a_mesh(corpus, tmp_path):
    """The YAML keys trainer.mesh / mesh_model / fsdp / mesh_devices."""
    from desta25_audio_tpu_torch.cli.train import main
    manifest, root = corpus
    exp = tmp_path / "exp"
    main(["--config", "configs/desta25_debug.yaml", "--device", "cpu",
          f"exp_dir={exp}", f"dataset.manifest_filepaths=[{manifest}]",
          f"dataset.data_root={root}", "trainer.max_steps=1",
          "trainer.mesh=on", "trainer.mesh_model=2", "trainer.fsdp=true",
          "trainer.mesh_devices=[cpu,cpu,cpu,cpu]"])
    recs = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert any("train/lm_loss" in r for r in recs)
    assert os.path.exists(exp / "checkpoint-latest" / "model.safetensors")


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_a_cut_stack_gathers_a_layer_at_a_time(dim):
    """``models/orca.layer_trees`` / ``gather_layer`` on a stack cut along
    the layers or within them: each layer and the stack's gradient as the
    whole stack's."""
    from desta25_audio_tpu_torch.models.orca import gather_layer, layer_trees
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, 6, 8, generator=gen)
    x = torch.randn(6, generator=gen)
    whole = w.clone().requires_grad_(True)
    parts = [c.clone().requires_grad_(True) for c in torch.chunk(w, 2, dim)]
    cut = Shards(parts, dim)
    want = sum((x @ t).pow(2).sum() * (l + 1)
               for l, t in enumerate(layer_trees(whole, 4)))
    got = sum((x @ gather_layer(t, "cpu")).pow(2).sum() * (l + 1)
              for l, t in enumerate(layer_trees(cut, 4)))
    assert torch.allclose(got, want)
    want.backward()
    got.backward()
    assert torch.allclose(torch.cat([p.grad for p in parts], dim),
                          whole.grad)
