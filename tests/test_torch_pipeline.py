"""The port's GPipe pipelining (``parallel/pipeline.py``, the "pipe" axis of
``parallel/mesh.py``) on ``"cpu"`` ranks, against the one-device port and
against the JAX package's pipeline on its 8-device CPU mesh (the counterpart
of ``tests/test_pipeline.py:37-183``).

- The pipelined forward at ``(2, 2, 2)``, M = 2, with row 0 left-padded:
  within 1e-3 of JAX's ``pipeline_microbatches=2`` forward (JAX's own
  bound against its one-device scan) and within 1e-5 of the one-device
  port.
- M in {1, 2, 4} with and without remat on a ``(1, 2, 2)`` group: logits
  and the input gradient as one device; every (stage, microbatch, layer)
  runs once forward, and once more under remat.
- Gradients through the schedule, every LLM leaf and the embeddings,
  against one device and JAX (JAX's bound between its pipeline and scan).
- An int8 tower's products inside a stage read the global microbatch's
  rows, as JAX's pipeline body's do.
- P = 4 on a llama-nano with 4 layers, ``(2, 1, 4)``.
- The DeSTA train step at ``(2, 2, 2)``: lm_loss within 1e-3 of JAX's
  dp x tp x pp step (``test_dp_tp_pp_train_step``) and within 1e-5 of the
  one-device port, grad_norm too.
- LoRA and ORCA's hook under ``mesh_pipe=2`` (the stages in order, no
  GPipe) as one device.
- The ValueErrors for B % M, L % P, the mesh's device count and the batch
  over the data rows.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.config import llm_config_for as jllm_config_for
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.parallel import mesh as jmesh
from desta25_audio_tpu.parallel import sharding as jshard
from desta25_audio_tpu.train.optimizer import OptimizerConfig as JaxOptConfig
from desta25_audio_tpu.train.optimizer import make_optimizer as jmake_opt
from desta25_audio_tpu.train.step import make_train_step as jmake_step
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.config import llm_config_for
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
from desta25_audio_tpu_torch.parallel.pipeline import pipeline_enabled
from desta25_audio_tpu_torch.parallel.sharding import (
    apply_llm_sharding,
    data_rows,
    row_llm,
    shard_trainable,
)
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train import step as tstep

DRYRUN = dict(llm_model_id="test/llama-dryrun",
              encoder_model_id="test/whisper-dryrun", dtype="float32")
QFORMER = dict(DRYRUN, connector_mode="qformer_1",
               qformer_num_hidden_layers=2, prompt_size=8)
ONE_TOL = 1e-5        # the pipeline against the one-device port
JAX_TOL = 1e-3        # against the JAX package's pipeline (its own bound)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    """``tests/test_pipeline.py``'s batch: B=4, T=24, row 0 padded on the
    left by 5."""
    rng = np.random.default_rng(0)
    cfg = jllm_config_for("test/llama-dryrun")
    ids = rng.integers(2, cfg.vocab_size, (4, 24)).astype(np.int32)
    mask = np.ones((4, 24), np.int32)
    mask[0, :5] = 0
    return ids, mask


def _loss_np(logits, ids, mask):
    """``test_pp_gradients_match``'s loss in torch."""
    lp = torch.log_softmax(logits, -1)
    tgt = torch.roll(ids, -1, 1)
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    return (nll * mask).mean()


@pytest.fixture(scope="module")
def jax_llm():
    """JAX's pipelined forward and its gradients at (2, 2, 2), M = 2, once."""
    assert len(jax.devices()) >= 8
    cfg = jllm_config_for("test/llama-dryrun")
    params = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    ids, mask = _inputs()
    ids_j, mask_j = jnp.asarray(ids), jnp.asarray(mask)

    def loss(p):
        logits, _, _ = jllm.llm_apply(p, cfg, input_ids=ids_j,
                                      attention_mask=mask_j,
                                      pipeline_microbatches=2)
        lp = jax.nn.log_softmax(logits, axis=-1)
        tgt = jnp.roll(ids_j, -1, axis=1)
        nll = -jnp.take_along_axis(lp, tgt[..., None], axis=-1)[..., 0]
        return jnp.mean(nll * mask_j)

    mesh = jmesh.make_mesh(n_data=2, n_model=2, n_pipe=2)
    with jmesh.use_mesh(mesh):
        sharded = jshard.apply_sharding(
            params, jshard.llm_partition_specs(params))
        logits = jax.jit(lambda p: jllm.llm_apply(
            p, cfg, input_ids=ids_j, attention_mask=mask_j,
            pipeline_microbatches=2)[0])(sharded)
        grads = jax.jit(jax.grad(loss))(sharded)
    return {"params": _np(params), "logits": np.asarray(logits),
            "grads": _np(grads)}


def _port_tree(jax_llm, grad=False):
    tree = bridge.llm_from_jax(jax_llm["params"], "cpu")
    if grad:
        tree = jax.tree.map(lambda t: t.requires_grad_(True), tree)
    return tree


def _port_logits(tree, cfg, ids, mask, mesh=None, M=0, remat=False,
                 embeds=None):
    """The port's logits: one device, or each data row's group of ``mesh``
    on its rows (as the train step splits them)."""
    if mesh is None:
        return tllm.llm_apply(tree, cfg, input_ids=ids if embeds is None
                              else None, inputs_embeds=embeds,
                              attention_mask=mask, remat=remat)[0]
    cut = apply_llm_sharding(tree, cfg, mesh)
    outs = []
    for d in range(mesh.n_data):
        rows = data_rows(mesh, ids.shape[0], d)
        group = row_llm(cut, d)
        with use_mesh(group.mesh):
            outs.append(tllm.llm_apply(
                group, cfg, input_ids=None if embeds is not None
                else ids[rows], inputs_embeds=None if embeds is None
                else embeds[rows], attention_mask=mask[rows],
                pipeline_microbatches=M, remat=remat)[0])
    return torch.cat(outs)


def _err(got, want) -> float:
    want = (want.detach() if isinstance(want, torch.Tensor)
            else torch.as_tensor(np.asarray(want)))
    return float((got.detach() - want).abs().max()) / float(
        want.abs().max())


def test_pp_forward_matches_jax_and_one_device(jax_llm):
    cfg = llm_config_for("test/llama-dryrun")
    ids, mask = (torch.from_numpy(a).long() for a in _inputs())
    tree = _port_tree(jax_llm)
    mesh = make_mesh(2, 2, ["cpu"] * 8, n_pipe=2)
    assert (mesh.n_data, mesh.n_model, mesh.n_pipe) == (2, 2, 2)
    assert not pipeline_enabled()
    with use_mesh(mesh):
        assert pipeline_enabled()
    with use_mesh(make_mesh(2, 4, ["cpu"] * 8)):
        assert not pipeline_enabled()
    cut = apply_llm_sharding(tree, cfg, mesh)
    st = cut.stages[0]
    assert [(s.lo, s.hi) for s in st] == [(0, 1), (1, 2)]
    with torch.no_grad():
        got = _port_logits(tree, cfg, ids, mask, mesh, M=2)
        one = _port_logits(tree, cfg, ids, mask)
    assert float((got - one).abs().max()) <= JAX_TOL
    assert float((got - one).abs().max()) <= ONE_TOL * float(
        one.abs().max())
    assert float((got - torch.tensor(jax_llm["logits"])).abs().max()) \
        < JAX_TOL


def test_mesh_orders_devices_as_jax():
    """``reshape(n_data, n_model, n_pipe)``, "pipe" innermost; the 2-D
    view is stage 0's; a 2-D mesh is as before (device objects need no
    card)."""
    devs = [torch.device("cuda", i) for i in range(8)]
    mesh = make_mesh(2, 2, devs, n_pipe=2)
    for d in range(2):
        for m in range(2):
            assert mesh.grid[d][m] == devs[(d * 2 + m) * 2:(d * 2 + m + 1) * 2]
            assert mesh.devices[d][m] == devs[(d * 2 + m) * 2]
    assert mesh.stage_mesh(1, 1).devices == [[devs[5], devs[7]]]
    assert mesh.stage_mesh(1, 1) is mesh.stage_mesh(1, 1)
    row = mesh.row_mesh(1)
    assert (row.n_data, row.n_model, row.n_pipe) == (1, 2, 2)
    assert row.grid == [mesh.grid[1]] and row.all_devices() == devs[4:]
    flat = make_mesh(2, 4, devs)
    assert flat.n_pipe == 1 and flat.devices == [devs[:4], devs[4:]]
    assert flat.grid == [[[d] for d in devs[:4]], [[d] for d in devs[4:]]]
    assert flat.row_mesh(1).devices == [devs[4:]]


def test_stages_are_views_of_the_stacked_layers(jax_llm):
    """A stage on the layers' own device holds views of the stacked
    leaves (no copy), its layers the ones pipe_layer_specs gives it."""
    cfg = llm_config_for("test/llama-dryrun")
    tree = _port_tree(jax_llm)
    cut = apply_llm_sharding(tree, cfg, make_mesh(1, 1, ["cpu"] * 2,
                                                  n_pipe=2))
    for s, stage in enumerate(cut.stages[0]):
        for k in ("wqkv", "wo", "w_gu", "w_down"):
            leaf = stage.tree["layers"][k]
            assert leaf.data_ptr() == tree["layers"][k][s].data_ptr()
            assert torch.equal(leaf, tree["layers"][k][s:s + 1])
        assert stage.tree["layers"]["ln1"]["scale"].data_ptr() == \
            tree["layers"]["ln1"]["scale"][s].data_ptr()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("M", [1, 2, 4])
def test_pp_microbatches_and_remat(jax_llm, monkeypatch, M, remat):
    cfg = llm_config_for("test/llama-dryrun")
    ids, mask = (torch.from_numpy(a).long() for a in _inputs())
    tree = _port_tree(jax_llm)
    calls = []
    real = tllm._decoder_layer
    monkeypatch.setattr(tllm, "_decoder_layer", lambda tree, cfg, l, xs, *a:
                        calls.append(xs[0].shape[0]) or real(tree, cfg, l,
                                                             xs, *a))
    embeds = tllm.embed_tokens(tree, ids)
    x = embeds.clone().requires_grad_(True)
    got = _port_logits(tree, cfg, ids, mask, make_mesh(
        1, 2, ["cpu"] * 4, n_pipe=2), M=M, remat=remat, embeds=x)
    _loss_np(got, ids, mask).backward()
    # each (stage, microbatch, layer) once, once more in the recompute
    assert calls == [4 // M] * (2 * M * (2 if remat else 1))
    x1 = embeds.clone().requires_grad_(True)
    want = _port_logits(tree, cfg, ids, mask, embeds=x1)
    _loss_np(want, ids, mask).backward()
    assert _err(got, want) <= ONE_TOL
    assert _err(x.grad, x1.grad) <= ONE_TOL


def test_pp_gradients_match(jax_llm):
    cfg = llm_config_for("test/llama-dryrun")
    ids, mask = (torch.from_numpy(a).long() for a in _inputs())
    grads = {}
    for name, mesh in (("one", None),
                       ("pp", make_mesh(2, 2, ["cpu"] * 8, n_pipe=2))):
        tree = _port_tree(jax_llm, grad=True)
        _loss_np(_port_logits(tree, cfg, ids, mask, mesh, M=2), ids,
                 mask).backward()
        grads[name] = jax.tree.map(lambda t: t.grad, tree)
    want_jax = bridge.llm_from_jax(jax_llm["grads"], "cpu")
    flat = jax.tree_util.tree_flatten_with_path(grads["pp"])[0]
    assert len(flat) == len(jax.tree.leaves(want_jax)) == 9
    for path, g in flat:
        one, jx = grads["one"], want_jax
        for p in path:
            one, jx = one[p.key], jx[p.key]
        assert _err(g, one) <= ONE_TOL, path
        np.testing.assert_allclose(g.numpy(), jx.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=str(path))


def test_int8_rows_read_the_global_microbatch(jax_llm, monkeypatch):
    """An int8 tower in a stage picks its products' row regime on the rows
    the JAX pipeline body's products see, the global microbatch: 2 data
    rows of 2 rows at M = 2 run microbatches of 1 row, each product read as
    2 * T rows (``row_scale`` 2); the hidden as one device's."""
    from desta25_audio_tpu_torch.ops.quant import quantize_llm_params
    cfg = llm_config_for("test/llama-dryrun")
    tree = quantize_llm_params(_port_tree(jax_llm))
    ids, mask = (torch.from_numpy(a).long() for a in _inputs())
    seen = []
    real = tllm.quant_matmul
    monkeypatch.setattr(tllm, "quant_matmul", lambda x, leaf, *a, row_scale=1,
                        **k: seen.append(x[..., 0].numel() * row_scale)
                        or real(x, leaf, *a, row_scale=row_scale, **k))
    mesh = make_mesh(2, 1, ["cpu"] * 4, n_pipe=2)
    cut = apply_llm_sharding(tree, cfg, mesh)
    got = []
    for d in range(2):
        group, rows = row_llm(cut, d), data_rows(mesh, 4, d)
        with use_mesh(group.mesh):
            got.append(tllm.llm_apply(
                group, cfg, input_ids=ids[rows], attention_mask=mask[rows],
                pipeline_microbatches=2, w8a8=False, skip_head=True,
                return_hidden=True, batch_rows=(rows.start, 4))[2])
    assert len(seen) == 2 * 2 * 2 * 4 and set(seen) == {2 * 24}
    want = tllm.llm_apply(tree, cfg, input_ids=ids, attention_mask=mask,
                          w8a8=False, skip_head=True, return_hidden=True)[2]
    assert _err(torch.cat(got), want) <= ONE_TOL


def test_p4_on_a_four_layer_nano():
    """P = 4 over a llama-nano with 4 layers on (2, 1, 4): one layer a
    stage, M = 2; logits and the input gradient as one device."""
    cfg = dataclasses.replace(llm_config_for("test/llama-nano"),
                              num_hidden_layers=4)
    gen = torch.Generator().manual_seed(0)
    tree = tllm.init_llm(cfg, torch.float32, "cpu", gen)
    ids = torch.randint(2, cfg.vocab_size, (4, 20), generator=gen)
    mask = torch.ones(4, 20, dtype=torch.long)
    mask[1, :3] = 0
    embeds = tllm.embed_tokens(tree, ids)
    outs = []
    for mesh in (make_mesh(2, 1, ["cpu"] * 8, n_pipe=4), None):
        x = embeds.clone().requires_grad_(True)
        lg = _port_logits(tree, cfg, ids, mask, mesh, M=2, remat=True,
                          embeds=x)
        _loss_np(lg, ids, mask).backward()
        outs.append((lg.detach(), x.grad))
    (got, gx), (want, wx) = outs
    assert torch.equal(got, want) or _err(got, want) <= ONE_TOL
    assert _err(gx, wx) <= ONE_TOL


# -- the DeSTA train step ------------------------------------------------------

def _batch_np(cfg_prompt: int, trans: int = 0, B: int = 4, L: int = 64):
    """``test_dp_tp_pp_train_step``'s batch, each row naming its own clip
    (the port's data rows carry their rows' clips)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 500, size=(B, L)).astype(np.int32)
    labels = ids.copy()
    labels[:, :L // 2] = -100
    kind = np.zeros((B, L), np.int32)
    kind[:, 4:4 + cfg_prompt] = 1
    kind[:, 4 + cfg_prompt:4 + cfg_prompt + trans] = 2
    pos = np.zeros((B, L), np.int32)
    pos[:, 4:4 + cfg_prompt] = np.arange(cfg_prompt)
    pos[:, 4 + cfg_prompt:4 + cfg_prompt + trans] = np.arange(trans)
    aidx = (np.arange(B)[:, None] * (kind > 0)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": np.ones((B, L), np.int32),
            "labels": labels,
            "audio": rng.standard_normal((B, 16000)).astype(np.float32) * 0.1,
            "trans_ids": rng.integers(10, 200, (B, 8)).astype(np.int32),
            "trans_mask": np.ones((B, 8), np.int32),
            "kind": kind, "aidx": aidx, "pos": pos}


def _torch_batch(batch_np):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch_np.items()}


def _port_steps(model, batch, mesh=None, n=1, **kw):
    """n port train steps on a copy of the trainable leaves (one device
    with mesh None) -> a metrics dict a step."""
    cfg = model.config
    optimizer = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    trainable, frozen = model.split_params()
    flat = {k: v.detach().clone()
            for k, v in topt.flatten_tree(trainable).items()}
    layout = tstep.TrainLayout(mesh, frozen, cfg, **kw)
    owners = (topt.unflatten_tree(flat) if mesh is None
              else shard_trainable(flat, mesh))
    state = optimizer.init(flat if mesh is None else owners)
    step = tstep.make_train_step(cfg, optimizer, remat=True)
    out = []
    for _ in range(n):
        owners, state, m = step(owners, layout, state, batch)
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def jax_step():
    """JAX's dp x tp x pp train step at (2, 2, 2), M = 2, once (the setup
    of ``test_dp_tp_pp_train_step``) -> its first lm_loss and the model's
    params."""
    jcfg = JaxConfig(**QFORMER)
    jm = JaxModel(jcfg, seed=0)
    params = _np(jm.params)
    batch_np = _batch_np(jcfg.prompt_size)
    optimizer = jmake_opt(JaxOptConfig(**OPT))
    mesh = jmesh.make_mesh(n_data=2, n_model=2, n_pipe=2)
    with jmesh.use_mesh(mesh):
        trainable, frozen = jm.split_params()
        frozen = {"llm": jshard.apply_sharding(
            frozen["llm"], jshard.llm_partition_specs(frozen["llm"])),
            "whisper": jshard.apply_sharding(
                frozen["whisper"],
                jshard.whisper_partition_specs(frozen["whisper"]))}
        trainable = jshard.apply_sharding(
            trainable, jshard.replicated_specs(trainable))
        step = jmake_step(jcfg, optimizer, pipeline_microbatches=2)
        dbatch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, JP("data", *([None] * (v.ndim - 1)))))
            for k, v in batch_np.items()}
        _, _, metrics = step(trainable, frozen, optimizer.init(trainable),
                             dbatch)
    return {"params": params, "batch": batch_np,
            "lm_loss": float(metrics["lm_loss"])}


def test_dp_tp_pp_train_step(jax_step):
    cfg = DeSTA25Config(**QFORMER)
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0, params=bridge
                              .from_jax_params(jax_step["params"], cfg,
                                               "cpu"))
    batch = _torch_batch(jax_step["batch"])
    want = _port_steps(model, batch)[0]
    got = _port_steps(model, batch, make_mesh(2, 2, ["cpu"] * 8, n_pipe=2),
                      pipeline_microbatches=2)[0]
    assert np.isfinite(got["lm_loss"]) and got["grad_norm"] > 0
    for k in ("lm_loss", "grad_norm"):
        assert abs(got[k] - want[k]) <= ONE_TOL * abs(want[k]), (k, got,
                                                                  want)
    assert abs(got["lm_loss"] - jax_step["lm_loss"]) < JAX_TOL, (
        got["lm_loss"], jax_step["lm_loss"])


@pytest.mark.parametrize("kind", ["lora", "orca"])
def test_lora_and_orca_under_a_pipe_mesh(kind):
    """Under LoRA (with dropout) or ORCA's deep injection GPipe does not
    run (as in the JAX package) even with pipeline_microbatches set: the
    layers go through the stages in order, the hook and the adapters on
    the data row's first device; two steps as one device."""
    if kind == "lora":
        cfg = DeSTA25Config(**dict(QFORMER, use_lora=True, lora_rank=4,
                                   lora_alpha=8, lora_dropout=0.3))
        trans = 0
    else:
        cfg = DeSTA25Config(**DRYRUN, connector_mode="orca_hybrid",
                            orca_global_num_tokens=4,
                            orca_local_downsample=4,
                            orca_local_kernel_size=5)
        trans = 3
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    if kind == "lora":
        with torch.no_grad():        # B off zero, so the adapters count
            for t in model.params["lora"]["layers"].values():
                t["b"].normal_(0.0, 0.05,
                               generator=torch.Generator().manual_seed(1))
    batch = _torch_batch(_batch_np(cfg.audio_token_size, trans, L=48))
    if kind == "lora":
        batch["lora_seed"] = 7
    want = _port_steps(model, batch, n=2)
    got = _port_steps(model, batch, make_mesh(1, 2, ["cpu"] * 4, n_pipe=2),
                      n=2, pipeline_microbatches=2)
    keys = ["lm_loss", "loss", "grad_norm"] + (
        ["L_align_layerwise"] if kind == "orca" else [])
    if kind == "orca":
        assert got[0]["L_align_layerwise"] > 0
    for g, w in zip(got, want):
        for k in keys:
            assert abs(g[k] - w[k]) <= ONE_TOL * abs(w[k]), (k, g[k], w[k])


def test_value_errors(jax_llm, tmp_path):
    cfg = llm_config_for("test/llama-dryrun")
    tree = _port_tree(jax_llm)
    ids, mask = (torch.from_numpy(a).long() for a in _inputs())
    with pytest.raises(ValueError, match="not divisible by n_micro 3"):
        _port_logits(tree, cfg, ids, mask, make_mesh(
            1, 1, ["cpu"] * 2, n_pipe=2), M=3)
    with pytest.raises(ValueError, match="do not split into 4 pipeline"):
        apply_llm_sharding(tree, cfg, make_mesh(1, 1, ["cpu"] * 4, n_pipe=4))
    with pytest.raises(ValueError, match=r"mesh 2x2x2 != 6 devices"):
        make_mesh(2, 2, ["cpu"] * 6, n_pipe=2)
    assert make_mesh(n_model=2, devices=["cpu"] * 8, n_pipe=2).n_data == 2
    # a cached call on a pipe mesh is refused (the pipe axis trains)
    cut = row_llm(apply_llm_sharding(tree, cfg, make_mesh(
        1, 1, ["cpu"] * 2, n_pipe=2)), 0)
    with use_mesh(cut.mesh), pytest.raises(ValueError, match="pipe mesh"):
        tllm.llm_apply(cut, cfg, input_ids=ids, cache=tllm.init_kv_cache(
            cfg, 4, 32, torch.float32, "cpu"), cache_index=0)
    # the batch over the data rows keeps the JAX package's text
    from desta25_audio_tpu_torch.data import dataset as tdata
    from desta25_audio_tpu_torch.train.trainer import (DeSTA25Trainer,
                                                       TrainerConfig)
    dcfg = DeSTA25Config(**QFORMER)
    model = DeSTA25AudioModel(dcfg, device="cpu", seed=0)
    manifest = tmp_path / "m.jsonl"
    manifest.write_text(json.dumps({"id": "a.wav", "prompt": "<|AUDIO|>",
                                    "response": "x"}) + "\n")
    data = tdata.DataConfig(manifest_filepaths=[str(manifest)],
                            data_root=str(tmp_path), batch_size=4)
    with pytest.raises(ValueError, match="larger mesh_model/mesh_pipe"):
        DeSTA25Trainer(model, tdata.AudioTextDataset(dcfg, data,
                                                     model.tokenizer),
                       None, tdata.CollateFn(dcfg, data, model.tokenizer),
                       topt.OptimizerConfig(**OPT), TrainerConfig(
                           exp_dir=str(tmp_path / "exp"), mesh="on",
                           mesh_pipe=2, mesh_devices=["cpu"] * 6))
    assert not os.path.exists(tmp_path / "exp" / "metrics.jsonl")
