"""The port's Megatron sequence parallelism (``models/llm._group_layer``,
``llm_apply(sequence_parallel=True)``) on ``"cpu"`` ranks: the residual cut
over T between blocks on each data row's ``1 x p`` group (the counterpart
of ``tests/test_sharding.py:126-228``).

RMSNorm is per row and the reduce-scatter sums each slice in the rank order
the tensor-parallel forward sums the whole, so the SP forward equals the
tensor-parallel forward without SP bit for bit (``torch.equal``), values
and gradients (under LoRA the gradients within 1e-6: autograd sums the
normed input's three consumers in another order); against the JAX package's SP forward on its 8-device CPU
mesh it is held within 1e-3, JAX's own bound against its one-device scan.

- The SP forward on ``(2, 4)``: logits and hidden.
- T % p != 0 (``torch.tensor_split``), with and without remat: hidden and
  the input gradient; each rank holds its slice between blocks.
- The DeSTA train step on ``(2, 4)``: lm_loss and grad_norm with SP equal
  the plain dp x tp step's.
- SP under LoRA (with dropout) and under an aux hook (ORCA's form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from desta25_audio_tpu.config import llm_config_for as jllm_config_for
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.parallel import mesh as jmesh
from desta25_audio_tpu.parallel import sharding as jshard
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.config import llm_config_for
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
from desta25_audio_tpu_torch.parallel.sharding import (
    apply_llm_sharding,
    data_rows,
    row_llm,
    shard_trainable,
)
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train import step as tstep

JAX_TOL = 1e-3
ONE_TOL = 1e-5
LORA_GRAD_TOL = 1e-6  # SP under LoRA: gradients summed in another order


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_sp():
    """JAX's SP forward on (2, 4) (``test_sequence_parallel_forward_
    matches_unsharded``'s setup), once."""
    assert len(jax.devices()) >= 8
    cfg = jllm_config_for("test/llama-dryrun")
    params = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    mesh = jmesh.make_mesh(n_data=2, n_model=4)
    with jmesh.use_mesh(mesh):
        sharded = jshard.apply_sharding(params,
                                        jshard.llm_partition_specs(params))
        dids = jax.device_put(jnp.asarray(ids),
                              NamedSharding(mesh, JP("data", None)))
        logits, _, hidden = jax.jit(lambda p, x: jllm.llm_apply(
            p, cfg, input_ids=x, return_hidden=True,
            sequence_parallel=True))(sharded, dids)
    return {"params": jax.tree.map(np.asarray, params), "ids": ids,
            "logits": np.asarray(logits), "hidden": np.asarray(hidden)}


def _groups(tree, cfg, mesh):
    cut = apply_llm_sharding(tree, cfg, mesh)
    return [row_llm(cut, d) for d in range(mesh.n_data)]


def _forward(groups, cfg, B, sp, **kw):
    """Each data row's group on its rows -> (logits, hidden) in row order;
    ``kw`` per call: a function of the rows."""
    outs = []
    for d, g in enumerate(groups):
        rows = data_rows(make_mesh(len(groups), 1, ["cpu"] * len(groups)),
                         B, d)
        with use_mesh(g.mesh):
            outs.append(tllm.llm_apply(g, cfg, return_hidden=True,
                                       sequence_parallel=sp,
                                       **{k: v(rows) for k, v in kw.items()}))
    return tuple(torch.cat([o[i] for o in outs]) for i in (0, 2))


def test_sp_forward_matches_tp_and_jax(jax_sp):
    cfg = llm_config_for("test/llama-dryrun")
    tree = bridge.llm_from_jax(jax_sp["params"], "cpu")
    ids = torch.from_numpy(jax_sp["ids"]).long()
    groups = _groups(tree, cfg, make_mesh(2, 4, ["cpu"] * 8))
    with torch.no_grad():
        sp = _forward(groups, cfg, 4, True, input_ids=lambda r: ids[r])
        tp = _forward(groups, cfg, 4, False, input_ids=lambda r: ids[r])
        one = tllm.llm_apply(tree, cfg, input_ids=ids, return_hidden=True)
    for got, want, jx in zip(sp, tp, (jax_sp["logits"], jax_sp["hidden"])):
        assert torch.equal(got, want)
        assert float((got - torch.tensor(jx)).abs().max()) < JAX_TOL
    assert float((sp[0] - one[0]).abs().max()) <= ONE_TOL * float(
        one[0].abs().max())


@pytest.mark.parametrize("T,remat", [(15, False), (15, True), (16, True)])
def test_sp_slices_and_gradients_equal_tp(monkeypatch, T, remat):
    """T = 15 over p = 4 (slices of 4, 4, 4, 3): hidden and the input
    gradient equal the tensor-parallel forward's; between blocks each rank
    holds only its slice."""
    cfg = llm_config_for("test/llama-dryrun")
    gen = torch.Generator().manual_seed(0)
    tree = tllm.init_llm(cfg, torch.float32, "cpu", gen)
    x0 = torch.randn(2, T, cfg.hidden_size, generator=gen)
    mask = torch.ones(2, T, dtype=torch.long)
    mask[1, :4] = 0
    slices = []
    real = tllm._group_layer
    monkeypatch.setattr(tllm, "_group_layer", lambda p, c, l, xs, *a: (
        len(xs) > 1 and slices.append([tuple(x.shape) for x in xs]))
        or real(p, c, l, xs, *a))
    group = _groups(tree, cfg, make_mesh(1, 4, ["cpu"] * 4))[0]
    got = []
    for sp in (True, False):
        x = x0.clone().requires_grad_(True)
        with use_mesh(group.mesh):
            h = tllm.llm_apply(group, cfg, inputs_embeds=x,
                               attention_mask=mask, return_hidden=True,
                               skip_head=True, remat=remat,
                               sequence_parallel=sp)[2]
        h.pow(2).mean().backward()
        got.append((h.detach(), x.grad))
    (h_sp, g_sp), (h_tp, g_tp) = got
    assert torch.equal(h_sp, h_tp) and torch.equal(g_sp, g_tp)
    sizes = [4, 4, 4, 3] if T == 15 else [4] * 4
    assert slices[0] == [(2, t, cfg.hidden_size) for t in sizes]
    assert len(slices) == cfg.num_hidden_layers * (2 if remat else 1)


@pytest.mark.parametrize("kind", ["lora", "hook"])
def test_sp_under_lora_and_the_hook(kind):
    """LoRA's deltas on the gathered normed input (with dropout drawn over
    the whole rows) and an aux hook on the gathered residual: hidden and aux
    equal the tensor-parallel forward's, and so do the hook's gradients.
    Under LoRA the normed input has three consumers (the adapters, each
    rank's heads) whose gradients autograd sums in another order than
    without SP: within LORA_GRAD_TOL (f32 ulps; read 1.6e-7)."""
    cfg = llm_config_for("test/llama-nano")
    gen = torch.Generator().manual_seed(0)
    tree = tllm.init_llm(cfg, torch.float32, "cpu", gen)
    lora = tllm.init_lora(cfg, 4, "cpu", gen)
    for t in lora["layers"].values():
        t["b"].normal_(0.0, 0.05, generator=gen)
    x0 = torch.randn(2, 13, cfg.hidden_size, generator=gen)
    group = _groups(tree, cfg, make_mesh(1, 2, ["cpu"] * 2))[0]

    def hook(l, h, aux):
        return h * 1.01 + 0.01, (aux[0] + h.float().pow(2).mean(),)

    got = []
    for sp in (True, False):
        x = x0.clone().requires_grad_(True)
        lo = {k: {n: v.clone().requires_grad_(True) for n, v in t.items()}
              for k, t in lora["layers"].items()}
        kw = (dict(lora={"layers": lo}, lora_scale=2.0, lora_dropout=0.3,
                   lora_seed=5) if kind == "lora" else
              dict(extra_layer_fn=hook, extra_aux_init=(torch.zeros(()),)))
        with use_mesh(group.mesh):
            out = tllm.llm_apply(group, cfg, inputs_embeds=x, remat=True,
                                 return_hidden=True, skip_head=True,
                                 sequence_parallel=sp, **kw)
        loss = out[2].pow(2).mean() + (out[3][0] if kind == "hook" else 0)
        loss.backward()
        got.append([out[2].detach(), x.grad] + (
            [lo["v"]["a"].grad, lo["q"]["b"].grad] if kind == "lora"
            else [out[3][0].detach()]))
    (h, *grads), (wh, *wgrads) = got
    assert torch.equal(h, wh)
    for a, b in zip(grads, wgrads):
        if kind == "hook":
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= LORA_GRAD_TOL * float(
                b.abs().max())


def test_sp_train_step_equals_plain_dp_tp():
    """The (2, 4) DeSTA step with sequence_parallel: lm_loss and grad_norm
    those of the plain dp x tp step (``test_sequence_parallel_train_step_
    matches``), and within 1e-5 of one device."""
    cfg = DeSTA25Config(llm_model_id="test/llama-dryrun",
                        encoder_model_id="test/whisper-dryrun",
                        connector_mode="qformer_1",
                        qformer_num_hidden_layers=2, prompt_size=8,
                        dtype="float32")
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    B, L = 4, 64
    ids = rng.integers(0, 500, size=(B, L))
    labels = ids.copy()
    labels[:, :L // 2] = -100
    kind = np.zeros((B, L), np.int64)
    kind[:, 4:12] = 1
    pos = np.zeros((B, L), np.int64)
    pos[:, 4:12] = np.arange(8)
    t = torch.from_numpy
    batch = {"input_ids": t(ids), "attention_mask": torch.ones(B, L).long(),
             "labels": t(labels),
             "audio": t((0.1 * rng.standard_normal((B, 16000))).astype(
                 np.float32)),
             "trans_ids": torch.zeros(B, 8).long(),
             "trans_mask": torch.zeros(B, 8).long(), "kind": t(kind),
             "aidx": t(np.arange(B)[:, None] * (kind > 0)), "pos": t(pos)}
    out = {}
    for name, mesh, sp in (("one", None, False),
                           ("tp", make_mesh(2, 4, ["cpu"] * 8), False),
                           ("sp", make_mesh(2, 4, ["cpu"] * 8), True)):
        optimizer = topt.make_optimizer(topt.OptimizerConfig(
            lr=1e-3, warmup_steps=1, total_steps=10))
        trainable, frozen = model.split_params()
        flat = {k: v.detach().clone()
                for k, v in topt.flatten_tree(trainable).items()}
        owners = (topt.unflatten_tree(flat) if mesh is None
                  else shard_trainable(flat, mesh))
        step = tstep.make_train_step(cfg, optimizer, remat=True)
        _, _, m = step(owners, tstep.TrainLayout(mesh, frozen, cfg,
                                                 sequence_parallel=sp),
                       optimizer.init(flat if mesh is None else owners),
                       batch)
        out[name] = {k: float(v) for k, v in m.items()}
    assert np.isfinite(out["sp"]["lm_loss"])
    for k in ("lm_loss", "loss", "grad_norm"):
        assert out["sp"][k] == out["tp"][k], k
        assert abs(out["sp"][k] - out["one"][k]) <= ONE_TOL * abs(
            out["one"][k]), k
