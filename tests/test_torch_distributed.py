"""The port's process groups on the CPU (``parallel/distributed.py``): the
launcher environments, the per-process row split of the dataset, writes by
the main process only, and two processes over gloo, each with a ``1 x 1``
mesh (``mesh="auto"``) and B=2, whose one train step equals the
one-process ``(2, 1)`` step on their two batches concatenated (and whose
out-of-memory in one process backs both off together)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt.checkpoint import save_train_state
from desta25_audio_tpu_torch.data import dataset as tdata
from desta25_audio_tpu_torch.parallel import distributed as pdist
from desta25_audio_tpu_torch.parallel.mesh import make_mesh
from desta25_audio_tpu_torch.parallel.sharding import (
    gather_trainable,
    shard_trainable,
)
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train import step as tstep
from desta25_audio_tpu_torch.train.trainer import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", connector_mode="qformer_1",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20, gradient_clip_val=1.0)

# one process of the run: its trainer with mesh "auto" (a 1 x 1 mesh of the
# CPU a process: two devices in the run), one step at B=2 over its rows of
# the manifest; then (phase "oom", mesh "on") a trainer whose step runs out
# of memory in process 1 alone at B=2
WORKER = r"""
import json, os, sys, torch
torch.set_num_threads(1)
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.data import dataset as tdata
from desta25_audio_tpu_torch.parallel import distributed as pdist
from desta25_audio_tpu_torch.train import optimizer as topt
from desta25_audio_tpu_torch.train import step as tstep
from desta25_audio_tpu_torch.train.trainer import DeSTA25Trainer, TrainerConfig
manifest, root, out, nano, opt = sys.argv[1:6]
assert pdist.maybe_initialize("gloo")
rank, world = pdist.world()

def trainer(name, mesh, **kw):
    cfg = DeSTA25Config(**json.loads(nano))
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    dcfg = tdata.DataConfig(manifest_filepaths=[manifest], data_root=root,
                            batch_size=2, max_seq_length=96,
                            num_audio_samples=48000, trans_max_tokens=8)
    ds = tdata.AudioTextDataset(cfg, dcfg, model.tokenizer)
    return DeSTA25Trainer(
        model, ds, None, tdata.CollateFn(cfg, dcfg, model.tokenizer),
        topt.OptimizerConfig(**json.loads(opt)),
        TrainerConfig(exp_dir=os.path.join(out, name), max_steps=1,
                      log_every_n_steps=1, eval_before_train=False,
                      val_check_interval=1e9, mesh=mesh,
                      mesh_devices=["cpu"], **kw))

tr = trainer("exp", "auto", auto_find_batch_size=False)
tr.train()
torch.save({"rows": [r["id"] for r in tr.train_dataset.rows],
            "trainable": topt.flatten_tree(tr.model.split_params()[0])},
           os.path.join(out, f"rank{rank}.pt"))
real = tstep.forward_parts
def oom(params, batch, *a, **k):
    if rank == 1 and batch["input_ids"].shape[0] > 1:
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
    return real(params, batch, *a, **k)
tstep.forward_parts = oom
tr = trainer("oom", "on")
tr.train()
with open(os.path.join(out, f"oom{rank}.json"), "w") as f:
    json.dump({"batch_size": tr.collate_fn.data_cfg.batch_size,
               "step": tr.global_step}, f)
"""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
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
                     "response": f"tone {i}" + " and more" * (i % 3)})
    manifest = root / "train.jsonl"
    with open(manifest, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(manifest), str(root)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launch_env():
    assert pdist.launch_env({}) is None
    assert pdist.launch_env({"WORLD_SIZE": "1", "RANK": "0"}) is None
    tr = pdist.launch_env({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2",
                           "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "h0",
                           "MASTER_PORT": "1234"})
    assert tr == {"RANK": "2", "WORLD_SIZE": "4", "LOCAL_RANK": "2",
                  "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "h0",
                  "MASTER_PORT": "1234"}
    # SLURM, as scripts/train_multihost.sh:27-32 maps it: a process a node
    sl = pdist.launch_env({"SLURM_JOB_ID": "7", "SLURM_NNODES": "3",
                           "SLURM_NODEID": "1", "MASTER_ADDR": "node0"})
    assert sl == {"RANK": "1", "WORLD_SIZE": "3", "LOCAL_RANK": "0",
                  "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "node0",
                  "MASTER_PORT": str(pdist.SLURM_PORT)}
    assert pdist.launch_env({"SLURM_JOB_ID": "7", "SLURM_NNODES": "1"}) \
        is None


def test_one_process_needs_no_group(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "SLURM_JOB_ID"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.maybe_initialize() is False
    assert pdist.world() == (0, 1) and pdist.is_main_process()
    assert not pdist.shares_host()
    assert pdist.local_device("cuda") == torch.device("cuda")
    assert pdist.local_device("cpu") == torch.device("cpu")
    pdist.barrier()


def test_dataset_rows_split_by_process(corpus, monkeypatch):
    manifest, root = corpus
    cfg = DeSTA25Config(**NANO)
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    dcfg = tdata.DataConfig(manifest_filepaths=[manifest], data_root=root)
    whole = tdata.AudioTextDataset(cfg, dcfg, model.tokenizer)
    monkeypatch.setattr(pdist, "world", lambda: (1, 3))
    part = tdata.AudioTextDataset(cfg, dcfg, model.tokenizer)
    assert part.rows == whole.rows[1::3] and len(part) == 3
    kept = tdata.AudioTextDataset(cfg, dcfg, model.tokenizer,
                                  shard_by_process=False)
    assert kept.rows == whole.rows


def test_only_the_main_process_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(pdist, "world", lambda: (1, 2))
    log = MetricsLogger(str(tmp_path / "exp"))
    log.log({"loss": 1.0}, 1)
    assert not os.path.exists(log.path)
    path = save_train_state(str(tmp_path / "exp"), 3,
                            {"w": torch.zeros(2)}, {"count": 0})
    assert path.endswith("checkpoint-3") and not os.path.exists(path)


def test_two_processes_over_gloo_equal_one_process(corpus, tmp_path):
    manifest, root = corpus
    out = tmp_path / "run"
    out.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "LOCAL_RANK")}
    env.update(WORLD_SIZE="2", LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, manifest, root, str(out),
         json.dumps(NANO), json.dumps(OPT)], cwd=REPO,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs

    # the one-process (2, 1) step on the two processes' first batches
    torch.set_num_threads(1)
    cfg = DeSTA25Config(**NANO)
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    dcfg = tdata.DataConfig(manifest_filepaths=[manifest], data_root=root,
                            batch_size=2, max_seq_length=96,
                            num_audio_samples=48000, trans_max_tokens=8)
    items, runs = [], []
    for r in range(2):
        ds = tdata.AudioTextDataset(cfg, dcfg, model.tokenizer,
                                    shard_by_process=False)
        ds.rows = ds.rows[r::2]
        run = torch.load(out / f"rank{r}.pt", weights_only=True)
        assert run["rows"] == [row["id"] for row in ds.rows]
        items += list(ds.iter_valid(0))[:2]
        runs.append(run["trainable"])
    batch = tdata.CollateFn(cfg, dcfg, model.tokenizer)(items)
    batch = {k: torch.as_tensor(v) if v.dtype.kind == "f"
             else torch.as_tensor(v).long()
             for k, v in batch.items() if isinstance(v, np.ndarray)}
    mesh = make_mesh(2, 1, ["cpu"] * 2)
    trainable, frozen = model.split_params()
    layout = tstep.TrainLayout(mesh, frozen, cfg)
    optimizer = topt.make_optimizer(topt.OptimizerConfig(**OPT))
    owners = shard_trainable({k: v.detach().clone() for k, v in
                              topt.flatten_tree(trainable).items()}, mesh)
    step = tstep.make_train_step(cfg, optimizer)
    owners, _, m = step(owners, layout, optimizer.init(owners), batch)
    want = gather_trainable(owners)

    with open(out / "exp" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 1                    # the main process's line only
    for k in ("lm_loss", "loss", "grad_norm", "n_tokens"):
        got = recs[0][f"train/{k}"]
        assert abs(got - float(m[k])) <= 1e-6 * abs(float(m[k])), (k, got)
    for k, w in want.items():
        for run in runs:
            assert float((run[k] - w).abs().max()) <= 1e-6 * (
                float(w.abs().max()) + 1e-12), k
    assert torch.equal(runs[0][k], runs[1][k])
    assert sorted(os.listdir(out / "exp")) == [
        "checkpoint-1", "checkpoint-latest", "metrics.jsonl"]

    # an OOM in process 1 alone backs off both processes
    for r in range(2):
        with open(out / f"oom{r}.json") as f:
            assert json.load(f) == {"batch_size": 1, "step": 1}
