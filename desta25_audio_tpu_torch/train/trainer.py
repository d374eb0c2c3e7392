"""Training loop (port of ``desta25_audio_tpu/train/trainer.py``).

Behaviour kept from the reference: the epoch loop with ``max_steps`` taking
precedence over ``max_epochs``, eval-before-train and an initial checkpoint
on fresh runs, empty-batch skip, loss decomposition logged to JSONL (and
wandb when it is importable and configured), ``val_check_interval`` (a
fraction of an epoch, or a step count above 1), the eval loop with greedy
generation from the context-only view, ConsecutiveWordsAccuracy and a
per-category report JSON (config and git commit), epoch checkpoints, resume
from ``checkpoint-latest``, and ``auto_find_batch_size`` (halve the batch
and restart the epoch on a device OOM before the first successful step).

``num_workers > 0`` collates in background threads
(``data/prefetch.PrefetchLoader``).  With LoRA (``use_lora``) each train
step draws its adapter-dropout masks from a seed of ``global_step`` (the
JAX package's per-step key, ``trainer.py:297-301``), and ``evaluate()``
generates with the adapters and without dropout.

The trainer always trains on a mesh (``train/step.TrainLayout``): with
``mesh`` "on", or "auto" with more than one device in the run (every
process's), or ``mesh_model`` > 1, ``mesh_pipe`` > 1 or ``fsdp`` (JAX's
rule, ``trainer.py:150-168``) a ``(n_data, mesh_model, mesh_pipe)`` mesh
over ``mesh_devices`` (default: every card, or the process's own card under
torchrun; "pipe" innermost), else the ``1 x 1`` mesh of the model's device.
Each data row's group runs its rows' forward with the LLM cut into
``mesh_pipe`` stages of layers and over each stage's ``mesh_model`` ranks:
GPipe over the stages with ``pipeline_microbatches`` > 0, the stages in
order otherwise (and under LoRA or ORCA's hook), and the residual cut over
the sequence between blocks with ``sequence_parallel``
(``parallel/pipeline.py``, ``models/llm.llm_apply``); the gradients meet
on each trainable leaf's owner (with ``fsdp`` the large leaves and their
optimizer state cut over the data rows), and across processes
(``parallel/distributed.py``) they are summed; the batch size is per
process and must divide over the data rows.  ``mesh="off"`` under several
processes raises ValueError (each would train a model of its own).
Metrics, the eval report and checkpoints are written by the main process
only; ``evaluate()`` computes its loss on the mesh and generates on the
model's device.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..audio.mel import log_mel, pad_or_trim
from ..ckpt.checkpoint import restore_train_state, save_train_state
from ..data.dataset import AudioTextDataset, CollateFn, data_loader
from ..data.prefetch import PrefetchLoader
from ..eval.metrics import ConsecutiveWordsAccuracyMetric
from ..generate.decode import llm_generate
from ..models.desta import DeSTA25AudioModel
from ..parallel.distributed import is_main_process, world
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.sharding import Shards, gather_leaf, shard_trainable
from .optimizer import (
    OptimizerConfig,
    flatten_tree,
    make_optimizer,
    unflatten_tree,
)
from .step import TrainLayout, make_eval_step, make_train_step

logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    exp_dir: str = "exp"
    max_epochs: int = 2
    max_steps: int = -1
    log_every_n_steps: int = 10
    val_check_interval: float = 1.0   # fraction of an epoch, or >1 = steps
    eval_max_new_tokens: int = 16
    eval_do_sample: bool = False
    save_strategy: str = "epoch"
    keep_checkpoints: int = 3
    remat: bool = False
    pipeline_microbatches: int = 0
    sequence_parallel: bool = False
    mesh: str = "off"
    mesh_model: int = 1
    mesh_pipe: int = 1
    fsdp: bool = False
    # the mesh's devices, data row by data row (e.g. ["cpu"] * 8, or
    # ["cuda:0"] * 2 for two virtual ranks of one card); None: every card,
    # or the process's own under torchrun
    mesh_devices: Optional[List[str]] = None
    eval_before_train: bool = True
    eval_max_batches: int = -1
    num_workers: int = 0
    seed: int = 0
    auto_find_batch_size: bool = True


def check_trainer_config(tc: TrainerConfig) -> None:
    """Raise ValueError for a bad ``mesh``."""
    if tc.mesh not in ("off", "auto", "on"):
        raise ValueError(f"trainer.mesh={tc.mesh!r} (expected 'off', 'auto', "
                         "or 'on')")


def trainer_mesh(tc: TrainerConfig, device) -> Mesh:
    """The trainer's mesh by JAX's rule (``trainer.py:152-160``): over
    ``mesh_devices`` when ``mesh`` is "on", or "auto" with more than one
    device in the run (counting every process's, as ``jax.devices()``
    does), or ``mesh_model`` > 1, ``mesh_pipe`` > 1 or ``fsdp`` ask for one
    (never when "off"); else the ``1 x 1`` mesh of ``device``.  Raises ValueError for
    ``mesh="off"`` under several processes: each would train a model of its
    own on its share of the rows."""
    processes = world()[1]
    if tc.mesh != "off":
        devices = tc.mesh_devices
        if devices is None and torch.device(device).type != "cuda":
            raise ValueError("a mesh on the CPU needs trainer.mesh_devices "
                             "(e.g. ['cpu'] * 8)")
        mesh = make_mesh(n_model=tc.mesh_model, devices=devices,
                         n_pipe=tc.mesh_pipe)
        if (tc.mesh == "on" or tc.mesh_model > 1 or tc.mesh_pipe > 1
                or tc.fsdp
                or mesh.n_data * mesh.n_model * mesh.n_pipe * processes > 1):
            return mesh
    if processes > 1:
        raise ValueError(
            f"trainer.mesh={tc.mesh!r} under {processes} processes would "
            "train a model a process: set trainer.mesh to 'auto' or 'on'")
    return make_mesh(devices=[device])


class MetricsLogger:
    """JSONL metrics writer, plus wandb when asked for and importable."""

    def __init__(self, exp_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, "metrics.jsonl")
        self.wandb = None
        if use_wandb and is_main_process():
            try:
                import wandb
            except ImportError:
                logger.warning("wandb unavailable; logging to JSONL only")
            else:
                self.wandb = wandb
                wandb.init(**(wandb_kwargs or {}))

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if not is_main_process():
            return
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()
                                if np.ndim(v) == 0}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(rec, step=step)


def _git_commit() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


class DeSTA25Trainer:
    def __init__(self, model: DeSTA25AudioModel,
                 train_dataset: AudioTextDataset,
                 eval_dataset: Optional[AudioTextDataset],
                 collate_fn: CollateFn,
                 optimizer_config: OptimizerConfig,
                 trainer_config: TrainerConfig,
                 logger_: Optional[MetricsLogger] = None):
        check_trainer_config(trainer_config)
        self.model = model
        self.config = model.config
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.collate_fn = collate_fn
        self.opt_cfg = optimizer_config
        self.tcfg = trainer_config
        self.metrics = logger_ or MetricsLogger(trainer_config.exp_dir)
        self.accuracy = ConsecutiveWordsAccuracyMetric()
        self.mesh = trainer_mesh(trainer_config, model.device)
        bs = collate_fn.data_cfg.batch_size
        if bs % self.mesh.n_data:
            raise ValueError(
                f"batch_size={bs} not divisible by the mesh's data axis "
                f"({self.mesh.n_data}); pick a divisible batch size or a "
                f"larger mesh_model/mesh_pipe")
        self.optimizer = make_optimizer(optimizer_config)
        self.layout: Optional[TrainLayout] = None
        self._owners: Optional[Dict[str, Any]] = None
        self.train_step = make_train_step(self.config, self.optimizer,
                                          remat=trainer_config.remat)
        self.global_step = 0

    # -- helpers ----------------------------------------------------------

    def _layout(self) -> TrainLayout:
        """The frozen towers laid out on the mesh, and the eval step there
        (made at first use: a cut LLM takes device memory)."""
        if self.layout is None:
            import torch.distributed as dist
            group = dist.group.WORLD if world()[1] > 1 else None
            self.layout = TrainLayout(
                self.mesh, self.model.split_params()[1], self.config, group,
                pipeline_microbatches=self.tcfg.pipeline_microbatches,
                sequence_parallel=self.tcfg.sequence_parallel)
            self.eval_step = make_eval_step(self.config, self.layout,
                                            remat=self.tcfg.remat)
        return self.layout

    def _shard_state(self, trainable) -> Dict[str, Any]:
        """The trainable leaves' owners on the mesh: with ``fsdp`` the large
        ones cut over the data rows (``Shards``), the others whole on the
        first row's device (the model's own tensors where that is their
        device)."""
        return shard_trainable(flatten_tree(trainable), self.mesh,
                               fsdp=self.tcfg.fsdp)

    def _write_back(self, owners: Dict[str, Any]) -> None:
        """The owners' values into the model's trainable tensors."""
        with torch.no_grad():
            for k, t in flatten_tree(self.model.split_params()[0]).items():
                o = owners[k]
                if isinstance(o, Shards) or o.data_ptr() != t.data_ptr():
                    t.copy_(gather_leaf(o, t.device))

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's arrays as host tensors, for the step to split over
        the data rows and move to their devices; integer arrays as int64
        (index tensors)."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.as_tensor(v)
                out[k] = t if t.is_floating_point() else t.long()
        return out

    def _steps_per_epoch(self) -> int:
        return max(len(self.train_dataset)
                   // self.collate_fn.data_cfg.batch_size, 1)

    def _val_every(self) -> int:
        if self.tcfg.val_check_interval > 1.0:
            return int(self.tcfg.val_check_interval)
        return max(int(self._steps_per_epoch()
                       * self.tcfg.val_check_interval), 1)

    # -- train ------------------------------------------------------------

    def train(self, resume_from_checkpoint: Optional[str] = None):
        layout = self._layout()
        trainable = self._owners = self._shard_state(
            self.model.split_params()[0])
        opt_state = self.optimizer.init(trainable)
        start_epoch = 0
        if resume_from_checkpoint:
            # the values are copied into the owners
            _, opt_state, self.global_step = restore_train_state(
                resume_from_checkpoint, unflatten_tree(trainable), opt_state)
            start_epoch = self.global_step // self._steps_per_epoch()
            logger.info("resumed from step %d (epoch %d)", self.global_step,
                        start_epoch)
        elif self.tcfg.eval_before_train and self.eval_dataset is not None:
            self.evaluate(tag="initial")
            save_train_state(self.tcfg.exp_dir, 0, unflatten_tree(trainable),
                             opt_state, self.config,
                             keep=self.tcfg.keep_checkpoints)

        val_every = self._val_every()
        t_last = time.time()
        # max_steps takes precedence over max_epochs
        max_epochs = (10 ** 9 if self.tcfg.max_steps > 0
                      else self.tcfg.max_epochs)
        stepped_ok = False
        for epoch in range(start_epoch, max_epochs):
            while True:  # auto_find_batch_size retry (restarts the epoch)
                bs = self.collate_fn.data_cfg.batch_size
                if self.tcfg.num_workers > 0:
                    loader = PrefetchLoader(
                        self.train_dataset, self.collate_fn, bs, epoch=epoch,
                        num_workers=self.tcfg.num_workers)
                else:
                    loader = data_loader(self.train_dataset,
                                         self.collate_fn, bs, epoch=epoch)
                try:
                    for batch in loader:
                        if batch.get("_empty_batch"):
                            logger.warning("empty batch at step %d; skipped",
                                           self.global_step)
                            continue
                        db = self._device_batch(batch)
                        if (self.config.use_lora
                                and self.config.lora_dropout > 0):
                            # this step's adapter-dropout seed (peft train())
                            db["lora_seed"] = self.global_step
                        trainable, opt_state, metrics = self.train_step(
                            trainable, layout, opt_state, db)
                        if not stepped_ok:
                            # an allocation failure surfaces here
                            metrics = {k: float(v)
                                       for k, v in metrics.items()}
                            stepped_ok = True
                        self.global_step += 1
                        if self.global_step % self.tcfg.log_every_n_steps \
                                == 0:
                            m = {k: float(v) for k, v in metrics.items()}
                            dt = time.time() - t_last
                            m["steps_per_sec"] = (
                                self.tcfg.log_every_n_steps / dt
                                if dt > 0 else 0.0)
                            m["epoch"] = epoch
                            t_last = time.time()
                            self.metrics.log({f"train/{k}": v
                                              for k, v in m.items()},
                                             self.global_step)
                        if (self.eval_dataset is not None
                                and self.global_step % val_every == 0):
                            self.evaluate(
                                tag=f"ep={epoch}-step={self.global_step}")
                        if 0 < self.tcfg.max_steps <= self.global_step:
                            break
                except torch.cuda.OutOfMemoryError:
                    new_bs = max(bs // 2, 1)
                    if (not self.tcfg.auto_find_batch_size or stepped_ok
                            or bs <= 1 or new_bs % self.mesh.n_data):
                        raise
                    logger.warning(
                        "device OOM at batch_size=%d; retrying the epoch at "
                        "batch_size=%d (auto_find_batch_size)", bs, new_bs)
                    if self.model.device.type == "cuda":
                        torch.cuda.empty_cache()
                    self.collate_fn.data_cfg.batch_size = new_bs
                    val_every = self._val_every()
                    continue
                break
            if self.tcfg.save_strategy == "epoch":
                save_train_state(self.tcfg.exp_dir, self.global_step,
                                 unflatten_tree(trainable), opt_state,
                                 self.config,
                                 keep=self.tcfg.keep_checkpoints)
            if 0 < self.tcfg.max_steps <= self.global_step:
                break

        save_train_state(self.tcfg.exp_dir, self.global_step,
                         unflatten_tree(trainable), opt_state, self.config,
                         keep=self.tcfg.keep_checkpoints)
        self._write_back(trainable)
        self.opt_state = opt_state
        return self.model

    # -- eval -------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, tag: str = "val") -> Dict[str, Any]:
        """Eval loss / ppl and greedy generation from the context view,
        with the per-category accuracy report.  The loss runs on the mesh
        (this process's eval rows) and the generation on the model's device
        with the trained values written back; the main process writes the
        report of its rows."""
        assert self.eval_dataset is not None
        self._layout()
        owners = self._owners
        if owners is None:
            owners = self._shard_state(self.model.split_params()[0])
        else:
            # generation reads the model's own tensors
            self._write_back(owners)
        losses: List[float] = []
        results: List[Dict[str, Any]] = []
        self.accuracy.reset()
        bs = self.collate_fn.data_cfg.batch_size
        n_batches = 0
        for batch in data_loader(self.eval_dataset, self.collate_fn, bs,
                                 drop_last=False):
            if batch.get("_empty_batch"):
                continue
            db = self._device_batch(batch)
            m = self.eval_step(owners, db)
            losses.append(float(m["lm_loss"]))
            db = {k: v.to(self.model.device) for k, v in db.items()}
            gen = dict(db)
            for key in ("input_ids", "attention_mask", "kind", "aidx", "pos"):
                gen[key] = db[f"context_{key}"]
            texts = self._predict_step(gen)
            for i, meta in enumerate(batch["metadata"]):
                label = meta.get("response", "")
                ok = self.accuracy.update(texts[i], label)
                results.append({
                    "context": meta.get("prompt", ""), "label": label,
                    "prediction": texts[i], "correct": ok,
                    "dataset": meta.get("dataset", "unknown")})
            n_batches += 1
            if 0 < self.tcfg.eval_max_batches <= n_batches:
                break
        report = self._save_results(results, losses, tag)
        self.metrics.log({f"val/{k}": v for k, v in report.items()
                          if isinstance(v, (int, float))}, self.global_step)
        return report

    def _predict_step(self, db: Dict[str, torch.Tensor]) -> List[str]:
        model = self.model
        enc_cfg = self.config.encoder_config
        wav = pad_or_trim(db["audio"], enc_cfg.expected_mel_frames * 160)
        mel = log_mel(wav, enc_cfg.num_mel_bins, layout="btm").to(
            model.dtype)
        embeds, _ = model.prepare_inputs_embeds(
            db["input_ids"], mel, db["trans_ids"], db["kind"], db["aidx"],
            db["pos"])
        tk = model.tokenizer
        tokens, _ = llm_generate(
            model.params["llm"], self.config.llm_config, embeds,
            db["attention_mask"],
            torch.Generator(model.device).manual_seed(self.tcfg.seed),
            max_new_tokens=self.tcfg.eval_max_new_tokens,
            do_sample=self.tcfg.eval_do_sample,
            eos_ids=model._terminators(), pad_id=tk.pad_token_id,
            lora=model.params.get("lora"), lora_scale=self.config.lora_scale)
        return tk.batch_decode(tokens.cpu().numpy(), skip_special_tokens=True)

    def _save_results(self, results, losses, tag: str) -> Dict[str, Any]:
        loss = float(np.mean(losses)) if losses else 0.0
        report: Dict[str, Any] = {
            "loss": loss,
            "ppl": float(np.exp(loss)) if losses else 0.0,
            "accuracy": self.accuracy.compute(),
            "n_samples": len(results),
        }
        per_cat: Dict[str, List[bool]] = {}
        for r in results:
            per_cat.setdefault(r["dataset"], []).append(r["correct"])
        for cat, oks in sorted(per_cat.items()):
            report[f"accuracy/{cat}"] = float(np.mean(oks))
        if is_main_process():
            os.makedirs(self.tcfg.exp_dir, exist_ok=True)
            base = os.path.join(self.tcfg.exp_dir, f"val@{tag}")
            with open(base + ".jsonl", "w") as f:
                for r in results:
                    f.write(json.dumps(r) + "\n")
            full = dict(report)
            full["config"] = self.config.to_dict()
            full["git_commit"] = _git_commit()
            full["step"] = self.global_step
            with open(base + "-report.json", "w") as f:
                json.dump(full, f, indent=2)
        logger.info("eval %s: %s", tag, {k: v for k, v in report.items()
                                         if isinstance(v, (int, float))})
        return report
