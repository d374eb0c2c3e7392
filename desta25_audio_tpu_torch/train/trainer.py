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

One device, one process.  The JAX package's mesh options (``mesh``,
``mesh_model``, ``mesh_pipe``, ``fsdp``, ``pipeline_microbatches``,
``sequence_parallel``) raise NotImplementedError naming their ROADMAP.md
item.
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
from .optimizer import OptimizerConfig, flatten_tree, make_optimizer
from .step import make_eval_step, make_train_step

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
    eval_before_train: bool = True
    eval_max_batches: int = -1
    num_workers: int = 0
    seed: int = 0
    auto_find_batch_size: bool = True


def check_trainer_config(tc: TrainerConfig) -> None:
    """Raise NotImplementedError for the options the port lacks."""
    if (tc.mesh != "off" or tc.mesh_model > 1 or tc.mesh_pipe > 1 or tc.fsdp
            or tc.pipeline_microbatches or tc.sequence_parallel):
        raise NotImplementedError(
            "multi-device training (mesh, tensor/pipeline/sequence "
            "parallelism, fsdp) is not ported yet (ROADMAP.md Queue 1, "
            "item 5: multi-GPU)")


class MetricsLogger:
    """JSONL metrics writer, plus wandb when asked for and importable."""

    def __init__(self, exp_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, "metrics.jsonl")
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                logger.warning("wandb unavailable; logging to JSONL only")
            else:
                self.wandb = wandb
                wandb.init(**(wandb_kwargs or {}))

    def log(self, metrics: Dict[str, Any], step: int) -> None:
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
        self.optimizer = make_optimizer(optimizer_config)
        self.train_step = make_train_step(self.config, self.optimizer,
                                          remat=trainer_config.remat)
        self.eval_step = make_eval_step(self.config,
                                        remat=trainer_config.remat)
        self.global_step = 0

    # -- helpers ----------------------------------------------------------

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the model's device; integer arrays as
        int64 (index tensors)."""
        dev = self.model.device
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.as_tensor(v)
                if not t.is_floating_point():
                    t = t.long()
                out[k] = t.to(dev)
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
        trainable, frozen = self.model.split_params()
        for t in flatten_tree(trainable).values():
            t.requires_grad_(True)
        opt_state = self.optimizer.init(flatten_tree(trainable))
        start_epoch = 0
        if resume_from_checkpoint:
            trainable, opt_state, self.global_step = restore_train_state(
                resume_from_checkpoint, trainable, opt_state)
            start_epoch = self.global_step // self._steps_per_epoch()
            logger.info("resumed from step %d (epoch %d)", self.global_step,
                        start_epoch)
        elif self.tcfg.eval_before_train and self.eval_dataset is not None:
            self.evaluate(tag="initial")
            save_train_state(self.tcfg.exp_dir, 0, trainable, opt_state,
                             self.config, keep=self.tcfg.keep_checkpoints)

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
                            trainable, frozen, opt_state, db)
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
                    if (not self.tcfg.auto_find_batch_size or stepped_ok
                            or bs <= 1):
                        raise
                    new_bs = max(bs // 2, 1)
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
                                 trainable, opt_state, self.config,
                                 keep=self.tcfg.keep_checkpoints)
            if 0 < self.tcfg.max_steps <= self.global_step:
                break

        save_train_state(self.tcfg.exp_dir, self.global_step, trainable,
                         opt_state, self.config,
                         keep=self.tcfg.keep_checkpoints)
        self.opt_state = opt_state
        return self.model

    # -- eval -------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, tag: str = "val") -> Dict[str, Any]:
        """Eval loss / ppl and greedy generation from the context view,
        with the per-category accuracy report."""
        assert self.eval_dataset is not None
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
            m = self.eval_step(self.model.params, db)
            losses.append(float(m["lm_loss"]))
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
