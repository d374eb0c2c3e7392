"""Training entry point (port of ``desta25_audio_tpu/cli/train.py``): the
reference-schema YAML config (``model:``, ``trainer:``, ``optim:``,
``dataset:`` groups) plus dotted overrides and Hydra-style dataset groups.

    python -m desta25_audio_tpu_torch.cli.train \\
        --config configs/desta25_llama31-8B_Qformer6L.yaml \\
        exp_dir=exp/run1 +dataset=DestaAQA-5M trainer.max_steps=10

``--device`` picks the device (default ``cuda``).  The YAML keys
``trainer.mesh`` ("off" / "auto" / "on"), ``trainer.mesh_model``,
``trainer.fsdp`` and ``trainer.mesh_devices`` train on a device mesh
(``train/trainer.py``).  Under torchrun (or SLURM, one process a node) the
processes join one process group before any device is touched
(``parallel/distributed.maybe_initialize``: NCCL for ``--device cuda``,
gloo for the CPU), each on its own card, and sum their gradients:

    torchrun --nproc_per_node 4 -m desta25_audio_tpu_torch.cli.train \
        --config configs/desta25_llama31-8B_Qformer6L.yaml \
        exp_dir=exp/run1 +dataset=DestaAQA-5M trainer.mesh=on

The main process logs at INFO (the others at WARNING) and writes the
config, metrics, reports and checkpoints.  The config is dumped to
``exp_dir/config.yaml``; fresh runs evaluate and checkpoint before training;
``resume_from_checkpoint`` resumes; ``init_from_pretrained_weights`` (a
checkpoint dir or its ``model.safetensors``) warm-starts the trainable params
instead (the two exclude each other).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict, List

import yaml

logger = logging.getLogger("desta25_train")


def compose_dataset_group(cfg: Dict[str, Any], name: str, config_dir: str):
    """``+dataset=NAME``: load ``<config_dir>/dataset/NAME.yaml`` (or NAME
    as a path) into ``cfg["dataset"]``."""
    candidates = [
        name,
        os.path.join(config_dir, "dataset", f"{name}.yaml"),
        os.path.join(config_dir, "dataset", name),
    ]
    for path in candidates:
        if os.path.isfile(path):
            with open(path) as f:
                cfg["dataset"] = yaml.safe_load(f)
            return cfg
    raise FileNotFoundError(
        f"dataset group {name!r} not found (tried {candidates})")


def apply_overrides(cfg: Dict[str, Any], overrides: List[str],
                    config_dir: str = "."):
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key.path=value")
        key, value = ov.split("=", 1)
        key = key.lstrip("+")
        if key == "dataset" and not value.startswith(("{", "[")):
            compose_dataset_group(cfg, value, config_dir)
            continue
        try:
            value = yaml.safe_load(value)
        except yaml.YAMLError:
            pass
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg


def _mesh_key(value) -> str:
    """``trainer.mesh``: YAML 1.1 reads a bare on / off as a boolean."""
    if isinstance(value, bool):
        return "on" if value else "off"
    return str(value)


def build_from_config(cfg: Dict[str, Any], device: str = "cuda"):
    from ..config import config_from_yaml_model_section
    from ..data.dataset import AudioTextDataset, CollateFn, DataConfig
    from ..models.desta import DeSTA25AudioModel
    from ..train.optimizer import OptimizerConfig
    from ..parallel.distributed import local_device
    from ..train.trainer import DeSTA25Trainer, MetricsLogger, TrainerConfig

    model_cfg = config_from_yaml_model_section(cfg["model"])
    model = DeSTA25AudioModel(model_cfg, device=local_device(device),
                              seed=cfg.get("seed", 0))

    # warm-start from a pretrained trainable-only checkpoint
    # (train_desta.py:73-83, :188-189) -- mutually exclusive with resume
    init_w = (cfg.get("init_from_pretrained_weights")
              or cfg.get("model", {}).get("init_from_pretrained_weights"))
    if init_w and init_w != "null":
        if cfg.get("resume_from_checkpoint"):
            raise ValueError("Cannot provide both resume_from_checkpoint and "
                             "init_from_pretrained_weights")
        from ..ckpt.desta_io import load_trainable_safetensors
        path = (os.path.join(init_w, "model.safetensors")
                if os.path.isdir(init_w) else init_w)
        logger.info("warm-starting trainable params from %s", path)
        model.params = load_trainable_safetensors(model.params, model_cfg,
                                                  path)

    ds_cfg = cfg.get("dataset", {})
    trainer_cfg = cfg.get("trainer", {})
    optim_cfg = cfg.get("optim", {})

    def data_config(split: str) -> DataConfig:
        split_cfg = ds_cfg.get(split, {})
        return DataConfig(
            manifest_filepaths=split_cfg.get(
                "manifest_filepaths", ds_cfg.get("manifest_filepaths", [])),
            data_root=split_cfg.get("data_root", ds_cfg.get("data_root", "")),
            batch_size=split_cfg.get("batch_size",
                                     ds_cfg.get("batch_size", 8)),
            max_seq_length=split_cfg.get(
                "max_seq_length", ds_cfg.get("max_seq_length", 300)),
            system_prompt=ds_cfg.get("system_prompt"),
            shuffle=(split == "train"),
        )

    train_dc = data_config("train_ds")
    val_dc = data_config("validation_ds")
    train_ds = AudioTextDataset(model_cfg, train_dc, model.tokenizer)
    val_ds = (AudioTextDataset(model_cfg, val_dc, model.tokenizer)
              if val_dc.manifest_filepaths else None)
    collate = CollateFn(model_cfg, train_dc, model.tokenizer)

    steps_per_epoch = max(len(train_ds) // train_dc.batch_size, 1)
    max_epochs = trainer_cfg.get("max_epochs", 2)
    total_steps = trainer_cfg.get("max_steps", -1)
    if total_steps is None or total_steps <= 0:
        total_steps = steps_per_epoch * max_epochs

    ocfg = OptimizerConfig(
        lr=float(optim_cfg.get("lr", 1e-4)),
        warmup_steps=int(optim_cfg.get("sched", {}).get("warmup_steps",
                                                        5000)),
        total_steps=int(total_steps),
        gradient_clip_val=float(trainer_cfg.get("gradient_clip_val", 1.0)),
        accumulate_grad_batches=int(
            trainer_cfg.get("accumulate_grad_batches", 1)),
        weight_decay=float(optim_cfg.get("weight_decay", 0.0)),
    )
    exp_dir = cfg.get("exp_dir") or "exp/default"
    tcfg = TrainerConfig(
        exp_dir=exp_dir,
        max_epochs=max_epochs,
        max_steps=trainer_cfg.get("max_steps", -1) or -1,
        log_every_n_steps=int(trainer_cfg.get("log_every_n_steps", 10)),
        # YAML 1.1 reads a bare "1e9" as a string
        val_check_interval=float(trainer_cfg.get("val_check_interval", 1.0)),
        eval_max_new_tokens=cfg.get("model", {}).get(
            "generation_kwargs", {}).get("max_new_tokens", 16),
        remat=bool(trainer_cfg.get("gradient_checkpointing", False)),
        pipeline_microbatches=int(
            trainer_cfg.get("pipeline_microbatches", 0) or 0),
        sequence_parallel=bool(trainer_cfg.get("sequence_parallel", False)),
        mesh=_mesh_key(trainer_cfg.get("mesh", "off")),
        mesh_model=int(trainer_cfg.get("mesh_model", 1)),
        mesh_pipe=int(trainer_cfg.get("mesh_pipe", 1)),
        fsdp=bool(trainer_cfg.get("fsdp", False)),
        mesh_devices=trainer_cfg.get("mesh_devices"),
        seed=cfg.get("seed", 0),
        auto_find_batch_size=bool(
            trainer_cfg.get("auto_find_batch_size", True)),
    )
    wandb_cfg = cfg.get("wandb")
    mlogger = MetricsLogger(
        exp_dir, use_wandb=bool(wandb_cfg),
        wandb_kwargs=({"project": wandb_cfg.get("project", "desta25"),
                       "name": cfg.get("name"), "config": cfg}
                      if wandb_cfg else None))
    trainer = DeSTA25Trainer(model, train_ds, val_ds, collate, ocfg, tcfg,
                             logger_=mlogger)
    return model, trainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device for the model and every step")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    # join the run's processes before any device is touched
    from ..parallel.distributed import is_main_process, maybe_initialize
    maybe_initialize(device=args.device)
    logging.basicConfig(
        level=logging.INFO if is_main_process() else logging.WARNING,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")

    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    cfg = apply_overrides(cfg, args.overrides,
                          config_dir=os.path.dirname(args.config) or ".")
    exp_dir = cfg.get("exp_dir") or "exp/default"
    os.makedirs(exp_dir, exist_ok=True)
    if is_main_process():
        with open(os.path.join(exp_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)

    _, trainer = build_from_config(cfg, device=args.device)
    trainer.train(resume_from_checkpoint=cfg.get("resume_from_checkpoint"))
    logger.info("training done at step %d", trainer.global_step)


if __name__ == "__main__":
    main()
