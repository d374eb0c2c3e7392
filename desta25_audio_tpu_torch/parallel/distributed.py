"""Processes of one training run (counterpart of
``desta25_audio_tpu/parallel/distributed.py:22-58``).

The JAX package runs one controller per host (``jax.distributed``); the
port runs one process per host, or one per card under ``torchrun``, and sums
gradients between them over a ``torch.distributed`` process group: gloo for
CPU tensors, NCCL for CUDA ones.  Inside a process a ``parallel/mesh.Mesh``
drives the process's devices.

:func:`maybe_initialize` reads the launcher's environment:

- torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
- else SLURM's, mapped as ``scripts/train_multihost.sh:27-32`` maps them for
  the JAX package: one process a node (``SLURM_NODEID`` of
  ``SLURM_NNODES``), ``MASTER_ADDR`` (default: the first host of
  ``SLURM_JOB_NODELIST``, which needs ``scontrol``) and ``MASTER_PORT``
  (default 8476).

With one process it does nothing, so single-process runs and the CPU tests
never touch ``torch.distributed``.
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

SLURM_PORT = 8476


def launch_env(env=None) -> Optional[Dict[str, str]]:
    """The process group's settings from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), or None for one process."""
    env = os.environ if env is None else env
    if int(env.get("WORLD_SIZE", "1")) > 1:
        return {"RANK": env["RANK"], "WORLD_SIZE": env["WORLD_SIZE"],
                "LOCAL_RANK": env.get("LOCAL_RANK", "0"),
                "LOCAL_WORLD_SIZE": env.get("LOCAL_WORLD_SIZE", "1"),
                "MASTER_ADDR": env.get("MASTER_ADDR", "localhost"),
                "MASTER_PORT": env.get("MASTER_PORT", "29500")}
    if env.get("SLURM_JOB_ID") and int(env.get("SLURM_NNODES", "1")) > 1:
        addr = env.get("MASTER_ADDR")
        if not addr:
            hosts = subprocess.run(
                ["scontrol", "show", "hostnames", env["SLURM_JOB_NODELIST"]],
                capture_output=True, text=True, check=True).stdout.split()
            addr = hosts[0]
        return {"RANK": env["SLURM_NODEID"], "WORLD_SIZE": env["SLURM_NNODES"],
                "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                "MASTER_ADDR": addr,
                "MASTER_PORT": env.get("MASTER_PORT", str(SLURM_PORT))}
    return None


def maybe_initialize(backend: Optional[str] = None, device=None) -> bool:
    """Join the run's process group when the environment names more than
    one process (:func:`launch_env`); True when a group is up afterwards.

    ``backend``: "gloo" or "nccl"; default NCCL when ``device`` (default:
    CUDA when available) is a CUDA device, else gloo.  Gloo also takes CUDA
    tensors for ``all_reduce`` and ``broadcast``, so processes sharing one
    card name it.  A second call is logged and skipped, as the JAX package
    does."""
    if dist.is_available() and dist.is_initialized():
        logger.warning("torch.distributed is already initialized; skipped")
        return True
    cfg = launch_env()
    if cfg is None:
        return False
    if backend is None:
        dev = torch.device(device if device is not None else
                           "cuda" if torch.cuda.is_available() else "cpu")
        backend = "nccl" if dev.type == "cuda" else "gloo"
    os.environ.update(cfg)
    if backend == "nccl" and int(cfg["LOCAL_WORLD_SIZE"]) > 1:
        torch.cuda.set_device(int(cfg["LOCAL_RANK"]))
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{cfg['MASTER_ADDR']}:{cfg['MASTER_PORT']}",
        world_size=int(cfg["WORLD_SIZE"]), rank=int(cfg["RANK"]))
    logger.info("torch.distributed initialized (%s): process %d of %d",
                backend, dist.get_rank(), dist.get_world_size())
    return True


def world() -> Tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) without a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return world()[0] == 0


def shares_host() -> bool:
    """True when several processes of the run share this host's cards (one
    a card under torchrun, which sets ``LOCAL_WORLD_SIZE``)."""
    return world()[1] > 1 and int(os.environ.get("LOCAL_WORLD_SIZE",
                                                 "1")) > 1


def local_device(device="cuda") -> torch.device:
    """A bare "cuda" is this process's own card when processes share the
    host (``cuda:LOCAL_RANK``), else card 0; any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and shares_host():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def barrier() -> None:
    """Wait for every process (no-op for one)."""
    if world()[1] > 1:
        dist.barrier()
