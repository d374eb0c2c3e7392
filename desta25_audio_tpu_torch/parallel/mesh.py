"""Device meshes for the port (counterpart of
``desta25_audio_tpu/parallel/mesh.py:28-69``).

A mesh is a ``(n_data, n_model)`` grid of torch devices with the JAX
package's axis names: ``data`` splits the batch rows, ``model`` is tensor
parallelism over attention heads and the MLP's hidden dim.  A third axis,
``pipe`` (innermost, as the JAX package orders it), cuts the LLM's layers
into ``n_pipe`` stages for GPipe pipelining (``parallel/pipeline.py``):
``grid[d][m][s]`` is stage s's device of data row d, model rank m, and
``devices[d][m]`` stays stage 0's, so every caller that reads a 2-D mesh
reads a pipe mesh's first stage (at ``n_pipe == 1`` nothing changes).  One process
drives every rank, as ``shard_map`` does in the JAX package.  A device may
repeat: ``make_mesh(n_model=2, devices=["cuda:0"] * 2)`` gives two virtual
ranks on one card (each with its own shard, cache slice, receive buffer and
CUDA stream), ``["cpu"] * 2`` two ranks on the CPU.  On distinct CUDA
devices the ranks' kernels write each other's memory through plain device
pointers; :meth:`Mesh.enable_peer_access` turns that on between every pair
of distinct cards (never from a card to itself: the runtime refuses that).

Serving drives a mesh's every rank at once; training (``train/step.py``)
gives each data row its own ``1 x n_model`` group (:meth:`Mesh.row_mesh`):
the row's batch rows run their whole forward there, and the LLM sees the
group as its mesh.  Between processes (one a host, or one a card under
``torchrun``) ``parallel/distributed.py`` sums the gradients; each process's
default mesh is then its own card, or its own cards' stages.  On a pipe
mesh each data row's group is a ``1 x n_model x n_pipe`` mesh, and
:meth:`Mesh.stage_mesh` gives one stage's ``1 x n_model`` group.
:func:`use_mesh` installs a mesh for the code below it, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import torch

_state = threading.local()


class Mesh:
    """``devices[d][m]``: the device of data row d, model rank m (of stage
    0); ``grid[d][m][s]``: of stage s.  Built from ``[d][m]`` devices (one
    stage) or ``[d][m][s]`` lists of them."""

    def __init__(self, devices: Sequence[Sequence]):
        self.grid: List[List[List[torch.device]]] = [
            [[torch.device(x) for x in (r if isinstance(r, (list, tuple))
                                        else [r])] for r in row]
            for row in devices]
        self.devices: List[List[torch.device]] = [
            [r[0] for r in row] for row in self.grid]
        self.n_data, self.n_model = len(self.devices), len(self.devices[0])
        self.n_pipe = len(self.grid[0][0])
        self._stages: dict = {}
        self._streams: Optional[List[List[torch.cuda.Stream]]] = None
        self._peer_done = False
        # device buffers of the mesh's collectives, made at first use and
        # kept for the mesh's life (ops/tp_allreduce.group_buffers)
        self.buffers: dict = {}

    def device(self, d: int, m: int) -> torch.device:
        return self.devices[d][m]

    def streams(self) -> List[List[torch.cuda.Stream]]:
        """One CUDA stream per rank, made at first use (CUDA meshes only)."""
        if self._streams is None:
            self._streams = [[torch.cuda.Stream(dev) for dev in row]
                             for row in self.devices]
        return self._streams

    def enable_peer_access(self) -> None:
        """Let every pair of distinct CUDA devices of the mesh read and
        write each other's memory (``cudaDeviceEnablePeerAccess``), once."""
        if self._peer_done:
            return
        cards = [dev for dev in self.all_devices() if dev.type == "cuda"]
        if len(cards) > 1:
            from ..ops import _build
            lib = _build.library()
            for a in cards:
                for b in cards:
                    if a != b:
                        _build.check(lib.desta_enable_peer_access(
                            a.index or 0, b.index or 0),
                            f"peer access {a} -> {b}")
        self._peer_done = True

    def all_devices(self) -> List[torch.device]:
        """Every distinct device of the mesh, in grid order."""
        out: List[torch.device] = []
        for row in self.grid:
            for r in row:
                out.extend(dev for dev in r if dev not in out)
        return out

    def row_mesh(self, d: int) -> "Mesh":
        """Data row d's ``1 x n_model`` group (``1 x n_model x n_pipe`` on
        a pipe mesh) as a mesh of its own."""
        if self.n_pipe > 1:
            return Mesh([self.grid[d]])
        return Mesh([self.devices[d]])

    def stage_mesh(self, d: int, s: int) -> "Mesh":
        """Data row d's stage s as a ``1 x n_model`` mesh, made once (its
        streams and buffers are kept with it)."""
        if (d, s) not in self._stages:
            self._stages[d, s] = Mesh([[r[s] for r in self.grid[d]]])
        return self._stages[d, s]

    def __repr__(self) -> str:
        shape = f"{self.n_data}x{self.n_model}" + (
            f"x{self.n_pipe}" if self.n_pipe > 1 else "")
        return f"Mesh({shape}: {self.grid if self.n_pipe > 1 else self.devices})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None, n_pipe: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over ``devices`` (default: every CUDA
    device; a process's own card when several processes share the host under
    a launcher), ``n_data`` defaulting to ``len(devices) // (n_model *
    n_pipe)``; with ``n_pipe`` > 1 a ``("data", "model", "pipe")`` mesh,
    the devices in the JAX package's order (``reshape(n_data, n_model,
    n_pipe)``: "pipe" innermost).  Raises ValueError where the counts do
    not fill the devices."""
    if devices is None:
        from .distributed import local_device, shares_host
        devices = ([local_device("cuda")] if shares_host() else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // (n_model * n_pipe)
    if (n_data < 1 or n_model < 1 or n_pipe < 1
            or n_data * n_model * n_pipe != len(devices)):
        raise ValueError(f"mesh {n_data}x{n_model}x{n_pipe} != "
                         f"{len(devices)} devices")
    if n_pipe == 1:
        return Mesh([devices[d * n_model:(d + 1) * n_model]
                     for d in range(n_data)])
    return Mesh([[devices[(d * n_model + m) * n_pipe:
                          (d * n_model + m + 1) * n_pipe]
                  for m in range(n_model)] for d in range(n_data)])


def on_device(device):
    """Make ``device`` the current CUDA device for the launches below (a
    kernel launches on a stream of the current device); a no-op for the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
