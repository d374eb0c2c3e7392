"""The all-reduce of tensor-parallel partial sums (K10's collective; the
kernels of ``csrc/tp_allreduce.cu``, whose header holds the protocol).

The ranks of one "model" group each hold an f32 partial sum [R, D] of a wo or
w_down product; every rank adds the sum of all of them into its residual h,
in rank order d = 0..p-1 (``fused_decode.py:690-693`` of the JAX package
sums its own partial first; at p = 2 that is the same number, and at p >= 3
rank order keeps the ranks' residuals replicated bit for bit, see the
kernel's header):

    bf16 residual (K10):  h = bf16(h + bf16(p_0 + p_1 + ... + p_{p-1}))
    f32 residual (K9):    h = h + (p_0 + p_1 + ... + p_{p-1})

On CUDA each round is two launches per rank: :meth:`MeshBuffers.store`, the
wo / down GEMM that writes its partial into every rank's receive buffer and
publishes an epoch (counted under the caller's name), and
:meth:`MeshBuffers.reduce`, which waits for every rank's epoch and adds the
sum into h (counted as ``tp_allreduce``).  :func:`allreduce_plain` is the
same function in plain PyTorch, the one the CPU runs.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import _build
from .skinny_gemm import passes

ATTN_SLOT, MLP_SLOT = 0, 1


def allreduce_plain(parts: Sequence[torch.Tensor],
                    hs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each rank's new residual: ``hs[r] + sum(parts)`` with the sum taken
    in f32 in rank order on rank r's device; a bf16 (or any non-f32)
    residual adds the sum rounded to its dtype and rounds again."""
    out = []
    for h in hs:
        tot = parts[0].to(h.device)
        for part in parts[1:]:
            tot = tot + part.to(h.device)
        if h.dtype == torch.float32:
            out.append(h + tot)
        else:
            out.append((h.float() + tot.to(h.dtype).float()).to(h.dtype))
    return out


class MeshBuffers:
    """The device memory of one model group's all-reduce at R rows of width
    D, made once and kept on the mesh (:func:`group_buffers`): per rank a
    receive buffer [2, p, R, D] f32 (slot 0: attention, slot 1: MLP), flag
    words [2, p] int64, two arrival counters and an error word, and device
    tables of the group's buffer and flag pointers.  ``epoch`` counts the
    rounds; flags are never reset."""

    def __init__(self, devices: Sequence[torch.device], R: int, D: int):
        p = len(devices)
        self.p, self.R, self.D = p, R, D
        self.rbuf = [torch.zeros(2, p, R, D, dtype=torch.float32, device=dev)
                     for dev in devices]
        self.flags = [torch.zeros(2, p, dtype=torch.int64, device=dev)
                      for dev in devices]
        self.counter = [torch.zeros(2, dtype=torch.int32, device=dev)
                        for dev in devices]
        self.err = [torch.zeros(1, dtype=torch.int32, device=dev)
                    for dev in devices]

        def table(ts, dev):
            return torch.tensor([t.data_ptr() for t in ts], dtype=torch.int64,
                                device=dev)
        self.dst_table = [table(self.rbuf, dev) for dev in devices]
        self.flag_table = [table(self.flags, dev) for dev in devices]
        self.epoch = 0

    def next_round(self) -> int:
        self.epoch += 1
        return self.epoch

    def store(self, rank: int, slot: int, epoch: int, x: torch.Tensor, w,
              scale, name: str, stream: int) -> None:
        """Rank ``rank``'s producer: x [R, K] bf16 times its weight w [D, K]
        (bf16, or int8 with f32 ``scale`` [D]) into slot ``slot`` of every
        rank's buffer, then the epoch into their flags."""
        R, K = x.shape
        lib = _build.library()
        _build.check(lib.desta_gemm_peer(
            x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            int(w.dtype == torch.int8), R, self.D, K,
            self.dst_table[rank].data_ptr(), self.flag_table[rank].data_ptr(),
            self.counter[rank][slot:].data_ptr(),
            (slot * self.p + rank) * R * self.D, self.p, slot * self.p + rank,
            epoch, stream), name)
        _build.count_launch(name)
        _build.count_kernel("skinny_gemm", passes(R))

    def reduce(self, rank: int, slot: int, epoch: int, h: torch.Tensor,
               stream: int) -> None:
        """Rank ``rank``'s consumer: h [R, D] (bf16 or f32) += the slot's
        sum once every rank has published ``epoch``."""
        name = "tp_allreduce"
        _build.check(_build.library().desta_tp_allreduce(
            self.rbuf[rank].data_ptr(), self.flags[rank].data_ptr(),
            h.data_ptr(), int(h.dtype == torch.float32), self.p, slot, epoch,
            self.R, self.D, self.err[rank].data_ptr(), stream), name)
        _build.count_launch(name)

    def check_timeouts(self, what: str) -> None:
        """Raise RuntimeError if a spin of a finished step timed out (syncs
        the devices), clearing the error words."""
        bad = [r for r, e in enumerate(self.err) if int(e.item())]
        for e in self.err:
            e.zero_()
        if bad:
            raise RuntimeError(
                f"{what}: the all-reduce of ranks {bad} timed out waiting "
                "for a peer's partial sum (a rank's producer never ran)")


def group_buffers(mesh, group: int, R: int, D: int) -> MeshBuffers:
    """The all-reduce buffers of the mesh's data row ``group`` at R x D;
    the mesh's cards reach each other's memory from here on."""
    key = ("tp_allreduce", group, R, D)
    if key not in mesh.buffers:
        mesh.enable_peer_access()
        mesh.buffers[key] = MeshBuffers(mesh.devices[group], R, D)
    return mesh.buffers[key]
