"""The all-reduce of tensor-parallel partial sums (K10's collective; the
kernels of ``csrc/tp_allreduce.cu``, whose header holds the protocol).

The ranks of one "model" group each hold an f32 partial sum [R, D] of a wo or
w_down product; every rank adds the sum of all of them into its residual h,
in rank order d = 0..p-1 (``fused_decode.py:690-693`` of the JAX package
sums its own partial first; at p = 2 that is the same number, and at p >= 3
rank order keeps the ranks' residuals replicated bit for bit, see the
kernel's header), and, given the next half's norm weight, writes that
norm of the new residual:

    bf16 residual (K10):  h = bf16(h + bf16(p_0 + p_1 + ... + p_{p-1}))
    f32 residual (K9):    h = h + (p_0 + p_1 + ... + p_{p-1})
    next norm (optional): xn = bf16(rms_norm(h) * w)

On CUDA each round is two launches per rank: :meth:`MeshBuffers.store`, the
wo / down GEMM that writes its partial into every rank's receive buffer and
publishes the round's epoch (counted under the caller's name), and
:meth:`MeshBuffers.reduce`, which waits for every rank's epoch, adds the sum
into h and writes the norm (counted as ``tp_allreduce``).  Epochs live on
the device: :meth:`MeshBuffers.begin` fills each rank's base word before a
step, and a launch carries only its round within the step
(:func:`layer_round`), so that a CUDA graph of the step publishes new
epochs at every replay.  :func:`allreduce_rmsnorm_plain` is the same
function in plain PyTorch, the one the CPU runs; the kernel's residual is
its bits, and its norm the bits of the step's own norm kernel on that
residual (``ops/fused_decode.decode_rms_norm``: the same thread layout and
arithmetic; ``rms_plain`` sums the squares in torch's order).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import _build
from .fused_decode import rms_plain
from .skinny_gemm import passes

ATTN_SLOT, MLP_SLOT = 0, 1


def layer_round(layer: int, slot: int) -> int:
    """The round of layer ``layer``'s attention (slot 0) or MLP (slot 1)
    all-reduce within a step: 2 * layer + slot + 1.  Its epoch is the
    step's base (:meth:`MeshBuffers.begin`) + this round, so a step of L
    layers takes the 2 * L epochs after its base."""
    return 2 * layer + slot + 1


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


def allreduce_rmsnorm_plain(parts: Sequence[torch.Tensor],
                            hs: Sequence[torch.Tensor],
                            w: Optional[torch.Tensor] = None,
                            eps: float = 0.0
                            ) -> Tuple[List[torch.Tensor],
                                       Optional[List[torch.Tensor]]]:
    """The fused consumer's function: every rank's new residual
    (:func:`allreduce_plain`) and, given the next half's norm weight ``w``
    [D], each rank's norm of it in bf16 (``rms_plain``), else None."""
    new = allreduce_plain(parts, hs)
    if w is None:
        return new, None
    return new, [rms_plain(h, w.to(h.device), eps, torch.bfloat16)
                 for h in new]


class MeshBuffers:
    """The device memory of one model group's all-reduce at R rows of width
    D, made once and kept on the mesh (:func:`group_buffers`): per rank a
    receive buffer [2, p, R, D] f32 (slot 0: attention, slot 1: MLP), flag
    words [2, p] int64, two arrival counters, an error word and a base word
    (int64: the step's epochs are base + round), and device tables of the
    group's buffer and flag pointers.  ``rounds`` counts the epochs handed
    out; flags are never reset."""

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
        self.base = [torch.zeros(1, dtype=torch.int64, device=dev)
                     for dev in devices]

        def table(ts, dev):
            return torch.tensor([t.data_ptr() for t in ts], dtype=torch.int64,
                                device=dev)
        self.dst_table = [table(self.rbuf, dev) for dev in devices]
        self.flag_table = [table(self.flags, dev) for dev in devices]
        self.rounds = 0

    def begin(self, rounds: int) -> int:
        """Reserve the group's next ``rounds`` epochs for one step: every
        rank's base word is filled, on its device's current stream, with
        the epochs handed out so far, ``base``, and the step's round r
        (1..rounds) publishes and waits for base + r.  Returns base.  Call
        it stream-ordered after every kernel of the previous step (they
        read the word) and before every kernel of this one."""
        base = self.rounds
        self.rounds += rounds
        for word in self.base:
            word.fill_(base)
        return base

    def store(self, rank: int, slot: int, round_: int, x: torch.Tensor, w,
              scale, name: str, stream: int) -> None:
        """Rank ``rank``'s producer: x [R, K] bf16 times its weight w [D, K]
        (bf16, or int8 with f32 ``scale`` [D]) into slot ``slot`` of every
        rank's buffer, then the epoch base + ``round_`` into their flags."""
        R, K = x.shape
        lib = _build.library()
        _build.check(lib.desta_gemm_peer(
            x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            int(w.dtype == torch.int8), R, self.D, K,
            self.dst_table[rank].data_ptr(), self.flag_table[rank].data_ptr(),
            self.counter[rank][slot:].data_ptr(),
            (slot * self.p + rank) * R * self.D, self.p, slot * self.p + rank,
            self.base[rank].data_ptr(), round_, stream), name)
        _build.count_launch(name)
        _build.count_kernel("skinny_gemm", passes(R))

    def reduce(self, rank: int, slot: int, round_: int, h: torch.Tensor,
               stream: int, norm: Optional[torch.Tensor] = None,
               xn: Optional[torch.Tensor] = None, eps: float = 0.0) -> None:
        """Rank ``rank``'s consumer: h [R, D] (bf16 or f32) += the slot's
        sum once every rank has published base + ``round_``; with ``norm``
        [D] bf16, also xn [R, D] bf16 = the norm of the new h (eps)."""
        name = "tp_allreduce"
        _build.check(_build.library().desta_tp_allreduce(
            self.rbuf[rank].data_ptr(), self.flags[rank].data_ptr(),
            h.data_ptr(), int(h.dtype == torch.float32), self.p, slot,
            self.base[rank].data_ptr(), round_, self.R, self.D,
            None if norm is None else norm.data_ptr(),
            None if xn is None else xn.data_ptr(), float(eps),
            self.err[rank].data_ptr(), stream), name)
        _build.count_launch(name)

    def check_timeouts(self, what: str) -> None:
        """Raise RuntimeError if a spin since the last check timed out
        (syncs the devices), clearing the error words."""
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
