"""Collectives between the ranks of one host through shared host memory.

gloo sums on the host: for a CUDA tensor it copies to the host, runs its
TCP algorithm over loopback and copies back, ~1.2 ms for one decode row on
the card's machine, where the algorithm alone takes ~1 ms on CPU tensors
(scripts/torch_gloo_cuda_probe.py). Ranks that share a host can instead
meet in one mapped file: each rank copies its payload into its own slot,
publishes a counter, waits for its peers' counters and reads their slots.
A tensor-parallel step of two ranks on one card issues 58 such collectives
(parallel/mesh.py ``TPGroup`` routes CUDA tensors on a gloo group here).

Each rank has two slots, used by turns: the slot of collective ``k`` is
written again at ``k + 2``. A rank gets there only once every peer has
published ``k + 1``, and a rank publishes ``k + 1`` only after it has read
every slot of ``k`` (each collective reads them before it returns). A
reduction sums the slots in rank order on every rank, so every rank gets
the same bits (at two ranks, ``a + b``, as gloo's sum). The counters are
plain 8-byte stores and loads, ordered by the x86 memory model (a store is
not passed by a later store, a load not by a later load); elsewhere
:func:`supported` is false and the caller keeps gloo.
"""

from __future__ import annotations

import mmap
import os
import platform
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

SLOT_BYTES = 32 << 20
LINE = 64  # bytes between two counters (one cache line each)


def supported() -> bool:
    """Whether this machine orders the counters' stores and loads as the
    exchange needs (x86)."""
    return platform.machine().lower() in ("x86_64", "amd64")


class HostMemoryCollectives:
    """all_reduce and all_gather for the ranks of one process group that
    share a host, through a file that every rank maps. Every rank of
    ``group`` constructs it, in the same order (it exchanges the file's
    name over ``group``). ``members``: the group's global ranks in order;
    ``index``: this rank's place among them."""

    def __init__(self, group, members, index: int, *, slot_bytes: int = SLOT_BYTES,
                 timeout_s: float = 300.0):
        self.size, self.index, self.slot_bytes = len(members), index, slot_bytes
        self.timeout_s = timeout_s
        header = self.size * LINE
        total = header + 2 * self.size * slot_bytes
        name = [None]
        if index == 0:
            fd, name[0] = tempfile.mkstemp(prefix="asd_tp_collectives_")
            os.ftruncate(fd, total)
            os.close(fd)
        dist.broadcast_object_list(name, src=members[0], group=group)
        fd = os.open(name[0], os.O_RDWR)
        try:
            self._map = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        dist.barrier(group=group)
        if index == 0:
            os.unlink(name[0])  # the mappings stay; nothing is left behind
        # rank r's count of published collectives, one cache line each
        self._ready = np.frombuffer(self._map, dtype=np.int64, count=header // 8)[::LINE // 8]
        self._slots = torch.frombuffer(self._map, dtype=torch.uint8, offset=header)
        self._slots.view(self.size, 2, slot_bytes)[index].zero_()  # fault the pages in now
        self._k = 0
        self._staging = None

    def fits(self, x: torch.Tensor) -> bool:
        return x.numel() * x.element_size() <= self.slot_bytes

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the group, in rank order, in place."""
        parts = self._exchange(x)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return x.copy_(acc)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last dim, in rank order."""
        return torch.cat(self._exchange(x), dim=-1).to(x.device)

    # ------------------------------------------------------------------

    def _slot(self, rank: int, turn: int, nbytes: int) -> torch.Tensor:
        start = (rank * 2 + turn) * self.slot_bytes
        return self._slots[start:start + nbytes]

    def _exchange(self, x: torch.Tensor) -> list:
        """Publish ``x`` and return every rank's payload of this collective
        (views of the slots, on the host), which the caller reads before
        its next collective."""
        x = x.contiguous()
        data = x.reshape(-1).view(torch.uint8)
        if x.is_cuda:
            # by DMA into page-locked memory (waits for the work that made x)
            if self._staging is None or self._staging.numel() < data.numel():
                self._staging = torch.empty(max(data.numel(), 1 << 20), dtype=torch.uint8,
                                            pin_memory=True)
            data = self._staging[:data.numel()].copy_(data)
        self._k += 1
        k, turn = self._k, self._k % 2
        self._slot(self.index, turn, data.numel()).copy_(data)
        self._ready[self.index] = k
        self._wait(self._ready, k)
        return [self._slot(r, turn, data.numel()).view(x.dtype).view(x.shape)
                for r in range(self.size)]

    def _wait(self, counters: np.ndarray, k: int) -> None:
        spins = 0
        deadline = None
        while int(counters.min()) < k:
            spins += 1
            if spins % 1024 == 0:
                time.sleep(0)
                now = time.monotonic()
                if deadline is None:
                    deadline = now + self.timeout_s
                elif now > deadline:
                    raise TimeoutError(
                        f"host-memory collective {k}: a peer did not arrive in "
                        f"{self.timeout_s:.0f} s (counters {counters.tolist()})")


def on_one_host(group) -> bool:
    """Whether every rank of ``group`` runs on this host."""
    names = [None] * dist.get_world_size(group)
    dist.all_gather_object(names, socket.gethostname(), group=group)
    return len(set(names)) == 1
