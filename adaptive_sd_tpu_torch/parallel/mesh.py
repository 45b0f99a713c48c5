"""Process groups for tensor parallelism: (dp, tp) and (dcn, dp, tp) meshes
over the ranks of a ``torch.distributed`` world, cascade tier slices, and
the helper that starts one process per rank (counterpart of
``adaptive_sd_tpu/parallel/mesh.py``).

JAX holds every device in one controller and hands ``jax.devices()`` to a
``Mesh``; here each rank is a process, and a :class:`Mesh` is this rank's
view of the layout: its coordinates and the process groups of the axes it
belongs to. Every rank runs the same calls on the same inputs (SPMD), so a
``dp`` replica computes what its peers compute. :func:`spawn_ranks` starts
the ranks (``torch.multiprocessing`` with a ``file://`` rendezvous); on the
CPU its gloo ranks are the port's virtual mesh, as ``virtual_cpu_devices``
is the JAX package's.

Collectives go through :class:`TPGroup`, the one place that issues them.
gloo sums on the host. A CUDA tensor on a gloo group whose ranks share this
host goes through shared host memory instead of gloo's loopback TCP
(parallel/host_memory.py, made at the group's first such collective);
across hosts gloo stages CUDA tensors itself. gloo's point-to-point
``send``/``recv`` take CPU tensors only, so the ring of parallel/overlap.py
refuses CUDA tensors on a gloo group rather than copy them in secret.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.exceptions import ShardingError

# Canonical axis names: dp = data (batch) parallel, tp = tensor parallel,
# dcn = the cross-host axis (slowest; outermost).
AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_DCN = "dcn"


@dataclass(frozen=True)
class TPGroup:
    """One tensor-parallel group as this rank sees it: the process group,
    its global ranks in order, and this rank's index in it. The forward
    (models/qwen.py ``tp=``) and the sharded ops issue every collective
    through these methods."""

    group: object
    ranks: tuple[int, ...]
    rank: int
    backend: str
    # the host-memory collectives, or None, once the first CUDA collective
    # on a gloo group has decided
    _host: list = field(default_factory=list, compare=False, repr=False)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _through_host_memory(self, x: torch.Tensor):
        """The group's host-memory collectives for ``x``: a CUDA tensor on a
        gloo group whose ranks share this host (gloo sums on the host
        anyway, over loopback TCP), when it fits a slot; else None."""
        if not (x.is_cuda and self.backend == "gloo"):
            return None
        if not self._host:
            from .host_memory import HostMemoryCollectives, on_one_host, supported

            same_host = on_one_host(self.group)  # collective: every rank calls it
            self._host.append(HostMemoryCollectives(self.group, self.ranks, self.rank)
                              if same_host and supported() else None)
        host = self._host[0]
        return host if host is not None and host.fits(x) else None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the group, in place; returns ``x``."""
        host = self._through_host_memory(x)
        if host is not None:
            return host.all_reduce(x)
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last dim, in rank order
        (vocab-sharded logits -> the whole vocabulary)."""
        host = self._through_host_memory(x)
        if host is not None:
            return host.all_gather_last(x)
        parts = [torch.empty_like(x) for _ in self.ranks]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def ring_shift(self, x: torch.Tensor, work: Callable[[], torch.Tensor]):
        """Send ``x`` to the next rank of the group and receive the previous
        rank's, while ``work()`` runs; returns (received, work's result).
        Point-to-point: gloo moves CPU tensors only."""
        if x.is_cuda and self.backend == "gloo":
            raise ShardingError(
                "ring_shift: gloo's send/recv take CPU tensors only; the ring over CUDA "
                "tensors needs an NCCL group (use all_reduce on gloo)")
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        buf = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x.contiguous(), nxt, self.group),
                                       dist.P2POp(dist.irecv, buf, prv, self.group)])
        out = work()
        for r in reqs:
            r.wait()
        return buf, out


@dataclass
class Mesh:
    """This rank's place in a mesh of ranks: axis sizes (``shape``, in axis
    order, minor last), its coordinate on each axis, and for each axis the
    group of the ranks that differ from it only on that axis."""

    shape: dict
    coords: dict
    groups: dict = field(repr=False)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def tp(self) -> TPGroup:
        return self.groups[AXIS_TP]

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def _grid_mesh(shape: dict, ranks: Optional[Sequence[int]]) -> Optional[Mesh]:
    """A mesh of ``shape`` over ``ranks`` (default: the whole world), ranks
    laid out row-major. Every rank of the world must call this in the same
    order (group creation is collective); a rank outside ``ranks`` gets
    ``None``."""
    if not dist.is_initialized():
        raise ShardingError("torch.distributed is not initialised (see spawn_ranks)")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    n = 1
    for v in shape.values():
        n *= v
    if n != len(ranks):
        dims = "x".join(str(v) for v in shape.values())
        raise ShardingError(f"mesh {dims} needs {n} devices, have {len(ranks)}")
    me = dist.get_rank()
    names, sizes = list(shape), list(shape.values())
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    backend = dist.get_backend()
    groups, coords = {}, None
    if me in ranks:
        idx = ranks.index(me)
        coords = {a: (idx // s) % n_a for a, s, n_a in zip(names, strides, sizes)}
    for ax, (size, stride) in enumerate(zip(sizes, strides)):
        # the lines of axis ``ax``: indices that agree on every other axis
        starts = [i for i in range(n) if (i // stride) % size == 0]
        for start in starts:
            members = tuple(ranks[start + j * stride] for j in range(size))
            group = dist.new_group(list(members))
            if me in members:
                groups[names[ax]] = TPGroup(group, members, members.index(me), backend)
    if coords is None:
        return None
    return Mesh(dict(shape), coords, groups)


def build_mesh(dp: int = 1, tp: int = 1, ranks: Optional[Sequence[int]] = None
               ) -> Optional[Mesh]:
    """(dp, tp) mesh over the given global ranks (default: all). tp is the
    minor axis: a tensor-parallel group is ``tp`` consecutive ranks."""
    return _grid_mesh({AXIS_DP: dp, AXIS_TP: tp}, ranks)


@dataclass(frozen=True)
class TierPlacement:
    """A cascade tier pinned to a slice of the world's ranks."""

    name: str
    device_ids: tuple[int, ...]
    dp: int = 1
    tp: int = 1

    def mesh(self) -> Optional[Mesh]:
        """The tier's mesh; every rank of the world calls this (group
        creation is collective), a rank outside the slice gets ``None``."""
        world = dist.get_world_size()
        if max(self.device_ids) >= world:
            raise ShardingError(
                f"tier {self.name} wants devices {self.device_ids}, only {world} present")
        return build_mesh(self.dp, self.tp, self.device_ids)


def plan_tier_placements(
    tier_names: Sequence[str],
    tier_weights_bytes: Sequence[int],
    n_devices: int,
    device_hbm_bytes: int = 16 << 30,
    kv_fraction: float = 0.3,
) -> list[TierPlacement]:
    """Partition the ranks into disjoint per-tier slices sized by weight
    footprint (the JAX function's arithmetic, unchanged).

    Greedy: each tier gets the smallest power-of-two device count whose pooled
    memory fits weights/(1-kv_fraction); remaining devices are handed to tiers
    round-robin (largest first) to widen tp for latency.
    """
    if len(tier_names) != len(tier_weights_bytes):
        raise ValueError("names/weights length mismatch")
    needs = []
    for w in tier_weights_bytes:
        need = 1
        while need * device_hbm_bytes * (1 - kv_fraction) < w:
            need *= 2
        needs.append(need)
    total = sum(needs)
    if total > n_devices:
        raise ShardingError(
            f"cascade needs >= {total} devices ({list(zip(tier_names, needs))}), "
            f"have {n_devices}"
        )
    # hand out spare devices to the largest tiers (doubling keeps power-of-2 tp)
    spare = n_devices - total
    order = sorted(range(len(needs)), key=lambda i: -tier_weights_bytes[i])
    for i in order:
        if spare >= needs[i]:
            spare -= needs[i]
            needs[i] *= 2
    placements = []
    cursor = 0
    for name, n in zip(tier_names, needs):
        placements.append(
            TierPlacement(name=name, device_ids=tuple(range(cursor, cursor + n)), dp=1, tp=n)
        )
        cursor += n
    return placements


def build_multihost_mesh(dp: int = 1, tp: int = 1, dcn: Optional[int] = None,
                         ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """(dcn, dp, tp) mesh: dcn outermost, so that only the data-parallel
    axes cross hosts and a tensor-parallel group stays on one host. ``dcn``
    defaults to the world size over dp * tp (the number of hosts when each
    host runs dp * tp ranks)."""
    n = len(ranks) if ranks is not None else dist.get_world_size()
    n_dcn = dcn if dcn is not None else max(n // max(dp * tp, 1), 1)
    return _grid_mesh({AXIS_DCN: n_dcn, AXIS_DP: dp, AXIS_TP: tp}, ranks)


# ---------------------------------------------------------------------------
# starting ranks


def _rank_main(rank: int, fn, world: int, backend: str, devices, init_file: str,
               out_dir: str, threads: int, timeout_s: float, args: tuple) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, device, *args)
        tmp = Path(out_dir) / f"{rank}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, Path(out_dir) / f"{rank}.pkl")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo",
                devices: Optional[Sequence] = None, threads: int = 1,
                timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, device, *args)`` in ``world_size`` new processes joined
    in one ``torch.distributed`` world and return each rank's result, in
    rank order. ``fn`` must be importable by name (spawned processes import
    it; they do not fork this one). ``backend``: ``"gloo"`` (CPU tensors,
    and CUDA tensors through host memory) or ``"nccl"`` (one card a rank).
    ``devices``: each rank's device (default: the CPU for every rank); ranks
    may share a card. The rendezvous is a ``file://`` in a fresh temporary
    directory, so concurrent worlds never collide on a port. A rank that
    raises makes this raise; every process has ended when it returns."""
    import torch.multiprocessing as mp

    devices = [str(d) for d in (devices or ["cpu"] * world_size)]
    if len(devices) != world_size:
        raise ShardingError(f"{len(devices)} devices for {world_size} ranks")
    tmp = tempfile.mkdtemp(prefix="asd_ranks_")
    try:
        mp.start_processes(
            _rank_main, nprocs=world_size, join=True, start_method="spawn",
            args=(fn, world_size, backend, devices, os.path.join(tmp, "rendezvous"), tmp,
                  threads, timeout_s, args))
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
