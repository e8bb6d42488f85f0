"""Meshes over the ranks of a process group — the port of the JAX package's
``launch/mesh.py`` for explicit SPMD: one process per mesh position.

``Mesh`` is a grid of global ranks with named axes (``("data",
"model")`` or ``("pod", "data", "model")``) and, for every line of ranks
along an axis, a process group; a rank knows its coordinates and the group
of each axis it sits on.  Groups are made by every rank of the default
group, in one order (``torch.distributed.new_group``'s rule), so a mesh
is built by all ranks together, a shrunk one too.

The backend is chosen once, explicitly (``choose_backend``): NCCL when
every rank has a card of its own, gloo when ranks share one (NCCL refuses
two ranks on one device) or run on the CPU.  Gloo's collectives on CUDA
tensors are staged through host memory by the caller
(``dist.sharding.reshard_tensor``).
"""
from __future__ import annotations

import collections
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def choose_backend(device: str, world: int) -> str:
    """``nccl`` when each of ``world`` ranks has a card of its own,
    ``gloo`` when they share one or run on the CPU."""
    if str(device).startswith("cuda") and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_world(rank: int, world: int, store_path: str, backend: str,
               timeout_s: float = 300.0) -> None:
    """Join the default process group over a ``FileStore`` at
    ``store_path`` (every rank passes the same path).  Under NCCL the rank
    first takes its own card (``rank % device_count``) as the current
    device, so ``device="cuda"`` names that card in the rank."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))


class Mesh:
    """A grid of global ranks with named axes and a process group for each
    line along each axis.  ``shape`` maps axis -> size; ``devices`` is the
    rank grid (the reference's name); ``coord(axis)`` is this rank's
    position along ``axis``; ``fingerprint`` is ``((axis, size), ...)``."""

    def __init__(self, ranks, axis_names):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-D rank grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(s) for a, s in zip(self.axis_names, ranks.shape)}
        self.size = int(ranks.size)
        self.fingerprint = tuple((a, self.shape[a]) for a in self.axis_names)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        pos = np.argwhere(ranks == self.rank)
        self.coords = tuple(int(c) for c in pos[0]) if pos.size else None
        #: axis -> (group, its ranks in coordinate order) for this rank
        self.groups: dict = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for line in lines:
                members = [int(r) for r in line]
                grp = dist.new_group(members)
                if self.rank in members:
                    self.groups[name] = (grp, members)
        self.group = dist.new_group([int(r) for r in ranks.ravel()])
        #: ``gathers`` (all-gather calls that moved data) and ``gather_s``
        #: (their host seconds, the staging copies included)
        self.stats = collections.Counter()

    @property
    def member(self) -> bool:
        """Whether this rank is in the mesh (an evicted one is not)."""
        return self.coords is not None

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def leader(self) -> int:
        """The mesh's first rank (writes what one rank writes)."""
        return int(self.devices.ravel()[0])

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``t`` along ``dim`` in the order of
        their coordinates on ``axis``."""
        grp, members = self.groups[axis]
        if len(members) == 1:
            return t
        t0 = time.perf_counter()
        staged = self.backend == "gloo" and t.device.type != "cpu"
        src = (t.cpu() if staged else t).contiguous()
        parts = [torch.empty_like(src) for _ in members]
        dist.all_gather(parts, src, group=grp)
        # all_gather fills by group rank (ascending global rank): reorder
        by_rank = dict(zip(sorted(members), parts))
        out = torch.cat([by_rank[r] for r in members], dim=dim)
        out = out.to(t.device) if staged else out
        self.stats["gathers"] += 1
        self.stats["gather_s"] += time.perf_counter() - t0
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, ranks={self.devices.tolist()})"


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """A ``(data, model)`` mesh, or ``(pod, data, model)`` with ``pod``,
    over the first ranks of the process group (row-major)."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    n = int(np.prod(shape))
    if n > dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return Mesh(np.arange(n).reshape(shape), axes)


def shrink_mesh(mesh: Mesh, failed_rank: int) -> Mesh:
    """Rebuild ``mesh`` without the row of ranks holding ``failed_rank``.

    The row is dropped along the outermost shrinkable axis — ``pod`` if
    present and > 1, else ``data`` — which keeps the ``model`` axis, so
    every tensor-parallel block keeps its size and each survivor its model
    coordinate.  Every rank of the default group calls it (the evicted
    ones help form the new groups, then leave the mesh).  Raises if the
    rank is not in the mesh or no data-parallel axis can shrink (a pure-TP
    mesh cannot lose a rank and keep the layout)."""
    ranks = mesh.devices
    pos = np.argwhere(ranks == failed_rank)
    if pos.size == 0:
        raise ValueError(f"rank {failed_rank} not in mesh {mesh.axis_names}")
    for ax, name in enumerate(mesh.axis_names):
        if name != "model" and ranks.shape[ax] > 1:
            keep = [i for i in range(ranks.shape[ax]) if i != pos[0][ax]]
            return Mesh(np.take(ranks, keep, axis=ax), mesh.axis_names)
    raise ValueError(
        f"mesh {mesh.shape} has no shrinkable data axis; cannot evict a "
        "rank without breaking the TP layout")


def rank_of(mesh: Mesh, *coords: int) -> int:
    """The global rank at ``coords`` of ``mesh``."""
    return int(mesh.devices[tuple(coords)])

