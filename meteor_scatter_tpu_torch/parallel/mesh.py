"""The (station, time) mesh of devices, and placing tensors on it.

Counterpart of `meteor_scatter_tpu/parallel/mesh.py`.  The JAX layer runs
one controller over ``jax.devices()`` with ``shard_map``; here one process
holds a grid of ``torch.device``s and runs each mesh position's share of
the work in turn on that position's device.  A device may appear more than
once: ``["cuda:0"] * 8`` is a virtual 8-device mesh on one card (the JAX
tests' 8 virtual CPU devices), ``["cpu"] * 8`` the same on the CPU.  On a
virtual mesh the seams, halos and per-position launches are all real; only
the transfers between positions cost nothing.

A layout is given per tensor dimension as a mesh axis name (the dimension
is split over that axis) or ``None`` (not split), as ``PartitionSpec``
does; an axis the layout does not name is replicated over.  :func:`shard`
splits a global tensor into a grid of local tensors, each on its
position's device; :func:`unshard` assembles a grid back.

Under a process group (``torch.distributed``) the grid spans processes, as
``jax.devices()`` spans hosts after ``jax.distributed.initialize``: each
process names its own devices, the global grid is every process's list in
rank order, and each process holds only the positions it owns.  A grid of
local tensors then has ``None`` at the other processes' positions;
:func:`unshard` gathers the global tensor on every process.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device
from meteor_scatter_tpu_torch.parallel.distributed import Link, row_groups

STATION_AXIS = "station"
TIME_AXIS = "time"

Grid = List[List[Optional[torch.Tensor]]]  # [station][time] local tensors, None where remote


@dataclass(frozen=True)
class Mesh:
    """A ``(n_station, n_time)`` grid of devices of one type.

    ``owners`` holds each position's process rank and ``rank`` this
    process's; ``devices`` holds None at the other processes' positions;
    ``local_device`` is this process's first device.  Without a process
    group every position is rank 0's, ``link`` is None and ``row_groups``
    empty; under one ``row_groups`` holds each row's process sub-group
    (:func:`~meteor_scatter_tpu_torch.parallel.distributed.row_groups`)."""

    devices: Tuple[Tuple[Optional[torch.device], ...], ...]
    owners: Tuple[Tuple[int, ...], ...]
    rank: int
    local_device: torch.device
    link: Optional[Link] = field(compare=False)
    row_groups: tuple = field(compare=False)

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (STATION_AXIS, TIME_AXIS)

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return {STATION_AXIS: len(self.devices), TIME_AXIS: len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """This process's first device: where assembled results are
        returned."""
        return self.local_device

    @property
    def transport(self) -> Optional[str]:
        """How data crosses processes (``Link.transport``); None for a mesh
        one process holds."""
        return self.link.transport if self.link is not None else None

    def is_local(self, s: int, t: int) -> bool:
        return self.owners[s][t] == self.rank

    def positions(self):
        """Every mesh position ``(s, t)`` with its device (None where
        another process owns it), station-major."""
        for s, row in enumerate(self.devices):
            for t, dev in enumerate(row):
                yield s, t, dev

    def local_positions(self):
        """This process's positions ``(s, t)`` with their devices."""
        return ((s, t, dev) for s, t, dev in self.positions() if self.is_local(s, t))


def make_mesh(
    n_station: int = 1,
    n_time: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a (station, time) mesh.  With ``n_time=None`` the time axis
    absorbs all remaining devices.  ``devices`` defaults to every CUDA
    device and may repeat a device (a virtual mesh); without CUDA the
    default raises, there is no fallback to the CPU.

    Under a process group ``devices`` names this process's devices, every
    process passes as many, and the grid takes every process's list in
    rank order (a process may own no position of a small mesh).  Every
    process must call this, in the same order: it gathers the counts and
    makes the rows' process sub-groups."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() defaults to every CUDA device, but torch.cuda.is_available() "
                "is False; pass devices=['cpu'] * n for a CPU mesh"
            )
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    devices = [_indexed(resolve_device(d)) for d in devices]
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh's devices must be of one type, got {devices}")
    link, rank, n_proc = None, 0, 1
    if dist.is_available() and dist.is_initialized():
        link = Link(devices[0].type)
        rank, n_proc = link.rank, link.world
        counts = [int(c) for c in link.all_gather(torch.tensor([len(devices)], device=link.wire))]
        if len(set(counts)) != 1:
            raise ValueError(f"every process must pass as many devices to make_mesh; "
                             f"the processes passed {counts}")
    per = len(devices)
    total = per * n_proc
    if n_time is None:
        if total % n_station:
            raise ValueError(f"{total} devices not divisible by n_station={n_station}")
        n_time = total // n_station
    use = n_station * n_time
    if n_station < 1 or n_time < 1 or use > total:
        raise ValueError(f"a {n_station} x {n_time} mesh needs {use} devices, got {total}")
    owners = tuple(tuple((s * n_time + t) // per for t in range(n_time)) for s in range(n_station))
    grid = tuple(tuple(devices[(s * n_time + t) % per] if owners[s][t] == rank else None
                       for t in range(n_time)) for s in range(n_station))
    groups = row_groups(owners) if link is not None else ()
    return Mesh(grid, owners, rank, devices[0], link, groups)


def _indexed(dev: torch.device) -> torch.device:
    """A device in the form a tensor's ``.device`` takes: ``cuda`` as
    ``cuda:<current>``, ``cpu:0`` as ``cpu``."""
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def station_time_specs() -> Tuple[str, str]:
    """The layout of (channels, samples)-shaped tensors."""
    return (STATION_AXIS, TIME_AXIS)


def _split_dims(t: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> dict:
    dims = {}
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = mesh.shape[axis]
        if t.shape[dim] % size:
            raise ValueError(
                f"dimension {dim} of shape {tuple(t.shape)} does not divide over the "
                f"{size} shards of mesh axis {axis!r}"
            )
        dims[axis] = (dim, t.shape[dim] // size)
    return dims


def shard(t: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> Grid:
    """Split ``t`` by the layout ``spec`` into a grid of local tensors,
    each on its position's device (a view where it already lies there).
    Every process passes the whole global tensor and gets tensors at its
    own positions, None elsewhere."""
    dims = _split_dims(t, mesh, spec)
    grid = []
    for s, row in enumerate(mesh.devices):
        out = []
        for k, dev in enumerate(row):
            if dev is None:
                out.append(None)
                continue
            local = t
            for axis, idx in ((STATION_AXIS, s), (TIME_AXIS, k)):
                if axis in dims:
                    dim, n = dims[axis]
                    local = local.narrow(dim, idx * n, n)
            out.append(local.to(dev))
        grid.append(out)
    return grid


def unshard(grid: Grid, mesh: Mesh, spec: Sequence[Optional[str]]) -> torch.Tensor:
    """Assemble a grid of local tensors laid out by ``spec`` into the global
    tensor on this process's first device.  Over an axis the layout does
    not name, the locals are replicas and the first is taken.

    Across processes every process gets the global tensor
    (``process_allgather``): one ``all_gather`` of the positions the
    assembly reads, padded to the most any process owns.  For the
    sample-rate outputs that moves the whole result to every process."""
    dev = mesh.device
    axes = {axis: dim for dim, axis in enumerate(spec) if axis is not None}
    if mesh.link is not None:
        grid = _gather_grid(grid, mesh, STATION_AXIS in axes, TIME_AXIS in axes)

    def along_time(row):
        if TIME_AXIS in axes:
            return torch.cat([a.to(dev) for a in row], axes[TIME_AXIS])
        return row[0].to(dev)

    if STATION_AXIS in axes:
        return torch.cat([along_time(row) for row in grid], axes[STATION_AXIS])
    return along_time(grid[0])


_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64, torch.bool, torch.uint8,
           torch.int16, torch.complex64)


def _gather_grid(grid: Grid, mesh: Mesh, by_station: bool, by_time: bool) -> Grid:
    """The grid with every position the assembly reads filled in on every
    process: position (s, t) where the layout splits its axis or the index
    is 0.  Each position's tensor has one shape and dtype; a process that
    owns no position of the mesh learns them from the owner of (0, 0)."""
    link = mesh.link
    needed = [(s, t) for s in range(len(grid)) for t in range(len(grid[0]))
              if (by_station or s == 0) and (by_time or t == 0)]
    per_rank = [[p for p in needed if mesh.owners[p[0]][p[1]] == r] for r in range(link.world)]
    mine = [grid[s][t] for s, t in per_rank[link.rank]]
    like = next((a for row in grid for a in row if a is not None), None)
    if len({o for row in mesh.owners for o in row}) < link.world:
        like = _broadcast_like(like, mesh)
    m = max(len(p) for p in per_rank)
    pad = [torch.zeros_like(like)] * (m - len(mine))
    gathered = link.all_gather(torch.stack([a.to(like.device) for a in mine] + pad))
    out = [[None] * len(grid[0]) for _ in grid]
    for r, positions in enumerate(per_rank):
        for j, (s, t) in enumerate(positions):
            out[s][t] = gathered[r][j]
    return out


def _broadcast_like(like: Optional[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """An empty tensor of the grid's shape and dtype on this process's
    device, as the owner of position (0, 0) holds it."""
    head = torch.zeros(10, dtype=torch.int64)
    if like is not None:
        head[0], head[1] = _DTYPES.index(like.dtype), like.dim()
        head[2 : 2 + like.dim()] = torch.tensor(like.shape)
    head = head.to(mesh.link.wire)
    dist.broadcast(head, src=mesh.owners[0][0])
    head = head.tolist()
    return torch.empty(head[2 : 2 + head[1]], dtype=_DTYPES[head[0]], device=mesh.device)
