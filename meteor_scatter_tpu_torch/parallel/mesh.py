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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device

STATION_AXIS = "station"
TIME_AXIS = "time"

Grid = List[List[torch.Tensor]]  # [station][time] local tensors


@dataclass(frozen=True)
class Mesh:
    """A ``(n_station, n_time)`` grid of devices of one type."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (STATION_AXIS, TIME_AXIS)

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return {STATION_AXIS: len(self.devices), TIME_AXIS: len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The first device: where assembled results are returned."""
        return self.devices[0][0]

    def positions(self):
        """Every mesh position ``(s, t)`` with its device, station-major."""
        for s, row in enumerate(self.devices):
            for t, dev in enumerate(row):
                yield s, t, dev


def make_mesh(
    n_station: int = 1,
    n_time: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a (station, time) mesh.  With ``n_time=None`` the time axis
    absorbs all remaining devices.  ``devices`` defaults to every CUDA
    device and may repeat a device (a virtual mesh); without CUDA the
    default raises, there is no fallback to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() defaults to every CUDA device, but torch.cuda.is_available() "
                "is False; pass devices=['cpu'] * n for a CPU mesh"
            )
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    devices = [_indexed(resolve_device(d)) for d in devices]
    if n_time is None:
        if len(devices) % n_station:
            raise ValueError(f"{len(devices)} devices not divisible by n_station={n_station}")
        n_time = len(devices) // n_station
    use = n_station * n_time
    if n_station < 1 or n_time < 1 or use > len(devices):
        raise ValueError(f"a {n_station} x {n_time} mesh needs {use} devices, got {len(devices)}")
    if len({d.type for d in devices[:use]}) != 1:
        raise ValueError(f"a mesh's devices must be of one type, got {devices[:use]}")
    grid = tuple(tuple(devices[s * n_time : (s + 1) * n_time]) for s in range(n_station))
    return Mesh(grid)


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
    each on its position's device (a view where it already lies there)."""
    dims = _split_dims(t, mesh, spec)
    grid = []
    for s, row in enumerate(mesh.devices):
        out = []
        for k, dev in enumerate(row):
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
    tensor on the mesh's first device.  Over an axis the layout does not
    name, the locals are replicas and the first is taken."""
    dev = mesh.device
    axes = {axis: dim for dim, axis in enumerate(spec) if axis is not None}

    def along_time(row):
        if TIME_AXIS in axes:
            return torch.cat([a.to(dev) for a in row], axes[TIME_AXIS])
        return row[0].to(dev)

    if STATION_AXIS in axes:
        return torch.cat([along_time(row) for row in grid], axes[STATION_AXIS])
    return along_time(grid[0])
