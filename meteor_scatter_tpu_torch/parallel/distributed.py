"""Multi-host runtime on ``torch.distributed``: initialization, heartbeat
failure detection, which stations a process owns, and how a mesh that
spans processes moves data between them.

Counterpart of `meteor_scatter_tpu/parallel/distributed.py`.  The
reference's "multi-node" story is two Docker containers sharing a CSV bind
mount with ``--restart=always`` supervision; at cluster scale:

* :func:`init_multihost` joins the process group when multi-process
  settings are given (arguments, or ``torchrun``'s ``MASTER_ADDR`` /
  ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``); a single process needs none;
  :func:`process_device` gives each process of a node its own card
  (``LOCAL_RANK``);
* :class:`Heartbeat` is a collective liveness check: every process adds its
  device count to an ``all_reduce``; a hung process surfaces as a timeout
  of the collective, a short count as a lost device, and the supervisor
  restarts from the last flushed ledger hour (``io/ledger.py``);
* :func:`host_shard_info` says which contiguous range of stations this
  process owns;
* :class:`Link` is the transport of a mesh whose positions belong to
  several processes (:func:`~meteor_scatter_tpu_torch.parallel.mesh.make_mesh`
  under a process group): NCCL moves CUDA tensors as they are, gloo takes
  CPU tensors, so a CUDA position under gloo is copied to the host and
  back, explicitly and counted (``"gloo-host-staged"``);
  :func:`row_groups` makes the process sub-group of each mesh row.
  Only ``parallel/halo.py``'s row operations and ``mesh.unshard`` call it.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from meteor_scatter_tpu_torch.device import DeviceLike


def process_device(device: DeviceLike = "cuda") -> torch.device:
    """This process's device of ``device``'s type.  A CUDA device becomes
    ``cuda:LOCAL_RANK`` when the launcher sets ``LOCAL_RANK`` (``torchrun``:
    one card per process of a node), made the current device with
    ``torch.cuda.set_device``; without ``LOCAL_RANK``, or for the CPU,
    ``device`` is returned as given."""
    dev = torch.device(device)
    local = os.environ.get("LOCAL_RANK")
    if dev.type != "cuda" or local is None:
        return dev
    dev = torch.device("cuda", int(local))
    torch.cuda.set_device(dev)
    return dev


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group when multi-process settings are present.
    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` /
    ``file://`` URL) and defaults to ``MASTER_ADDR:MASTER_PORT``;
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``.  The backend defaults to NCCL for a CUDA ``device`` and gloo
    for the CPU; ``backend="gloo"`` with a CUDA device stages every
    transfer through the host (several processes sharing one card, which
    NCCL refuses).  With a CUDA device and ``LOCAL_RANK`` set, the process
    takes ``cuda:LOCAL_RANK`` first (:func:`process_device`).  Returns True
    when the process group is active, False for a single process (nothing
    is initialized)."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if not coordinator_address or num_processes <= 1:
        return False
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected 'cpu' or 'cuda')")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    transport_for(backend, kind)  # an unsupported pair raises before anyone waits
    process_device(device)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    return True


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return _rank_and_size()[0]


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return _rank_and_size()[1]


@dataclass
class HostShard:
    """This process's slice of the global (station, time) work."""

    process_id: int
    num_processes: int
    station_range: Tuple[int, int]
    local_devices: int


def _rank_and_size() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard_info(n_stations: int) -> HostShard:
    """Contiguous station assignment across processes (stations are the
    embarrassingly parallel axis; time sharding stays within a process's
    devices, so halos never cross hosts unless stations < processes).
    Rank 0 of 1 when no process group is initialized."""
    pid, n_proc = _rank_and_size()
    per = -(-n_stations // n_proc)
    lo = min(pid * per, n_stations)
    hi = min(lo + per, n_stations)
    return HostShard(
        process_id=pid,
        num_processes=n_proc,
        station_range=(lo, hi),
        local_devices=torch.cuda.device_count(),
    )


class Heartbeat:
    """Collective liveness probe.

    ``beat()`` sums every process's device count with an ``all_reduce``
    (the collective's device: the current CUDA device under NCCL, the CPU
    under gloo, where a process counts as one device); the result equals
    the expected global count iff every process took part with all its
    devices.  A hung process surfaces as a timeout (the collective never
    completes), which the caller's watchdog turns into a restart, matching
    the reference's supervision tiers (`prime_watchdog.sh`, Docker
    ``--restart=always``) at cluster scale.
    """

    def __init__(self, interval_sec: float = 60.0):
        self.interval = interval_sec
        self.last_beat = 0.0
        self.beats = 0

    @staticmethod
    def _device() -> torch.device:
        if dist.is_initialized() and dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    @classmethod
    def _local_devices(cls) -> int:
        return torch.cuda.device_count() if cls._device().type == "cuda" else 1

    def due(self) -> bool:
        return time.monotonic() - self.last_beat >= self.interval

    def beat(self) -> int:
        total = torch.tensor([self._local_devices()], dtype=torch.int64, device=self._device())
        if dist.is_initialized():
            dist.all_reduce(total, op=dist.ReduceOp.SUM)
        self.last_beat = time.monotonic()
        self.beats += 1
        return int(total.item())

    def check(self) -> bool:
        """True iff all expected devices answered."""
        return self.beat() == self._local_devices() * _rank_and_size()[1]


def transport_for(backend: str, device_type: str) -> str:
    """How a mesh of ``device_type`` positions moves data under ``backend``:
    ``"nccl"`` (CUDA tensors as they are), ``"gloo"`` (CPU tensors) or
    ``"gloo-host-staged"`` (CUDA tensors copied to the host and back).
    Any other pair raises: there is no silent switch."""
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("NCCL moves CUDA tensors only; a CPU mesh needs a gloo process group")
        return "nccl"
    if backend == "gloo":
        return "gloo" if device_type == "cpu" else "gloo-host-staged"
    raise ValueError(f"process-group backend {backend!r} is not supported (use 'nccl' or 'gloo')")


class Link:
    """This process's connection to the other processes of a mesh.

    ``transport`` is :func:`transport_for` of the group's backend and the
    mesh's device type.  Tensors cross on ``wire``: the current CUDA
    device under NCCL, the host under gloo.  ``bool`` tensors cross as
    ``uint8``.  ``wire_bytes`` counts the bytes this process sent to other
    processes, ``staged_bytes`` the bytes copied between a card and the
    host to reach the wire (gloo with CUDA positions only)."""

    def __init__(self, device_type: str):
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.transport = transport_for(dist.get_backend(), device_type)
        self.wire = (torch.device("cuda", torch.cuda.current_device())
                     if self.transport == "nccl" else torch.device("cpu"))
        self.wire_bytes = 0
        self.staged_bytes = 0

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        w = t.to(torch.uint8) if t.dtype == torch.bool else t
        if self.transport == "gloo-host-staged":
            self.staged_bytes += w.nbytes
        return w.to(self.wire).contiguous()

    def _from_wire(self, w: torch.Tensor, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        if self.transport == "gloo-host-staged":
            self.staged_bytes += w.nbytes
        w = w.to(device)
        return w.to(torch.bool) if dtype == torch.bool else w

    def all_gather(self, t: torch.Tensor, group=None) -> List[torch.Tensor]:
        """``t`` of every process of ``group`` (default: all), in the
        group's rank order, on ``t``'s device.  Every process passes the
        same shape and dtype."""
        w = self._to_wire(t)
        out = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, w, group=group)
        self.wire_bytes += w.nbytes * (len(out) - 1)
        return [self._from_wire(o, t.dtype, t.device) for o in out]

    def exchange(self, sends: Sequence[tuple], recvs: Sequence[tuple]) -> List[torch.Tensor]:
        """Point-to-point transfers, all posted at once
        (``batch_isend_irecv``) and then waited for: ``sends`` holds
        ``(tensor, peer, tag)``, ``recvs`` ``(shape, dtype, device, peer,
        tag)``; returns the received tensors in ``recvs``' order, each on
        its device.  A (peer, tag) pair names one message each way."""
        ops = []
        for t, peer, tag in sends:
            w = self._to_wire(t)
            self.wire_bytes += w.nbytes
            ops.append(dist.P2POp(dist.isend, w, peer, tag=tag))
        bufs = [torch.empty(shape, dtype=torch.uint8 if dtype == torch.bool else dtype,
                            device=self.wire) for shape, dtype, _, _, _ in recvs]
        ops += [dist.P2POp(dist.irecv, b, peer, tag=tag)
                for b, (_, _, _, peer, tag) in zip(bufs, recvs)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [self._from_wire(b, dtype, device)
                for b, (_, dtype, device, _, _) in zip(bufs, recvs)]


def row_groups(owners: Sequence[Sequence[int]]) -> tuple:
    """The process sub-group of each mesh row whose positions belong to
    more than one process (None for a row one process holds).
    ``dist.new_group`` must be entered by every process, in the same
    order, also for a group it is not a member of, so every process makes
    every group here, in row order, when the mesh is built."""
    return tuple(dist.new_group(sorted(set(row))) if len(set(row)) > 1 else None
                 for row in owners)


def row_group(mesh, s: int):
    """Station row ``s``'s process sub-group (None when one process holds
    the whole row)."""
    return mesh.row_groups[s]
