"""Multi-host runtime on ``torch.distributed``: initialization, heartbeat
failure detection, and which stations a process owns.

Counterpart of `meteor_scatter_tpu/parallel/distributed.py`.  The
reference's "multi-node" story is two Docker containers sharing a CSV bind
mount with ``--restart=always`` supervision; at cluster scale:

* :func:`init_multihost` joins the process group when multi-process
  settings are given (arguments, or ``torchrun``'s ``MASTER_ADDR`` /
  ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``); a single process needs none;
* :class:`Heartbeat` is a collective liveness check: every process adds its
  device count to an ``all_reduce``; a hung process surfaces as a timeout
  of the collective, a short count as a lost device, and the supervisor
  restarts from the last flushed ledger hour (``io/ledger.py``);
* :func:`host_shard_info` says which contiguous range of stations this
  process owns.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from meteor_scatter_tpu_torch.device import DeviceLike


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> bool:
    """Join the process group when multi-process settings are present.
    ``coordinator_address`` is ``host:port`` (or a full ``tcp://`` /
    ``file://`` URL) and defaults to ``MASTER_ADDR:MASTER_PORT``;
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``.  The backend is NCCL for a CUDA ``device`` and gloo for the
    CPU.  Returns True when the process group is active, False for a
    single process (nothing is initialized)."""
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
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        init_method=url, world_size=num_processes, rank=process_id,
    )
    return True


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
