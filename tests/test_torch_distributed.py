"""The port's multi-process runtime (``parallel/distributed.py``) on gloo,
on the CPU: one process through a ``file://`` store, and two spawned
processes.  This file imports neither JAX nor the JAX package, so a
spawned worker starts with torch and the port alone.
"""

import os

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from meteor_scatter_tpu_torch.parallel import distributed as tdist


def test_init_multihost_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.init_multihost() is False
    assert tdist.init_multihost("localhost:1", 1, 0) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert tdist.init_multihost() is False
    assert not dist.is_initialized()
    assert tdist.host_shard_info(64) == tdist.HostShard(0, 1, (0, 64), torch.cuda.device_count())
    with pytest.raises(ValueError, match="unsupported device"):
        tdist.init_multihost("localhost:1", 2, 0, device="meta")


def test_world_size_one_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        hb = tdist.Heartbeat(interval_sec=0.0)
        assert hb.due() and hb.check() and hb.beats == 1
        assert tdist.host_shard_info(64) == tdist.HostShard(0, 1, (0, 64),
                                                            torch.cuda.device_count())
    finally:
        dist.destroy_process_group()


def _two_process_worker(rank, store, out_dir):
    assert tdist.init_multihost(f"file://{store}", 2, rank, device="cpu")
    try:
        info = tdist.host_shard_info(63)
        ok = tdist.Heartbeat().check()
        with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
            f.write(f"{ok} {info.process_id} {info.num_processes} {info.station_range}")
    finally:
        dist.destroy_process_group()


def test_two_process_gloo(tmp_path):
    """Two processes: every heartbeat hears both, and the stations split
    into contiguous halves."""
    mp.spawn(_two_process_worker, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=2,
             join=True)
    got = [(tmp_path / f"rank{r}").read_text() for r in range(2)]
    assert got == ["True 0 2 (0, 32)", "True 1 2 (32, 63)"]
