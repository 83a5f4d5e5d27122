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


# --- one card per local rank (LOCAL_RANK) ----------------------------------------


@pytest.fixture
def fake_cards(monkeypatch):
    """``torch.cuda`` of a machine with 4 cards, recording ``set_device``."""
    taken = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: taken.append(torch.device(d)))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "fake card")
    return taken


def test_process_device_takes_local_rank(fake_cards, monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert tdist.process_device("cuda") == torch.device("cuda") and fake_cards == []
    assert tdist.process_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tdist.process_device("cuda") == torch.device("cuda", 3)
    assert tdist.process_device("cpu") == torch.device("cpu")
    assert fake_cards == [torch.device("cuda", 3)]
    monkeypatch.setenv("LOCAL_RANK", "0")  # a one-card machine: cuda:0, as without it
    assert tdist.process_device("cuda") == torch.device("cuda", 0)


def test_init_multihost_sets_the_local_card_first(fake_cards, monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, list(fake_cards), kw)))
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tdist.init_multihost("localhost:1", 2, 1, device="cuda")
    assert calls == [("nccl", [torch.device("cuda", 1)],
                      dict(init_method="tcp://localhost:1", world_size=2, rank=1))]
    monkeypatch.delenv("LOCAL_RANK")
    fake_cards.clear()
    assert tdist.init_multihost("localhost:1", 2, 1, device="cuda")
    assert fake_cards == []  # without LOCAL_RANK nothing changes
    assert tdist.init_multihost("localhost:1", 2, 0, device="cpu") and fake_cards == []


@pytest.mark.parametrize("local_rank", [None, "2"])
def test_make_mesh_default_under_a_group(fake_cards, monkeypatch, tmp_path, local_rank):
    """Under a process group the default is this process's card with
    ``LOCAL_RANK``, every card without it (as before)."""
    from meteor_scatter_tpu_torch.parallel import mesh as tmesh

    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        m = tmesh.make_mesh(1)
        want = [torch.device("cuda", k) for k in range(4)] if local_rank is None else [
            torch.device("cuda", 2)]
        assert list(m.devices[0]) == want
        assert m.transport == "gloo-host-staged"
        assert fake_cards == ([] if local_rank is None else [torch.device("cuda", 2)])
    finally:
        dist.destroy_process_group()


def test_child_and_bench_take_the_local_card(fake_cards, monkeypatch):
    import importlib.util

    import torch_multiproc_child as child

    spec = importlib.util.spec_from_file_location(
        "torch_scaling_bench",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                     "torch_scaling_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    monkeypatch.setenv("LOCAL_RANK", "2")
    assert child.positions("cuda", 2) == [torch.device("cuda", 2)] * 2
    assert child.positions("cpu", 2) == ["cpu", "cpu"]
    assert bench.local_devices("cuda", None) == (["cuda:2"], "fake card")
    assert bench.local_devices("cuda", 3) == (["cuda:2"] * 3, "fake card")
    monkeypatch.delenv("LOCAL_RANK")
    assert bench.local_devices("cuda", None) == ([f"cuda:{k}" for k in range(4)], "fake card")
    assert bench.local_devices("cuda", 6)[0] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3",
                                                 "cuda:0", "cuda:1"]
    assert bench.local_devices("cpu", None) == (["cpu"], "cpu")
