"""Whole runs of each cell at a CPU size: the reference agrees with the
port's CPU paths through each of the three entries, the traffic is the
same for the same seed, and a traced run reads its trace."""

import pytest
import torch

from bench_h100 import signals
from bench_h100.tests import tiny_cells

CELLS = ("archive_hour_files", "network64_replay", "network64_live_capacity")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = tiny_cells.run(tiny_cells.cell(workload))
    assert out["correct"], out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["info"]["answers_compared"] > 0
    e2e = {m["name"] for m in tiny_cells.bench()["end_to_end"]
           if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == e2e
    assert list(out)[-1] == "checked"


@pytest.mark.parametrize("workload", CELLS)
def test_driver_inputs_follow_the_seed(workload):
    import importlib

    def inputs(seed):
        c = tiny_cells.cell(workload, seed=seed)
        c.workdir = tiny_cells.harness.tempfile.gettempdir()
        drv = importlib.import_module("bench_h100.drivers." + c.traffic["driver"]).Driver(c)
        drv.setup()
        return torch.as_tensor(drv.audio)

    a, b, c = inputs(2 ** 33 + 1), inputs(2 ** 33 + 1), inputs(2 ** 33 + 2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_every_seed_gets_the_same_echoes():
    sig = tiny_cells.harness.read_json(tiny_cells.ROOT, "bench_h100", "configs",
                                       "brams_network64_4k.json")["signal"]
    p1 = signals.echo_plan(1, 0, 2, 4000 * 3600, 4000, sig)
    p2 = signals.echo_plan(2 ** 35, 0, 2, 4000 * 3600, 4000, sig)
    for a, b in zip(p1, p2):
        assert len(a) == len(b) == sig["echoes_per_hour"]
        for k in (1, 2):  # lengths and peaks: the same set, in another order
            assert sorted(e[k] for e in a) == sorted(e[k] for e in b)
        assert [e[0] for e in a] != [e[0] for e in b]


@pytest.mark.parametrize("workload", CELLS[1:])
def test_traced_run_reports_per_layer_metrics(workload):
    out = tiny_cells.run(tiny_cells.cell(workload, trace=True))
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in tiny_cells.bench()["per_layer"]
                 if workload in m.get("workloads", [workload])}
    # on the CPU the device metrics find no kernel and stay out of the line
    assert set(out["metrics"]) <= per_layer
    assert not any(k.endswith("_roofline") for k in out["metrics"])


@pytest.mark.parametrize("stations,ring,chunk", [(64, 6, 5), (3, 2, 7), (1, 4, 3), (5, 1, 2)])
def test_replay_ring_is_rearranged_in_place(stations, ring, chunk):
    from bench_h100.drivers.card_chunks import chunk_major_

    x = torch.randn(stations, ring * chunk)
    want = torch.stack([x[:, p * chunk:(p + 1) * chunk] for p in range(ring)])
    storage = x.data_ptr()
    got = chunk_major_(x, ring)
    assert torch.equal(got, want) and got.is_contiguous()
    assert got.data_ptr() == storage


def test_fragile_thresholds_are_the_cancelling_windows():
    """A stream that starts on two levels a hundred-thousandth of a dB
    apart: its block 2 threshold, and a threshold locked from it, are
    fragile; the thresholds of a noise window are not."""
    import numpy as np

    from bench_h100.reference import detectors

    rng = np.random.default_rng(5)
    on = rng.normal(0.0, 0.5, 400)
    on[:2] = (2.61, 2.60999)
    on[2:6] = 9.0  # above block 2's threshold: a track locks it
    r = detectors.stream_detect(on, 0.2, 40, 0.0, 2.4, 4.0, -1e9, 0.0, 1e-3)
    assert r.fragile[2] and r.fragile[3:6].all()
    assert r.events and r.events[0].start_block == 2
    assert not r.fragile[60:].any()
