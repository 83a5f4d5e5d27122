"""The port's multi-device layer on a process group: meshes that span
processes, on the CPU with gloo.

Two groups are spawned once for the module, each child running
``tests/torch_multiproc_child.py`` (torch and the port only):

* ``1x4_over_2``: a 1 x 4 mesh over 2 processes x 2 CPU positions, so the
  time row has a seam inside a process and one between the processes;
* ``2x2_over_4``: a 2 x 2 mesh over 4 processes x 1 position, so each
  station row spans two processes.

Each child runs the ten sharded entry points, the three row operations and
the dryrun, and saves its global results; rank 0 first computes the same on
one process driving the whole mesh (``["cpu"] * 4``, no group), with the
same thread settings.  Every process's result equals the single-process
result bit for bit (the single-process layer is exact against itself; the
row sum is an ordered sum after a gather, never an ``all_reduce``).  Once
the children have run, the parent computes the JAX layer's sharded functions on
4 of the 8 virtual CPU devices for ``sharded_detect_adaptive``,
``sharded_stream_process`` (welch/scan and bins/fused) and
``sharded_channelize_iq``; the 1 x 4 group's results are held against
them with the tolerances of ``tests/test_torch_parallel.py`` and, for the
whole streaming pipeline, of ``tests/test_torch_streaming.py``.
"""

import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.config import DetectionConfig as JDetectionConfig
from meteor_scatter_tpu.parallel import mesh as jmesh_mod
from meteor_scatter_tpu.parallel import sharded as jsh
from meteor_scatter_tpu_torch.parallel import distributed as tdist
from meteor_scatter_tpu_torch.parallel import mesh as tmesh
from meteor_scatter_tpu_torch.parallel import sharded as tsh

import torch_multiproc_child as child

# name -> (processes, n_station, n_time)
LAYOUTS = {"1x4_over_2": (2, 1, 4), "2x2_over_4": (4, 2, 2)}
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
JOIN_TIMEOUT_S = 240
JAX_THR_RTOL = 1e-5  # tests/test_torch_parallel.py
IQ_ATOL = 2e-5  # tests/test_torch_parallel.py
DB_ATOL = 1e-3  # the whole streaming pipeline against JAX, tests/test_torch_streaming.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Group:
    """One spawned group of children and the files they write."""

    def __init__(self, out_dir, world, n_station, n_time):
        self.out_dir, self.world = str(out_dir), world
        self.ctx = mp.spawn(child.run, args=(world, f"{out_dir}/store", self.out_dir, n_station,
                                             n_time), nprocs=world, join=False)
        self._results = None

    def results(self):
        if self._results is None:
            deadline = time.monotonic() + JOIN_TIMEOUT_S
            while not self.ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    self.stop()
                    raise TimeoutError(f"the {self.world} children did not finish in "
                                       f"{JOIN_TIMEOUT_S} s")
            assert not any(p.is_alive() for p in self.ctx.processes)

            def load(name):
                with np.load(os.path.join(self.out_dir, name + ".npz")) as z:
                    arrays = dict(z)
                with open(os.path.join(self.out_dir, name + ".json")) as f:
                    return arrays, json.load(f)

            self._results = {"reference": load("reference"),
                             "ranks": [load(f"rank{r}") for r in range(self.world)]}
        return self._results

    def stop(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups, started together; children run with one BLAS thread."""
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    os.environ.update({k: "1" for k in THREAD_VARS})
    try:
        started = {name: Group(tmp_path_factory.mktemp(name), *layout)
                   for name, layout in LAYOUTS.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    yield started
    for g in started.values():
        g.stop()


@pytest.fixture(scope="module")
def jax_results():
    """The JAX layer's sharded functions on a 1 x 4 mesh of virtual CPU
    devices (after the children finish: run beside them, JAX's compiles
    and six children contend for the cores and take longer in all)."""
    jm = jmesh_mod.make_mesh(n_station=1, n_time=4, devices=jax.devices()[:4])
    cfg = JDetectionConfig(signal_freq=1000, detection_db_over_noise_mean_min=1,
                           detection_dur_min_sec=0.5)
    out = {"detect_adaptive": jsh.sharded_detect_adaptive(jnp.asarray(child.delta(32.0, 3)), jm,
                                                          **child.KW)}
    for front, impl, seed in child.STREAM_CASES:
        out[f"{front}_{impl}"] = jsh.sharded_stream_process(
            cfg, None, jnp.asarray(child.stream_audio(seed)), child.STREAM_FS, jm, front=front,
            impl=impl)
    x_re, x_im = child.iq_capture(4.0)
    out["channelize_iq"] = jsh.sharded_channelize_iq(jnp.asarray(x_re), jnp.asarray(x_im), jm,
                                                     child.IQ_FS, child.IQ_CENTERS, **child.IQ_KW)
    return jax.tree_util.tree_map(np.asarray, out)


def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8) if a.dtype != np.bool_ else a


def assert_bit_equal(got: dict, want: dict, prefix: str):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys, prefix
    for k in keys:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


# --- the ten entry points, on every process of both groups ---------------------


@pytest.mark.parametrize("case", list(child.CASES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_entry_point_equals_single_process(groups, layout, case):
    res = groups[layout].results()
    want = res["reference"][0]
    for got, _ in res["ranks"]:
        assert_bit_equal(got, want, f"cases/{case}/")


def test_idle_processes_get_global_results(groups):
    """A 1 x 2 mesh over a group's first two positions: the processes that
    own none of it take part in ``unshard`` and get every result."""
    for g in groups.values():
        res = g.results()
        for got, _ in res["ranks"]:
            assert_bit_equal(got, res["reference"][0], "idle/")


# --- against the JAX layer's sharded functions (1 x 4) -------------------------------


def ranks_1x4(groups):
    return [got for got, _ in groups["1x4_over_2"].results()["ranks"]]


def test_detect_adaptive_matches_jax(jax_results, groups):
    thr_j, above_j = jax_results["detect_adaptive"]
    for got in ranks_1x4(groups):
        np.testing.assert_allclose(got["cases/detect_adaptive/y.0"], thr_j, rtol=JAX_THR_RTOL)
        np.testing.assert_array_equal(got["cases/detect_adaptive/y.1"], above_j)


@pytest.mark.parametrize("variant", [f"{f}_{i}" for f, i, _ in child.STREAM_CASES])
def test_stream_process_matches_jax(jax_results, groups, variant):
    _, ev_j, dg_j = jax_results[variant]
    assert int(ev_j.count.min()) >= 1, "the fixture must produce events"
    for got in ranks_1x4(groups):
        pre = f"cases/stream_process/{variant}"
        count = got[f"{pre}.1.count"]
        np.testing.assert_array_equal(count, ev_j.count)
        for c, n in enumerate(count):
            for f in ("time_start", "time_stop"):
                np.testing.assert_array_equal(got[f"{pre}.1.{f}"][c, :n], getattr(ev_j, f)[c, :n])
            for f in ("db_min", "db_max", "db_mean", "db_std"):
                np.testing.assert_allclose(got[f"{pre}.1.{f}"][c, :n], getattr(ev_j, f)[c, :n],
                                           rtol=0, atol=DB_ATOL, err_msg=f)
        for k in ("threshold", "over_noise"):
            np.testing.assert_allclose(got[f"{pre}.2.{k}"], dg_j[k], rtol=0, atol=DB_ATOL,
                                       equal_nan=True, err_msg=k)


def test_channelize_iq_matches_jax(jax_results, groups):
    for got in ranks_1x4(groups):
        for j, want in enumerate(jax_results["channelize_iq"]):
            np.testing.assert_allclose(got[f"cases/channelize_iq/y.{j}"], want, atol=IQ_ATOL)


# --- the row operations, the mesh and the runtime across processes -----------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_halo_exchange_across_processes(groups, layout):
    """Every shard gets its neighbours' 2-sample tail and 3-sample head,
    local or remote, and zeros at the stream's edges."""
    res = groups[layout].results()
    _, n_st, n_t = LAYOUTS[layout]
    x = np.random.default_rng(4).standard_normal((2, 6 * n_t)).astype(np.float32)
    padded = np.concatenate([np.zeros((2, 2), np.float32), x, np.zeros((2, 3), np.float32)], 1)
    want = np.concatenate([padded[:, 6 * k : 6 * k + 11] for k in range(n_t)], 1)
    np.testing.assert_array_equal(res["reference"][0]["row_ops/halo"], want)
    for got, _ in res["ranks"]:
        assert_bit_equal(got, res["reference"][0], "row_ops/halo")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_time_psum_is_the_shard_order_sum(groups, layout):
    """The row sum across processes is float32 ((v0 + v1) + v2) + ... in
    shard order; over 4 shards these values round differently in the
    reverse order (two terms commute exactly)."""
    res = groups[layout].results()
    _, n_st, n_t = LAYOUTS[layout]
    v = child.psum_values(2, n_t)
    ordered, reverse = v[:, 0].copy(), v[:, -1].copy()
    for k in range(1, n_t):
        ordered = (ordered + v[:, k]).astype(np.float32)
        reverse = (reverse + v[:, n_t - 1 - k]).astype(np.float32)
    assert n_t == 2 or not np.array_equal(ordered, reverse), "the values must be order-sensitive"
    for got, _ in res["ranks"]:
        np.testing.assert_array_equal(bits(got["row_ops/psum"]), bits(ordered))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_time_all_gather_bool_round_trip(groups, layout):
    res = groups[layout].results()
    _, _, n_t = LAYOUTS[layout]
    mask = np.random.default_rng(6).random((2, 5 * n_t)) > 0.5
    for got, _ in res["ranks"]:
        assert got["row_ops/gather"].dtype == np.bool_
        np.testing.assert_array_equal(got["row_ops/gather"], mask)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_spans_processes_in_rank_order(groups, layout):
    world, n_st, n_t = LAYOUTS[layout]
    per = n_st * n_t // world
    owners = [[(s * n_t + t) // per for t in range(n_t)] for s in range(n_st)]
    for rank, (_, info) in enumerate(groups[layout].results()["ranks"]):
        assert (info["process_index"], info["process_count"]) == (rank, world)
        assert info["owners"] == owners
        assert info["transport"] == "gloo" and info["staged_bytes"] == 0
        assert info["wire_bytes"] > 0
        assert info["jax_modules"] == []  # the children run the port alone


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_make_mesh_rejects_unequal_device_counts(groups, layout):
    world = LAYOUTS[layout][0]
    counts = list(range(1, world + 1))
    for _, info in groups[layout].results()["ranks"]:
        assert info["unequal_counts"] == (
            f"every process must pass as many devices to make_mesh; the processes passed {counts}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dryrun_under_a_group(groups, layout):
    """The port's dryrun on a 2 x 2 mesh spanning the group: every process
    checks the global results and prints the single-process line."""
    res = groups[layout].results()
    line = res["reference"][1]["dryrun"]
    assert line.startswith("dryrun_multichip ok: mesh=(2x2)")
    for _, info in res["ranks"]:
        assert info["dryrun"] == line


def test_transport_rules():
    assert tdist.transport_for("nccl", "cuda") == "nccl"
    assert tdist.transport_for("gloo", "cpu") == "gloo"
    assert tdist.transport_for("gloo", "cuda") == "gloo-host-staged"
    with pytest.raises(ValueError, match="NCCL moves CUDA tensors only"):
        tdist.transport_for("nccl", "cpu")
    with pytest.raises(ValueError, match="not supported"):
        tdist.transport_for("mpi", "cpu")
    with pytest.raises(ValueError, match="not supported"):
        tdist.init_multihost("localhost:1", 2, 0, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="NCCL moves CUDA tensors only"):
        tdist.init_multihost("localhost:1", 2, 0, device="cpu", backend="nccl")
    assert not dist.is_initialized()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)


def test_world_size_one_group_equals_no_group(tmp_path):
    """Under a gloo group of one the mesh records its transport and
    ``unshard`` gathers through the group: the results are the mesh's
    without a group, bit for bit."""
    x = torch.from_numpy(child.audio(2, 8.0, 2))
    taps = child.tfir.firwin_bandpass(101, 950.0, 1050.0, child.FS)
    want = tsh.sharded_fir_filter(x, tmesh.make_mesh(2, 2, ["cpu"] * 4), taps)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        mesh = tmesh.make_mesh(2, 2, ["cpu"] * 4)
        assert mesh.transport == "gloo" and mesh.row_groups == (None, None)
        got = tsh.sharded_fir_filter(x, mesh, taps)
        assert mesh.link.wire_bytes == 0 and mesh.link.staged_bytes == 0
    finally:
        dist.destroy_process_group()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# --- the scaling bench ---------------------------------------------------------------


def test_scaling_bench_two_processes(tmp_path):
    """``tools/torch_scaling_bench.py`` as two gloo processes on the CPU,
    ``--pipeline both`` at seconds-scale sizes: rank 0 prints one JSON line
    per pipeline and mesh size, rank 1 nothing."""
    cmd = [sys.executable, os.path.join(REPO, "tools", "torch_scaling_bench.py"),
           "--device", "cpu", "--local-devices", "2", "--devices", "1", "2", "4",
           "--pipeline", "both", "--seconds-per-device", "20", "--window-blocks", "25",
           "--stations-per-device", "2", "--stations-seconds", "12", "--reps", "1",
           "--chain", "2", "--coordinator", f"file://{tmp_path}/store", "--num-processes", "2"]
    env = {**os.environ, **{k: "1" for k in THREAD_VARS}}
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=JOIN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert outs[1][0] == ""
    lines = [json.loads(ln) for ln in outs[0][0].splitlines()]
    assert [(ln["pipeline"], ln["devices"]) for ln in lines] == [
        (p, n) for p in ("batch", "stations") for n in (1, 2, 4)]
    for ln in lines:
        assert ln["processes"] == 2 and ln["transport"] == "gloo" and ln["device"] == "cpu"
        assert ln["sec_per_step"] > 0 and ln["samples_per_sec"] > 0
    assert lines[0]["weak_scaling_efficiency"] == lines[3]["weak_scaling_efficiency"] == 1.0


def test_scaling_bench_imports_only_the_port():
    """The bench imports nothing of JAX or of the JAX package."""
    path = os.path.join(REPO, "tools", "torch_scaling_bench.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in names} <= {
        "__future__", "argparse", "json", "os", "sys", "time", "numpy", "torch",
        "meteor_scatter_tpu_torch"}, names
