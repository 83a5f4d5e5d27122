"""What a run refuses, and what it must not load."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import types

import pytest

from bench_h100 import harness
from bench_h100.tests.tiny_cells import ROOT

RUN = [sys.executable, "bench_h100/run.py", "--workload", "archive_hour_files", "--seed",
       str(2 ** 40 + 3), "--seconds", "1", "--trace", "0"]


def _cpu_only_env(tmp_path):
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the run exits non-zero and prints nothing on
    standard output, instead of running on the CPU."""
    p = subprocess.run(RUN, cwd=ROOT, env=_cpu_only_env(tmp_path), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder
    (no program), the run exits non-zero and prints nothing."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_h100"), tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH="")
    p = subprocess.run(RUN, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import meteor_scatter_tpu_torch  # noqa: F401  (begins with the JAX package's name)

    clean = harness.forbidden_modules()
    assert "meteor_scatter_tpu" not in clean
    monkeypatch.setitem(sys.modules, "meteor_scatter_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert {"meteor_scatter_tpu", "jaxlib"} <= set(harness.forbidden_modules())


def test_run_and_reference_load_no_jax(tmp_path):
    """In a fresh process: the reference loads nothing of the port; the
    entry point and a whole run of a cell load neither JAX nor the JAX
    package (by whole top-level names: the port's begins with the JAX
    package's)."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {ROOT!r})
        from bench_h100.reference import detectors, fronts
        from bench_h100 import check
        tops = lambda: sorted({{m.split(".")[0] for m in sys.modules}})
        ref_loaded = tops()
        import bench_h100.run
        from bench_h100.tests import tiny_cells
        out = tiny_cells.run(tiny_cells.cell("network64_live_capacity"))
        print(json.dumps({{"ref": ref_loaded, "after": tops(), "correct": out["correct"]}}))
    """)
    p = subprocess.run([sys.executable, "-c", code], env=_cpu_only_env(tmp_path),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert "meteor_scatter_tpu_torch" not in got["ref"]
    assert not set(got["after"]) & {"jax", "jaxlib", "flax", "meteor_scatter_tpu"}
    assert "meteor_scatter_tpu_torch" in got["after"] and got["correct"]


@pytest.mark.cuda
def test_card_run_prints_result(tmp_path):
    """On a card: a short run of a cell prints its result last, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark refuses to run on the CPU")
    p = subprocess.run(RUN, cwd=ROOT, env=dict(os.environ, TMPDIR=str(tmp_path)),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
