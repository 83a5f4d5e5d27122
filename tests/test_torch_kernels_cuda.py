"""The hand-written CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without JAX.  There, from the repo root (``--noconftest`` skips
``tests/conftest.py``, which sets up JAX)::

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tests marked ``cuda`` need a GPU and skip without one.  The kernel and its
twin take float prefix sums in different orders, so the above mask and
``s_incl`` must be equal, and ``thr`` / ``csm`` agree to ``THR_ATOL`` /
``CSM_RTOL`` (the reasoning is in ``chip_smoke.py``).  The build tests run
anywhere: they stand in a fake ``nvcc``.
"""

import os
import stat

import numpy as np
import pytest
import torch

from meteor_scatter_tpu_torch.models import adaptive as tad
from meteor_scatter_tpu_torch.ops.kernels import _build
from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as tak

THR_ATOL = 1e-2
CSM_RTOL = 1e-5


def series(n, seed, amp=30.0):
    """3 dB noise with 5-block bursts every ~235 blocks, like a delta-dB day."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal(n) * 3.0).astype(np.float32)
    for s in rng.integers(0, max(n - 5, 1), size=max(n // 235, 1)):
        d[s : s + 5] += amp
    return d


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def solver_args(d, halo=0, i0=0, freeze_in=-1, thr_shift=0.0, k=4.0, window=600,
                fb=15, fa=100, fixed=50, max_rounds=None):
    fixed_thr = d.mean() + k * d.std(correction=0)
    carry_i = torch.tensor([i0, freeze_in], dtype=torch.int32, device=d.device)
    carry_f = torch.stack([fixed_thr, fixed_thr + thr_shift]).float()
    rounds = d.shape[0] if max_rounds is None else max_rounds
    return (d, carry_i, carry_f, halo, k, window, fb, fa, fixed, rounds)


def assert_kernel_equals_twin(args):
    before = tak.launches
    thr_k, ab_k, s_k, c_k = tak._launch(*args)
    assert tak.launches == before + 1
    thr_p, ab_p, s_p, c_p = tak.adaptive_solver_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ab_k, ab_p)
    assert torch.equal(s_k, s_p)
    assert float((thr_k - thr_p).abs().max()) <= THR_ATOL
    assert float((c_k - c_p).abs().max()) <= CSM_RTOL * max(1.0, float(c_p.abs().max()))
    return ab_p


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,kw",
    [
        (100, dict(window=50, fixed=5)),  # shorter than one warp's tile
        (1023, dict(window=128)),
        (8193, {}),  # one block past a full 8192-block tile
        (18000, {}),  # 1 h at the main path's parameters
        (131072, {}),  # a full chunk
        (5000, dict(fixed=0)),  # threshold 0 at block 0
        (5000, dict(window=0)),
        (5000, dict(fb=0, fa=1, fixed=1)),
        (5000, dict(k=1.5)),  # dense detections: many fixpoint rounds
        (5000, dict(k=1.5, max_rounds=1)),  # stopped by the round cap
        (5000, dict(k=1.5, max_rounds=2)),
    ],
)
def test_whole_series_matches_twin(cuda, n, kw):
    d = torch.from_numpy(series(n, n)).to(cuda)
    ab = assert_kernel_equals_twin(solver_args(d, **kw))
    assert int(ab.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("freeze_in,thr_shift", [(-1, 0.0), (130472 + 40, 1.5), (130472 + 5000, -2.0)])
def test_haloed_chunk_matches_twin(cuda, freeze_in, thr_shift):
    d = torch.from_numpy(series(131072, 7)).to(cuda)
    args = solver_args(d, halo=600, i0=131072 - 600, freeze_in=freeze_in, thr_shift=thr_shift)
    assert_kernel_equals_twin(args)


@pytest.mark.cuda
def test_chunked_path_on_card(cuda, monkeypatch):
    """The chunked path on the card: one launch per chunk, the same
    above mask and events as the plain-PyTorch parallel solver."""
    d = torch.from_numpy(series(40000, 3)).to(cuda)
    kw = dict(threshold_std_factor=4.0, window_blocks=600, freeze_blocks_before=15,
              freeze_blocks_after=100, fixed_threshold_blocks=50)
    monkeypatch.setattr(tak, "MAX_FUSED_BLOCKS", 10600)  # chunk = 10 000 blocks
    before = tak.launches
    ev_f, thr_f = tad._detect_adaptive_fused(d, cap=512, **kw)
    assert tak.launches == before + 4
    thr_p, ab_p = tad.adaptive_thresholds_parallel(d, **kw)
    ev_p = tad.events_from_mask(ab_p, d, 512)
    assert torch.equal(d > thr_f, ab_p)
    c = int(ev_p.count)
    assert int(ev_f.count) == c > 100 and bool(ev_f.overflow) == bool(ev_p.overflow)
    assert torch.equal(ev_f.start[:c], ev_p.start[:c]) and torch.equal(ev_f.stop[:c], ev_p.stop[:c])
    assert float((ev_f.db_mean[:c] - ev_p.db_mean[:c]).abs().max()) <= 1e-2


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    d = torch.from_numpy(series(1000, 1)).to(cuda)
    args = list(solver_args(d))
    bad = [
        (0, d.cpu()),  # device
        (0, d.double()),  # dtype
        (0, torch.stack([d, d], 1)[:, 0]),  # not contiguous
        (0, d.reshape(10, 100)),  # not 1-D
        (3, 1000),  # halo past the series
        (1, args[1].long()),  # carry dtype
        (2, args[2][:1]),  # carry shape
        (2, args[2].cpu()),  # carry device
    ]
    for pos, value in bad:
        a = list(args)
        a[pos] = value
        with pytest.raises(ValueError):
            tak._launch(*a)


def fake_nvcc(tmp_path, script):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + script)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    nvcc = fake_nvcc(tmp_path, 'echo "adaptive_solver.cu(1): error: something broke" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="something broke"):
        _build.load("adaptive_solver")
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-written is kept


def test_build_command_and_cache_key(tmp_path, monkeypatch):
    """nvcc gets the sm_90a flags and the csrc source; the library name
    changes with the source."""
    args_file = tmp_path / "args.txt"
    nvcc = fake_nvcc(tmp_path, f'echo "$@" > {args_file}\nexit 1\n')
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "adaptive_solver.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    first = _build.library_path("adaptive_solver")
    with pytest.raises(RuntimeError):
        _build.load("adaptive_solver")
    argv = args_file.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in argv and "-shared" in argv
    assert argv[-1] == str(src / "adaptive_solver.cu")
    (src / "adaptive_solver.cu").write_text("// v2\n")
    assert _build.library_path("adaptive_solver") != first
    assert first.parent == tmp_path / "build"


def test_real_sources_are_shipped():
    assert (_build.CSRC / "adaptive_solver.cu").is_file()
    assert os.path.basename(_build.BUILD_DIR) == "torch_kernels"
