"""The hand-written CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without JAX.  There, from the repo root (``--noconftest`` skips
``tests/conftest.py``, which sets up JAX)::

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tests marked ``cuda`` need a GPU and skip without one.  K1 (adaptive
solver) and its twin take float prefix sums in different orders, so the
above mask and ``s_incl`` must be equal, and ``thr`` / ``csm`` agree to
``THR_ATOL`` / ``CSM_RTOL`` (the reasoning is in ``chip_smoke.py``).  K3
(streaming state machine) is bit-exact against its twin on every output
and the carry.  K2 (band power) sums its FP32 product in another order
than the twin's ``torch.matmul``: dB levels agree to the JAX package's own
kernel tolerances, 2e-3 dB (band, noise) and 4e-3 dB (delta).  The build
tests run anywhere: they stand in a fake ``nvcc``.
"""

import os
import stat

import numpy as np
import pytest
import torch

from meteor_scatter_tpu_torch.models import adaptive as tad
from meteor_scatter_tpu_torch.models import streaming as tst
from meteor_scatter_tpu_torch.ops import bandpower as tbp
from meteor_scatter_tpu_torch.ops.kernels import _build
from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as tak
from meteor_scatter_tpu_torch.ops.kernels import bandpower_kernel as tbk
from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as tsk

THR_ATOL = 1e-2
CSM_RTOL = 1e-5
K2_ATOL = (2e-3, 2e-3, 4e-3)  # band, noise, delta (tests/test_pallas_kernels.py)


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
    for name in ("adaptive_solver", "stream_machine", "bandpower"):
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert os.path.basename(_build.BUILD_DIR) == "torch_kernels"


# ---- K3: streaming state machine ---------------------------------------------

STREAM_CFG = tst.StreamConfig(block_sec=0.2, avg_win=40, init_wait_sec=8.0, after_wait_sec=12.0,
                              k_std=4.0, min_mean_db=1.0, min_dur_sec=0.5, cap=64)


def stream_inputs(C, n, seed, dev):
    """Over-noise series with bursts (some rejected as short), PSD means."""
    rng = np.random.default_rng(seed)
    on = (rng.standard_normal((C, n)) * 0.3).astype(np.float32)
    for c in range(C):
        for b in rng.integers(50, max(n - 50, 51), size=max(n // 150, 1)):
            on[c, b : b + int(rng.integers(2, 30))] += rng.uniform(2.0, 10.0)
    pm = (-80.0 + rng.standard_normal((C, n))).astype(np.float32)
    return torch.from_numpy(on).to(dev), torch.from_numpy(pm).to(dev)


def machine_args(state, on, pm):
    """The kernel's inputs as the streaming solvers build them."""
    args, kw, _ = tst.machine_inputs(STREAM_CFG, state, on, pm)
    return args, kw


def assert_bits_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), what


def assert_machine_equals_twin(args, kw):
    before = tsk.launches
    ys_k, cf_k, ci_k = tsk._launch(*args, **kw)
    assert tsk.launches == before + 1
    ys_p, cf_p, ci_p = tsk.stream_machine_plain(*args, **kw)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(ys_k, ys_p)):
        assert_bits_equal(a, b, f"output {k}")
    assert_bits_equal(cf_k, cf_p, "carry_f")
    assert_bits_equal(ci_k, ci_p, "carry_i")
    return ys_p


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 64, 130])
def test_stream_machine_fresh_state_bit_exact(cuda, C):
    on, pm = stream_inputs(C, 700, C, cuda)
    args, kw = machine_args(tst.stream_init_batch(STREAM_CFG, C, cuda), on, pm)
    assert bool(torch.isnan(args[2][0]).all())  # block 0: empty ring, NaN base threshold
    ys = assert_machine_equals_twin(args, kw)
    assert int(ys[1].sum()) > 0  # events were emitted


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 64, 130])
def test_stream_machine_carried_state_bit_exact(cuda, C):
    on, pm = stream_inputs(C, 900, 100 + C, cuda)
    st, _, _ = tst.stream_scan(STREAM_CFG, tst.stream_init_batch(STREAM_CFG, C, cuda),
                               on[:, :437], pm[:, :437])
    assert int((st.state == tst.TRACK).sum() + (st.state == tst.DETECT).sum()) == C
    args, kw = machine_args(st, on[:, 437:], pm[:, 437:])
    assert_machine_equals_twin(args, kw)


@pytest.mark.cuda
def test_stream_machine_mid_track_and_short_series(cuda):
    """A chunk that starts inside a track, and chunks of 0 to 9 blocks."""
    on, pm = stream_inputs(3, 300, 7, cuda)
    on[:, 120:160] += 9.0
    st, _, _ = tst.stream_scan(STREAM_CFG, tst.stream_init_batch(STREAM_CFG, 3, cuda),
                               on[:, :130], pm[:, :130])
    assert bool((st.state == tst.TRACK).all())
    for n in (0, 1, 7, 8, 9, 170):
        args, kw = machine_args(st, on[:, 130 : 130 + n], pm[:, 130 : 130 + n])
        assert_machine_equals_twin(args, kw)


@pytest.mark.cuda
def test_stream_fused_equals_scan_on_card(cuda):
    on, pm = stream_inputs(64, 1100, 5, cuda)
    st0 = tst.stream_init_batch(STREAM_CFG, 64, cuda)
    out_f = tst.stream_scan_fused_batch(STREAM_CFG, st0, on, pm)
    out_s = tst.stream_scan(STREAM_CFG, st0, on, pm)
    for part_f, part_s in zip(out_f[:2], out_s[:2]):
        for a, b in zip(part_f, part_s):
            assert_bits_equal(a, b, "state / events")
    assert_bits_equal(out_f[2], out_s[2], "thresholds")
    assert int(out_f[1].count.sum()) > 64


@pytest.mark.cuda
def test_stream_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    on, pm = stream_inputs(4, 50, 1, cuda)
    args, kw = machine_args(tst.stream_init_batch(STREAM_CFG, 4, cuda), on, pm)
    on2 = args[0]
    bad = [
        (0, on2.cpu()),  # device
        (0, on2.double()),  # dtype
        (0, torch.cat([on2, on2], 1)[:, ::2]),  # not contiguous
        (0, on2.reshape(-1)),  # not 2-D
        (1, args[1][:-1]),  # shape
        (2, args[2].cpu()),  # device
        (3, args[3][:7]),  # carry shape
        (4, args[4].long()),  # carry dtype
    ]
    for pos, value in bad:
        a = list(args)
        a[pos] = value
        with pytest.raises(ValueError):
            tsk._launch(*a, **kw)


# ---- K2: band power ------------------------------------------------------------


def k2_inputs(nf, dev, bands=((993.0, 1013.0), (690.0, 710.0)), seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(nf * 1200 + 77) * 1500).astype(np.float32)
    x[1200 * (nf // 2) : 1200 * (nf // 2) + 1200] += 9000 * np.sin(
        2 * np.pi * 1003.0 * np.arange(1200) / 6000
    ).astype(np.float32)
    M, slices = tbp.band_projection_matrix(6000, 1024, 1200, list(bands))
    return torch.from_numpy(x).to(dev), M, slices


@pytest.mark.cuda
@pytest.mark.parametrize("nf", [1, 3, 4, 35, 1001, 4097])
def test_bandpower_kernel_matches_twin_ragged(cuda, nf):
    x, M, slices = k2_inputs(nf, cuda, seed=nf)
    frames = x[: nf * 1200].reshape(nf, 1200)  # a view: rows 1200 apart, 1024 read
    proj = torch.from_numpy(M).to(cuda)
    n_band = slices[0].stop
    before = tbk.launches
    got = tbk._launch(frames, proj, n_band, 1e-12)
    assert tbk.launches == before + 1
    want = tbk.band_power_db_plain(frames, proj, n_band, 1e-12)
    torch.cuda.synchronize()
    for g, w, tol in zip(got, want, K2_ATOL):
        assert g.shape == (nf,)
        assert float((g - w).abs().max()) <= tol


@pytest.mark.cuda
def test_bandpower_kernel_wide_projection_and_public_entry(cuda):
    """More than 16 projection columns (the 32-column instance), and the
    public entry point launching the kernel on a CUDA tensor."""
    x, M, slices = k2_inputs(300, cuda, bands=((975.0, 1030.0), (690.0, 710.0)))
    assert 16 < M.shape[1] <= tbk.MAX_COLUMNS
    before = tbk.launches
    got = tbk.band_power_db_pallas(x[: 300 * 1200].reshape(300, 1200), M, slices)
    assert tbk.launches == before + 1
    want = tbk.band_power_db_pallas(x[: 300 * 1200].reshape(300, 1200).cpu(), M, slices)
    for g, w, tol in zip(got, want, K2_ATOL):
        assert float((g.cpu() - w).abs().max()) <= tol
    got = tbk.fused_bandpower_delta(x, 6000, 1024, 1200, (993.0, 1013.0), (690.0, 710.0))
    want = tbp.delta_power_db(x, 6000, 1024, 1200, (993.0, 1013.0), (690.0, 710.0))
    assert tbk.launches == before + 2
    for g, w, tol in zip(got, want, K2_ATOL):
        assert float((g - w).abs().max()) <= tol


@pytest.mark.cuda
def test_bandpower_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, M, slices = k2_inputs(10, cuda)
    frames = x[:12000].reshape(10, 1200)
    proj = torch.from_numpy(M).to(cuda)
    bad = [
        (0, frames.cpu()),  # device
        (0, frames.double()),  # dtype
        (0, frames.t()),  # columns not unit-stride
        (0, x[:12000]),  # not 2-D
        (0, frames[:, :1000]),  # narrower than the projection
        (1, proj.double()),  # projection dtype
        (1, proj.t()),  # projection not contiguous
        (1, torch.zeros((1024, 40), device=cuda)),  # too many columns
    ]
    for pos, value in bad:
        a = [frames, proj, slices[0].stop, 1e-12]
        a[pos] = value
        with pytest.raises(ValueError):
            tbk._launch(*a)
