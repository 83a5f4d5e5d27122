"""The hand-written CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without JAX.  There, from the repo root (``--noconftest`` skips
``tests/conftest.py``, which sets up JAX)::

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tests marked ``cuda`` need a GPU and skip without one.  K1 (adaptive
solver) and its twin take float prefix sums in different orders, so the
above mask and ``s_incl`` must be equal, and ``thr`` / ``csm`` agree to
``THR_ATOL`` / ``CSM_RTOL`` (the reasoning is in ``chip_smoke.py``), on
both of K1's routes: the walk (a round cap covering the solved blocks) and
the rounds (a smaller cap).  K3
(the fused streaming solve) is bit-exact against its twin on thresholds,
every event slot, count, overflow, every state leaf and the ring.  K2 (band power) sums its FP32 product in another order
than the twin's ``torch.matmul``: dB levels agree to the JAX package's own
kernel tolerances, 2e-3 dB (band, noise) and 4e-3 dB (delta).  On a
virtual 2 x 4 mesh of the card, the sharded streaming machine launches K3
once per mesh position, bit-equal to the twin on the gathered series.  The
build tests run anywhere: they stand in a fake ``nvcc``.
"""

import os
import stat
import time

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
@pytest.mark.parametrize(
    "label,n,kw",
    [
        ("straddling_episodes", 20000, {}),  # freezes opened just before seams
        ("dense_k1.5", 131072, dict(k=1.5)),  # freezes that rarely lift
        ("never_lifting", 131072, dict(fixed=0)),  # one freeze at 0 dB over the chunk
        ("fa_2000", 131072, dict(fa=2000)),  # freezes longer than the warm-up and a segment
        ("window_2000", 131072, dict(window=2000, halo=2000, i0=131072 - 2000,
                                     freeze_in=131072 - 2000 + 40, thr_shift=1.5)),
        ("ragged_100001", 100001, {}),
        ("largest_grid_131672", 131672, {}),  # 129 CTAs
    ],
)
def test_walk_seams_and_density_match_twin(cuda, label, n, kw):
    """The walk route at its seams and on dense data, where speculation and
    truth disagree and the fix-up re-walks."""
    d = series(n, n + 1)
    if label == "straddling_episodes":
        for s0 in range(tak.SEGMENT, n, 3 * tak.SEGMENT):
            d[s0 - 3 : s0 + 2] += 60.0
    if label == "never_lifting":
        d[0] = abs(d[0]) + 5.0  # above block 0's zero threshold
    d = torch.from_numpy(d).to(cuda)
    walks = tak.walk_launches
    ab = assert_kernel_equals_twin(solver_args(d, **kw))
    assert tak.walk_launches == walks + 1
    untrusted, fixup_walks, walked = tak.last_fixup.tolist()
    if label in ("dense_k1.5", "never_lifting", "fa_2000"):
        assert untrusted > 0 and fixup_walks > 0 and walked > 0
    if label == "never_lifting":
        assert float(ab.float().mean()) > 0.3 and walked > 0.9 * n
    if label == "straddling_episodes":
        assert all(bool(ab[s0 - 3 : s0 + 2].all()) for s0 in range(tak.SEGMENT, n, 3 * tak.SEGMENT))


@pytest.mark.cuda
def test_route_by_round_cap(cuda):
    """A cap that covers the solved blocks (the app paths' cap) walks; a
    smaller one iterates rounds.  Both count in ``launches``."""
    d = torch.from_numpy(series(5000, 11)).to(cuda)
    for args, walks in (
        (solver_args(d), True),
        (solver_args(d, max_rounds=4999), False),
        (solver_args(d, k=1.5, max_rounds=1), False),
        (solver_args(d, k=1.5, max_rounds=2), False),
        (solver_args(d, halo=600, i0=9400, max_rounds=4400), True),
    ):
        before, walks_before = tak.launches, tak.walk_launches
        tak._launch(*args)
        assert tak.launches == before + 1
        assert tak.walk_launches == walks_before + int(walks)
    walks_before = tak.walk_launches
    tak.adaptive_solver_fused(d, 4.0, 600, 15, 100, 50)
    assert tak.walk_launches == walks_before + 1


@pytest.mark.cuda
def test_grid_past_co_residency_raises(cuda):
    """4 096 segments cannot all be resident on the card at once: the
    cooperative launch is refused and the wrapper raises, with no fallback."""
    d = torch.zeros(4 << 20, device=cuda)
    before = tak.launches
    with pytest.raises(RuntimeError, match="co-resident"):
        tak._launch(*solver_args(d))
    assert tak.launches == before


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


# ---- K3: the fused streaming solve ---------------------------------------------

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


def alternating_inputs(n, dev):
    """Two channels that cross the locked threshold every block (after a
    quiet start): period 2 (an episode every two blocks, none accepted) and
    period 3 (an accepted two-block track every three blocks)."""
    on = (np.random.default_rng(3).standard_normal((2, n)) * 0.1).astype(np.float32)
    k = np.arange(n - 100)
    on[0, 100:] = np.where(k % 2 == 0, 5.0, -1.0)
    on[1, 100:] = np.where(k % 3 < 2, 5.0, -1.0)
    return torch.from_numpy(on).to(dev), torch.zeros((2, n), device=dev)


def carried_state(scfg, on, pm, n_before):
    return tst.stream_scan(scfg, tst.stream_init_batch(scfg, on.shape[0], device=on.device),
                           on[:, :n_before], pm[:, :n_before])[0]


def assert_bits_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), what


def assert_solve_equals_twin(state, on, pm, scfg=STREAM_CFG, **kw):
    """One launch of K3 against ``stream_solve_plain`` on the same inputs:
    thresholds, every event slot, count, overflow, every state leaf and the
    ring, bit for bit.  Returns the twin's events."""
    params = tst.solve_params(scfg)
    before = tsk.launches
    st_k, ev_k, thr_k = tsk._launch(on, pm, tuple(state), **params, **kw)
    assert tsk.launches == before + 1
    st_p, ev_p, thr_p = tsk.stream_solve_plain(on, pm, tuple(state), **params)
    torch.cuda.synchronize()
    assert_bits_equal(thr_k, thr_p, "thresholds")
    for name, a, b in zip(tst.StreamEvents._fields, ev_k, ev_p):
        assert_bits_equal(a, b, name)
    for name, a, b in zip(tst.StreamState._fields, st_k, st_p):
        assert_bits_equal(a, b, name)
    return tst.StreamEvents(*ev_p)


@pytest.mark.cuda
@pytest.mark.parametrize("C,n", [(1, 300), (64, 3000), (130, 1100)])
def test_stream_machine_fresh_state_bit_exact(cuda, C, n):
    on, pm = stream_inputs(C, n, C, cuda)
    ev = assert_solve_equals_twin(tst.stream_init_batch(STREAM_CFG, C, device=cuda), on, pm)
    assert int(ev.count.sum()) > 0  # events were emitted


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 64, 130])
def test_stream_machine_carried_state_bit_exact(cuda, C):
    on, pm = stream_inputs(C, 900, 100 + C, cuda)
    st = carried_state(STREAM_CFG, on, pm, 437)
    assert int((st.state == tst.TRACK).sum() + (st.state == tst.DETECT).sum()) == C
    assert_solve_equals_twin(st, on[:, 437:].contiguous(), pm[:, 437:].contiguous())


@pytest.mark.cuda
def test_stream_machine_mid_track_and_short_series(cuda):
    """A chunk that starts inside a track, and chunks of 0 to 9 blocks; a
    track of more than 32 blocks still open at the chunk's end."""
    on, pm = stream_inputs(3, 300, 7, cuda)
    on[:, 120:200] += 9.0
    st = carried_state(STREAM_CFG, on, pm, 130)
    assert bool((st.state == tst.TRACK).all())
    for n in (0, 1, 7, 8, 9, 50, 170):
        assert_solve_equals_twin(st, on[:, 130 : 130 + n].contiguous(),
                                 pm[:, 130 : 130 + n].contiguous())
    st2 = tst.stream_scan(STREAM_CFG, st, on[:, 130:180], pm[:, 130:180])[0]
    assert bool((st2.state == tst.TRACK).all()) and int(st2.tr_count.min()) > 32


@pytest.mark.cuda
@pytest.mark.parametrize("seam", ["mid_init", "lock_window", "block_below_w"])
def test_stream_solve_seams_bit_exact(cuda, seam):
    """Seams a live feed can start at: inside Init (blocks 0-40 of a fresh
    stream), inside a lock window that runs past the seam, and at i0 < w."""
    on, pm = stream_inputs(4, 600, 21, cuda)
    on[:, 150:190] += 9.0  # a track leaving at block 190: lock through ~247
    n_before = {"mid_init": 17, "lock_window": 200, "block_below_w": 33}[seam]
    st = carried_state(STREAM_CFG, on, pm, n_before)
    if seam == "mid_init":
        assert bool((st.state == tst.INIT).all())
    if seam == "lock_window":
        assert bool((st.state == tst.DETECT).all() and (st.locked_until_block >= 200).all())
    assert_solve_equals_twin(st, on[:, n_before:].contiguous(), pm[:, n_before:].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("C,n,tile", [
    (2, 20000, tsk.TILE),  # past one shared-memory tile (bulk copies, double-buffered)
    (3, 1103, tsk.TILE),  # n not a multiple of 4: plain loads
    (3, 3000, 256),  # many tiles
    (2, 1101, 64),  # many tiles, ragged last tile, plain loads
])
def test_stream_solve_tiles_bit_exact(cuda, C, n, tile):
    on, pm = stream_inputs(C, n, n, cuda)
    on[:, n // 2 - 20 : n // 2 + 45] += 9.0  # a 65-block track across tiles
    ev = assert_solve_equals_twin(tst.stream_init_batch(STREAM_CFG, C, device=cuda), on, pm, tile=tile)
    assert int(ev.count.min()) > 0


@pytest.mark.cuda
def test_stream_solve_alternating_and_overflow(cuda):
    """A series that crosses the threshold every block (about n episodes),
    and a small event buffer that overflows."""
    scfg = STREAM_CFG._replace(cap=16, min_dur_sec=0.2)
    on, pm = alternating_inputs(700, cuda)
    ev = assert_solve_equals_twin(tst.stream_init_batch(scfg, 2, device=cuda), on, pm, scfg)
    assert int(ev.count[1]) > 16 and bool(ev.overflow[1]) and not bool(ev.overflow[0])


@pytest.mark.cuda
def test_stream_fused_equals_scan_on_card(cuda):
    on, pm = stream_inputs(64, 1100, 5, cuda)
    st0 = tst.stream_init_batch(STREAM_CFG, 64, device=cuda)
    out_f = tst.stream_scan_fused_batch(STREAM_CFG, st0, on, pm)
    out_s = tst.stream_scan(STREAM_CFG, st0, on, pm)
    for part_f, part_s in zip(out_f[:2], out_s[:2]):
        for a, b in zip(part_f, part_s):
            assert_bits_equal(a, b, "state / events")
    assert_bits_equal(out_f[2], out_s[2], "thresholds")
    assert int(out_f[1].count.sum()) > 64


def seam_audio(seconds=64.0, fs=4000, seed=13):
    """2 channels at 4 kHz, a 1000 Hz burst straddling the 16 s seam of a
    4-shard time axis on channel 0, one near the 32 s seam on channel 1."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    x = rng.standard_normal((2, t.size)).astype(np.float32) * 0.05
    for c, (s0, dur) in enumerate([(15.5, 1.5), (31.4, 1.2)]):
        m = (t >= s0) & (t < s0 + dur)
        x[c, m] += 0.6 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.cuda
def test_sharded_fused_launches_k3_per_mesh_position(cuda):
    """On a virtual 2 x 4 mesh of the card, ``impl="fused"`` launches K3
    once per mesh position on that position's station group, each launch
    bit-equal to the twin on the gathered series, and the events equal the
    same call's on a virtual 2 x 4 mesh of the CPU (the twin)."""
    from meteor_scatter_tpu_torch.config import DetectionConfig
    from meteor_scatter_tpu_torch.parallel import make_mesh, sharded_stream_process

    cfg = DetectionConfig(signal_freq=1000.0, detection_db_over_noise_mean_min=1.0,
                          detection_dur_min_sec=0.5)
    x = seam_audio()
    before = tsk.launches
    st, ev, dg = sharded_stream_process(cfg, None, x.to(cuda), 4000,
                                        make_mesh(2, 4, ["cuda:0"] * 8), front="bins",
                                        impl="fused")
    torch.cuda.synchronize()
    assert tsk.launches == before + 8
    scfg = tst.StreamConfig.from_config(cfg)
    on = dg["over_noise"]
    st_s, ev_s, thr_s = tst.stream_scan(scfg, tst.stream_init_batch(scfg, 2, device=cuda), on,
                                        torch.zeros_like(on))
    for a, b in zip((*st, *ev, dg["threshold"]), (*st_s, *ev_s, thr_s)):
        assert_bits_equal(a, b, "sharded K3 against the twin")
    before = tsk.launches
    _, ev_c, _ = sharded_stream_process(cfg, None, x, 4000, make_mesh(2, 4, ["cpu"] * 8),
                                        front="bins", impl="fused")
    assert tsk.launches == before  # the twin on the CPU
    assert int(ev.count.min()) >= 1
    for f in ("count", "time_start", "time_stop", "overflow"):
        assert torch.equal(getattr(ev, f).cpu(), getattr(ev_c, f)), f


@pytest.mark.cuda
def test_stream_fused_launches_only_k3(cuda):
    """On the card the fused solve is one kernel launch and nothing else:
    no gather, reduction, cumsum or scatter; one channel as well."""
    from torch.profiler import ProfilerActivity, profile

    on, pm = stream_inputs(8, 600, 9, cuda)
    st0 = tst.stream_init_batch(STREAM_CFG, 8, device=cuda)
    st1 = tst.stream_init(STREAM_CFG, device=cuda)
    tst.stream_scan_fused_batch(STREAM_CFG, st0, on, pm)  # build outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)  # a fresh tracer window can miss the first records
        tst.stream_scan_fused_batch(STREAM_CFG, st0, on, pm)
        tst.stream_scan_fused(STREAM_CFG, st1, on[3], pm[3])
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    assert [r.count for r in rows] == [2] and "stream_solve_kernel" in rows[0].key


@pytest.mark.cuda
def test_stream_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    on, pm = stream_inputs(4, 50, 1, cuda)
    state = tuple(tst.stream_init_batch(STREAM_CFG, 4, device=cuda))
    params = tst.solve_params(STREAM_CFG)
    bad = [
        (0, on.cpu()),  # device
        (0, on.double()),  # dtype
        (0, torch.cat([on, on], 1)[:, ::2]),  # not contiguous
        (0, on.reshape(-1)),  # not 2-D
        (1, pm[:-1]),  # shape
        (1, pm.cpu()),  # device
        (2, state[:-1]),  # a state leaf missing
        (2, state[:2] + (state[2][:, :0],) + state[3:]),  # empty ring
        (2, state[:3] + (state[3][:3],) + state[4:]),  # leaf shape
        (2, state[:4] + (state[4].long(),) + state[5:]),  # leaf dtype
    ]
    for pos, value in bad:
        a = [on, pm, state]
        a[pos] = value
        with pytest.raises(ValueError):
            tsk._launch(*a, **params)
    with pytest.raises(ValueError):
        tsk._launch(on, pm, state, **params, tile=48)  # not a multiple of 32


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
