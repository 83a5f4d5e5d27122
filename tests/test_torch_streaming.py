"""The streaming detector of the PyTorch port against the JAX package, on
the CPU, and the port's own solver contracts.

Against the JAX package, on one input made with numpy: event counts,
``time_start`` / ``time_stop``, the ring and the integer state fields are
exactly equal; thresholds, ``locked_threshold`` and the accumulated
statistics agree to ``RTOL`` / ``ATOL``.  They cannot be bit-equal: the
port's base-threshold prologue sums each 40-value window in another order
than XLA does, and XLA may contract ``i·bs − t0`` into an FMA.

Within the port: the fused solver (K3's plain twin on the CPU) equals the
scan bit for bit, a chunked run equals an unchunked one bit for bit, and
the per-block ``stream_step`` oracle equals the scan to float32 rounding.
The twin's pieces are held bit for bit against independent oracles: the
slot-order window sums against a numpy float32 replay of the live ring,
and the whole solve against the block machine followed by a Python-loop
compaction and the replayed ring.
The CUDA kernel itself is held against the twin on a GPU by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.config import DetectionConfig as JDetectionConfig
from meteor_scatter_tpu.models import streaming as jst
from meteor_scatter_tpu_torch.config import DetectionConfig
from meteor_scatter_tpu_torch.models import streaming as tst
from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as tsk

from test_streaming_headless import make_audio
from test_streaming_jump import default_cfg, make_series

RTOL = ATOL = 1e-5
DB_ATOL = 1e-3
EXACT_STATE = ("state", "block_idx", "ring", "locked_until_block", "track_start_block",
               "tr_count", "init_count")
CLOSE_STATE = ("locked_threshold", "track_start_sec", "tr_sum", "tr_sumsq", "tr_min", "tr_max",
               "init_sum", "psd_db_mean_from_init")
EXACT_EV = ("time_start", "time_stop")
CLOSE_EV = ("duration", "db_min", "db_max", "db_mean", "db_std")

J_SCFG = default_cfg()
T_SCFG = tst.StreamConfig(*J_SCFG)
LIVE = dict(signal_freq=1000.0, detection_db_over_noise_mean_min=1.0, detection_dur_min_sec=0.5)
J_CFG, T_CFG = JDetectionConfig(**LIVE), DetectionConfig(**LIVE)
FS = 4000


def series(C, n, seed, bursts=()):
    pairs = [make_series(n, seed + c, bursts) for c in range(C)]
    return (np.stack([np.asarray(o) for o, _ in pairs]),
            np.stack([np.asarray(p) for _, p in pairs]))


def as_numpy(tup):
    return type(tup)(*(np.asarray(x) for x in tup))


def torch_numpy(tup):
    return type(tup)(*(x.numpy() for x in tup))


def assert_matches_jax(t_out, j_out):
    (st_t, ev_t, thr_t), (st_j, ev_j, thr_j) = (
        (torch_numpy(t_out[0]), torch_numpy(t_out[1]), t_out[2].numpy()),
        (as_numpy(j_out[0]), as_numpy(j_out[1]), np.asarray(j_out[2])),
    )
    np.testing.assert_allclose(thr_t, thr_j, rtol=RTOL, atol=ATOL, equal_nan=True)
    np.testing.assert_array_equal(ev_t.count, ev_j.count)
    np.testing.assert_array_equal(ev_t.overflow, ev_j.overflow)
    assert thr_t.dtype == np.float32 and ev_t.count.dtype == np.int32
    for f in EXACT_EV:
        np.testing.assert_array_equal(getattr(ev_t, f), getattr(ev_j, f), err_msg=f)
    for f in CLOSE_EV:
        np.testing.assert_allclose(getattr(ev_t, f), getattr(ev_j, f), rtol=RTOL, atol=ATOL,
                                   err_msg=f)
    for f in EXACT_STATE:
        a, b = getattr(st_t, f), getattr(st_j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in CLOSE_STATE:
        a, b = getattr(st_t, f), getattr(st_j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)


def assert_bits_equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert_bits_equal(x, y)
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def jax_vmapped_scan(scfg, st0, on, pm):
    return jax.vmap(lambda s, o, p: jst.stream_scan(scfg, s, o, p))(st0, jnp.asarray(on),
                                                                  jnp.asarray(pm))


@pytest.mark.parametrize(
    "n,seed,bursts",
    [
        (700, 0, ()),
        (700, 1, ((120, 140, 8.0), (400, 430, 9.0))),
        (900, 3, ((100, 104, 3.0), (300, 330, 12.0), (352, 380, 12.0), (700, 702, 9.0))),
    ],
)
def test_scan_matches_jax_vmapped_scan(n, seed, bursts):
    on, pm = series(3, n, seed, bursts)
    got = tst.stream_scan(T_SCFG, tst.stream_init_batch(T_SCFG, 3, device="cpu"),
                          torch.from_numpy(on), torch.from_numpy(pm))
    want = jax_vmapped_scan(J_SCFG, jst.stream_init_batch(J_SCFG, 3), on, pm)
    assert_matches_jax(got, want)
    if bursts:
        assert got[1].count.min() >= 1


def test_fused_twin_matches_jax_fused_kernel():
    """600 blocks cross the JAX kernel's 512-block grid chunk."""
    on, pm = series(3, 600, 5, ((100, 130, 8.0), (480, 530, 9.0)))
    got = tst.stream_scan_fused_batch(T_SCFG, tst.stream_init_batch(T_SCFG, 3, device="cpu"),
                                      torch.from_numpy(on), torch.from_numpy(pm))
    want = jst.stream_scan_fused_batch(J_SCFG, jst.stream_init_batch(J_SCFG, 3), jnp.asarray(on),
                                       jnp.asarray(pm), interpret=True)
    assert_matches_jax(got, want)
    assert got[1].count.min() >= 2


@pytest.mark.parametrize("cap", [16, 2])  # cap 2 overflows: 3 events a channel
def test_port_fused_equals_scan_bit_exact(cap):
    scfg = T_SCFG._replace(cap=cap)
    on, pm = series(4, 800, 7, ((150, 170, 8.0), (400, 430, 9.0), (650, 690, 7.0)))
    st0 = tst.stream_init_batch(scfg, 4, device="cpu")
    on, pm = torch.from_numpy(on), torch.from_numpy(pm)
    fused = tst.stream_scan_fused_batch(scfg, st0, on, pm)
    assert_bits_equal(fused, tst.stream_scan(scfg, st0, on, pm))
    assert_bits_equal(  # one channel, unbatched
        tst.stream_scan_fused(scfg, tst.stream_init(scfg, device="cpu"), on[1], pm[1]),
        tst.stream_scan(scfg, tst.stream_init(scfg, device="cpu"), on[1], pm[1]),
    )
    if cap == 2:
        assert bool(fused[1].overflow.all()) and int(fused[1].count.min()) == 3


def test_chunked_equals_unchunked():
    on, pm = series(2, 900, 9, ((280, 310, 8.0), (590, 640, 9.0)))
    on, pm = torch.from_numpy(on), torch.from_numpy(pm)
    st_w, ev_w, thr_w = tst.stream_scan_fused_batch(
        T_SCFG, tst.stream_init_batch(T_SCFG, 2, device="cpu"), on, pm)
    st = tst.stream_init_batch(T_SCFG, 2, device="cpu")
    thrs, starts = [], []
    for a, b in ((0, 300), (300, 597), (597, 600), (600, 900)):  # seams inside both tracks
        st, ev, thr = tst.stream_scan_fused_batch(T_SCFG, st, on[:, a:b], pm[:, a:b])
        thrs.append(thr)
        starts += [ev.time_start[c, : int(ev.count[c])] for c in range(2)]
    assert_bits_equal(st, st_w)
    assert_bits_equal((torch.cat(thrs, 1),), (thr_w,))
    got = torch.sort(torch.cat(starts)).values
    want = torch.sort(torch.cat([ev_w.time_start[c, : int(ev_w.count[c])] for c in range(2)])).values
    assert torch.equal(got, want) and got.numel() >= 4


def test_stream_step_loop_equals_scan():
    """The per-block oracle formulation against the scan (float32 rounding:
    the scan's window sums run batched, the step's over the ring)."""
    on, pm = (torch.from_numpy(a[0]) for a in series(1, 600, 11, ((100, 140, 8.0), (350, 356, 9.0))))
    st, ev = tst.stream_init(T_SCFG, device="cpu"), tst._empty_events(T_SCFG.cap, torch.float32, "cpu")
    thrs = []
    for i in range(600):
        st, ev, thr = tst.stream_step(T_SCFG, st, ev, on[i], pm[i])
        thrs.append(thr)
    st_s, ev_s, thr_s = tst.stream_scan(T_SCFG, tst.stream_init(T_SCFG, device="cpu"), on, pm)
    np.testing.assert_allclose(torch.stack(thrs).numpy(), thr_s.numpy(), rtol=1e-6, equal_nan=True)
    assert int(ev.count) == int(ev_s.count) == 2
    for f in tst.StreamEvents._fields[:7]:
        np.testing.assert_allclose(getattr(ev, f).numpy(), getattr(ev_s, f).numpy(), rtol=1e-6,
                                   err_msg=f)
    for f in tst.StreamState._fields:
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(st_s, f).numpy(), rtol=1e-6,
                                   err_msg=f)


def test_state_carried_across_packages():
    """A stream begun in JAX and finished in the port gives JAX's events,
    and the port's state hands back to JAX the same way."""
    on, pm = series(1, 800, 13, ((380, 420, 8.0), (600, 630, 9.0)))
    on, pm = on[0], pm[0]
    st_j, _, _ = jst.stream_scan(J_SCFG, jst.stream_init(J_SCFG), jnp.asarray(on[:400]),
                                 jnp.asarray(pm[:400]))
    assert int(st_j.state) == tst.TRACK  # the seam falls inside the first track
    rest_j = jst.stream_scan(J_SCFG, st_j, jnp.asarray(on[400:]), jnp.asarray(pm[400:]))
    st_t = tst.state_from_numpy(as_numpy(st_j), "cpu")
    rest_t = tst.stream_scan(T_SCFG, st_t, torch.from_numpy(on[400:]), torch.from_numpy(pm[400:]))
    assert int(rest_t[1].count) == 2
    assert_matches_jax(rest_t, rest_j)

    back = jst.StreamState(*(jnp.asarray(a) for a in tst.state_to_numpy(st_t)))
    for a, b in zip(back, st_j):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(tst.state_from_numpy(dict(as_numpy(st_j)._asdict()), "cpu"), tst.StreamState)


@pytest.mark.parametrize("front", ["welch", "bins"])
def test_fronts_match_jax(front):
    x = make_audio(FS)
    t_fn = tst.stream_front if front == "welch" else tst.stream_front_headless
    j_fn = jst.stream_front if front == "welch" else jst.stream_front_headless
    on_t, pm_t, dg_t = t_fn(T_CFG, torch.from_numpy(x), FS)
    on_j, pm_j, dg_j = j_fn(J_CFG, jnp.asarray(x), FS)
    assert tuple(on_t.shape) == on_j.shape == (450,)
    np.testing.assert_allclose(on_t.numpy(), np.asarray(on_j), rtol=0, atol=DB_ATOL)
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), rtol=0, atol=DB_ATOL)
    assert set(dg_t) == set(dg_j)
    for key in ("ms_db", "noise1_db", "noise2_db"):
        np.testing.assert_allclose(dg_t[key].numpy(), np.asarray(dg_j[key]), rtol=0, atol=DB_ATOL)
    if front == "welch":
        np.testing.assert_array_equal(dg_t["freqs"], dg_j["freqs"])
        assert tuple(dg_t["psd_db"].shape) == dg_j["psd_db"].shape
    # pre-blocked audio gives the same bits as flat audio
    on_b, pm_b, _ = t_fn(T_CFG, torch.from_numpy(x[: 450 * 800].reshape(1, 450, 800)), FS)
    assert torch.equal(on_b[0], on_t) and torch.equal(pm_b[0], pm_t)


@pytest.mark.parametrize("front", ["welch", "bins"])
def test_stream_process_matches_jax(front):
    x = make_audio(FS)
    st_t, ev_t, dg_t = tst.stream_process(
        T_CFG, tst.stream_init(tst.StreamConfig.from_config(T_CFG), device="cpu"), torch.from_numpy(x), FS,
        front=front, impl="scan")
    st_j, ev_j, dg_j = jst.stream_process(
        J_CFG, jst.stream_init(jst.StreamConfig.from_config(J_CFG)), jnp.asarray(x), FS,
        front=front, impl="scan")
    c = int(ev_j.count)
    assert int(ev_t.count) == c >= 3
    for f in EXACT_EV:
        np.testing.assert_array_equal(getattr(ev_t, f).numpy()[:c], np.asarray(getattr(ev_j, f))[:c])
    for f in ("db_min", "db_max", "db_mean", "db_std"):
        np.testing.assert_allclose(getattr(ev_t, f).numpy()[:c], np.asarray(getattr(ev_j, f))[:c],
                                   rtol=0, atol=DB_ATOL, err_msg=f)
    assert set(dg_t) == set(dg_j)
    np.testing.assert_allclose(dg_t["threshold"].numpy(), np.asarray(dg_j["threshold"]),
                               rtol=0, atol=DB_ATOL, equal_nan=True)
    assert int(st_t.state) == int(st_j.state) and int(st_t.block_idx) == int(st_j.block_idx)


@pytest.mark.parametrize("front", ["welch", "bins"])
def test_empty_chunk_keeps_the_diag_schema(front):
    st = tst.stream_init(tst.StreamConfig.from_config(T_CFG), device="cpu")
    x = torch.from_numpy(make_audio(FS, dur=10.0))
    st, _, d_full = tst.stream_process(T_CFG, st, x, FS, front=front, impl="fused")
    st2, ev, d_empty = tst.stream_process(T_CFG, st, x[:10], FS, front=front, impl="fused")
    assert set(d_empty) == set(d_full) and tuple(d_empty["over_noise"].shape) == (0,)
    assert st2 is st and int(ev.count) == 0 and tuple(ev.time_start.shape) == (T_CFG.max_events,)


def test_stream_process_rejects_unknown_and_unported():
    """Unknown fronts and solvers raise; the episode-jump solvers, once
    unported, now run (``tests/test_torch_episode.py`` holds them)."""
    st = tst.stream_init(tst.StreamConfig.from_config(T_CFG), device="cpu")
    x = torch.zeros(4000)
    with pytest.raises(ValueError, match="front"):
        tst.stream_process(T_CFG, st, x, FS, front="fft")
    with pytest.raises(ValueError, match="impl"):
        tst.stream_process(T_CFG, st, x, FS, impl="magic")
    for impl in ("jump", "hop"):
        st2, ev, dg = tst.stream_process(T_CFG, st, x, FS, impl=impl)
        assert int(st2.block_idx) == 5 and int(ev.count) == 0
        assert ("thr_degraded" in dg) == (impl == "hop")
    with pytest.raises(ValueError, match=r"\(C, n_blocks\)"):
        tst.stream_scan_fused_batch(T_SCFG, st, x[:10], x[:10])


def test_resolve_stream_auto():
    assert tst.resolve_stream_auto("auto", "auto", device="cpu") == ("welch", "scan")
    assert tst.resolve_stream_auto("auto", "auto", device="cuda") == ("bins", "fused")
    assert tst.resolve_stream_auto("auto", "auto", device=torch.device("cuda", 0)) == ("bins", "fused")
    assert tst.resolve_stream_auto("welch", "auto", device="cuda") == ("welch", "fused")
    assert tst.resolve_stream_auto("bins", "scan", device="cpu") == ("bins", "scan")
    # the reference's third parameter, the batch width, is accepted and ignored
    assert tst.resolve_stream_auto("auto", "auto", 64, device="cpu") == ("welch", "scan")
    assert tst.resolve_stream_auto("auto", "auto", n_channels=8, device="cuda") == ("bins", "fused")


@pytest.mark.parametrize("name", ["stream_init", "stream_init_batch", "resolve_stream_auto"])
def test_signatures_extend_the_reference(name):
    """The reference's parameters in its order, then ``device``."""
    t = list(inspect.signature(getattr(tst, name)).parameters)
    j = list(inspect.signature(getattr(jst, name)).parameters)
    assert t == j + ["device"], (t, j)


def test_positional_dtype_as_in_jax():
    """``stream_init(cfg, dtype)`` / ``stream_init_batch(cfg, n, dtype)``:
    a positional dtype reaches the float leaves, as in the JAX package
    (whose float64 is float32 unless x64 is on in this process)."""
    pairs = ((tst.stream_init(T_SCFG, torch.float64, device="cpu"), jst.stream_init(J_SCFG, jnp.float64)),
             (tst.stream_init_batch(T_SCFG, 2, torch.float64, device="cpu"),
              jst.stream_init_batch(J_SCFG, 2, jnp.float64)))
    for t, j in pairs:
        for f in tst.StreamState._fields:
            a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            assert a.dtype == (np.float64 if b.dtype.kind == "f" else b.dtype), f
            assert a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert pairs[0][0].tr_sum.dtype == torch.float64 and pairs[0][0].state.dtype == torch.int32


@pytest.mark.parametrize("sec,bs", [(12.0, 0.2), (0.5, 0.2), (-1.0, 0.2), (0.6, 0.2), (1.0, 0.25)])
def test_block_counts_match_jax(sec, bs):
    assert tst.lock_tail_blocks(sec, bs) == jst.lock_tail_blocks(sec, bs)
    assert tst.min_duration_blocks(sec, bs) == jst.min_duration_blocks(sec, bs)


def test_config_and_init_match_jax():
    assert tst.StreamConfig.from_config(T_CFG) == tuple(jst.StreamConfig.from_config(J_CFG))
    for prop in ("signal_band", "noise_band_1", "noise_band_2"):
        assert getattr(T_CFG, prop) == getattr(J_CFG, prop)
    for t, j in ((tst.stream_init(T_SCFG, device="cpu"), jst.stream_init(J_SCFG)),
                 (tst.stream_init_batch(T_SCFG, 3, device="cpu"), jst.stream_init_batch(J_SCFG, 3))):
        for f in tst.StreamState._fields:
            a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_sanitize_levels_matches_jax():
    x = np.array([0.0, -3.5, np.inf, -np.inf, np.nan, 2e15, -2e15, 1e14], np.float32)
    np.testing.assert_array_equal(tst._sanitize_levels(torch.from_numpy(x)).numpy(),
                                  np.asarray(jst._sanitize_levels(jnp.asarray(x))))


def test_cuda_state_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tst.stream_init(T_SCFG)


def replay_ring(ring, i0, on, w, k_std):
    """numpy float32 oracle of the prologue: the live ring replayed block by
    block, each window summed left to right over slots 0 … w−1 (unwritten
    slots add 0), then the block written into slot i mod w.  The square
    root is torch's, as the twin's on the CPU (within an ulp of the
    correctly rounded root there; on the card both sides round it
    exactly).  Returns (base thresholds (C, n), the ring after the chunk)."""
    f32 = np.float32
    r, on = ring.copy(), on.astype(f32)
    C, n = on.shape
    bt = np.empty((C, n), f32)
    rows = np.arange(C)
    for t in range(n):
        i = i0 + t
        cnt = np.minimum(i, w)
        s = np.zeros(C, f32)
        s2 = np.zeros(C, f32)
        for j in range(w):
            s = (s + np.where(j < cnt, r[:, j], f32(0))).astype(f32)
            s2 = (s2 + np.where(j < cnt, (r[:, j] * r[:, j]).astype(f32), f32(0))).astype(f32)
        cnt_f = np.maximum(cnt, 1).astype(f32)
        m, m2 = (s / cnt_f).astype(f32), (s2 / cnt_f).astype(f32)
        var = np.maximum((m2 - (m * m).astype(f32)).astype(f32), f32(0))
        std = torch.sqrt(torch.from_numpy(var)).numpy()
        bt[:, t] = np.where(cnt > 0, (m + (f32(k_std) * std).astype(f32)).astype(f32), f32(np.nan))
        r[rows, i % w] = on[:, t]
    return bt, r


def ring_case(case, C=3, n=150, w=40):
    rng = np.random.default_rng(31)
    on = (rng.standard_normal((C, n)) * 2.0 + 1.0).astype(np.float32)
    ring = (rng.standard_normal((C, w)) * 3.0).astype(np.float32)  # unwritten slots hold junk
    i0 = {"fresh": 0, "i0_below_w": 13, "carried": 1234}[case] + np.array([0, 1, 7])[:C]
    if case == "fresh":
        i0[:] = 0
    return ring, i0.astype(np.int32), on


@pytest.mark.parametrize("case", ["fresh", "i0_below_w", "carried"])
def test_ring_base_thresholds_slot_order_oracle(case):
    ring, i0, on = ring_case(case)
    w = ring.shape[1]
    bt, ext = tsk.ring_base_thresholds(torch.from_numpy(ring), torch.from_numpy(i0),
                                       torch.from_numpy(on), w, 4.0)
    want_bt, want_ring = replay_ring(ring, i0, on, w, 4.0)
    assert_bits_equal((bt, tsk.final_ring(ext, torch.from_numpy(i0),
                                          torch.from_numpy(i0 + on.shape[1]), w)),
                      (torch.from_numpy(want_bt), torch.from_numpy(want_ring)))
    assert bool(torch.isnan(bt[:, 0]).all()) == (case == "fresh")


def composed_solve(scfg, state, on, pm):
    """The solve as separate pieces: the prologue, the block machine on
    time-major series, a Python loop that files each emit into its slot,
    and the ring replayed block by block."""
    kw = tst.solve_params(scfg)
    cap, w = kw.pop("cap"), scfg.avg_win
    bt, _ = tsk.ring_base_thresholds(state.ring, state.block_idx, on, w, kw.pop("k_std"))
    carry_f = torch.stack([state.locked_threshold, state.track_start_sec, state.tr_sum,
                           state.tr_sumsq, state.tr_min, state.tr_max, state.init_sum,
                           state.psd_db_mean_from_init])
    carry_i = torch.stack([state.state, state.locked_until_block, state.track_start_block,
                           state.tr_count, state.init_count, state.block_idx])
    ys, cf, ci = tsk.stream_machine_plain(on.t().contiguous(), pm.t().contiguous(),
                                          bt.t().contiguous(), carry_f, carry_i, **kw)
    emit, fields = ys[1].t().numpy(), [y.t().numpy() for y in ys[2:]]
    C = on.shape[0]
    ev = np.zeros((7, C, cap), np.float32)
    count = np.zeros(C, np.int32)
    for c in range(C):
        for t in np.flatnonzero(emit[c]):
            if count[c] < cap:
                ev[:, c, count[c]] = [f[c, t] for f in fields]
            count[c] += 1
    _, ring = replay_ring(state.ring.numpy(), state.block_idx.numpy(), on.numpy(), w, scfg.k_std)
    st = tst.StreamState(
        state=ci[0], block_idx=ci[5], ring=torch.from_numpy(ring), locked_threshold=cf[0],
        locked_until_block=ci[1], track_start_sec=cf[1], track_start_block=ci[2],
        tr_count=ci[3], tr_sum=cf[2], tr_sumsq=cf[3], tr_min=cf[4], tr_max=cf[5],
        init_sum=cf[6], init_count=ci[4], psd_db_mean_from_init=cf[7])
    events = tst.StreamEvents(*(torch.from_numpy(e) for e in ev), count=torch.from_numpy(count),
                              overflow=torch.from_numpy(count > cap))
    return st, events, ys[0].t()


@pytest.mark.parametrize("case", ["fresh", "mid_track", "overflow"])
def test_solve_plain_equals_composed_solve(case):
    scfg = T_SCFG._replace(cap=2 if case == "overflow" else 16)
    on, pm = series(3, 520, 17, ((150, 170, 8.0), (260, 300, 9.0), (420, 460, 7.0)))
    on, pm = torch.from_numpy(on), torch.from_numpy(pm)
    state = tst.stream_init_batch(scfg, 3, device="cpu")
    if case == "mid_track":
        state = tst.stream_scan(scfg, state, on[:, :280], pm[:, :280])[0]
        assert bool((state.state == tst.TRACK).all())
        on, pm = on[:, 280:].contiguous(), pm[:, 280:].contiguous()
    st, ev, thr = tsk.stream_solve_plain(on, pm, tuple(state), **tst.solve_params(scfg))
    assert_bits_equal((tst.StreamState(*st), tst.StreamEvents(*ev), thr),
                      composed_solve(scfg, state, on, pm))
    assert int(ev[7].min()) >= (2 if case == "mid_track" else 3)
    assert bool(ev[8].all()) == (case == "overflow")


def test_stream_solve_dispatch_by_device():
    """A CPU tensor goes to the twin and never to the kernel; other devices
    raise."""
    on, pm = (torch.from_numpy(a) for a in series(2, 20, 3))
    state = tuple(tst.stream_init_batch(T_SCFG, 2, device="cpu"))
    kw = tst.solve_params(T_SCFG)
    assert_bits_equal(tsk.stream_solve(on, pm, state, **kw), tsk.stream_solve_plain(on, pm, state, **kw))
    with pytest.raises(ValueError, match="CUDA"):
        tsk._launch(on, pm, state, **kw)
    with pytest.raises(ValueError, match="not supported"):
        tsk.stream_solve(on.to("meta"), pm.to("meta"), state, **kw)
