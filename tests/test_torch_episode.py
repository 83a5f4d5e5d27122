"""The episode-jump streaming solvers of the PyTorch port and the last
numerics of ``ops/``, ``models/`` and ``io/``, on the CPU.

Port against port: ``stream_scan_jump`` and ``stream_scan_jump_batch``
against the port's ``stream_scan`` on the fixtures of
``tests/test_streaming_jump.py`` and ``tests/test_streaming_hop.py``, with
their split of fields: thresholds, count, overflow, event start / stop
times, the ring and the ``EXACT_STATE`` leaves bit for bit; the events'
dB statistics and durations within ``1e-5`` (jump) and ``1e-4`` (hop);
the ``CLOSE_STATE`` sums within ``1e-5``.  A batch equals its channels run
one by one, bit for bit.

Port against JAX (the JAX ``while_loop``s compile for seconds on the CPU,
so a few fixtures of one shape each, computed once per module): the
port's exact fields of ``tests/test_torch_streaming.py`` bit for bit and
``thr_degraded`` equal; thresholds and the close fields within
``CROSS_TOL`` (the base thresholds sum their windows in another order than
XLA, and the span statistics are sums of another order).

The remainders against JAX: ``welch_band_sums_db`` (both branches) within
``WELCH_DB_ATOL``, ``adaptive_thresholds_fast`` (above-mask exact,
thresholds within ``FAST_RTOL`` / ``FAST_ATOL``: float32 prefix sums of
another order) and ``stream_wav_blocks``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_streaming_jump as jj
from meteor_scatter_tpu.config import DetectionConfig as JDetectionConfig
from meteor_scatter_tpu.io import wavio as jwav
from meteor_scatter_tpu.models import adaptive as jad
from meteor_scatter_tpu.models import streaming as jst
from meteor_scatter_tpu.ops import welch as jwelch
from meteor_scatter_tpu_torch import io as tio
from meteor_scatter_tpu_torch.config import DetectionConfig
from meteor_scatter_tpu_torch.models import adaptive as tad
from meteor_scatter_tpu_torch.models import streaming as tst
from meteor_scatter_tpu_torch.ops import welch as twelch

from test_torch_streaming import CLOSE_EV, CLOSE_STATE, EXACT_EV, EXACT_STATE, as_numpy

TOL = {"jump": 1e-5, "hop": 1e-4}  # the JAX tests' event tolerances
STATE_TOL = 1e-5
CROSS_TOL = 1e-4
WELCH_DB_ATOL = 1e-4
FAST_RTOL, FAST_ATOL = 1e-5, 1e-4
LIVE = dict(signal_freq=1000.0, detection_db_over_noise_mean_min=1.0, detection_dur_min_sec=0.5)
FS = 4000

BURSTY = ((100, 110, 8.0), (120, 121, 9.0), (160, 170, 8.0), (400, 420, 6.0), (700, 704, 7.0))
# name -> (config changes, n, seed, bursts); hop tracks 128 blocks at a time
FIXTURES = {
    "noise_only": ({}, 900, 0, ()),
    "bursty": ({}, 900, 1, BURSTY),
    "multi_hop": ({}, 900, 2, ((100, 400, 8.0),)),  # a 300-block track: three hops
    "track_survives_chunk_end": ({}, 300, 2, ((280, 300, 8.0),)),
    "cap_overflow": ({"cap": 2}, 900, 3, tuple((b, b + 6, 8.0) for b in range(60, 800, 90))),
}
# the JAX suites run the multi-hop fixture with hop only
CASES = [(s, f) for s in ("jump", "hop") for f in FIXTURES if (s, f) != ("jump", "multi_hop")]


def series(n, seed, bursts=(), noise=0.3):
    on, pm = jj.make_series(n, seed, bursts, noise=noise)
    return torch.from_numpy(np.array(on)), torch.from_numpy(np.array(pm))


def tcfg(**kw):
    return tst.StreamConfig(*jj.default_cfg(**kw))


def solver(name, track_hop=128):
    if name == "jump":
        return tst.stream_scan_jump
    return functools.partial(tst.stream_scan_jump_batch, track_hop=track_hop)


def bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def assert_bits_equal(a, b, name):
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert torch.equal(bits(a), bits(b)), name


def assert_equals_scan(scfg, want, got, tol):
    """``got`` (an episode solver) against ``want`` (the port's scan)."""
    (st_s, ev_s, thr_s), (st_g, ev_g, thr_g) = want, got[:3]
    assert_bits_equal(thr_g, thr_s, "thresholds")
    for f in ("count", "overflow"):
        assert_bits_equal(getattr(ev_g, f), getattr(ev_s, f), f)
    c = min(int(ev_s.count.max()), scfg.cap)
    for f in jj.EXACT_EV:
        assert_bits_equal(getattr(ev_g, f)[..., :c], getattr(ev_s, f)[..., :c], f)
    for f in jj.CLOSE_EV:
        a, b = getattr(ev_g, f), getattr(ev_s, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a[..., :c].numpy(), b[..., :c].numpy(), rtol=tol, atol=tol,
                                   err_msg=f)
    for f in jj.EXACT_STATE + ("ring",):
        assert_bits_equal(getattr(st_g, f), getattr(st_s, f), f"state.{f}")
    for f in jj.CLOSE_STATE:
        a, b = getattr(st_g, f), getattr(st_s, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STATE_TOL, atol=STATE_TOL,
                                   err_msg=f"state.{f}")


@functools.lru_cache(maxsize=None)
def fixture_scan(name):
    """(config, on, pm, the port's scan from a fresh state) of a fixture."""
    changes, n, seed, bursts = FIXTURES[name]
    scfg = tcfg(**changes)
    on, pm = series(n, seed, bursts)
    return scfg, on, pm, tst.stream_scan(scfg, tst.stream_init(scfg, device="cpu"), on, pm)


@pytest.mark.parametrize("solver_name,fixture", CASES)
def test_episode_solver_equals_scan(solver_name, fixture):
    scfg, on, pm, want = fixture_scan(fixture)
    got = solver(solver_name)(scfg, tst.stream_init(scfg, device="cpu"), on, pm)
    assert_equals_scan(scfg, want, got, TOL[solver_name])
    count, st = int(want[1].count), int(want[0].state)
    if fixture == "noise_only":
        assert count == 0
    elif fixture == "bursty":
        assert count >= 3, "fixture must produce accepted events"
    elif fixture == "track_survives_chunk_end":
        assert st == tst.TRACK
    elif fixture == "cap_overflow":
        assert count > 2 and bool(want[1].overflow)


@pytest.mark.parametrize("solver_name", ["jump", "hop"])
def test_episode_solver_chunked_carry(solver_name):
    """30-block chunks cut inside INIT, inside events and inside lock
    windows; every chunk equals the scan's from the same carried state."""
    scfg = tcfg()
    on, pm = series(910, 4, ((100, 110, 8.0), (400, 412, 6.0), (640, 650, 7.0)))
    st_s = st_g = tst.stream_init(scfg, device="cpu")
    total = 0
    for i in range(0, 900, 30):
        want = tst.stream_scan(scfg, st_s, on[i : i + 30], pm[i : i + 30])
        got = solver(solver_name)(scfg, st_g, on[i : i + 30], pm[i : i + 30])
        assert_equals_scan(scfg, want, got, TOL[solver_name])
        (st_s, ev, _), st_g = want, got[0]
        total += int(ev.count)
    assert total >= 3


@pytest.mark.parametrize("solver_name", ["jump", "hop"])
@pytest.mark.parametrize("seed", range(5, 11))
def test_episode_solver_fuzz(solver_name, seed):
    """High-variance series with many borderline crossings, random settings
    (the JAX suites' fuzz)."""
    rng = np.random.default_rng(seed)
    scfg = tcfg(
        avg_win=int(rng.integers(8, 60)),
        after_wait_sec=float(rng.uniform(0.0, 6.0)),
        k_std=float(rng.uniform(1.0, 3.0)),
        min_mean_db=float(rng.uniform(0.0, 1.0)),
        min_dur_sec=float(rng.uniform(0.0, 1.0)),
        cap=8,
    )
    n = int(rng.integers(200, 700))
    on, pm = series(n, seed + 100, noise=1.0)
    hop = int(rng.choice([8, 32, 128]))
    want = tst.stream_scan(scfg, tst.stream_init(scfg, device="cpu"), on, pm)
    got = solver(solver_name, hop)(scfg, tst.stream_init(scfg, device="cpu"), on, pm)
    assert_equals_scan(scfg, want, got, TOL[solver_name])


@pytest.mark.parametrize("solver_name", ["jump", "hop"])
def test_wide_batch_equals_per_channel(solver_name):
    """One batched call over C channels equals C one-channel calls bit for
    bit, and each channel equals the scan."""
    scfg = tcfg()
    C, n = 6, 700
    pairs = [series(n, 20 + c, ((120 + 40 * c, 160 + 40 * c, 6.0),) if c % 2 == 0 else ())
             for c in range(C)]
    on, pm = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    fn = solver(solver_name)
    st_b, ev_b, thr_b = fn(scfg, tst.stream_init_batch(scfg, C, device="cpu"), on, pm)
    assert int(ev_b.count.sum()) >= 3
    for c in range(C):
        st_1, ev_1, thr_1 = fn(scfg, tst.stream_init(scfg, device="cpu"), on[c], pm[c])
        for name, a, b in ([("thresholds", thr_b[c], thr_1)]
                           + [(f, x[c], y) for f, x, y in zip(ev_b._fields, ev_b, ev_1)]
                           + [(f, x[c], y) for f, x, y in zip(st_b._fields, st_b, st_1)]):
            assert_bits_equal(a, b, f"{name} ch{c}")
        want = tst.stream_scan(scfg, tst.stream_init(scfg, device="cpu"), on[c], pm[c])
        assert_equals_scan(scfg, want, (st_1, ev_1, thr_1), TOL[solver_name])


def pathological():
    """A 1-block spike every 3 blocks: every spike is a lock episode (none
    accepted: min_dur 2 s), far past the 4·cap + 8 = 16 records."""
    scfg = tcfg(cap=2, min_dur_sec=2.0)
    return scfg, *series(600, 50, tuple((b, b + 1, 9.0) for b in range(60, 580, 3)))


def test_thr_degraded_flag():
    scfg, on, pm = pathological()
    st, ev, thr, diag = tst.stream_scan_jump_batch(scfg, tst.stream_init(scfg, device="cpu"), on, pm,
                                                   with_diag=True)
    assert diag["thr_degraded"].dtype == torch.bool and bool(diag["thr_degraded"])
    # events and state stay exact against the scan (only thresholds degrade)
    st_s, ev_s, _ = tst.stream_scan(scfg, tst.stream_init(scfg, device="cpu"), on, pm)
    assert int(ev.count) == int(ev_s.count)
    for f in jj.EXACT_EV:
        assert_bits_equal(getattr(ev, f), getattr(ev_s, f), f)
    for f in jj.EXACT_STATE:
        assert_bits_equal(getattr(st, f), getattr(st_s, f), f)

    scfg, on, pm, _ = fixture_scan("bursty")
    out4 = tst.stream_scan_jump_batch(scfg, tst.stream_init(scfg, device="cpu"), on, pm, with_diag=True)
    assert not bool(out4[3]["thr_degraded"])
    out3 = tst.stream_scan_jump_batch(scfg, tst.stream_init(scfg, device="cpu"), on, pm)
    assert len(out3) == 3
    assert_bits_equal(out3[2], out4[2], "thresholds")


@pytest.mark.parametrize("impl", ["jump", "hop"])
def test_stream_process_diags_schema(impl):
    """``stream_process`` routes to the solver; hop adds ``thr_degraded``;
    an empty chunk keeps the schema of a full one, and both are JAX's
    (JAX's empty-chunk path, which runs no solver)."""
    cfg, jcfg = DetectionConfig(**LIVE), JDetectionConfig(**LIVE)
    x = (np.random.default_rng(9).standard_normal(FS * 20) * 0.05).astype(np.float32)
    st0 = tst.stream_init(tst.StreamConfig.from_config(cfg), device="cpu")
    st, ev, full = tst.stream_process(cfg, st0, torch.from_numpy(x), FS, front="bins", impl=impl)
    want = tst.stream_process(cfg, st0, torch.from_numpy(x), FS, front="bins", impl="scan")
    assert_bits_equal(full["threshold"], want[2]["threshold"], "thresholds")
    assert int(ev.count) == int(want[1].count) and int(st.block_idx) == 100
    _, ev0, empty = tst.stream_process(cfg, st, torch.from_numpy(x[:10]), FS, front="bins",
                                       impl=impl)
    _, _, j_empty = jst.stream_process(jcfg, jst.stream_init(jst.StreamConfig.from_config(jcfg)),
                                       jnp.asarray(x[:10]), FS, front="bins", impl=impl)
    assert set(full) == set(empty) == set(j_empty)
    assert ("thr_degraded" in full) == (impl == "hop")
    if impl == "hop":
        assert not bool(full["thr_degraded"]) and empty["thr_degraded"].shape == ()
    assert int(ev0.count) == 0 and tuple(empty["over_noise"].shape) == (0,)


# --- the port against JAX ------------------------------------------------------


def jax_solver(name):
    if name == "jump":
        return jst.stream_scan_jump
    return functools.partial(jst.stream_scan_jump_batch, with_diag=True)


@functools.lru_cache(maxsize=None)
def jax_run(name, fixture):
    """JAX's solver on a fixture from a fresh state, as numpy."""
    scfg, on, pm = (fixture_scan(fixture)[:3] if fixture in FIXTURES else pathological())
    out = jax_solver(name)(jst.StreamConfig(*scfg), jst.stream_init(jst.StreamConfig(*scfg)),
                           jnp.asarray(on.numpy()), jnp.asarray(pm.numpy()))
    return (as_numpy(out[0]), as_numpy(out[1]), np.asarray(out[2]),
            {k: np.asarray(v) for k, v in (out[3] if len(out) > 3 else {}).items()})


def assert_matches_jax(t_out, j_out):
    """The port's split of ``tests/test_torch_streaming.py``: exact fields
    bit for bit, thresholds and close fields within ``CROSS_TOL``."""
    st_t, ev_t, thr_t = t_out[:3]
    st_j, ev_j, thr_j, diag_j = j_out
    np.testing.assert_allclose(thr_t.numpy(), thr_j, rtol=CROSS_TOL, atol=CROSS_TOL,
                               equal_nan=True)
    for f in ("count", "overflow"):
        np.testing.assert_array_equal(getattr(ev_t, f).numpy(), getattr(ev_j, f), err_msg=f)
    c = min(int(ev_j.count), ev_t.time_start.shape[-1])
    for f in EXACT_EV:
        np.testing.assert_array_equal(getattr(ev_t, f).numpy()[:c], getattr(ev_j, f)[:c], f)
    for f in CLOSE_EV:
        np.testing.assert_allclose(getattr(ev_t, f).numpy()[:c], getattr(ev_j, f)[:c],
                                   rtol=CROSS_TOL, atol=CROSS_TOL, err_msg=f)
    for f in EXACT_STATE:
        np.testing.assert_array_equal(getattr(st_t, f).numpy(), getattr(st_j, f), err_msg=f)
    for f in CLOSE_STATE:
        np.testing.assert_allclose(getattr(st_t, f).numpy(), getattr(st_j, f), rtol=CROSS_TOL,
                                   atol=CROSS_TOL, err_msg=f)
    if "thr_degraded" in diag_j:
        assert bool(t_out[3]["thr_degraded"]) == bool(diag_j["thr_degraded"])


@pytest.mark.parametrize("name,fixture", [
    ("jump", "noise_only"), ("jump", "bursty"), ("jump", "multi_hop"),
    ("hop", "noise_only"), ("hop", "bursty"), ("hop", "pathological"),
])
def test_episode_solver_matches_jax(name, fixture):
    if fixture in FIXTURES:
        scfg, on, pm, _ = fixture_scan(fixture)
    else:
        scfg, on, pm = pathological()
    t_fn = tst.stream_scan_jump if name == "jump" else functools.partial(
        tst.stream_scan_jump_batch, with_diag=True)
    got = t_fn(scfg, tst.stream_init(scfg, device="cpu"), on, pm)
    want = jax_run(name, fixture)
    assert_matches_jax(got, want)
    if fixture == "bursty":
        assert int(got[1].count) >= 3
    if fixture == "pathological":
        assert bool(got[3]["thr_degraded"])


@pytest.mark.parametrize("name", ["jump", "hop"])
def test_carry_from_jax_mid_track_state(name):
    """A stream begun in JAX and cut inside a track continues in the port
    through ``state_from_numpy`` as it does in JAX."""
    scfg = tcfg()
    on, pm = series(900, 1, ((100, 110, 8.0), (440, 470, 8.0), (700, 704, 7.0)))
    jscfg = jst.StreamConfig(*scfg)
    fn = jax_solver(name)
    first = fn(jscfg, jst.stream_init(jscfg), jnp.asarray(on[:450].numpy()),
               jnp.asarray(pm[:450].numpy()))
    assert int(first[0].state) == tst.TRACK
    rest = fn(jscfg, first[0], jnp.asarray(on[450:].numpy()), jnp.asarray(pm[450:].numpy()))
    want = (as_numpy(rest[0]), as_numpy(rest[1]), np.asarray(rest[2]),
            {k: np.asarray(v) for k, v in (rest[3] if len(rest) > 3 else {}).items()})
    t_fn = tst.stream_scan_jump if name == "jump" else functools.partial(
        tst.stream_scan_jump_batch, with_diag=True)
    got = t_fn(scfg, tst.state_from_numpy(as_numpy(first[0]), "cpu"), on[450:], pm[450:])
    assert int(got[1].count) >= 2
    assert_matches_jax(got, want)


# --- the remainders of ops/, models/ and io/ -------------------------------------


@pytest.mark.parametrize("noverlap", [128, 100])  # hop 128 divides 256 (group sums); 156 does not
def test_welch_band_sums_db_matches_jax(noverlap):
    x = (np.random.default_rng(0).standard_normal((3, 4000))).astype(np.float32)
    bands = ((993.0, 1013.0), (690.0, 710.0))
    P_j, sl_j = jwelch.welch_band_matrix(6000, 1024, 256, bands)
    P_t, sl_t = twelch.welch_band_matrix(6000, 1024, 256, bands)
    np.testing.assert_array_equal(P_t, P_j)
    assert sl_t == sl_j
    got = twelch.welch_band_sums_db(torch.from_numpy(x), 256, torch.from_numpy(P_t), sl_t,
                                    noverlap=noverlap)
    want = jwelch.welch_band_sums_db(jnp.asarray(x), 256, jnp.asarray(P_j), sl_j,
                                     noverlap=noverlap)
    psd = twelch.welch_psd(torch.from_numpy(x), 6000, 1024, nperseg=256, noverlap=noverlap)
    for band, g, w in zip(bands, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (3,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=WELCH_DB_ATOL)
        direct = twelch.band_sum_db(psd, twelch.welch_freqs(6000, 1024), band)
        np.testing.assert_allclose(g.numpy(), direct.numpy(), rtol=0, atol=WELCH_DB_ATOL)


def delta_series(n, seed):
    """3 dB noise with 5-block 30 dB bursts (float32)."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal(n) * 3.0).astype(np.float32)
    for s in rng.integers(10, n - 10, size=max(n // 235, 1)):
        d[s : s + 5] += 30.0
    return d


@pytest.mark.parametrize("fixed_blocks", [50, 0])  # 0: block 0 takes the empty-window 0
def test_adaptive_thresholds_fast_matches_jax(fixed_blocks):
    d = delta_series(4000, 13)
    kw = dict(threshold_std_factor=4.0, window_blocks=600, freeze_blocks_before=15,
              freeze_blocks_after=100, fixed_threshold_blocks=fixed_blocks)
    thr, above = tad.adaptive_thresholds_fast(torch.from_numpy(d), **kw)
    thr_j, above_j = jad.adaptive_thresholds_fast(jnp.asarray(d), **kw)
    assert thr.dtype == torch.float32 and above.dtype == torch.bool and thr.shape == (4000,)
    np.testing.assert_array_equal(above.numpy(), np.asarray(above_j))
    np.testing.assert_allclose(thr.numpy(), np.asarray(thr_j), rtol=FAST_RTOL, atol=FAST_ATOL)
    # the port's own sequential scan: the same mask
    _, above_s, _ = tad.adaptive_thresholds(torch.from_numpy(d), **kw)
    assert torch.equal(above, above_s) and int(above.sum()) >= 10
    assert bool(above[0]) == (fixed_blocks == 0)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_stream_wav_blocks_matches_jax(tmp_path, dtype):
    x = (np.arange(4000 * 2 + 123) % 3000).astype(dtype)
    path = str(tmp_path / "b.wav")
    tio.write_wav(path, 4000, x)
    got = list(tio.stream_wav_blocks(path, 800))
    want = list(jwav.stream_wav_blocks(path, 800))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (800,)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), x[:8000])


def test_io_package_exports_the_reference_names():
    import meteor_scatter_tpu.io as jio

    names = [k for k in vars(jio) if not k.startswith("_") and callable(getattr(jio, k))]
    assert "stream_wav_blocks" in names and len(names) >= 10
    for k in names:
        assert callable(getattr(tio, k, None)), k
