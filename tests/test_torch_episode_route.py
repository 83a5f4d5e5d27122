"""The episode-jump solvers' K3 route, on the CPU.

On a GPU ``stream_scan_jump`` and ``stream_scan_jump_batch`` solve through
``models/streaming.py::_episode_on_k3``: one launch of K3, which is
bit-exact to the scan that both solvers' contracts are stated against.
Hop's ``thr_degraded`` is False there, because a chunk with
``n_blocks + 2 ≤ 4·cap + 8`` cannot drop a lock-episode record; a longer
chunk runs the lockstep hop on the same device.  Here the helper runs on
CPU tensors, so K3's twin takes the kernel's place:

* the route against the port's scan: every output bit for bit;
* the route against the JAX package's ``stream_scan_jump`` /
  ``stream_scan_jump_batch`` on the fixtures of
  ``tests/test_torch_episode.py``: counts, overflow, start / stop times,
  the integer state and ``thr_degraded`` exactly; the events' dB
  statistics within ``TOL`` (jump 1e-5, hop 1e-4; the 300-block track of
  ``multi_hop``, which the JAX suites run with hop only, 1e-4); thresholds and the
  state's sums within ``CROSS_TOL`` (the port sums its windows in another
  order than XLA, as its lockstep solvers and scan do);
* ``thr_degraded`` and the thresholds against the lockstep hop on both
  sides of the bound, and a fuzz showing that the lockstep hop never drops
  a record inside it.

The public functions keep the lockstep solvers on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meteor_scatter_tpu.models import streaming as jst
from meteor_scatter_tpu_torch.models import streaming as tst

from test_torch_episode import (
    FIXTURES,
    STATE_TOL,
    TOL,
    assert_bits_equal,
    pathological,
    series,
    tcfg,
)
from test_torch_streaming import CLOSE_EV, CLOSE_STATE, EXACT_EV, EXACT_STATE, as_numpy

CROSS_TOL = 1e-4
LIVE_CAP = 1024  # DetectionConfig.max_events: 4 104 lock-episode records a chunk


def route(scfg, on, pm, hop, state=None, track_hop=128):
    st0 = state if state is not None else (
        tst.stream_init(scfg, device="cpu") if on.dim() == 1
        else tst.stream_init_batch(scfg, on.shape[0], device="cpu"))
    return tst._episode_on_k3(scfg, st0, on, pm, hop=hop, track_hop=track_hop)


def lockstep_hop(scfg, on, pm, state=None, track_hop=128):
    st0 = state if state is not None else tst.stream_init(scfg, device="cpu")
    return tst.stream_scan_jump_batch(scfg, st0, on, pm, track_hop=track_hop, with_diag=True)


def assert_all_bits_equal(got, want):
    """(state, events, thresholds) of two solves, every leaf bit for bit."""
    assert_bits_equal(got[2], want[2], "thresholds")
    for f in tst.StreamEvents._fields:
        assert_bits_equal(getattr(got[1], f), getattr(want[1], f), f)
    for f in tst.StreamState._fields:
        assert_bits_equal(getattr(got[0], f), getattr(want[0], f), f"state.{f}")


def fixture(name, cap=None):
    """(config, on, pm) of a fixture of ``tests/test_torch_episode.py``,
    its event capacity replaced by ``cap`` where given."""
    changes, n, seed, bursts = FIXTURES[name]
    changes = dict(changes, cap=cap) if cap is not None else changes
    return (tcfg(**changes), *series(n, seed, bursts))


# the hop cases run at the live capacity, inside the bound; the event
# buffer fixture keeps its capacity of 2 for jump only (hop runs the
# lockstep there, see test_route_against_lockstep_hop_both_sides)
SCAN_CASES = ([(False, f) for f in FIXTURES]
              + [(True, f) for f in FIXTURES if f != "cap_overflow"])


@pytest.mark.parametrize("hop,name", SCAN_CASES)
def test_route_equals_scan(hop, name):
    scfg, on, pm = fixture(name, None if not hop else LIVE_CAP)
    assert hop is False or tst._hop_records_fit(scfg, on.shape[-1])
    tst.iterations = 0
    got = route(scfg, on, pm, hop)
    assert tst.iterations == 0  # no lockstep iteration: K3's solve alone
    want = tst.stream_scan(scfg, tst.stream_init(scfg, device="cpu"), on, pm)
    assert_all_bits_equal(got, want)
    assert len(got) == (4 if hop else 3)
    if hop:
        assert got[3]["thr_degraded"].dtype == torch.bool and got[3]["thr_degraded"].shape == ()
        assert not bool(got[3]["thr_degraded"])
    if name == "cap_overflow":
        assert bool(want[1].overflow) and int(want[1].count) > scfg.cap


@pytest.mark.parametrize("hop", [False, True])
def test_route_batched_and_carried_equals_scan(hop):
    """Three channels in one call, then 30-block chunks of a stream carried
    through INIT, tracks and lock windows: each call equals the scan's on
    the same state, bit for bit, with a per-channel ``thr_degraded``."""
    scfg = tcfg(cap=LIVE_CAP)
    pairs = [fixture(f)[1:] for f in ("noise_only", "bursty", "multi_hop")]
    on, pm = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    got = route(scfg, on, pm, hop)
    st_b = tst.stream_init_batch(scfg, 3, device="cpu")
    assert_all_bits_equal(got, tst.stream_scan(scfg, st_b, on, pm))
    if hop:
        assert got[3]["thr_degraded"].shape == (3,) and not bool(got[3]["thr_degraded"].any())
    assert int(got[1].count.sum()) >= 3

    on1, pm1 = series(910, 4, ((100, 110, 8.0), (400, 412, 6.0), (640, 650, 7.0)))
    st_r = st_s = tst.stream_init(scfg, device="cpu")
    for i in range(0, 900, 30):
        want = tst.stream_scan(scfg, st_s, on1[i : i + 30], pm1[i : i + 30])
        got = route(scfg, on1[i : i + 30], pm1[i : i + 30], hop, state=st_r)
        assert_all_bits_equal(got, want)
        st_s, st_r = want[0], got[0]


# --- against the JAX package ---------------------------------------------------


def jax_fixture(name, cap):
    if name == "pathological":
        return pathological()
    return fixture(name, cap)


@functools.lru_cache(maxsize=None)
def jax_run(solver, name, cap):
    scfg, on, pm = jax_fixture(name, cap)
    jscfg = jst.StreamConfig(*scfg)
    fn = (jst.stream_scan_jump if solver == "jump"
          else functools.partial(jst.stream_scan_jump_batch, with_diag=True))
    out = fn(jscfg, jst.stream_init(jscfg), jnp.asarray(on.numpy()), jnp.asarray(pm.numpy()))
    diag = {k: np.asarray(v) for k, v in (out[3] if len(out) > 3 else {}).items()}
    return as_numpy(out[0]), as_numpy(out[1]), np.asarray(out[2]), diag


# (solver, fixture, capacity): jump and hop on the K3 side of the bound, hop
# also on the lockstep side (the fixtures' own capacity of 16, and the
# pathological series whose records overflow)
JAX_CASES = [
    ("jump", "noise_only", None), ("jump", "bursty", None), ("jump", "multi_hop", None),
    ("hop", "noise_only", LIVE_CAP), ("hop", "bursty", LIVE_CAP),
    ("hop", "bursty", None), ("hop", "pathological", None),
]


@pytest.mark.parametrize("solver,name,cap", JAX_CASES)
def test_route_matches_jax(solver, name, cap):
    scfg, on, pm = jax_fixture(name, cap)
    hop = solver == "hop"
    inside = tst._hop_records_fit(scfg, on.shape[-1])
    tst.iterations = 0
    got = route(scfg, on, pm, hop)
    assert (tst.iterations == 0) == (not hop or inside)
    st_j, ev_j, thr_j, diag_j = jax_run(solver, name, cap)
    st_t, ev_t, thr_t = got[:3]
    np.testing.assert_allclose(thr_t.numpy(), thr_j, rtol=CROSS_TOL, atol=CROSS_TOL,
                               equal_nan=True)
    for f in ("count", "overflow"):
        np.testing.assert_array_equal(getattr(ev_t, f).numpy(), getattr(ev_j, f), err_msg=f)
    c = min(int(ev_j.count), scfg.cap)
    for f in EXACT_EV:
        np.testing.assert_array_equal(getattr(ev_t, f).numpy()[:c], getattr(ev_j, f)[:c], f)
    # the JAX suites hold a 300-block track (multi_hop) at hop's tolerance only
    tol = TOL["hop" if name == "multi_hop" else solver]
    for f in CLOSE_EV:
        np.testing.assert_allclose(getattr(ev_t, f).numpy()[:c], getattr(ev_j, f)[:c],
                                   rtol=tol, atol=tol, err_msg=f)
    for f in EXACT_STATE:
        np.testing.assert_array_equal(getattr(st_t, f).numpy(), getattr(st_j, f), err_msg=f)
    for f in CLOSE_STATE:
        np.testing.assert_allclose(getattr(st_t, f).numpy(), getattr(st_j, f), rtol=CROSS_TOL,
                                   atol=CROSS_TOL, err_msg=f)
    if hop:
        assert bool(got[3]["thr_degraded"]) == bool(diag_j["thr_degraded"])
        assert bool(diag_j["thr_degraded"]) == (name == "pathological")
    if name == "bursty":
        assert int(ev_t.count) >= 3


# --- the bound n_blocks + 2 <= 4·cap + 8 ---------------------------------------


# (label, capacity, blocks): the pathological spikes (a lock episode every
# 3 blocks) and the event-buffer fixture on either side of the bound, and
# the bound's edge
BOUND_CASES = [
    ("pathological_outside", 2, 600),
    ("pathological_inside", 150, 600),
    ("edge_inside", 148, 598),
    ("edge_outside", 148, 599),
    ("cap_overflow_outside", 2, 900),
]


@pytest.mark.parametrize("label,cap,n", BOUND_CASES)
def test_route_against_lockstep_hop_both_sides(label, cap, n):
    if label.startswith("cap_overflow"):
        scfg, on, pm = fixture("cap_overflow")
    else:
        scfg, on, pm = pathological()
        scfg = scfg._replace(cap=cap)
    on, pm = on[:n], pm[:n]
    inside = tst._hop_records_fit(scfg, n)
    assert inside == label.endswith("_inside")
    tst.iterations = 0
    got = route(scfg, on, pm, hop=True)
    assert (tst.iterations == 0) == inside
    want = lockstep_hop(scfg, on, pm)
    assert bool(got[3]["thr_degraded"]) == bool(want[3]["thr_degraded"])
    assert_bits_equal(got[2], want[2], "thresholds")
    for f in ("count", "overflow") + EXACT_EV:
        assert_bits_equal(getattr(got[1], f), getattr(want[1], f), f)
    if inside:
        assert not bool(want[3]["thr_degraded"])
        scan = tst.stream_scan(scfg, tst.stream_init(scfg, device="cpu"), on, pm)
        assert_all_bits_equal(got, scan)
    else:  # the lockstep hop itself: every output bit for bit
        assert_all_bits_equal(got, want)
        assert bool(got[3]["thr_degraded"]) == label.startswith("pathological")


def chatty(lead, n, rng):
    """A quiet lead, then a spike every ``period`` blocks (widths and levels
    drawn at random) with -1 dB between: the first spike enters tracking
    at the quiet window's low threshold, and inside each lock window the
    locked value applies, so every spike is one more lock episode."""
    on = (rng.standard_normal(lead + n) * 0.1).astype(np.float32)
    period = int(rng.integers(2, 4))
    width = int(rng.integers(1, period))
    k = np.arange(n)
    on[lead:] = np.where(k % period < width, rng.uniform(5.0, 10.0, n), -1.0)
    pm = (-80.0 + rng.standard_normal(lead + n)).astype(np.float32)
    return torch.from_numpy(on), torch.from_numpy(pm)


@pytest.mark.parametrize("seed", range(6))
def test_hop_bound_fuzz(seed):
    """Chatty series at small capacities, the scan carried through INIT and
    a quiet lead, then one chunk: inside the bound the lockstep hop never
    sets ``thr_degraded`` and its thresholds are the scan's, which the route
    returns; at three times the bound's length the same series drop
    records, so the fuzz does fill the record buffer."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        scfg = tcfg(
            avg_win=int(rng.integers(4, 40)),
            after_wait_sec=float(rng.uniform(1.0, 6.0)),  # a lock window of 4 to 29 blocks
            k_std=float(rng.uniform(1.0, 3.0)),
            min_mean_db=float(rng.uniform(0.0, 2.0)),
            min_dur_sec=float(rng.uniform(0.0, 1.0)),
            cap=int(rng.integers(1, 9)),
        )
        slots = 4 * scfg.cap + 8
        lead = int(rng.integers(45, 80))  # past INIT's 40 blocks
        on, pm = chatty(lead, 3 * slots, rng)
        st0 = tst.stream_scan(scfg, tst.stream_init(scfg, device="cpu"), on[:lead], pm[:lead])[0]
        assert int(st0.state) != tst.INIT  # in DETECT, or inside a track the noise began
        for n in (slots - 2, int(rng.integers(1, slots - 2))):
            assert tst._hop_records_fit(scfg, n) and not tst._hop_records_fit(scfg, slots - 1)
            ck_on, ck_pm = on[lead : lead + n], pm[lead : lead + n]
            want = lockstep_hop(scfg, ck_on, ck_pm, state=st0, track_hop=int(rng.choice([1, 8])))
            assert not bool(want[3]["thr_degraded"]), (seed, scfg, n)
            scan = tst.stream_scan(scfg, st0, ck_on, ck_pm)
            assert_bits_equal(want[2], scan[2], "thresholds")
            assert_all_bits_equal(route(scfg, ck_on, ck_pm, hop=True, state=st0), scan)
        long = lockstep_hop(scfg, on[lead:], pm[lead:], state=st0)
        assert bool(long[3]["thr_degraded"]), (seed, scfg)


def test_cpu_keeps_lockstep_solvers():
    """On CPU tensors the public solvers are the lockstep loops (iterations
    counted), with the lockstep's own dB sums; only the helper takes K3's
    twin."""
    scfg, on, pm = fixture("bursty", LIVE_CAP)
    st0 = tst.stream_init(scfg, device="cpu")
    for hop in (False, True):
        tst.iterations = 0
        fn = (functools.partial(tst.stream_scan_jump_batch, with_diag=True) if hop
              else tst.stream_scan_jump)
        got = fn(scfg, st0, on, pm)
        assert tst.iterations > 0
        k3 = route(scfg, on, pm, hop)
        assert_bits_equal(got[2], k3[2], "thresholds")
        for f in ("count",) + EXACT_EV:
            assert_bits_equal(getattr(got[1], f), getattr(k3[1], f), f)
        np.testing.assert_allclose(got[1].db_mean.numpy(), k3[1].db_mean.numpy(),
                                   rtol=TOL["hop" if hop else "jump"], atol=STATE_TOL)


def test_k3_takes_float32_only():
    """The route's rule reads devices and dtypes: CPU tensors never go to
    K3, and on any device only float32 series with the state of
    ``stream_init(cfg, torch.float32)`` are in the kernel's layout; a
    float64 state or series runs the lockstep loops, which keep it."""
    scfg, on, pm = fixture("bursty", LIVE_CAP)
    f32 = tst.stream_init(scfg, device="cpu")
    f64 = tst.stream_init(scfg, torch.float64, device="cpu")
    dtypes = [a.dtype for a in f32]
    assert dtypes == list(tst.stream_kernel.STATE_DTYPES)
    assert not tst._k3_takes(f32, on, pm)  # on the CPU
    assert [a.dtype for a in f64] != dtypes
    for hop in (False, True):
        fn = (functools.partial(tst.stream_scan_jump_batch, with_diag=True) if hop
              else tst.stream_scan_jump)
        got = fn(scfg, f64, on.double(), pm.double())
        want = fn(scfg, f32, on, pm)
        assert got[2].dtype == got[0].tr_sum.dtype == torch.float64
        assert_bits_equal(got[1].count, want[1].count, "count")
        for f in ("time_start", "time_stop"):
            np.testing.assert_allclose(getattr(got[1], f).numpy(), getattr(want[1], f).numpy(),
                                       rtol=CROSS_TOL, atol=CROSS_TOL, err_msg=f)
        np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=CROSS_TOL,
                                   atol=CROSS_TOL, err_msg="thresholds")
