"""Event buffers and the fixed detector of the PyTorch port against the JAX
package, on the CPU.

The same numpy inputs go through both packages and the Events are compared
field by field: start, stop, count and overflow exactly; db_mean to
``DB_RTOL`` — the two frameworks sum a run's values in different orders, so
means of float32 runs agree to a few ulps, not bit for bit.  In float64 the
port is held to the numpy oracle of the reference (`tests/oracles.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.models import events as jev
from meteor_scatter_tpu.models.fixed import detect_fixed
from meteor_scatter_tpu_torch.models import events as tev
from meteor_scatter_tpu_torch.models.fixed import detect_fixed as t_detect_fixed

from oracles import oracle_fixed

DB_RTOL = 1e-5  # float32 summation-order noise over runs of up to ~100 blocks

# the JAX reference, jitted: one compile per shape instead of one per op
j_events_from_mask = jax.jit(jev.events_from_mask, static_argnums=2)
j_events_from_run_sums = jax.jit(jev.events_from_run_sums, static_argnums=3)
j_merge_adjacent = jax.jit(jev.merge_adjacent)
j_truncate_events = jax.jit(jev.truncate_events, static_argnums=1)
j_detect_fixed = jax.jit(detect_fixed, static_argnames="cap")


def assert_events_equal(t_ev, j_ev, db_rtol=DB_RTOL, db_atol=0.0):
    """Port Events (torch) == reference Events (jax) on the valid rows, with
    fixed-capacity layout and dtypes kept."""
    assert t_ev.capacity == j_ev.capacity
    assert t_ev.start.dtype == torch.int32 and t_ev.stop.dtype == torch.int32
    assert t_ev.count.dtype == torch.int32 and t_ev.overflow.dtype == torch.bool
    c = int(j_ev.count)
    assert int(t_ev.count) == c
    assert bool(t_ev.overflow) == bool(j_ev.overflow)
    np.testing.assert_array_equal(t_ev.start[:c].numpy(), np.asarray(j_ev.start)[:c])
    np.testing.assert_array_equal(t_ev.stop[:c].numpy(), np.asarray(j_ev.stop)[:c])
    np.testing.assert_allclose(
        t_ev.db_mean[:c].numpy(), np.asarray(j_ev.db_mean)[:c], rtol=db_rtol, atol=db_atol
    )


def random_mask(n, seed, p_start=0.05, p_stop=0.3):
    rng = np.random.default_rng(seed)
    above = np.zeros(n, bool)
    on = False
    for i in range(n):
        on = (rng.random() > p_stop) if on else (rng.random() < p_start)
        above[i] = on
    return above


N = 500
MASKS = {  # one length, so the jitted reference compiles once per cap
    "random": random_mask(N, 1),
    "run_at_start_and_end": np.r_[np.ones(4, bool), np.zeros(N - 7, bool), np.ones(3, bool)],
    "empty": np.zeros(N, bool),
    "all_true": np.ones(N, bool),
    "alternating": np.tile([True, False], N // 2),
}


class TestEventsFromMask:
    @pytest.mark.parametrize("name", sorted(MASKS))
    @pytest.mark.parametrize("cap", [4, 64])
    def test_matches_jax(self, name, cap):
        above = MASKS[name]
        series = np.random.default_rng(3).standard_normal(len(above)).astype(np.float32)
        t_ev = tev.events_from_mask(torch.from_numpy(above), torch.from_numpy(series), cap)
        j_ev = j_events_from_mask(jnp.asarray(above), jnp.asarray(series), cap)
        assert_events_equal(t_ev, j_ev)

    def test_overflow_keeps_first_runs(self):
        above = MASKS["alternating"]
        t_ev = tev.events_from_mask(torch.from_numpy(above), torch.zeros(len(above)), cap=4)
        assert bool(t_ev.overflow) and int(t_ev.count) == 4
        np.testing.assert_array_equal(t_ev.start.numpy(), [0, 2, 4, 6])


class TestEventsFromRunSums:
    @pytest.mark.parametrize("name", ["random", "run_at_start_and_end", "empty", "all_true"])
    @pytest.mark.parametrize("cap", [3, 64])
    def test_matches_jax_and_mask_extraction(self, name, cap):
        above = MASKS[name]
        d = np.random.default_rng(5).standard_normal(len(above)).astype(np.float32)
        is_start = above & ~np.r_[False, above[:-1]]
        s_incl = np.cumsum(is_start).astype(np.int32)
        csm = np.cumsum(np.where(above, d, 0)).astype(np.float32)
        t_ev = tev.events_from_run_sums(
            torch.from_numpy(s_incl), torch.from_numpy(csm), torch.from_numpy(above), cap
        )
        j_ev = j_events_from_run_sums(
            jnp.asarray(s_incl), jnp.asarray(csm), jnp.asarray(above), cap
        )
        # means come from prefix-sum differences: absolute noise of the sums
        assert_events_equal(t_ev, j_ev, db_atol=1e-5)
        assert_events_equal(
            t_ev, j_events_from_mask(jnp.asarray(above), jnp.asarray(d), cap), db_atol=1e-5
        )


class TestMergeTruncate:
    @pytest.mark.parametrize("seam", [250, 251, 300])
    @pytest.mark.parametrize("cap", [2, 32])
    def test_merge_adjacent_matches_jax(self, seam, cap):
        above = MASKS["random"].copy()
        above[245:260] = True  # a run across seams 250 and 251
        d = np.random.default_rng(9).standard_normal(len(above)).astype(np.float32)
        halves = [(above[:seam], d[:seam]), (above[seam:], d[seam:])]
        t_l, t_r = (tev.events_from_mask(torch.from_numpy(a), torch.from_numpy(x), cap)
                    for a, x in halves)
        j_l, j_r = (j_events_from_mask(jnp.asarray(a), jnp.asarray(x), cap)
                    for a, x in halves)
        t_m = tev.merge_adjacent(t_l, t_r, seam)
        assert_events_equal(t_m, j_merge_adjacent(j_l, j_r, seam))
        if cap == 32:  # no drops: the merge equals whole-series extraction
            whole = j_events_from_mask(jnp.asarray(above), jnp.asarray(d), 64)
            assert_events_equal(tev.truncate_events(t_m, 64), whole)

    @pytest.mark.parametrize("cap", [2, 5, 12])
    def test_truncate_matches_jax(self, cap):
        above, d = MASKS["random"], np.linspace(-1, 1, 500, dtype=np.float32)
        t_ev = tev.events_from_mask(torch.from_numpy(above), torch.from_numpy(d), 5)
        j_ev = j_events_from_mask(jnp.asarray(above), jnp.asarray(d), 5)
        assert_events_equal(tev.truncate_events(t_ev, cap), j_truncate_events(j_ev, cap))

    def test_empty_events(self):
        ev = tev.empty_events(8)
        assert ev.capacity == 8 and int(ev.count) == 0 and not bool(ev.overflow)
        assert ev.db_mean.dtype == torch.float32


def burst_series(n=3000, n_bursts=12, seed=7):
    """Gaussian noise + boxcar bursts (as tests/test_detectors.py)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(n) * 0.8
    for _ in range(n_bursts):
        s = rng.integers(50, n - 60)
        w = rng.integers(2, 40)
        d[s : s + w] += rng.uniform(5, 15)
    return d


def end_run_series():
    d = np.zeros(100)
    for s in range(0, 90, 10):  # 9 closed runs of 3 blocks
        d[s : s + 3] = 100.0
    d[97:] = 100.0  # a 10th run reaches the end
    return d


class TestFixedDetector:
    @pytest.mark.parametrize(
        "name,d,k,cap",
        [
            ("bursts", burst_series(), 4.0, 256),
            ("open_end", np.r_[np.zeros(45), np.full(5, 100.0)], 1.0, 8),
            ("open_start", np.r_[np.full(4, 100.0), np.zeros(46)], 1.0, 8),
            ("open_end_overflow", end_run_series(), 1.0, 4),
            ("open_end_fits", end_run_series(), 1.0, 16),
        ],
    )
    def test_matches_jax(self, name, d, k, cap):
        d32 = d.astype(np.float32)
        t_ev, t_thr = t_detect_fixed(torch.from_numpy(d32), k, cap=cap)
        j_ev, j_thr = j_detect_fixed(jnp.asarray(d32), k, cap=cap)
        # threshold: f32 mean/std in another summation order
        np.testing.assert_allclose(float(t_thr), float(j_thr), rtol=1e-6)
        assert_events_equal(t_ev, j_ev, db_atol=1e-4)

    @pytest.mark.parametrize(
        "d,k",
        [(burst_series(), 4.0), (burst_series(n=2000, seed=3), 2.0),
         (np.r_[np.zeros(45), np.full(5, 100.0)], 1.0), (end_run_series(), 1.0)],
    )
    def test_float64_matches_oracle(self, d, k):
        want, want_thr = oracle_fixed(d, k)
        ev, thr = t_detect_fixed(torch.from_numpy(d), k, cap=256)
        assert abs(float(thr) - want_thr) < 1e-9
        assert int(ev.count) == len(want)
        for i, (s, e, m) in enumerate(want):
            assert (int(ev.start[i]), int(ev.stop[i])) == (s, e)
            np.testing.assert_allclose(float(ev.db_mean[i]), m, rtol=1e-12)

    def test_overflow_keeps_survivors_intact(self):
        ev, _ = t_detect_fixed(torch.from_numpy(end_run_series()), 1.0, cap=4)
        assert bool(ev.overflow) and int(ev.count) == 4
        for k in range(4):
            assert (int(ev.start[k]), int(ev.stop[k])) == (10 * k, 10 * k + 3)
            assert float(ev.db_mean[k]) == 100.0
