"""Adaptive detector of the PyTorch port against the JAX package, on the CPU.

The fused solver's plain twin (``adaptive_solver_plain``, the CPU path of
the CUDA kernel K1) is held against the Pallas kernel run in interpret mode,
as the JAX package's own tests run it.  The above mask and the run-start
count ``s_incl`` must be equal; thresholds and the masked prefix sum
``csm`` agree within ``THR_RTOL`` / ``CSM_ATOL``, the noise of float32
prefix sums taken in a different order.  Event lists: start, stop, count
and overflow exact.  In float64 the port's parallel solver is held to the
numpy oracle of the reference (`tests/oracles.py`).

The CUDA kernel itself is held against the twin on a GPU by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meteor_scatter_tpu.models import adaptive as jad
from meteor_scatter_tpu.ops.pallas import adaptive_kernel as jak
from meteor_scatter_tpu_torch.models import adaptive as tad
from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as tak

from oracles import oracle_adaptive
from test_torch_events import assert_events_equal

THR_RTOL = 1e-4  # as tests/test_adaptive_fused.py holds Pallas vs XLA
CSM_ATOL = 1e-3  # prefix sums of ~1e3 over a few thousand blocks

KW = dict(
    threshold_std_factor=4.0,
    window_blocks=300,
    freeze_blocks_before=15,
    freeze_blocks_after=100,
    fixed_threshold_blocks=50,
)


def series(n, seed, n_bursts=14, amp=7.0):
    """Noise plus 5-block bursts (as tests/test_adaptive_fused.py)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(n).astype(np.float32)
    if n_bursts:
        for s in np.linspace(60, n - 60, n_bursts).astype(int):
            d[s : s + 5] += amp
    return d


def assert_solver_equal(t_out, j_out):
    thr_t, ab_t, s_t, c_t = (x.numpy() for x in t_out)
    thr_j, ab_j, s_j, c_j = (np.asarray(x) for x in j_out)
    np.testing.assert_array_equal(ab_t, ab_j)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_allclose(thr_t, thr_j, rtol=THR_RTOL)
    np.testing.assert_allclose(c_t, c_j, atol=CSM_ATOL)
    assert thr_t.dtype == np.float32 and s_t.dtype == np.int32 and ab_t.dtype == bool


class TestFusedSolverTwin:
    def test_whole_series_matches_pallas(self):
        d = series(4000, 17)
        t_out = tak.adaptive_solver_fused(torch.from_numpy(d), **KW)
        j_out = jak.adaptive_solver_fused(jnp.asarray(d), interpret=True, **KW)
        assert_solver_equal(t_out, j_out)
        assert int(t_out[2][-1]) > 5  # runs were found

    def test_haloed_chunk_with_carries_matches_pallas(self):
        # a later chunk: W history blocks, i0 past the first chunk, the
        # freeze horizon reaching 40 blocks into it, a carried threshold
        d = series(4000, 23, n_bursts=20)
        w, i0 = KW["window_blocks"], 1500
        chunk = d[i0 - w :]
        fixed_thr = float(np.mean(d) + 4.0 * np.std(d))
        args = (i0, i0 + 40, fixed_thr, fixed_thr + 1.5, w)
        t_out = tak.adaptive_solver_fused_chunk(torch.from_numpy(chunk), *args, **KW)
        j_out = jak.adaptive_solver_fused_chunk(jnp.asarray(chunk), *args, interpret=True, **KW)
        assert_solver_equal(t_out, j_out)
        # frozen on entry: the first 40 solved blocks keep the carried threshold
        np.testing.assert_array_equal(t_out[0][:41].numpy(), np.float32(fixed_thr + 1.5))

    @pytest.mark.parametrize("seed,k", [(17, 4.0), (23, 3.0), (29, 2.5)])
    def test_above_mask_equals_parallel(self, seed, k):
        kw = dict(KW, threshold_std_factor=k)
        d = torch.from_numpy(series(4000, seed))
        thr_f, ab_f = tak.adaptive_thresholds_fused(d, **kw)
        thr_p, ab_p = tad.adaptive_thresholds_parallel(d, **kw)
        assert torch.equal(ab_f, ab_p)
        np.testing.assert_allclose(thr_f.numpy(), thr_p.numpy(), rtol=THR_RTOL)

    def test_zero_fixed_blocks_gives_zero_threshold_at_block_0(self):
        d = series(1500, 41)
        d[0] = abs(d[0]) + 5.0  # block 0 above the zero threshold
        kw = dict(KW, fixed_threshold_blocks=0)
        thr, above, _, _ = tak.adaptive_solver_fused(torch.from_numpy(d), **kw)
        assert float(thr[0]) == 0.0 and bool(above[0])
        thr_p, ab_p = tad.adaptive_thresholds_parallel(torch.from_numpy(d), **kw)
        assert float(thr_p[0]) == 0.0
        assert torch.equal(above, ab_p)

    def test_capacity_guard(self):
        with pytest.raises(ValueError):
            tak.adaptive_thresholds_fused(torch.zeros(tak.MAX_FUSED_BLOCKS + 1), **KW)

    def test_unsupported_device_raises(self):
        with pytest.raises(ValueError, match="not supported"):
            tak.adaptive_solver_fused(torch.zeros(100, device="meta"), **KW)


class TestDetectAdaptive:
    @pytest.mark.parametrize("impl", ["parallel", "fused"])
    def test_events_match_jax(self, impl):
        d = series(6000, 11, n_bursts=20)
        t_ev, t_thr = tad.detect_adaptive(torch.from_numpy(d), 4.0, 0.2, cap=64, impl=impl)
        j_ev, j_thr = jad.detect_adaptive(jnp.asarray(d), 4.0, 0.2, cap=64, impl="parallel")
        assert_events_equal(t_ev, j_ev, db_atol=1e-4)
        np.testing.assert_allclose(t_thr.numpy(), np.asarray(j_thr), rtol=THR_RTOL)

    def test_auto_is_parallel_on_cpu(self):
        d = torch.from_numpy(series(3000, 5))
        before = tak.launches
        ev_a, thr_a = tad.detect_adaptive(d, 4.0, 0.2, cap=64)
        ev_p, thr_p = tad.detect_adaptive(d, 4.0, 0.2, cap=64, impl="parallel")
        assert torch.equal(thr_a, thr_p) and torch.equal(ev_a.start, ev_p.start)
        assert tak.launches == before  # no kernel on the CPU

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError):
            tad.detect_adaptive(torch.zeros(100), 4.0, 0.2, impl="scan")

    @pytest.mark.parametrize("seed,k", [(7, 4.0), (13, 3.0)])
    def test_float64_parallel_matches_oracle(self, seed, k):
        rng = np.random.default_rng(seed)
        d = rng.standard_normal(3000) * 0.8
        for _ in range(12):
            s = rng.integers(50, 2940)
            d[s : s + rng.integers(2, 40)] += rng.uniform(5, 15)
        want, want_thr = oracle_adaptive(
            d, k, window_blocks=600, freeze_before=15, freeze_after=100, fixed_blocks=50
        )
        ev, thr = tad.detect_adaptive(torch.from_numpy(d), k, 0.2, cap=256, impl="parallel")
        assert thr.dtype == torch.float64
        np.testing.assert_allclose(thr.numpy(), want_thr, rtol=1e-10)
        assert int(ev.count) == len(want)
        for i, (s, e, m) in enumerate(want):
            assert (int(ev.start[i]), int(ev.stop[i])) == (s, e)
            np.testing.assert_allclose(float(ev.db_mean[i]), m, rtol=1e-12)


class TestChunkedDriver:
    """The chunked path with MAX_FUSED_BLOCKS shrunk (chunk = 1500 - 300 =
    1200 blocks), as tests/test_adaptive_fused.py does for the JAX one."""

    LIMIT = 1500

    def run_chunked(self, d, monkeypatch, cap, **kw):
        monkeypatch.setattr(tak, "MAX_FUSED_BLOCKS", self.LIMIT)
        return tad._detect_adaptive_fused(torch.from_numpy(d), cap=cap, **kw)

    def test_matches_unchunked_and_jax_chunked(self, monkeypatch):
        kw = dict(KW, threshold_std_factor=3.0)
        d = series(2400, 11, n_bursts=0)  # two chunks: [0, 1200), [1200, 2400)
        d[1195:1210] += 9.0  # a run across the seam
        d[400:404] += 9.0
        d[2390:2396] += 9.0
        ev_c, thr_c = self.run_chunked(d, monkeypatch, cap=16, **kw)
        thr_u, ab_u = tad.adaptive_thresholds_parallel(torch.from_numpy(d), **kw)
        ev_u = tad.events_from_mask(ab_u, torch.from_numpy(d), 16)
        assert torch.equal(torch.from_numpy(d) > thr_c, ab_u)
        np.testing.assert_allclose(thr_c.numpy(), thr_u.numpy(), rtol=THR_RTOL)
        c = int(ev_u.count)
        assert int(ev_c.count) == c and not bool(ev_c.overflow)
        assert torch.equal(ev_c.start[:c], ev_u.start[:c])
        assert torch.equal(ev_c.stop[:c], ev_u.stop[:c])
        assert int((ev_c.start[:c] == 1195).sum()) == 1  # merged once across the seam

        monkeypatch.setattr(jak, "MAX_FUSED_BLOCKS", self.LIMIT)
        ev_j, thr_j = jad._detect_adaptive_fused(jnp.asarray(d), cap=16, interpret=True, **kw)
        assert_events_equal(ev_c, ev_j, db_atol=1e-4)
        np.testing.assert_allclose(thr_c.numpy(), np.asarray(thr_j), rtol=THR_RTOL)

    def test_cap_contract_after_chunk_merge(self, monkeypatch):
        kw = dict(KW, threshold_std_factor=3.0)
        d = series(4000, 13, n_bursts=0)
        for s in range(100, 3900, 300):
            d[s : s + 3] += 9.0
        ev_c, _ = self.run_chunked(d, monkeypatch, cap=4, **kw)
        assert ev_c.capacity == 4 and int(ev_c.count) == 4 and bool(ev_c.overflow)
        ev_x, _ = self.run_chunked(d, monkeypatch, cap=64, **kw)
        assert torch.equal(ev_c.start, ev_x.start[:4])


class TestFixedPointWindowSums:
    """The fixpoint's window sums on a card: int64 fixed point
    (``window_sums_fixed_point``), here run on the CPU."""

    def test_matches_float64_windows(self):
        """Within one float32 ulp of the float64 window sums (the exact sum
        of values quantized to 2^-(k+1), k >= 30 here, rounded once)."""
        d = torch.from_numpy(np.stack([series(6000, s) for s in (1, 2)]))
        n, w = d.shape[-1], KW["window_blocks"]
        i = torch.arange(n)
        lo = torch.clamp(i - w, min=0)
        for x in (d, d * d):  # the window's sums of d and of d²
            cs = np.concatenate([np.zeros((2, 1)), np.cumsum(x.double().numpy(), -1)], -1)
            ref = cs[:, i] - cs[:, lo]
            got = tad.window_sums_fixed_point(x, lo, i).numpy()
            assert got.dtype == np.float32
            assert (np.abs(got - ref) <= np.spacing(np.abs(ref).astype(np.float32))).all()

    def test_non_finite_as_the_float_prefix_difference(self):
        d = torch.from_numpy(np.stack([series(2000, s) for s in (3, 4, 5)]))
        d[0, 100] = np.inf
        d[1, 700] = np.nan
        d[2, 300], d[2, 1500] = -np.inf, np.inf
        i = torch.arange(2000)
        lo = torch.clamp(i - 300, min=0)
        got = tad.window_sums_fixed_point(d, lo, i)
        want = tad._window_sums(d, lo, i)  # the CPU's float prefix difference
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got)) and int((~fin).sum()) > 1000
        assert torch.equal(torch.nan_to_num(got[~fin], nan=7.0), torch.nan_to_num(want[~fin], nan=7.0))

    @pytest.mark.parametrize("seed", [31, 32])
    def test_fixpoint_on_the_card_route_equals_cpu_and_jax(self, seed, monkeypatch):
        """``adaptive_thresholds_parallel`` with the card's window sums: the
        same above mask and events as the CPU route and as JAX, thresholds
        within ``THR_RTOL``."""
        d = series(5000, seed, n_bursts=30)
        want_thr, want_above = tad.adaptive_thresholds_parallel(torch.from_numpy(d), **KW)
        monkeypatch.setattr(tad, "_window_sums", tad.window_sums_fixed_point)
        thr, above = tad.adaptive_thresholds_parallel(torch.from_numpy(d), **KW)
        np.testing.assert_array_equal(above.numpy(), want_above.numpy())
        np.testing.assert_allclose(thr.numpy(), want_thr.numpy(), rtol=THR_RTOL)
        j_thr, j_above = jad.adaptive_thresholds_parallel(jnp.asarray(d), **KW)
        np.testing.assert_array_equal(above.numpy(), np.asarray(j_above))
