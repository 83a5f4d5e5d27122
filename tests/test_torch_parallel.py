"""The multi-device layer of the PyTorch port against the JAX package, on
the CPU.

The port runs on a virtual mesh of 8 CPU positions (2 stations x 4 time
shards, ``make_mesh(2, 4, ["cpu"] * 8)``), the JAX layer on the 8 virtual
CPU devices of ``tests/conftest.py``; both get the same numpy inputs, made
from a seed, with the fixtures and tolerances of ``tests/test_parallel.py``:

* delta power within ``DELTA_ATOL`` dB; the fixed threshold within
  ``FIXED_RTOL`` of the whole-series statistics, masks equal;
* the warm-started adaptive detector equal to the unsharded scan on
  shard 0 (``SHARD0_RTOL``; ``NEG_RTOL`` where the fixed threshold is
  negative: shard sums and a whole-row mean round differently), masks
  equal everywhere;
* the exact adaptive detector bit-equal to the unsharded fixpoint solver;
* spectrograms within ``SPEC_RTOL``, with the exact global frame count;
* the FIR and the Welch blocks within ``FIR_ATOL`` / ``WELCH_RTOL``;
* the streaming machine equal to the unsharded port: bit for bit with the
  Welch front; with the bins front the events' count and times are equal
  and the levels agree within ``BINS_RTOL`` (the CPU GEMM rounds a row
  differently with the row count, B / 4 per shard against B);
* the IQ bank within ``IQ_ATOL`` of the unsharded bank, pre-framed ==
  flat bit for bit.

Against the JAX package float32 sums run in other orders, so thresholds
agree within ``JAX_THR_RTOL`` and masks and event lists are equal.  The
delta power, the fixed and warm-started detectors, the FIR and the Welch
blocks are held against the JAX layer's sharded functions.  A call of the
JAX layer's sharded streaming machine, exact detector, spectrogram or IQ
bank compiles for 4-70 s on the CPU mesh (``tests/test_parallel.py``
durations), so those are held against the JAX unsharded functions, which
``tests/test_parallel.py`` holds equal to the sharded ones.
``adaptive_thresholds`` (the scan with a carry) is held against the JAX
scan on one series and a batch, chunked and warm-started.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from meteor_scatter_tpu.config import DetectionConfig as JDetectionConfig
from meteor_scatter_tpu.models import adaptive as jad
from meteor_scatter_tpu.models import streaming as jst
from meteor_scatter_tpu.ops import fir as jfir
from meteor_scatter_tpu.ops import spectrogram as jspec
from meteor_scatter_tpu.parallel import halo as jhalo
from meteor_scatter_tpu.parallel import mesh as jmesh_mod
from meteor_scatter_tpu.parallel import sharded as jsh
from meteor_scatter_tpu_torch.config import DetectionConfig
from meteor_scatter_tpu_torch.models import adaptive as tad
from meteor_scatter_tpu_torch.models import streaming as tst
from meteor_scatter_tpu_torch.ops import bandpower as tbp
from meteor_scatter_tpu_torch.ops import fir as tfir
from meteor_scatter_tpu_torch.ops import spectrogram as tspec
from meteor_scatter_tpu_torch.ops import welch as twelch
from meteor_scatter_tpu_torch.ops.framing import frame_signal
from meteor_scatter_tpu_torch.parallel import halo as thalo
from meteor_scatter_tpu_torch.parallel import mesh as tmesh_mod
from meteor_scatter_tpu_torch.parallel import sharded as tsh
from meteor_scatter_tpu_torch.parallel.dryrun import dryrun_multichip

from test_parallel import BLOCK, FB, FS, NB, NFFT, audio

DELTA_ATOL = 1e-4
FIXED_RTOL = 1e-5
SHARD0_RTOL = 1e-6
NEG_RTOL = 2e-5
JAX_THR_RTOL = 1e-5
SPEC_RTOL, SPEC_ATOL = 2e-3, 1e-9
FIR_ATOL = 1e-4
WELCH_RTOL = 1e-4
IQ_ATOL = 2e-5
BINS_RTOL = BINS_ATOL = 1e-5  # as the port against JAX (tests/test_torch_streaming.py)
# Port vs JAX where the window's m2 - m*m cancels: at mean -8 dB and std
# 0.5 dB it loses 8 bits, so sum-order noise of a few float32 ulps of the
# window's sum of squares (~1 600, ulp 1.2e-4) reaches ~1e-4 dB in k*std
NEG_JAX_ATOL = 1e-3

KW = dict(threshold_std_factor=4.0, window_blocks=25, freeze_blocks_before=3,
          freeze_blocks_after=10, fixed_threshold_blocks=10)
LIVE = dict(signal_freq=1000, detection_db_over_noise_mean_min=1, detection_dur_min_sec=0.5)
CFG, J_CFG = DetectionConfig(**LIVE), JDetectionConfig(**LIVE)
STREAM_FS = 4000
IQ_FS, IQ_AUDIO, IQ_TONE = 64_000, 4000, 1000.0
IQ_FREQS = [-17003.0, -7001.0, 6997.0, 15013.0]
IQ_KW = dict(bandwidth=1500.0, decim=16, numtaps=65)


@pytest.fixture(scope="module")
def mesh():
    return tmesh_mod.make_mesh(2, 4, ["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jmesh_mod.make_mesh(n_station=2, n_time=4)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(a, b, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, equal_nan=True)


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- the mesh, its placement helpers and the row operations -----------------


def test_make_mesh_layout_and_errors():
    m = tmesh_mod.make_mesh(2, None, ["cpu"] * 8)
    assert m.shape == {"station": 2, "time": 4}
    assert m.axis_names == ("station", "time") == tmesh_mod.station_time_specs()
    assert m.device == torch.device("cpu") and len(list(m.positions())) == 8
    assert tmesh_mod.make_mesh(8, 1, ["cpu"] * 8).shape == {"station": 8, "time": 1}
    with pytest.raises(ValueError, match="not divisible"):
        tmesh_mod.make_mesh(3, None, ["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 16 devices"):
        tmesh_mod.make_mesh(2, 8, ["cpu"] * 8)


def test_make_mesh_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh_mod.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh_mod.make_mesh(1, 1, ["cuda:0"])


def test_shard_unshard_round_trip(mesh):
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    grid = tmesh_mod.shard(x, mesh, ("station", "time", None))
    assert [[tuple(a.shape) for a in row] for row in grid] == [[(1, 2, 3)] * 4] * 2
    assert torch.equal(grid[1][2], x[1:, 4:6])
    assert torch.equal(tmesh_mod.unshard(grid, mesh, ("station", "time", None)), x)
    rep = tmesh_mod.shard(x, mesh, (None, "time"))  # replicated over stations
    assert torch.equal(rep[0][3], rep[1][3]) and torch.equal(
        tmesh_mod.unshard(rep, mesh, (None, "time")), x)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh_mod.shard(torch.zeros(3, 8), mesh, ("station", "time"))


def test_row_sum_and_gather():
    row = [torch.tensor([1.0, 2.0]), torch.tensor([10.0, 20.0]), torch.tensor([100.0, 200.0])]
    for got in thalo.time_psum(row):
        assert torch.equal(got, torch.tensor([111.0, 222.0]))
    got = thalo.time_psum(row)
    got[0] += 1  # every position holds its own result
    assert torch.equal(got[1], torch.tensor([111.0, 222.0]))
    for got in thalo.time_all_gather(row, -1):
        assert torch.equal(got, torch.tensor([1.0, 2, 10, 20, 100, 200]))


@pytest.mark.parametrize("lh,rh,n_dev", [(2, 2, 4), (1, 0, 2), (0, 3, 4)])
def test_halo_exchange_matches_jax(lh, rh, n_dev):
    """Per shard ``cat(left tail, local, right head)``, zeros at the stream
    edges, against ``lax.ppermute`` in ``shard_map``."""
    x = np.arange(16, dtype=np.float32)
    jm = jmesh_mod.make_mesh(n_station=1, n_time=n_dev)
    fn = jax.shard_map(
        lambda xl: jhalo.halo_exchange(xl[0], lh, rh, "time")[None],
        mesh=jm, in_specs=P("station", "time"), out_specs=P("station", "time"),
    )
    xs = jax.device_put(jnp.asarray(x)[None], jax.sharding.NamedSharding(jm, P("station", "time")))
    want = np.asarray(fn(xs))[0].reshape(n_dev, -1)
    row = list(t(x).reshape(n_dev, -1).clone())
    got = thalo.halo_exchange(row, lh, rh)
    equal(torch.stack(got), want)
    got[1][...] = -1  # a received halo is a copy: the neighbours are untouched
    assert torch.equal(torch.cat(row), t(x))
    with pytest.raises(ValueError, match="exceed"):
        thalo.halo_exchange(row, 16 // n_dev + 1, 0)


# --- the batch path ----------------------------------------------------------


@pytest.fixture(scope="module")
def delta16(mesh, jmesh):
    """2 channels x 16 s: the port's and the JAX layer's sharded delta."""
    x = audio(2, 16.0)
    got = tsh.sharded_delta_power(t(x), mesh, FS, NFFT, BLOCK, FB, NB)
    want = jsh.sharded_delta_power(jnp.asarray(x), jmesh, FS, NFFT, BLOCK, FB, NB)
    return x, got, want


def test_sharded_delta_power(delta16):
    x, got, want = delta16
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 80) and g.dtype == torch.float32
        close(g, w, atol=DELTA_ATOL)
    _, _, unsharded = tbp.delta_power_db(t(x), FS, NFFT, BLOCK, FB, NB)
    close(got[2], unsharded, atol=DELTA_ATOL)


def test_sharded_detect_fixed(delta16, mesh, jmesh):
    d = delta16[1][2].numpy()
    above, thr = tsh.sharded_detect_fixed(t(d), mesh, 4.0)
    above_j, thr_j = jsh.sharded_detect_fixed(jnp.asarray(d), jmesh, 4.0)
    assert thr.shape == (2,) and above.dtype == torch.bool
    for c in range(2):
        want = d[c].mean() + 4.0 * d[c].std()
        close(thr[c], want, rtol=FIXED_RTOL)
        equal(above[c], d[c] > want)
    close(thr, thr_j, rtol=JAX_THR_RTOL)
    equal(above, above_j)


@pytest.fixture(scope="module")
def delta32(mesh):
    return {seed: tsh.sharded_delta_power(t(audio(2, 32.0, seed=seed)), mesh, FS, NFFT, BLOCK,
                                          FB, NB)[2].numpy() for seed in (3, 8)}


def test_sharded_detect_adaptive(delta32, mesh):
    """Shard 0 equals the unsharded scan; the 35-block warm-up converges
    the rolling statistics, so the masks are equal everywhere."""
    d = delta32[3]
    thr, above = tsh.sharded_detect_adaptive(t(d), mesh, **KW)
    b_loc = d.shape[1] // 4
    thr_u, above_u, _ = tad.adaptive_thresholds(t(d), **KW)
    close(thr[:, :b_loc], thr_u[:, :b_loc], rtol=SHARD0_RTOL)
    equal(above, above_u)
    for c in range(2):
        thr_j, above_j, _ = jad.adaptive_thresholds(jnp.asarray(d[c]), **KW)
        close(thr[c, :b_loc], np.asarray(thr_j)[:b_loc], rtol=JAX_THR_RTOL)
        equal(above[c], above_j)


def test_sharded_detect_adaptive_negative_fixed_threshold(mesh, jmesh):
    """A fixed threshold below zero: shard 0's warm-up replay over its zero
    halo must not register phantom detections (the ``i >= 0`` guard)."""
    rng = np.random.default_rng(9)
    d = (rng.standard_normal((2, 4 * 60)) * 0.5 - 8.0).astype(np.float32)
    kw = dict(KW, freeze_blocks_after=40)
    thr, above = tsh.sharded_detect_adaptive(t(d), mesh, **kw)
    thr_j, above_j = jsh.sharded_detect_adaptive(jnp.asarray(d), jmesh, **kw)
    b_loc = d.shape[1] // 4
    assert (d.mean(1) + 4.0 * d.std(1) < 0).all()  # the trigger
    thr_u, above_u, _ = tad.adaptive_thresholds(t(d), **kw)
    close(thr[:, :b_loc], thr_u[:, :b_loc], rtol=NEG_RTOL)
    equal(above[:, :b_loc], above_u[:, :b_loc])
    close(thr, thr_j, atol=NEG_JAX_ATOL)
    equal(above, above_j)


def test_sharded_detect_adaptive_station_only_mesh():
    """No time shards: the plain scan from block 0, exact for the
    reference's 600-block window."""
    mesh8 = tmesh_mod.make_mesh(8, 1, ["cpu"] * 8)
    x = audio(8, 8.0, seed=5)
    _, _, d = tsh.sharded_delta_power(t(x), mesh8, FS, NFFT, BLOCK, FB, NB)
    kw = dict(threshold_std_factor=4.0, window_blocks=600, freeze_blocks_before=15,
              freeze_blocks_after=100, fixed_threshold_blocks=50)
    thr, above = tsh.sharded_detect_adaptive(d, mesh8, **kw)
    thr_u, above_u, _ = tad.adaptive_thresholds(d, **kw)
    close(thr, thr_u, rtol=SHARD0_RTOL)
    equal(above, above_u)
    for c in (0, 7):
        thr_j, above_j, _ = jad.adaptive_thresholds(jnp.asarray(d[c].numpy()), **kw)
        close(thr[c], thr_j, rtol=JAX_THR_RTOL)
        equal(above[c], above_j)


def test_sharded_detect_adaptive_rejects_small_shards(mesh):
    with pytest.raises(ValueError, match="time shards too small"):
        tsh.sharded_detect_adaptive(torch.zeros(2, 4 * 20), mesh, **KW)


def test_sharded_detect_adaptive_exact(delta32, mesh):
    d = delta32[8]
    thr, above = tsh.sharded_detect_adaptive_exact(t(d), mesh, **KW)
    thr_u, above_u = tad.adaptive_thresholds_parallel(t(d), **KW)
    equal(above, above_u)
    close(thr, thr_u)  # bit-exact
    for c in range(2):
        thr_j, above_j = jad.adaptive_thresholds_parallel(jnp.asarray(d[c]), **KW)
        equal(above[c], above_j)
        close(thr[c], thr_j, rtol=JAX_THR_RTOL)


@pytest.mark.parametrize("nper,nov", [(3000, None), (511, 256), (600, 388), (2048, 1024)])
def test_sharded_spectrogram_psd(mesh, nper, nov):
    """Hops that do not divide the 24 000-sample shards put frames across
    the seams; values and the exact global frame count equal the
    unsharded run."""
    x = audio(2, 16.0, seed=4)
    got = tsh.sharded_spectrogram_psd(t(x), mesh, FS, nper, noverlap=nov)
    _, _, want = tspec.spectrogram_scipy(t(x), FS, nper, noverlap=nov)
    assert got.shape == want.transpose(-1, -2).shape
    close(got.transpose(-1, -2), want, rtol=SPEC_RTOL, atol=SPEC_ATOL)
    if nov == 256:
        for c in range(2):
            _, _, want_j = jspec.spectrogram_scipy(jnp.asarray(x[c]), FS, nper, noverlap=nov)
            close(got[c].T, want_j, rtol=SPEC_RTOL, atol=SPEC_ATOL)


def test_sharded_spectrogram_errors(mesh):
    with pytest.raises(ValueError, match="must divide"):
        tsh.sharded_spectrogram_psd(torch.zeros(2, 4002), mesh, FS, 256)
    with pytest.raises(ValueError, match="shorter than one frame"):
        tsh.sharded_spectrogram_psd(torch.zeros(2, 400), mesh, FS, 512)
    with pytest.raises(ValueError, match="time shards too small"):
        tsh.sharded_spectrogram_psd(torch.zeros(2, 4000), mesh, FS, 2000, noverlap=0)


def test_sharded_fir_filter(mesh, jmesh):
    x = audio(2, 8.0, seed=2)
    taps = tfir.firwin_bandpass(101, 950.0, 1050.0, FS)
    got = tsh.sharded_fir_filter(t(x), mesh, taps)
    close(got, tfir.fir_filter(t(x), taps, mode="same"), atol=FIR_ATOL)
    close(got, jsh.sharded_fir_filter(jnp.asarray(x), jmesh, taps), atol=FIR_ATOL)


def test_sharded_welch_blocks(mesh, jmesh):
    x = audio(2, 8.0, seed=6)
    got = tsh.sharded_welch_blocks(t(x), mesh, FS, BLOCK, NFFT)
    want = twelch.welch_psd(frame_signal(t(x), BLOCK, BLOCK), FS, NFFT)
    assert got.shape == want.shape == (2, 40, NFFT // 2 + 1)
    close(got, want, rtol=WELCH_RTOL)
    close(got, jsh.sharded_welch_blocks(jnp.asarray(x), jmesh, FS, BLOCK, NFFT), rtol=WELCH_RTOL)


# --- the streaming machine ---------------------------------------------------


def stream_audio(seed):
    """64 s at 4 kHz, 2 channels: ch0's burst straddles the 16 s seam of
    the 4 time shards, ch1 has one near the 32 s seam and one inside."""
    from test_parallel import TestShardedStreaming

    return TestShardedStreaming._audio(STREAM_FS, 64.0, seed)


def assert_stream_equal(got, want_per_channel, exact):
    """Sharded (channel-batched) against unsharded per-channel outputs:
    bit for bit, or with equal integer fields and event times and the
    float fields within BINS_RTOL / BINS_ATOL."""
    st, ev, dg = got
    for c, (st_u, ev_u, dg_u) in enumerate(want_per_channel):
        pairs = [(f"state.{f}", x[c], y) for f, x, y in zip(st._fields, st, st_u)]
        pairs += [(f"events.{f}", x[c], y) for f, x, y in zip(ev._fields, ev, ev_u)]
        pairs += [(k, dg[k][c], dg_u[k]) for k in ("over_noise", "threshold", "psd_db")
                  if k in dg_u]
        for name, x, y in pairs:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            if exact or x.dtype != torch.float32 or name in ("events.time_start",
                                                               "events.time_stop"):
                equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                      y.view(torch.int32) if y.dtype == torch.float32 else y)
            else:
                close(x, y, rtol=BINS_RTOL, atol=BINS_ATOL)


@pytest.mark.parametrize("front,impl", [("welch", "scan"), ("bins", "fused"), ("welch", "jump"),
                                        ("bins", "hop")])
def test_sharded_stream_process_equals_unsharded(mesh, front, impl):
    """Time-sharded == the unsharded port (events, state, thresholds,
    over_noise, the psd waterfall), with a burst on a seam, for every
    solver (the episode-jump solvers run batched over each station group)."""
    x = stream_audio(11 if front == "welch" else 13)
    got = tsh.sharded_stream_process(CFG, None, t(x), STREAM_FS, mesh, front=front, impl=impl)
    scfg = tst.StreamConfig.from_config(CFG)
    want = [tst.stream_process(CFG, tst.stream_init(scfg, device="cpu"), t(x[c]), STREAM_FS,
                               front=front, impl=impl) for c in range(2)]
    assert all(int(w[1].count) >= 1 for w in want), "fixture must produce events"
    assert ("psd_db" in got[2]) == (front == "welch")
    assert_stream_equal(got, want, exact=front == "welch")


def test_sharded_stream_process_matches_jax(mesh):
    """The port's sharded machine (its default on the CPU: welch front,
    scan) against the JAX machine run on the port's gathered block series,
    per channel: equal event counts and times, thresholds within the
    port-vs-JAX tolerance of ``tests/test_torch_streaming.py``.  (The port's
    Welch front is held to the JAX front there, and bit-equal to its
    unsharded self here.)"""
    x = stream_audio(11)
    _, ev, dg = tsh.sharded_stream_process(CFG, None, t(x), STREAM_FS, mesh)
    jscfg = jst.StreamConfig.from_config(J_CFG)
    pm = tst.stream_front(CFG, t(x), STREAM_FS)[1].numpy()
    for c in range(2):
        _, ev_j, thr_j = jst.stream_scan(jscfg, jst.stream_init(jscfg),
                                         jnp.asarray(dg["over_noise"][c].numpy()),
                                         jnp.asarray(pm[c]))
        n = int(ev_j.count)
        assert n >= 1 and int(ev.count[c]) == n
        for f in ("time_start", "time_stop"):
            equal(getattr(ev, f)[c], getattr(ev_j, f))
        close(dg["threshold"][c], thr_j, rtol=BINS_RTOL, atol=BINS_ATOL)


def test_sharded_stream_chunked_carry(mesh):
    """Two chunks carried across calls == one unsharded pass."""
    x = stream_audio(12)
    half = x.shape[-1] // 2
    st, got = None, []
    for sl in (x[:, :half], x[:, half:]):
        st, ev, _ = tsh.sharded_stream_process(CFG, st, t(sl), STREAM_FS, mesh)
        got += [(c, float(ev.time_start[c, k]), float(ev.time_stop[c, k]))
                for c in range(2) for k in range(int(ev.count[c]))]
    scfg = tst.StreamConfig.from_config(CFG)
    want = []
    for c in range(2):
        _, ev_u, _ = tst.stream_process(CFG, tst.stream_init(scfg, device="cpu"), t(x[c]), STREAM_FS)
        want += [(c, float(ev_u.time_start[k]), float(ev_u.time_stop[k]))
                 for k in range(int(ev_u.count))]
    assert sorted(got) == sorted(want) and len(want) >= 1


@pytest.mark.parametrize("front,impl", [("bins", "fused"), ("welch", "scan")])
def test_sharded_stream_preblocked_equals_flat(mesh, front, impl):
    x = stream_audio(14)
    block = int(round(CFG.proc_block_sec * STREAM_FS))
    outs = [tsh.sharded_stream_process(CFG, None, xin, STREAM_FS, mesh, front=front, impl=impl)
            for xin in (t(x), t(x.reshape(2, -1, block)))]
    (st_f, ev_f, dg_f), (st_b, ev_b, dg_b) = outs
    assert int(ev_f.count.sum()) >= 1
    for a, b in zip((*ev_f, *st_f, dg_f["over_noise"]), (*ev_b, *st_b, dg_b["over_noise"])):
        equal(a, b)


def test_sharded_stream_rejects(mesh):
    with pytest.raises(ValueError, match="whole number"):
        tsh.sharded_stream_process(CFG, None, torch.zeros(2, 4000 * 3), STREAM_FS, mesh)
    with pytest.raises(ValueError, match="must be whole"):
        tsh.sharded_stream_process(CFG, None, torch.zeros(2, 6, 800), STREAM_FS, mesh)
    with pytest.raises(ValueError, match="impl"):
        tsh.sharded_stream_process(CFG, None, torch.zeros(2, 3200), STREAM_FS, mesh, impl="magic")
    for impl in ("jump", "hop"):  # once unported, they run
        _, ev, _ = tsh.sharded_stream_process(CFG, None, torch.zeros(2, 3200), STREAM_FS, mesh,
                                              impl=impl)
        assert ev.count.tolist() == [0, 0]


# --- the wideband IQ bank ------------------------------------------------------


def iq_capture(seconds):
    from test_parallel import TestShardedChannelizerIQ

    return TestShardedChannelizerIQ._capture(seconds)


def test_sharded_channelize_iq(mesh):
    """Sharded == unsharded within IQ_ATOL, == the JAX layer; the
    pre-framed form is bit-identical to the flat one."""
    x_re, x_im = iq_capture(4.0)
    centers = np.asarray(IQ_FREQS) - IQ_TONE
    yr, yi = tsh.sharded_channelize_iq(t(x_re), t(x_im), mesh, IQ_FS, centers, **IQ_KW)
    yr_u, yi_u = tfir.channelize_iq(t(x_re), t(x_im), IQ_FS, centers, **IQ_KW)
    assert yr.shape == yr_u.shape == (4, x_re.size // 16)
    close(yr, yr_u, atol=IQ_ATOL)
    close(yi, yi_u, atol=IQ_ATOL)
    yr_j, yi_j = jfir.channelize_iq(jnp.asarray(x_re), jnp.asarray(x_im), IQ_FS, centers,
                                    **IQ_KW)
    close(yr, yr_j, atol=IQ_ATOL)
    close(yi, yi_j, atol=IQ_ATOL)

    plan, _ = tfir.channel_bank_plan(x_re.size, IQ_FS, centers, device="cpu", **IQ_KW)
    f_sh = tfir.frame_capture_sharded_host(np.stack([x_re, x_im]), plan, 4)
    yr_p, yi_p = tsh.sharded_channelize_iq_frames(t(f_sh), mesh, IQ_FS, centers, **IQ_KW)
    assert torch.equal(yr_p.view(torch.int32), yr.view(torch.int32))
    assert torch.equal(yi_p.view(torch.int32), yi.view(torch.int32))


def test_sharded_channelize_iq_errors(mesh):
    centers = np.asarray(IQ_FREQS) - IQ_TONE
    with pytest.raises(ValueError, match="whole decimation frames"):
        tsh.sharded_channelize_iq(torch.zeros(1000), torch.zeros(1000), mesh, IQ_FS, centers,
                                  **IQ_KW)
    with pytest.raises(ValueError, match="I/Q shape mismatch"):
        tsh.sharded_channelize_iq(torch.zeros(64), torch.zeros(128), mesh, IQ_FS, centers,
                                  **IQ_KW)
    with pytest.raises(ValueError, match="does not match the bank plan"):
        tsh.sharded_channelize_iq_frames(torch.zeros(4, 2, 100, 8), mesh, IQ_FS, centers,
                                         **IQ_KW)
    with pytest.raises(ValueError, match="pre-framed input"):
        tsh.sharded_channelize_iq_frames(torch.zeros(2, 2, 100, 16), mesh, IQ_FS, centers,
                                         **IQ_KW)


def test_sharded_iq_stream_chain_equals_unsharded(mesh):
    """IQ → sharded bank → sharded streaming machine == the unsharded
    chain, and every station's burst is found."""
    x_re, x_im = iq_capture(16.0)
    centers = np.asarray(IQ_FREQS) - IQ_TONE
    cfg = DetectionConfig(signal_freq=IQ_TONE, detection_db_over_noise_mean_min=1.0,
                          detection_dur_min_sec=0.5)
    yr, _ = tsh.sharded_channelize_iq(t(x_re), t(x_im), mesh, IQ_FS, centers, **IQ_KW)
    _, ev, _ = tsh.sharded_stream_process(cfg, None, yr, IQ_AUDIO, mesh, front="bins",
                                          impl="fused")
    yr_u, _ = tfir.channelize_iq(t(x_re), t(x_im), IQ_FS, centers, **IQ_KW)
    scfg = tst.StreamConfig.from_config(cfg)
    _, ev_u, _ = tst.stream_process(cfg, tst.stream_init_batch(scfg, 4, device="cpu"), yr_u, IQ_AUDIO,
                                    front="bins", impl="fused")
    assert int(ev_u.count.min()) >= 1, "every station's burst must be found"
    for f in ("count", "time_start", "time_stop"):
        equal(getattr(ev, f), getattr(ev_u, f))


# --- adaptive_thresholds: the scan with a carry ----------------------------------


def scan_series(shape, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal(shape) + offset).astype(np.float32)
    d[..., 60:64] += 9.0
    d[..., 150:153] += 7.0
    return d


def jax_scan(d, **kw):
    """The JAX scan per row (its sharded caller vmaps it per channel)."""
    if d.ndim == 1:
        return jad.adaptive_thresholds(jnp.asarray(d), **kw)
    outs = [jad.adaptive_thresholds(jnp.asarray(row), **{
        k: (tuple(jnp.asarray(np.asarray(a)[c]) for a in v) if k in ("init_carry", "global_stats")
            else v) for k, v in kw.items()}) for c, row in enumerate(d)]
    return (np.stack([np.asarray(o[0]) for o in outs]), np.stack([np.asarray(o[1]) for o in outs]),
            tuple(np.stack([np.asarray(o[2][j]) for o in outs]) for j in range(4)))


def assert_scan_matches(got, want, atol=0.0):
    thr, above, carry = got
    assert thr.dtype == torch.float32 and above.dtype == torch.bool
    close(thr, want[0], rtol=JAX_THR_RTOL, atol=atol)
    equal(above, want[1])
    for j, (a, b) in enumerate(zip(carry, want[2])):
        assert a.shape == np.shape(b)
        if j == 3:
            close(a, b, rtol=JAX_THR_RTOL, atol=atol)
        else:
            equal(a, b)
            assert a.dtype == (torch.float32 if j == 0 else torch.int32)


@pytest.mark.parametrize("shape", [(240,), (3, 240)])
def test_adaptive_thresholds_matches_jax(shape):
    d = scan_series(shape, 1)
    assert_scan_matches(tad.adaptive_thresholds(t(d), **KW), jax_scan(d, **KW))


@pytest.mark.parametrize("shape", [(240,), (3, 240)])
def test_adaptive_thresholds_chunks_carry(shape):
    """Two chunks carried == one pass (bit for bit), with the whole-series
    statistics passed to the chunks; each chunk matches the JAX scan fed
    the same carry."""
    d = scan_series(shape, 2)
    whole = tad.adaptive_thresholds(t(d), **KW)
    stats = (torch.as_tensor(d).mean(-1), torch.as_tensor(d).std(-1, correction=0))
    a = tad.adaptive_thresholds(t(d[..., :100]), **KW, global_stats=stats)
    b = tad.adaptive_thresholds(t(d[..., 100:]), **KW, init_carry=a[2], global_stats=stats)
    close(torch.cat([a[0], b[0]], -1), whole[0])
    equal(torch.cat([a[1], b[1]], -1), whole[1])
    for x, y in zip(b[2], whole[2]):
        close(x, y)
    jkw = dict(KW, init_carry=tuple(x.numpy() for x in a[2]),
               global_stats=tuple(s.numpy() for s in stats))
    if d.ndim == 1:
        jkw = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else v)
               for k, v in jkw.items()}
    assert_scan_matches(b, jax_scan(d[..., 100:], **jkw))


def test_adaptive_thresholds_pre_stream_guard():
    """A warm start at a negative absolute index over a zero halo, with a
    negative fixed threshold: the pre-stream blocks never fire (the port
    and the JAX scan), and the ring slots follow the floor modulo."""
    d = scan_series((2, 120), 3, offset=-8.0)
    d[:, :30] = 0.0  # the zero halo of a shard-0 replay
    w = KW["window_blocks"]
    ring = np.zeros((2, w), np.float32)
    carry = (ring, np.full(2, -30, np.int32), np.full(2, -1, np.int32),
             np.full(2, -7.0, np.float32))
    stats = (np.full(2, -8.0, np.float32), np.full(2, 0.25, np.float32))
    got = tad.adaptive_thresholds(t(d), **KW, init_carry=tuple(t(a) for a in carry),
                                  global_stats=tuple(t(s) for s in stats))
    assert not bool(got[1][:, :30].any()) and bool((t(d[:, :30]) > got[0][:, :30]).all())
    assert torch.equal(got[2][1], torch.full((2,), 90, dtype=torch.int32))
    assert_scan_matches(got, jax_scan(d, **KW, init_carry=carry, global_stats=stats),
                        atol=NEG_JAX_ATOL)
    assert np.array_equal(ring, np.zeros((2, w), np.float32))  # the caller's carry is unchanged


# --- the dryrun ------------------------------------------------


def test_dryrun_multichip_cpu_mesh():
    line = dryrun_multichip(8, devices=["cpu"] * 8)
    assert line.startswith("dryrun_multichip ok: mesh=(2x4), 144000 samples/channel")
    assert "events per channel: [3, 3]" in line
    # the JAX dryrun's three streaming cases (__graft_entry__.py)
    assert "welch:scan ([1, 1] events), bins:hop ([1, 1] events), bins:fused ([1, 1] events)" in line
