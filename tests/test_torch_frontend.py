"""The wideband/IQ front end of the PyTorch port against the JAX package, on
the CPU.

Synthetic captures are equal bit for bit.  Channel audio agrees within
``REL_TOL`` of its largest magnitude (float32 products summed in another
order, see ``tests/test_torch_fir.py``).  Detection: event count, start,
stop and overflow are equal and ``db_mean`` agrees within ``DB_ATOL``
(the delta series differ by up to ~2e-5 dB).  The at-spec I/Q chain into
the streaming detector (channel bank → bins front → block-rate solve) gives
the JAX chain's events: counts and start/stop times equal, statistics
within ``STAT_ATOL``.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meteor_scatter_tpu.apps import frontend as jfe
from meteor_scatter_tpu.config import DetectionConfig as JDetectionConfig
from meteor_scatter_tpu.models import streaming as jst
from meteor_scatter_tpu.ops import fir as jf
from meteor_scatter_tpu_torch.apps import frontend as tfe
from meteor_scatter_tpu_torch.config import DetectionConfig
from meteor_scatter_tpu_torch.models import adaptive as tad
from meteor_scatter_tpu_torch.models import events as tev
from meteor_scatter_tpu_torch.models import streaming as tst
from meteor_scatter_tpu_torch.ops import fir as tf

from test_torch_events import assert_events_equal
from test_torch_fir import assert_close_rel

REL_TOL = 2e-5
DB_ATOL = 2e-4
# event statistics in dB: the two fronts read audio that differs by float32
# summation order (~4e-7 of its peak); measured up to 1.5e-3 dB on a 40 dB burst
STAT_ATOL = 5e-3
# detect_channels at a short capture: a 2 s fixed start, a 10 s window, a 5 s freeze
DETECT = dict(tone_freq=1000.0, threshold_estimation_window_sec=10.0,
              threshold_fixed_init_sec=2.0, threshold_freeze_after_sec=5.0)
# the three chains of tests/test_frontend.py at 10 s, one burst a station
CHAINS = {
    "integer_decimation": (48_000.0, [10_000.0, 16_000.0], False),  # /8
    "rational_resample": (200_000.0, [50_000.0], False),  # /20, x3/5
    "complex_iq": (48_000.0, [-10_000.0, 16_000.0], True),
}
SECONDS = 10.0


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN included."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def capture(chain):
    fs, stations, iq = CHAINS[chain]
    if iq:
        x, x_im, truth = tfe.synth_wideband_iq(fs, SECONDS, stations, bursts_per_station=1, seed=7)
    else:
        (x, truth), x_im = tfe.synth_wideband(fs, SECONDS, stations, bursts_per_station=1, seed=4), None
    return fs, stations, x, x_im, truth


@pytest.fixture(scope="module", params=list(CHAINS))
def chain(request):
    fs, stations, x, x_im, truth = capture(request.param)
    kw = dict(tone_freq=1000.0, numtaps=257, x_im=x_im)
    audio_t = tfe.iq_frontend(x, fs, stations, device="cpu", **kw)
    audio_j = np.asarray(jfe.iq_frontend(x, fs, stations, **kw))
    return dict(fs=fs, stations=stations, x=x, x_im=x_im, truth=truth, t=audio_t, j=audio_j)


@pytest.mark.parametrize("bursts,seed", [(2, 0), (4, 3)])
def test_synth_bits(bursts, seed):
    args = (48_000.0, 6.0, [-9000.0, 3000.0, 15_000.0], bursts, seed)
    (xt, tt), (xj, tj) = tfe.synth_wideband(*args), jfe.synth_wideband(*args)
    assert tt == tj and np.array_equal(xt.view(np.int32), xj.view(np.int32))
    got, want = tfe.synth_wideband_iq(*args), jfe.synth_wideband_iq(*args)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.float32 and np.array_equal(a.view(np.int32), b.view(np.int32))


def test_iq_frontend_matches_jax(chain):
    assert chain["t"].shape == (len(chain["stations"]), int(SECONDS * 6000))
    assert_close_rel(chain["t"], chain["j"])


def test_iq_frontend_tensor_capture_equals_host_capture(chain):
    """A tensor capture is framed on its device, a numpy one on the host:
    the same bits."""
    x, x_im = chain["x"], chain["x_im"]
    got = tfe.iq_frontend(torch.from_numpy(x), chain["fs"], chain["stations"], tone_freq=1000.0,
                          numtaps=257, x_im=None if x_im is None else torch.from_numpy(x_im))
    assert same_bits(got, chain["t"])


def test_detect_channels_matches_jax(chain):
    """On the same audio, and each package on its own audio (the whole
    slice): equal event lists, every burst found within 0.5 s."""
    for audio_t, audio_j in ((torch.tensor(chain["j"]), chain["j"]), (chain["t"], chain["j"])):
        ev_t, delta_t = tfe.detect_channels(audio_t, **DETECT)
        ev_j, delta_j = jfe.detect_channels(jnp.asarray(audio_j), **DETECT)
        assert delta_t.shape == delta_j.shape == (audio_j.shape[0], int(SECONDS * 5))
        assert np.abs(delta_t.numpy() - np.asarray(delta_j)).max() <= DB_ATOL
        for c in range(audio_j.shape[0]):
            assert_events_equal(tev.Events(*(f[c] for f in ev_t)),
                                jax.tree_util.tree_map(lambda a: a[c], ev_j),
                                db_rtol=0.0, db_atol=DB_ATOL)
    for c, bursts in enumerate(chain["truth"]):
        starts = ev_t.start[c, : int(ev_t.count[c])].numpy() * 0.2
        for t0, _ in bursts:
            assert np.abs(starts - t0).min() < 0.5, (c, t0, starts)


def test_detect_channels_mesh_matches_jax():
    """detect_channels over a 2 x 4 mesh (the fixture of
    tests/test_frontend.py::test_sharded_mesh_path: 32 s, 160 blocks, 40 a
    time shard over a 20-block window) against the JAX package's on its
    8-device mesh, on the same audio, and against the port without a mesh."""
    from meteor_scatter_tpu.parallel.mesh import make_mesh as jmake_mesh
    from meteor_scatter_tpu_torch.parallel.mesh import make_mesh

    fs, stations = 48_000.0, [10_000.0, 16_000.0]
    x, truth = tfe.synth_wideband(fs, 32.0, stations, bursts_per_station=1, seed=4)
    audio = np.array(jfe.iq_frontend(x, fs, stations, tone_freq=1000.0))
    kw = dict(DETECT, threshold_estimation_window_sec=4.0)
    ev_t, delta_t = tfe.detect_channels(torch.from_numpy(audio), **kw,
                                        mesh=make_mesh(2, 4, ["cpu"] * 8))
    ev_j, delta_j = jfe.detect_channels(jnp.asarray(audio), **kw,
                                        mesh=jmake_mesh(n_station=2, n_time=4))
    ev_u, _ = tfe.detect_channels(torch.from_numpy(audio), **kw)
    assert np.abs(delta_t.numpy() - np.asarray(delta_j)).max() <= DB_ATOL
    for c in range(2):
        assert int(ev_t.count[c]) >= 1, f"channel {c} found nothing"
        assert_events_equal(tev.Events(*(f[c] for f in ev_t)),
                            jax.tree_util.tree_map(lambda a: a[c], ev_j),
                            db_rtol=0.0, db_atol=DB_ATOL)
        assert_events_equal(tev.Events(*(f[c] for f in ev_t)),
                            tev.Events(*(f[c] for f in ev_u)), db_rtol=0.0, db_atol=DB_ATOL)


def test_iq_frontend_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tfe.iq_frontend(np.zeros(48_000, np.float32), 48_000.0, [10_000.0])


@pytest.mark.parametrize(
    "kw",
    [
        dict(threshold_std_factor=4.0, window_blocks=50, freeze_blocks_before=15,
             freeze_blocks_after=25, fixed_threshold_blocks=10),
        dict(threshold_std_factor=1.5, window_blocks=300, freeze_blocks_before=3,
             freeze_blocks_after=100, fixed_threshold_blocks=0),
        dict(threshold_std_factor=2.0, window_blocks=40, freeze_blocks_before=5,
             freeze_blocks_after=20, fixed_threshold_blocks=10, max_rounds=2),
    ],
)
def test_batched_adaptive_and_events_equal_rows(kw):
    """The (C, B) solve and event extraction equal the 1-D calls row by row,
    bit for bit, with rows that converge in different rounds."""
    rng = np.random.default_rng(5)
    d = (rng.standard_normal((4, 900)) * 3.0).astype(np.float32)
    for c in range(4):
        for s in rng.integers(10, 890, size=3 * c + 1):
            d[c, s : s + 5] += 30.0
    delta = torch.from_numpy(d)
    thr, above = tad.adaptive_thresholds_parallel(delta, **kw)
    ev = tev.events_from_mask(above, delta, cap=8)
    assert ev.start.shape == (4, 8) and ev.count.shape == (4,) and ev.capacity == 8
    for c in range(4):
        thr_c, above_c = tad.adaptive_thresholds_parallel(delta[c], **kw)
        assert same_bits(thr[c], thr_c) and same_bits(above[c], above_c)
        for f, f_c in zip(ev, tev.events_from_mask(above_c, delta[c], cap=8)):
            assert same_bits(f[c], f_c)


def test_at_spec_iq_chain_matches_jax():
    """BASELINE config 4's chain at a small size: an I/Q capture through the
    pre-framed channel bank, the bins front and the block-rate solve of two
    stations, against the JAX chain with its scan per channel."""
    fs, audio_rate, tone, numtaps, bw = 48_000, 4000, 1000.0, 257, 1500.0
    freqs = [-12_000.0, 7_000.0]
    centers = np.asarray([f - tone for f in freqs])
    x_re, x_im, truth = tfe.synth_wideband_iq(fs, 20.0, freqs, bursts_per_station=2, seed=3)
    decim = fs // audio_rate
    live = dict(signal_freq=tone, detection_db_over_noise_mean_min=1.0, detection_dur_min_sec=0.5)
    cfg_t, cfg_j = DetectionConfig(**live), JDetectionConfig(**live)
    scfg_t, scfg_j = tst.StreamConfig.from_config(cfg_t), jst.StreamConfig.from_config(cfg_j)

    plan, tables = tf.channel_bank_plan(x_re.size, fs, centers, bw, decim, numtaps, device="cpu")
    f = tf.frame_capture_host(np.stack([x_re, x_im]), plan)
    audio, _ = tf.channelize_iq_frames(torch.from_numpy(f), tables, plan)
    flat, _ = tf.channelize_iq(torch.from_numpy(x_re), torch.from_numpy(x_im), fs, centers, bw,
                               decim, numtaps)
    assert same_bits(audio, flat)
    on, pm, _ = tst.stream_front_headless(cfg_t, audio, audio_rate)
    st0 = tst.stream_init_batch(scfg_t, len(freqs), "cpu")
    st_t, ev_t, thr_t = tst.stream_scan(scfg_t, st0, on, pm)
    st_f, ev_f, thr_f = tst.stream_scan_fused_batch(scfg_t, st0, on, pm)
    assert all(same_bits(a, b) for a, b in zip((*st_t, *ev_t, thr_t), (*st_f, *ev_f, thr_f)))

    plan_j, tables_j = jf.channel_bank_plan(x_re.size, fs, centers, bw, decim, numtaps)
    audio_j, _ = jf.channelize_iq_frames(jnp.asarray(f), tables_j, plan_j)
    assert_close_rel(audio, audio_j)
    on_j, pm_j, _ = jst.stream_front_headless(cfg_j, audio_j, audio_rate)
    _, ev_j, _ = jax.vmap(lambda s, o, p: jst.stream_scan(scfg_j, s, o, p))(
        jst.stream_init_batch(scfg_j, len(freqs)), on_j, pm_j)

    np.testing.assert_array_equal(ev_t.count.numpy(), np.asarray(ev_j.count))
    np.testing.assert_array_equal(ev_t.overflow.numpy(), np.asarray(ev_j.overflow))
    for c in range(len(freqs)):
        n = int(ev_t.count[c])
        for name in ("time_start", "time_stop"):
            np.testing.assert_array_equal(getattr(ev_t, name)[c, :n].numpy(),
                                          np.asarray(getattr(ev_j, name))[c, :n])
        for name in ("duration", "db_min", "db_max", "db_mean", "db_std"):
            np.testing.assert_allclose(getattr(ev_t, name)[c, :n].numpy(),
                                       np.asarray(getattr(ev_j, name))[c, :n], rtol=0,
                                       atol=STAT_ATOL, err_msg=name)
        # every burst after the detector's 8 s initial wait is found
        starts = ev_t.time_start[c, :n].numpy()
        for t0, _ in truth[c]:
            if t0 > scfg_t.init_wait_sec:
                assert n and np.abs(starts - t0).min() < 0.5, (c, t0, starts)


def test_main_prints_as_jax():
    """Both CLIs on the same tiny capture print the same lines."""
    argv = ["--fs", "48000", "--stations", "2", "--seconds", "30", "--base-freq", "10000",
            "--spacing", "6000"]
    outs = []
    for main, extra in ((tfe.main, ["--device", "cpu"]), (jfe.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "Channelized to (2, 180000) @ 6 kHz" in outs[0]
