"""The wideband I/Q front end of the PyTorch port against the benchmark's
plain float64 reference (``bench_h100/reference/channelizer.py``), on the
CPU, without JAX: a seeded capture of 4 channels at 250 kHz for 20 s, which
takes the same two stages as 2 MS/s (/25 → 10 kHz → ×3/5 → 6 kHz), the
detector's window cut to 5 s.

Tolerances, each with its reason:

* ``AUDIO_TOL``: the channel audio agrees within this share of its largest
  magnitude.  The port's float32 products (513 taps split over 21 columns,
  then the row rotation and the resampler) read 4.4e-7 against float64
  here (3.4e-7 with I and Q as two planar tensors); float32 alone allows
  ~1e-5 (``tests/test_fir.py`` holds the JAX package to it).  The capture
  is interleaved I/Q, so the bank reads it in place.  The benchmark's two
  faults of the bank's product read past the tolerance: TF32 operands
  1.9e-4, a dropped rotation term 0.36.
* ``DB_TOL``: the detection series and the thresholds, in dB.  They read
  6.3e-6 and 7.8e-6 here (6.9e-6 and 9.5e-6 with planar I and Q); with
  the TF32 bank the series reads 5.7e-3 (the error is broadband, but its
  cross term with the band's noise is not averaged away).
* ``EVENT_DB_TOL``: the events' mean dB, a mean of the series over the
  event (2.3e-6 here).  Events themselves (first and last block) are equal.

The bank's plan is kept per key: a hit returns the very tensors of the
miss, equal bit for bit to a fresh build, and a change of any key misses.
Under a CPU profiler the spans of the two entries nest as named.
"""

import json
import math

import numpy as np
import pytest
import scipy.signal
import torch
from torch.profiler import ProfilerActivity, profile

from bench_h100.drivers.iq_captures import iq_capture
from bench_h100.reference import channelizer, detectors, fronts
from meteor_scatter_tpu_torch.apps import frontend
from meteor_scatter_tpu_torch.models.adaptive import adaptive_thresholds_parallel
from meteor_scatter_tpu_torch.ops import fir

FS, STATIONS, SPACING, SECONDS = 250_000, 4, 50_000.0, 20.0
FRONT = dict(audio_rate=6000, tone_freq=1003.0, channel_bandwidth=2500.0, numtaps=513)
DETECT = dict(threshold_estimation_window_sec=5.0, threshold_fixed_init_sec=2.0,
              threshold_freeze_after_sec=5.0)
BLOCK_SEC, K = 0.2, 4.0
SIGNAL = dict(noise_rms=1.0, echoes_per_hour=720, doppler_hz=4.0, duration_s=[0.5, 3.0],
              peak_over_noise=[1.0, 5.0])
AUDIO_TOL = 1e-5
DB_TOL = 2e-4
EVENT_DB_TOL = 2e-4


@pytest.fixture(scope="module")
def capture():
    x = torch.empty((int(FS * SECONDS), 2), dtype=torch.float32)
    freqs = channelizer.iq_station_freqs(STATIONS, SPACING)
    iq_capture(2 ** 36 + 11, 5, x.shape[0], FS, freqs, SIGNAL, FRONT["channel_bandwidth"], x)
    return x


def _blocks():
    bd = BLOCK_SEC
    return (int(DETECT["threshold_estimation_window_sec"] / bd), int(3.0 / bd),
            int(DETECT["threshold_freeze_after_sec"] / bd),
            int(DETECT["threshold_fixed_init_sec"] / bd))


@pytest.fixture(scope="module")
def reference(capture):
    """Per channel: audio, detection series and the detector's result."""
    audio = channelizer.iq_audio(capture, FS, channelizer.iq_station_freqs(STATIONS, SPACING),
                                 **FRONT)
    block = int(FRONT["audio_rate"] * BLOCK_SEC)
    tone = FRONT["tone_freq"]
    bands = [(tone - 10.0, tone + 10.0), (690.0, 710.0)]
    out = []
    for c in range(STATIONS):
        sig, noise = fronts.batch_band_db(audio[c], FRONT["audio_rate"], 1024, block, bands)
        delta = sig - noise
        out.append((delta, detectors.adaptive_detect(delta, K, *_blocks(), tie_db=1e-3)))
    return audio.numpy(), out


def _tf32_bank(orig):
    def bank(f, hh, *rest):
        return orig(fronts.tf32_round(f), fronts.tf32_round(hh), *rest)
    return bank


def _dropped_rotation_term(orig):
    """The bank without its middle tap column: one term of the rotation's sum."""
    def bank(f, hh, cr, sr, c_n, a_cols, n_out):
        cut = hh.clone().view(hh.shape[0], 2, c_n, a_cols)
        cut[..., a_cols // 2] = 0.0
        return orig(f, cut.view(hh.shape), cr, sr, c_n, a_cols, n_out)
    return bank


def _entries(capture):
    """The front end's two entries, as its CLI composes them."""
    freqs = frontend.station_freqs(STATIONS, 0.0, SPACING, iq=True)
    audio = frontend.iq_frontend(capture[:, 0], FS, freqs, x_im=capture[:, 1], device="cpu",
                                 **FRONT)
    return (audio, *frontend.detect_channels(audio, **DETECT))


def _port(capture):
    """Audio, events, series and the thresholds the detector takes from the series."""
    audio, events, delta = _entries(capture)
    thr, _ = adaptive_thresholds_parallel(delta, K, *_blocks())
    return audio.numpy(), events, delta.numpy(), thr.numpy()


@pytest.fixture(scope="module")
def sound(capture):
    return _port(capture)


@pytest.fixture(scope="module")
def tf32(capture):
    """The port's answers with the bank product's operands rounded to TF32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fir, "_bank_apply", _tf32_bank(fir._bank_apply))
        return _port(capture)


@pytest.fixture(scope="module")
def dropped_term(capture):
    """The port's audio with the bank's middle tap column dropped."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fir, "_bank_apply", _dropped_rotation_term(fir._bank_apply))
        return (_entries(capture)[0].numpy(),)


def _audio_gap(port, reference):
    got, want = port[0], reference[0]
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _series_gaps(port, reference):
    _, _, delta, thr = port
    return (max(np.abs(delta[c] - d).max() for c, (d, _) in enumerate(reference[1])),
            max(np.abs(thr[c] - r.thresholds).max() for c, (_, r) in enumerate(reference[1])))


def test_audio_matches_reference(sound, reference):
    assert _audio_gap(sound, reference) <= AUDIO_TOL


def test_series_and_thresholds_match_reference(sound, reference):
    front, thr = _series_gaps(sound, reference)
    assert front <= DB_TOL and thr <= DB_TOL


def test_events_match_reference(sound, reference):
    ev = sound[1]
    total = 0
    for c, (_, r) in enumerate(reference[1]):
        assert not r.ties.size, "a tie would excuse events; the seed has none"
        n = int(ev.count[c])
        assert not bool(ev.overflow[c])
        got = [(int(ev.start[c, i]), int(ev.stop[c, i])) for i in range(n)]
        assert got == [(s, e) for s, e, _ in r.events]
        for i, (_, _, mean) in enumerate(r.events):
            assert abs(float(ev.db_mean[c, i]) - mean) <= EVENT_DB_TOL
        total += n
    assert total >= STATIONS  # the capture's echoes are found


@pytest.mark.parametrize("compared", ["audio", "series"])
def test_tf32_bank_fails_the_same_tests(tf32, reference, capture, compared):
    assert fir.is_interleaved_iq(capture[:, 0], capture[:, 1])  # the bank's in-place route
    if compared == "audio":
        assert _audio_gap(tf32, reference) > AUDIO_TOL
    else:
        assert _series_gaps(tf32, reference)[0] > DB_TOL


def test_dropped_rotation_term_fails_the_audio(dropped_term, reference, capture):
    assert fir.is_interleaved_iq(capture[:, 0], capture[:, 1])
    assert _audio_gap(dropped_term, reference) > AUDIO_TOL


def test_reference_designs_are_scipys():
    for numtaps, cutoff, fs in [(513, 1250.0, 2e6), (201, 0.2, 2.0), (97, 400.0, 48_000.0)]:
        want = scipy.signal.firwin(numtaps, cutoff, window="hamming", fs=fs)
        np.testing.assert_allclose(channelizer.lowpass(numtaps, cutoff, fs), want, rtol=1e-12,
                                   atol=1e-15)
    y = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 10_001)))
    taps = channelizer.lowpass(201, 0.2, 2.0)
    want = scipy.signal.resample_poly(y.numpy(), 3, 5, axis=-1, window=taps)
    np.testing.assert_allclose(channelizer.resample(y, 3, 5).numpy(), want, atol=1e-12)


def test_channel_stage_is_its_definition(monkeypatch):
    """Steps 1-4 in blocks (forced small) against one complex128 numpy
    convolution of the whole capture."""
    monkeypatch.setattr(channelizer, "BLOCK_BYTES", 3000 * 8)
    fs, n, decim, numtaps = 48_000, 4_003, 8, 97
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    centers = [-7_001, 1_000, 12_345]
    got = channelizer.channel_audio(torch.from_numpy(x), fs, centers, 1500.0, decim, numtaps)
    h = channelizer.lowpass(numtaps, 750.0, fs)
    s = np.arange(n, dtype=np.int64)
    for c, f in enumerate(centers):
        z = (x[:, 0] + 1j * x[:, 1]) * np.exp(-2j * math.pi * ((s * f) % fs) / fs)
        y = np.convolve(z, h)[(numtaps - 1) // 2:][:n:decim].real
        np.testing.assert_allclose(got[c].numpy(), y, atol=1e-12)


def _plan_args(**change):
    args = dict(n=20_001, fs=2_000_000, center_freqs=np.array([-201_003, 48_997]),
                bandwidth=2500.0, decim=200, numtaps=513, device="cpu")
    args.update(change)
    return args


def test_bank_plan_hit_is_a_fresh_build_bit_for_bit():
    fir._bank_plan_on.cache_clear()
    plan, tables = fir.channel_bank_plan(**_plan_args())
    plan["n"] = 0  # the caller's copy: the kept plan is not changed
    plan, tables2 = fir.channel_bank_plan(**_plan_args())
    assert fir._bank_plan_on.cache_info().hits == 1
    assert all(a is b for a, b in zip(tables, tables2)) and plan["n"] == 20_001
    fir._bank_plan_on.cache_clear()
    fresh_plan, fresh = fir.channel_bank_plan(**_plan_args())
    assert fresh_plan == plan
    for a, b in zip(tables, fresh):
        assert a is not b and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("change", [dict(n=20_002), dict(fs=1_000_000),
                                    dict(center_freqs=np.array([-201_003, 48_998])),
                                    dict(bandwidth=2000.0), dict(decim=100), dict(numtaps=511)],
                         ids=lambda d: next(iter(d)))
def test_bank_plan_key_change_misses(change):
    fir._bank_plan_on.cache_clear()
    plan, tables = fir.channel_bank_plan(**_plan_args())
    other_plan, other = fir.channel_bank_plan(**_plan_args(**change))
    assert fir._bank_plan_on.cache_info().misses == 2
    assert other_plan != plan or any(a.shape != b.shape or not torch.equal(a, b)
                                     for a, b in zip(tables, other))


SPANS = {"iq_frontend", "bank_plan", "channelize", "bank_in_place", "resample", "detect_channels",
         "band_power", "wait.constant_upload", "detect", "wait.fixpoint_round", "events"}
NESTING = [("bank_plan", "iq_frontend"), ("channelize", "iq_frontend"),
           ("bank_in_place", "channelize"),
           ("resample", "iq_frontend"), ("band_power", "detect_channels"),
           ("wait.constant_upload", "band_power"), ("detect", "detect_channels"),
           ("wait.fixpoint_round", "detect"), ("events", "detect_channels")]


def _spans(capture, path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _entries(capture)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and e["name"].startswith("ms.")]


def _within(e, outer):
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_spans_nest_as_named(capture, tmp_path):
    fir._bank_plan_on.cache_clear()
    miss = _spans(capture, str(tmp_path / "miss.json"))
    by = {}
    for e in miss:
        by.setdefault(e["name"][3:], []).append(e)
    assert set(by) == SPANS
    assert len(by["iq_frontend"]) == len(by["detect_channels"]) == len(by["bank_in_place"]) == 1
    for child, parent in NESTING:
        assert all(any(_within(e, p) for p in by[parent]) for e in by[child]), (child, parent)
    assert not any(_within(by["bank_plan"][0], p) for p in by["channelize"])
    hit = {e["name"][3:] for e in _spans(capture, str(tmp_path / "hit.json"))}
    assert hit == SPANS - {"bank_plan"}
