"""The streaming CLI of the PyTorch port against the JAX package, on the CPU.

One 90 s, 4 kHz int16 WAV with three 1000 Hz bursts goes through both
packages' ``main`` and ``wav_file_process``, with the Welch front and the
headless (bins) front.  Event start / stop / duration lines are equal;
start and stop times are exactly equal, durations agree to 1e-5 (XLA may
contract ``i·bs − t0`` into an FMA), and the events' dB statistics agree to
``DB_ATOL``, since the two frameworks' float32 spectra and window sums
round in different orders.
"""

import re

import numpy as np
import pytest
import torch

from meteor_scatter_tpu.apps import live as jlive
from meteor_scatter_tpu.config import DetectionConfig as JDetectionConfig
from meteor_scatter_tpu_torch.apps import live as tlive
from meteor_scatter_tpu_torch.config import DetectionConfig, VisualizationConfig
from meteor_scatter_tpu_torch.io import wavio as twav

from test_streaming_headless import make_audio

DB_ATOL = 1e-3
FS = 4000
ARGS = ["--min-dur", "0.5", "--min-mean-db", "1"]
LIVE = dict(signal_freq=1000.0, detection_db_over_noise_mean_min=1.0, detection_dur_min_sec=0.5)
EXTENT = re.compile(r"^Detected Meteor: (start=\S+ stop=\S+ dur=\S+)", re.M)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("live") / "burst_4khz.wav")
    x = np.clip(np.round(make_audio(FS) * 32768.0), -32768, 32767).astype(np.int16)
    twav.write_wav(path, FS, x)
    return path


@pytest.mark.parametrize("headless", [False, True])
def test_main_matches_jax(wav, capsys, headless):
    extra = ["--headless"] if headless else []
    assert tlive.main([wav, "--device", "cpu", *ARGS, *extra]) == 0
    out_t = capsys.readouterr().out
    assert jlive.main([wav, *ARGS, *extra]) == 0
    out_j = capsys.readouterr().out
    assert EXTENT.findall(out_t) == EXTENT.findall(out_j)
    assert len(EXTENT.findall(out_t)) >= 3
    total = re.compile(r"^Total detected meteors: \d+$", re.M)
    assert total.findall(out_t) == total.findall(out_j)


@pytest.mark.parametrize("headless", [False, True])
def test_wav_file_process_matches_jax(wav, capsys, headless):
    ev_t = tlive.wav_file_process(wav, DetectionConfig(**LIVE), expected_sample_rate=FS,
                                  headless=headless, device="cpu")
    ev_j = jlive.wav_file_process(wav, JDetectionConfig(**LIVE), expected_sample_rate=FS,
                                  headless=headless)
    capsys.readouterr()
    assert len(ev_t) == len(ev_j) >= 3
    for a, b in zip(ev_t, ev_j):
        assert set(a) == set(b)
        for key in ("time_start", "time_stop"):
            assert a[key] == b[key], key
        # XLA may contract i*bs - t0 into an FMA: one ulp (tests/test_streaming_jump.py)
        assert a["duration"] == pytest.approx(b["duration"], rel=1e-5, abs=1e-5)
        for key in ("db_min", "db_max", "db_mean", "db_std"):
            assert abs(a[key] - b[key]) <= DB_ATOL, key


def test_chunking_and_impls_agree(wav, capsys):
    """Feeds of 5 s and of 60 s, and the scan and the fused twin, give the
    same events bit for bit."""
    kw = dict(expected_sample_rate=FS, device="cpu")
    base = tlive.wav_file_process(wav, DetectionConfig(**LIVE), impl="scan", **kw)
    assert tlive.wav_file_process(wav, DetectionConfig(**LIVE), impl="fused", **kw) == base
    assert tlive.wav_file_process(wav, DetectionConfig(**LIVE), chunk_sec=5.0, **kw) == base
    capsys.readouterr()


@pytest.mark.parametrize(
    "extra,match",
    [
        (["--ui"], "--ui"),
        (["--spec-export-dir", "spec"], "--spec-export-dir"),
        (["--impl", "jump"], "jump"),
        (["--impl", "hop"], "hop"),
    ],
)
def test_unported_options_raise(wav, tmp_path, extra, match):
    extra = [str(tmp_path / a) if a == "spec" else a for a in extra]
    with pytest.raises(NotImplementedError, match=f"{match}.*not yet ported"):
        tlive.main([wav, "--device", "cpu", *extra])
    assert not (tmp_path / "spec").exists()


def test_session_rejects_ui_and_export_and_missing_gpu(monkeypatch):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tlive.LiveSession(DetectionConfig(), FS, vis=VisualizationConfig(enable_ui_plots=True),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tlive.LiveSession(DetectionConfig(), FS, spec=tlive.SpecExportConfig(output_dir="x"),
                          device="cpu")
    with pytest.raises(SystemExit):  # argparse error, as in the reference CLI
        tlive.main(["x.wav", "--headless", "--ui"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tlive.LiveSession(DetectionConfig(), FS)


def test_sample_rate_check_and_short_feed(wav):
    with pytest.raises(ValueError, match="Sample Rate"):
        tlive.wav_file_process(wav, DetectionConfig(**LIVE), expected_sample_rate=6000,
                               device="cpu")
    sess = tlive.LiveSession(DetectionConfig(**LIVE), FS, device="cpu")
    assert sess.feed(np.zeros(799, np.float32)) == []  # shorter than one block
    assert int(sess.state.block_idx) == 0
