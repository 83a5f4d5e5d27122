"""The port on the CPU against the JAX package's golden outputs.

``tests/data/golden/`` holds what the JAX package (on the CPU, 64-bit mode
off) made of the seeded inputs of ``tools/golden_fixtures.py``
(``tools/make_golden.py``); ``chip_smoke.py`` holds the card against the
full-size files.  Here: every file loads; two hours of the 24 h day rebuild
to their hashes; the port on the CPU equals the golden outputs of the
day's first hour (adaptive on both solvers, and fixed) and of 8 of the 64
stations, within the tolerances ``chip_smoke.py`` names (the analyzer's
dB 1e-4, thresholds 1e-2 dB, event statistics 1e-2 dB); the generator
reproduces the hour's file byte for byte; ``tools/golden_compare.py``
calls a shift far from a tie a fault, one at a near-tie below the gap a
tie, and a changed hash a changed fixture; and neither tool loads JAX.
"""

import csv
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import golden_compare as gc  # noqa: E402
import golden_fixtures as gf  # noqa: E402
from meteor_scatter_tpu_torch.apps import analyze as tan  # noqa: E402
from meteor_scatter_tpu_torch.config import DetectionConfig  # noqa: E402
from meteor_scatter_tpu_torch.models import streaming as tst  # noqa: E402

STATIONS_HERE = 8  # of G3's 64


@pytest.mark.parametrize("name", gc.CONFIGS)
def test_golden_file_loads(name):
    g = gc.load(name)
    assert g["config"] == name and g["jax"].count(".") == 2
    fix = g["fixture"]
    hashes = fix.get("hour_sha256") or fix.get("station_sha256") or (
        g["real"]["sha256"] + g["iq"]["sha256"])
    assert hashes and all(len(h) == 64 and int(h, 16) >= 0 for h in hashes)


@pytest.mark.parametrize("hour", [0, gf.G1_HOURS - 1])
def test_g1_hour_rebuilds_to_its_hash(hour):
    assert gf.sha256(gf.g1_hour(hour)) == gc.load("G1")["fixture"]["hour_sha256"][hour]


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """The day's first hour as a WAV of its own (the gqrx name of G1)."""
    day = gf.g1_day(first_hours=gf.G1_CUT_HOURS)
    path = str(tmp_path_factory.mktemp("cut") / gf.G1_WAV)
    gf.write_wav(path, day.fs, day.pcm)
    return path, day.hour_sha256


@pytest.mark.parametrize("mode,impl", [("adaptive", "parallel"), ("adaptive", "fused"),
                                       ("fixed", "parallel")])
def test_port_cpu_matches_golden_cut(cut, tmp_path, mode, impl):
    """``impl="fused"`` is the card's route (K1's twin here): its event means
    came from the solver's float32 run sums and missed the JAX package's
    by 1.7e-4 dB on this hour, past 1e-4."""
    wav, hashes = cut
    csv_path, lbl_path = str(tmp_path / "ev.csv"), str(tmp_path / "ev.txt")
    res = tan.proc_wav_file(
        wav, out_csv_file=csv_path, out_audacity_lbl_file=lbl_path,
        wav_start_date_time=tan.parse_gqrx_start_time(wav), expected_sample_rate=None,
        flag_adaptive_threshold=mode == "adaptive", impl=impl, device="cpu", verbose=False)
    with open(csv_path) as fc, open(lbl_path) as fl:
        out = gc.compare_analyzer(gc.load("G1_cut"), mode, hashes, fc.read(), fl.read(),
                                  res.delta_power, res.thresholds, cs.ANALYZER_DB_ATOL,
                                  cs.THR_TOL_DB, cs.K2_ATOL[2])
    assert out["identical"] == out["events_jax"] == out["events_card"] >= 70
    assert out["ties"] == []


def test_port_cpu_matches_golden_stations():
    """G3's first 8 stations: the bins front and the scan (K3's twin)."""
    golden = gc.load("G3")
    x_np, _ = gf.g3_stations(STATIONS_HERE)
    cfg = DetectionConfig(signal_freq=gf.G3_TONE_HZ, detection_db_over_noise_mean_min=1.0,
                          detection_dur_min_sec=0.5)
    scfg = tst.StreamConfig.from_config(cfg)
    block = int(round(gf.BLOCK_SEC * gf.G3_FS))
    x = torch.from_numpy(x_np.reshape(STATIONS_HERE, -1, block))
    on, pm, _ = tst.stream_front_headless(cfg, x, gf.G3_FS)
    _, ev, thr = tst.stream_scan(scfg, tst.stream_init_batch(scfg, STATIONS_HERE, device="cpu"),
                                 on, pm)
    f = [getattr(ev, k).numpy() for k in gc.STREAM_FIELDS]
    events = [[[float(a[c, i]) for a in f] for i in range(int(ev.count[c]))]
              for c in range(STATIONS_HERE)]
    out = gc.compare_stations(golden, gf.station_hashes(x_np), events, ev.overflow.tolist(),
                              on.numpy(), thr.numpy(), cs.EVENT_DB_TOL, cs.DURATION_TOL,
                              cs.THR_TOL_DB)
    assert out["identical"] == out["events_jax"] == out["events_card"] >= STATIONS_HERE
    assert out["ties"] == []


def test_make_golden_check_reproduces_the_cut():
    """The generator, in a fresh process as it runs, gives the committed
    file of the first hour byte for byte."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_golden.py"), "--check",
                        "--only", "G1_cut"], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "G1_cut: identical" in r.stdout


def _shifted_stop(golden_mode: dict, k: int, blocks: int):
    """The golden CSV and labels with event ``k``'s stop moved by
    ``blocks``, as the analyzer would write them; and that block."""
    rows = list(csv.DictReader(io.StringIO(golden_mode["csv"])))
    b = int(round(float(rows[k]["t_stop"]) / 0.2))
    t0, t1 = float(rows[k]["t_start"]), (b + blocks) * 0.2
    rows[k].update(t_stop=repr(t1), dur_s=repr(t1 - t0))
    out = io.StringIO()
    w = csv.DictWriter(out, fieldnames=list(rows[0]), lineterminator="\n")
    w.writeheader()
    w.writerows(rows)
    labels = "".join(f"{float(r['t_start']):.2f}\t{float(r['t_stop']):.2f}\tM\n" for r in rows)
    return out.getvalue(), labels, b


def _sampled_run(record: dict, gap_part: float):
    """Per-block delta and thresholds that differ from the golden output's
    by ``gap_part`` dB each at the sampled blocks."""
    n, step = record["n"], record["sample_every"]
    d, t = np.zeros(n), np.zeros(n)
    d[::step] = np.asarray(record["delta"]) + gap_part
    t[::step] = np.asarray(record["thr"]) - gap_part
    return d, t


def test_compare_calls_a_shift_far_from_a_tie_a_fault():
    golden = gc.load("G1_cut")
    text, labels, b = _shifted_stop(golden["adaptive"], 5, 1)
    assert b not in gc.margins(golden["adaptive"]["blocks"])
    d, t = _sampled_run(golden["adaptive"]["blocks"], 1e-4)
    with pytest.raises(gc.GoldenMismatch, match="not a near-tie"):
        gc.compare_analyzer(golden, "adaptive", golden["fixture"]["hour_sha256"], text, labels,
                            d, t, cs.ANALYZER_DB_ATOL, cs.THR_TOL_DB, cs.K2_ATOL[2])


def test_compare_calls_a_shift_at_a_near_tie_a_tie():
    golden = gc.load("G1_cut")
    text, labels, b = _shifted_stop(golden["adaptive"], 5, 1)
    rec = golden["adaptive"]["blocks"]
    # the golden output with block b stored as a near-tie, 1e-5 dB from its
    # threshold: below the gap of 2e-4 that the sampled blocks show
    rec["near_ties"] = sorted(rec["near_ties"] + [[b, 3.0, 3.0 - 1e-5]])
    d, t = _sampled_run(rec, 1e-4)
    out = gc.compare_analyzer(golden, "adaptive", golden["fixture"]["hour_sha256"], text, labels,
                              d, t, cs.ANALYZER_DB_ATOL, cs.THR_TOL_DB, cs.K2_ATOL[2])
    assert [(x["block"], x["blocks"]) for x in out["ties"]] == [(b, 1)]
    assert out["ties"][0]["margin"] < out["gap"]
    assert out["identical"] == out["events_jax"] - 1


def test_compare_checks_the_fixture_hash_first():
    golden = gc.load("G1_cut")
    hashes = list(golden["fixture"]["hour_sha256"])
    hashes[0] = "0" * 64
    with pytest.raises(gc.FixtureDiffers, match="fixture differs"):
        # no event, delta or threshold: nothing past the hashes is read
        gc.compare_analyzer(golden, "adaptive", hashes, "", "", None, None, 0.0, 0.0, 0.0)


def test_golden_tools_load_no_jax():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        sys.path.insert(0, sys.argv[1])
        import golden_compare as gc, golden_fixtures as gf
        x, tones = gf.g3_stations(1)
        assert gf.station_hashes(x) == gc.load("G3")["fixture"]["station_sha256"][:1]
        assert gf.k1_seam_blocks(432000) == [130472, 260944, 391416]
        bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "torch", "meteor_scatter_tpu",
                                                            "meteor_scatter_tpu_torch")
               and sys.modules[k] is not None]
        assert not bad, bad
        """
    )
    r = subprocess.run([sys.executable, "-c", code, os.path.join(ROOT, "tools")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
