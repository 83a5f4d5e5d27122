#!/usr/bin/env python3
"""Make the golden outputs of ``tests/data/golden/`` with the JAX package.

Each configuration of ``tools/golden_fixtures.py`` runs through the JAX
package's entry points on the CPU, in a fresh process with JAX's defaults
(64-bit mode off), and its outputs go to ``<name>.json.gz``
(``tools/golden_compare.py`` holds the format)::

    JAX_PLATFORMS=cpu python tools/make_golden.py            # all of them
    JAX_PLATFORMS=cpu python tools/make_golden.py --only G1_cut,G3
    JAX_PLATFORMS=cpu python tools/make_golden.py --check    # regenerate, compare bytes

``--check`` writes to a temporary directory and exits 1 if any file
differs from the committed one.  The full set takes ~17 minutes on an
8-core CPU (G2's 1 440 live feeds and G5's 720 segments most of it) and up
to 8.5 GB of memory (the 24 h days); ``G1_cut`` takes seconds.

What each file holds (besides the inputs' SHA-256s and the JAX version):

* ``G1`` / ``G1_cut`` -- ``apps.analyze.main`` adaptive and with
  ``--fixed-threshold``: the event CSV and Audacity labels as written, and
  ``proc_wav_file``'s delta and thresholds at the stored blocks.
* ``G2`` -- ``apps.live.main`` with the live arguments: the ``Detected
  Meteor`` lines, the total line and every event's unrounded fields.
* ``G3`` -- ``stream_front_headless`` + the vmapped ``stream_scan`` on the
  64 stations: every station's events, the over-noise series and
  thresholds at the stored blocks.
* ``G4`` -- ``apps.frontend.main``, real and ``--iq``: the station lines
  and the SHA-256 of the capture it synthesized.
* ``G5`` -- ``apps.monitor.main --wav`` over the 6 h day on a fixed audio
  clock: the daily CSVs, the ledger's journal, the offset journal's
  position, the PNG names and each segment's counts.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import golden_compare as gc  # noqa: E402
import golden_fixtures as gf  # noqa: E402


def _header(name: str, **fixture) -> dict:
    import jax
    import numpy as np

    if jax.config.jax_enable_x64 or jax.default_backend() != "cpu":
        raise RuntimeError("the golden outputs are made on the CPU with 64-bit mode off")
    return {"config": name, "jax": jax.__version__, "numpy": np.__version__, "fixture": fixture}


def _analyzer(name: str, day: gf.Day, tmp: str) -> dict:
    """G1 and its cut: the analyzer's CLI, adaptive and fixed."""
    from meteor_scatter_tpu.apps import analyze

    wav = os.path.join(tmp, gf.G1_WAV)
    gf.write_wav(wav, day.fs, day.pcm)
    results = []
    proc = analyze.proc_wav_file

    def recorded(*args, **kw):  # the AnalyzeResult behind main's files
        results.append(proc(*args, **kw))
        return results[-1]

    out = _header(name, hour_sha256=day.hour_sha256, tones=len(day.tones))
    analyze.proc_wav_file = recorded
    try:
        for mode, extra in (("adaptive", []), ("fixed", ["--fixed-threshold"])):
            csv_path, lbl_path = os.path.join(tmp, mode + ".csv"), os.path.join(tmp, mode + ".txt")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = analyze.main([wav, "--out-csv", csv_path, "--out-audacity", lbl_path, *extra])
            if rc != 0:
                raise RuntimeError(f"analyze.main {mode} returned {rc}")
            with open(csv_path) as fc, open(lbl_path) as fl:
                out[mode] = {"csv": fc.read(), "labels": fl.read(),
                             "blocks": gc.block_record(results[-1].delta_power,
                                                       results[-1].thresholds)}
    finally:
        analyze.proc_wav_file = proc
    return out


def make_g1_cut(tmp: str) -> dict:
    return _analyzer("G1_cut", gf.g1_day(first_hours=gf.G1_CUT_HOURS), tmp)


def make_g1(tmp: str) -> dict:
    return _analyzer("G1", gf.g1_day(), tmp)


def make_g2(tmp: str) -> dict:
    """The live CLI over the 24 h 4 kHz day."""
    from meteor_scatter_tpu.apps import live

    day = gf.g2_day()
    wav = os.path.join(tmp, gf.G2_WAV)
    gf.write_wav(wav, day.fs, day.pcm)
    out = _header("G2", hour_sha256=day.hour_sha256, tones=len(day.tones))
    del day
    sessions = []
    process = live.wav_file_process

    def recorded(*args, **kw):  # the events main prints, unrounded
        sessions.append(process(*args, **kw))
        return sessions[-1]

    log = io.StringIO()
    live.wav_file_process = recorded
    try:
        with contextlib.redirect_stdout(log):
            rc = live.main([wav, *gf.G2_ARGS])
    finally:
        live.wav_file_process = process
    if rc != 0:
        raise RuntimeError(f"live.main returned {rc}")
    lines = log.getvalue().splitlines()
    out["lines"] = [ln for ln in lines if ln.startswith("Detected Meteor:")]
    out["total"] = [ln for ln in lines if ln.startswith("Total detected meteors:")]
    out["events"] = [[float(ev[k]) for k in gc.STREAM_FIELDS] for ev in sessions[0]]
    return out


def make_g3(tmp: str) -> dict:
    """The 64 stations: the bins front, then the vmapped scan."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from meteor_scatter_tpu.config import DetectionConfig
    from meteor_scatter_tpu.models.streaming import (StreamConfig, stream_front_headless,
                                                     stream_init_batch, stream_scan)

    x, tones = gf.g3_stations()
    cfg = DetectionConfig(signal_freq=gf.G3_TONE_HZ, detection_db_over_noise_mean_min=1.0,
                          detection_dur_min_sec=0.5)
    scfg = StreamConfig.from_config(cfg)
    block = int(round(gf.BLOCK_SEC * gf.G3_FS))

    @jax.jit
    def run(xb, st):
        on, pm, _ = stream_front_headless(cfg, xb, gf.G3_FS)
        _, ev, thr = jax.vmap(lambda s, o, p: stream_scan(scfg, s, o, p))(st, on, pm)
        return on, ev, thr

    on, ev, thr = run(jnp.asarray(x.reshape(x.shape[0], -1, block)),
                      stream_init_batch(scfg, x.shape[0]))
    f = {k: np.asarray(getattr(ev, k)) for k in gc.STREAM_FIELDS}
    count = np.asarray(ev.count)
    out = _header("G3", station_sha256=gf.station_hashes(x), tones=tones)
    out["events"] = [[[float(f[k][c, i]) for k in gc.STREAM_FIELDS] for i in range(int(count[c]))]
                     for c in range(x.shape[0])]
    out["overflow"] = [bool(v) for v in np.asarray(ev.overflow)]
    out["blocks"] = gc.block_record(on, thr)
    return out


def make_g4(tmp: str) -> dict:
    """The front-end CLI, real and I/Q, on its own synthesized capture."""
    from meteor_scatter_tpu.apps import frontend

    out = _header("G4", argv=gf.G4_ARGV)
    for label, extra, synth_name in (("real", [], "synth_wideband"),
                                     ("iq", ["--iq"], "synth_wideband_iq")):
        synth = getattr(frontend, synth_name)
        hashes = []

        def recorded(*args, **kw):  # the capture main synthesizes, hashed
            made = synth(*args, **kw)
            hashes.extend(gf.sha256(a) for a in made[:-1])
            return made

        log = io.StringIO()
        setattr(frontend, synth_name, recorded)
        try:
            with contextlib.redirect_stdout(log):
                rc = frontend.main([*gf.G4_ARGV, *extra])
        finally:
            setattr(frontend, synth_name, synth)
        if rc != 0:
            raise RuntimeError(f"frontend.main {label} returned {rc}")
        out[label] = {"sha256": hashes,
                      "lines": [ln for ln in log.getvalue().splitlines()
                                if ln.startswith("station ")]}
    return out


def make_g5(tmp: str) -> dict:
    """The monitor CLI over the 6 h day on the fixed audio clock."""
    import jax

    from meteor_scatter_tpu.apps import monitor

    day = gf.g5_day()
    wav = os.path.join(tmp, gf.G5_WAV)
    gf.write_wav(wav, day.fs, day.pcm)
    csv_dir, png_dir = os.path.join(tmp, "csv"), os.path.join(tmp, "png")
    detect = monitor.detect_and_cluster_bursts
    calls = []

    def released(*args, **kw):
        # the image path compiles one more executable every segment; 720 of
        # them exhaust the process's memory maps (LLVM "Cannot allocate
        # memory", then a crash), so the caches go every 100 segments
        calls.append(None)
        if len(calls) % 100 == 0:
            jax.clear_caches()
        return detect(*args, **kw)

    log = io.StringIO()
    monitor.detect_and_cluster_bursts = released
    try:
        with contextlib.redirect_stdout(log):
            rc = monitor.main(["--wav", wav, "--csv-out", csv_dir, "--spec-out", png_dir,
                               "--start-time", gf.G5_START])
    finally:
        monitor.detect_and_cluster_bursts = detect
    if rc != 0:
        raise RuntimeError(f"monitor.main returned {rc}")
    out = _header("G5", hour_sha256=day.hour_sha256, bursts=sum(gf.g5_bursts()))
    out.update(gc.monitor_outputs(csv_dir, png_dir, log.getvalue()))
    return out


MAKERS = {"G1_cut": make_g1_cut, "G1": make_g1, "G2": make_g2, "G3": make_g3, "G4": make_g4,
          "G5": make_g5}


def child(name: str, out_dir: str) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        data = gc.dumps(MAKERS[name](tmp))
    with open(gc.path(name, out_dir), "wb") as fh:
        fh.write(data)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", default=",".join(gc.CONFIGS),
                   help=f"comma-separated subset of {','.join(gc.CONFIGS)}")
    p.add_argument("--check", action="store_true",
                   help="regenerate into a temporary directory and compare byte for byte")
    p.add_argument("--out", default=gc.GOLDEN_DIR)
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child(args.child, args.out)

    names = [n for n in args.only.split(",") if n]
    unknown = sorted(set(names) - set(gc.CONFIGS))
    if unknown:
        p.error(f"unknown configurations {unknown}")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "0"}
    with tempfile.TemporaryDirectory() as scratch:
        out_dir = scratch if args.check else args.out
        os.makedirs(out_dir, exist_ok=True)
        differ = []
        for name in names:
            # a fresh process a configuration: JAX's defaults, memory returned
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name,
                            "--out", out_dir], env=env, check=True)
            if args.check:
                with open(gc.path(name, out_dir), "rb") as a, open(gc.path(name), "rb") as b:
                    same = a.read() == b.read()
                differ += [] if same else [name]
                print(f"{name}: {'identical' if same else 'DIFFERS'}")
            else:
                print(f"{name}: wrote {gc.path(name, out_dir)}")
    if differ:
        print(f"regenerated files differ from the committed ones: {differ}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
