"""The golden outputs' format and the comparison of a run against them.

``tools/make_golden.py`` runs the JAX package on the CPU over the seeded
inputs of ``tools/golden_fixtures.py`` and writes one gzip'd JSON file per
configuration to ``tests/data/golden/``.  ``chip_smoke.py`` runs the
PyTorch port on the same inputs on the card and holds its outputs against
those files with the functions here; ``tests/test_torch_golden.py`` does
the same on the CPU.  numpy and the standard library only.

A comparison first checks the inputs' hashes (:func:`check_fixture`: a
mismatch means the fixture differs, and nothing else is compared).  Then:

* what must be identical is compared exactly: event starts, stops and
  durations, UTC columns, label files, printed lines, ledgers;
* floats are held to the tolerance the caller names;
* every difference in an event list is classified (:func:`classify`).  A
  run of blocks where the two above-masks differ is a **tie** when its
  first block (the block whose decision differs) is a near-tie block of
  the golden output, ``|delta - thr| < NEAR_TIE_DB``, whose margin is below
  the gap measured on the sampled blocks (the largest ``|delta|``
  difference plus the largest ``|thr|`` difference: by at most that much
  the two runs can disagree on a block's side of the threshold).
  Anything else is a **fault**.
"""

from __future__ import annotations

import collections
import csv
import gzip
import io
import json
import os
import re
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tests", "data", "golden")
CONFIGS = ("G1_cut", "G1", "G2", "G3", "G4", "G5")
# every SAMPLE_EVERY-th block's delta and threshold is stored; blocks within
# NEAR_TIE_DB of their threshold are stored with their index
SAMPLE_EVERY = 97
NEAR_TIE_DB = 1e-2
EXACT_CSV_KEYS = ("t_start", "t_stop", "dur_s", "utc_start", "utc_stop")
LIVE_LINE = re.compile(
    r"^Detected Meteor: start=(\S+)s stop=(\S+)s dur=(\S+)s dB mean=(\S+) min=(\S+) max=(\S+) "
    r"std=(\S+) // total (\d+)$")
# the unrounded fields of a live or stations event, in StreamEvents' order
STREAM_FIELDS = ("time_start", "time_stop", "duration", "db_min", "db_max", "db_mean", "db_std")
# the printed order of LIVE_LINE's dB fields, as indices into STREAM_FIELDS
LIVE_DB_FIELDS = (5, 3, 4, 6)


class FixtureDiffers(AssertionError):
    """The input was not the one the golden output was made from."""


class GoldenMismatch(AssertionError):
    """A fault: a difference that is not a proven tie, or a value out of
    tolerance."""


def path(name: str, root: str = GOLDEN_DIR) -> str:
    return os.path.join(root, f"{name}.json.gz")


def dumps(obj: dict) -> bytes:
    """The file's bytes: sorted compact JSON, gzip'd without a timestamp,
    so the same content gives the same bytes."""
    text = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return gzip.compress(text.encode(), compresslevel=9, mtime=0)


def load(name: str, root: str = GOLDEN_DIR) -> dict:
    with open(path(name, root), "rb") as fh:
        return json.loads(gzip.decompress(fh.read()))


def floats(a) -> List[float]:
    """An array as a list of Python floats (float32 values exactly)."""
    return [float(v) for v in np.asarray(a).reshape(-1)]


def check_fixture(want: Sequence[str], got: Sequence[str], what: str) -> int:
    """The inputs' SHA-256s, in order.  Returns how many matched; raises
    :class:`FixtureDiffers` naming the first that did not."""
    if len(want) != len(got):
        raise FixtureDiffers(f"{what}: {len(got)} hashes, the golden output has {len(want)}")
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            raise FixtureDiffers(f"{what}: fixture differs at part {i} ({g[:12]} != {w[:12]}); "
                                 "no event was compared")
    return len(want)


def block_record(delta, thr) -> dict:
    """The stored blocks of a (delta, thr) pair, flattened in C order:
    every SAMPLE_EVERY-th value of each, and every near-tie block as
    [index, delta, thr]."""
    d = np.asarray(delta, np.float32).reshape(-1)
    t = np.asarray(thr, np.float32).reshape(-1)
    near = np.flatnonzero(np.abs(d.astype(np.float64) - t) < NEAR_TIE_DB)
    return {"n": int(d.size), "sample_every": SAMPLE_EVERY, "delta": floats(d[::SAMPLE_EVERY]),
            "thr": floats(t[::SAMPLE_EVERY]),
            "near_ties": [[int(i), float(d[i]), float(t[i])] for i in near]}


def _max_diff(a: np.ndarray, b: np.ndarray) -> float:
    """The largest |a - b|, where a NaN or an infinity on both sides at one
    place (a threshold not yet defined) is no difference."""
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return float(np.abs(np.where(same, 0.0, a - b)).max()) if a.size else 0.0


def block_gaps(record: dict, delta, thr) -> dict:
    """The run's delta and thresholds against the golden output's at the
    sampled blocks: the largest differences and the gap they make."""
    step = record["sample_every"]
    d = np.asarray(delta, np.float64).reshape(-1)
    t = np.asarray(thr, np.float64).reshape(-1)
    if d.size != record["n"] or t.size != record["n"]:
        raise GoldenMismatch(f"{d.size} / {t.size} blocks, the golden output has {record['n']}")
    dd = _max_diff(d[::step], np.asarray(record["delta"], np.float64))
    dt = _max_diff(t[::step], np.asarray(record["thr"], np.float64))
    return {"max_abs_ddelta": dd, "max_abs_dthr": dt, "gap": dd + dt}


def compare_sampled_delta(record: dict, delta, tol: float) -> dict:
    """Another computation of a record's delta series (K2's band power)
    against the golden output's at the sampled blocks, within ``tol``."""
    d = np.asarray(delta, np.float64).reshape(-1)
    if d.size != record["n"]:
        raise GoldenMismatch(f"{d.size} blocks, the golden output has {record['n']}")
    dd = _max_diff(d[::record["sample_every"]], np.asarray(record["delta"], np.float64))
    return _raise_faults([] if dd <= tol else [{"why": f"delta differs by {dd} > {tol}"}],
                         {"sampled_blocks": len(record["delta"]), "max_abs_ddelta": dd})


def margins(record: dict) -> Dict[int, float]:
    """Near-tie block index -> golden margin |delta - thr|."""
    return {i: abs(d - t) for i, d, t in record["near_ties"]}


def intervals_mask(iv: Iterable[Tuple[int, int]], n: int) -> np.ndarray:
    m = np.zeros(n, bool)
    for a, b in iv:
        m[a:b] = True
    return m


def classify(gold: Sequence[Tuple[int, int]], got: Sequence[Tuple[int, int]], n: int,
             near: Dict[int, float], gap: float, offset: int = 0) -> Tuple[list, list]:
    """Event intervals [start, stop) in blocks, golden and run, over ``n``
    blocks.  Returns (ties, faults): each run of blocks where the two masks
    differ is a tie when its first block (``+ offset`` in ``near``'s
    numbering) is a near-tie whose margin is below ``gap``, else a fault.
    Equal masks with unequal lists (a run split or merged) are a fault."""
    gold, got = [tuple(map(int, e)) for e in gold], [tuple(map(int, e)) for e in got]
    if gold == got:
        return [], []
    diff = intervals_mask(gold, n) ^ intervals_mask(got, n)
    if not diff.any():
        first = next(i for i, (a, b) in enumerate(zip(gold, got)) if a != b) if len(gold) == len(
            got) else min(len(gold), len(got))
        return [], [{"block": None, "why": f"the same blocks, events split or merged at event "
                                           f"{first}"}]
    edges = np.flatnonzero(np.diff(np.concatenate([[0], diff.view(np.int8), [0]])))
    ties, faults = [], []
    for a, b in zip(edges[::2], edges[1::2]):
        k = int(a) + offset
        m = near.get(k)
        rec = {"block": k, "blocks": int(b - a)}
        if m is not None and m < gap:
            ties.append({**rec, "margin": m})
        else:
            faults.append({**rec, "margin": m, "why": "not a near-tie" if m is None
                           else f"margin {m} not below the gap {gap}"})
    return ties, faults


def _csv_rows(text: str) -> List[dict]:
    return list(csv.DictReader(io.StringIO(text)))


def _blocks(t: str, block_sec: float) -> int:
    return int(round(float(t) / block_sec))


def _raise_faults(faults: list, out: dict) -> dict:
    if faults:
        raise GoldenMismatch(f"{len(faults)} fault(s), first {faults[:3]}; {out}")
    return out


def compare_analyzer(golden: dict, mode: str, hashes: Sequence[str], csv_text: str,
                     labels_text: str, delta, thr, db_tol: float, thr_tol: float,
                     delta_tol: float, block_sec: float = 0.2) -> dict:
    """G1 or its cut, one ``mode`` ("adaptive" or "fixed"): the run's hour
    hashes, event CSV, Audacity labels and per-block delta and thresholds
    against the golden output's.  Raises :class:`FixtureDiffers` before
    anything else is compared, :class:`GoldenMismatch` on a fault; returns
    the comparison's numbers."""
    matched = check_fixture(golden["fixture"]["hour_sha256"], hashes, golden["config"])
    gold = golden[mode]
    rec = gold["blocks"]
    gaps = block_gaps(rec, delta, thr)
    rows_g, rows_c = _csv_rows(gold["csv"]), _csv_rows(csv_text)
    key = lambda r: tuple(r[k] for k in EXACT_CSV_KEYS)  # noqa: E731
    span = lambda r: (_blocks(r["t_start"], block_sec), _blocks(r["t_stop"], block_sec))  # noqa: E731
    ties, faults = classify([span(r) for r in rows_g], [span(r) for r in rows_c], rec["n"],
                            margins(rec), gaps["gap"])
    identical = sum((collections.Counter(map(key, rows_g))
                     & collections.Counter(map(key, rows_c))).values())
    if not ties and not faults and identical != len(rows_g):
        faults.append({"block": None, "why": f"{len(rows_g) - identical} rows differ in "
                                             f"{EXACT_CSV_KEYS} over the same blocks"})
    by_key = {key(r): float(r["dB"]) for r in rows_g}
    db_err = max((abs(float(r["dB"]) - by_key[key(r)]) for r in rows_c if key(r) in by_key),
                 default=0.0)
    # the labels: byte for byte, but for the lines of tie-moved events
    if not ties and labels_text != gold["labels"]:
        faults.append({"block": None, "why": "Audacity labels differ"})
    elif ties:
        lg = collections.Counter(gold["labels"].splitlines())
        lc = collections.Counter(labels_text.splitlines())
        tie_blocks = [(t["block"], t["block"] + t["blocks"]) for t in ties]
        for line in (lg - lc) + (lc - lg):
            a, b = (_blocks(v, block_sec) for v in line.split("\t")[:2])
            if not any(a <= hi and lo <= b for lo, hi in tie_blocks):
                faults.append({"block": a, "why": f"label {line!r} differs away from every tie"})
    out = {"fixture_hashes_matched": matched, "events_jax": len(rows_g),
           "events_card": len(rows_c), "identical": identical, "ties": ties,
           "db_max_abs_err": db_err, **gaps}
    if db_err > db_tol:
        faults.append({"block": None, "why": f"dB differs by {db_err} > {db_tol}"})
    if gaps["max_abs_dthr"] > thr_tol:
        faults.append({"block": None, "why": f"thresholds differ by {gaps['max_abs_dthr']} > "
                                             f"{thr_tol} at the sampled blocks"})
    if gaps["max_abs_ddelta"] > delta_tol:
        faults.append({"block": None, "why": f"delta differs by {gaps['max_abs_ddelta']} > "
                                             f"{delta_tol} at the sampled blocks"})
    return _raise_faults(faults, out)


def channels_record(record: dict, n_channels: int, keep: int) -> dict:
    """The block record of the first ``keep`` of ``n_channels`` channels (a
    prefix of the flattened blocks)."""
    n = record["n"] // n_channels * keep
    step = record["sample_every"]
    k = -(-n // step)
    return {**record, "n": n, "delta": record["delta"][:k], "thr": record["thr"][:k],
            "near_ties": [r for r in record["near_ties"] if r[0] < n]}


def _stream_events(gold, got, db_tol: float, dur_tol: float, block_sec: float,
                   record: dict = None, gaps: dict = None) -> Tuple[dict, list]:
    """Streaming events per channel (lists of STREAM_FIELDS rows): start and
    stop times exactly, the duration within ``dur_tol`` (XLA may contract
    the reference's ``i * block_sec - start`` into one fused multiply-add,
    an ulp away), the dB fields within ``db_tol``.  With a block
    ``record`` (channels x blocks, flattened) and its ``gaps``, differences
    in the times are classified; without one each is a fault."""
    if len(gold) != len(got):
        raise GoldenMismatch(f"{len(got)} channels, the golden output has {len(gold)}")
    near = margins(record) if record is not None else {}
    n = record["n"] // len(gold) if record is not None else 0
    ties, faults, identical, db_err, dur_err = [], [], 0, 0.0, 0.0
    iv = lambda rows: [(int(round(r[0] / block_sec)), int(round(r[1] / block_sec)))  # noqa: E731
                       for r in rows]
    for c, (eg, ec) in enumerate(zip(gold, got)):
        times_g, times_c = [tuple(r[:2]) for r in eg], [tuple(r[:2]) for r in ec]
        identical += sum((collections.Counter(times_g) & collections.Counter(times_c)).values())
        by_times = {tuple(r[:2]): r for r in eg}
        for rc in ec:
            rg = by_times.get(tuple(rc[:2]))
            if rg is not None:
                dur_err = max(dur_err, abs(rg[2] - rc[2]))
                db_err = max(db_err, max(abs(a - b) for a, b in zip(rg[3:], rc[3:])))
        if times_g == times_c:
            continue
        if record is None:
            faults.append({"channel": c, "why": "event times differ"})
            continue
        t, f = classify(iv(eg), iv(ec), n, near, gaps["gap"], offset=c * n)
        ties += [{"channel": c, **x} for x in t]
        faults += [{"channel": c, **x} for x in f]
    out = {"events_jax": sum(map(len, gold)), "events_card": sum(map(len, got)),
           "identical": identical, "ties": ties, "db_max_abs_err": db_err,
           "duration_max_abs_err": dur_err}
    if db_err > db_tol:
        faults.append({"why": f"dB statistics differ by {db_err} > {db_tol}"})
    if dur_err > dur_tol:
        faults.append({"why": f"durations differ by {dur_err} > {dur_tol}"})
    return out, faults


def compare_stations(golden: dict, hashes: Sequence[str], events, overflow, series, thr,
                     db_tol: float, dur_tol: float, thr_tol: float,
                     block_sec: float = 0.2) -> dict:
    """G3: per-station events (the first ``len(events)`` stations, with
    their hashes), overflow flags, and the over-noise series and thresholds
    (stations x blocks) against the golden output's."""
    keep = len(events)
    matched = check_fixture(golden["fixture"]["station_sha256"][:keep], hashes, golden["config"])
    record = channels_record(golden["blocks"], len(golden["events"]), keep)
    gaps = block_gaps(record, series, thr)
    out, faults = _stream_events(golden["events"][:keep], events, db_tol, dur_tol, block_sec,
                                 record, gaps)
    if list(overflow) != golden["overflow"][:keep]:
        faults.append({"why": f"overflow flags {list(overflow)} differ"})
    if gaps["max_abs_dthr"] > thr_tol:
        faults.append({"why": f"thresholds differ by {gaps['max_abs_dthr']} > {thr_tol}"})
    return _raise_faults(faults, {"fixture_hashes_matched": matched, **out, **gaps})


def near_rounding(value: float, printed: str, gold_printed: str, tol: float) -> bool:
    """Two prints of one value to 2 decimals may differ in the last digit
    only where the golden unrounded value lies within ``tol`` of the
    rounding boundary between them."""
    a, b = float(printed), float(gold_printed)
    if abs(a - b) > 0.0100001:
        return False
    return abs(value - (a + b) / 2.0) <= tol


def compare_live(golden: dict, hashes: Sequence[str], lines: Sequence[str],
                 total: Sequence[str], events, db_tol: float, dur_tol: float) -> dict:
    """G2: the live CLI's ``Detected Meteor`` lines and total line, and the
    session's unrounded events, against the golden output's.  In a line,
    start, stop, duration and the running total must be equal; each dB
    field's print equal, or one last digit apart where the golden
    unrounded value lies within ``db_tol`` of the rounding boundary.  The
    unrounded events as :func:`_stream_events` holds them."""
    matched = check_fixture(golden["fixture"]["hour_sha256"], hashes, golden["config"])
    gold_lines = golden["lines"]
    out, faults = _stream_events([golden["events"]], [events], db_tol, dur_tol, 0.2)
    if len(lines) != len(gold_lines) or list(total) != golden["total"]:
        faults.append({"why": f"{len(lines)} event lines and {list(total)}, the golden output "
                              f"has {len(gold_lines)} and {golden['total']}"})
    boundary = []
    for i, (lg, lc) in enumerate(zip(gold_lines, lines)):
        if lg == lc:
            continue
        mg, mc = LIVE_LINE.match(lg), LIVE_LINE.match(lc)
        ok = bool(mg and mc) and mg.group(1, 2, 3, 8) == mc.group(1, 2, 3, 8) and all(
            pg == pc or near_rounding(golden["events"][i][LIVE_DB_FIELDS[g]], pc, pg, db_tol)
            for g, (pg, pc) in enumerate(zip(mg.group(4, 5, 6, 7), mc.group(4, 5, 6, 7))))
        if not ok:
            faults.append({"line": i, "why": f"{lc!r} != {lg!r}"})
        boundary.append(i)
    out = {"fixture_hashes_matched": matched, **out, "lines": len(lines),
           "identical_lines": sum(a == b for a, b in zip(gold_lines, lines)),
           "rounding_boundary_lines": boundary}
    return _raise_faults(faults, out)


def compare_frontend(golden: dict, label: str, hashes: Sequence[str],
                     lines: Sequence[str]) -> dict:
    """G4, ``label`` "real" or "iq": the capture's hashes, then the station
    lines (every event's [start, stop] and the truth) equal."""
    gold = golden[label]
    matched = check_fixture(gold["sha256"], hashes, f"G4 {label}")
    faults = [{"station": i, "why": f"{b!r} != {a!r}"} for i, (a, b) in enumerate(
        zip(gold["lines"], lines)) if a != b]
    if len(lines) != len(gold["lines"]):
        faults.append({"why": f"{len(lines)} station lines, golden {len(gold['lines'])}"})
    events = sum(int(re.match(r"^station \d+ \(.*?\): (\d+) events", ln).group(1))
                 for ln in gold["lines"])
    return _raise_faults(faults, {"fixture_hashes_matched": matched, "stations": len(lines),
                                  "events_jax": events, "identical_lines": len(lines) - len(faults),
                                  "ties": []})


def monitor_outputs(csv_dir: str, png_dir: str, text: str) -> dict:
    """What a golden output keeps of an ``apps.monitor.main`` run: the daily
    CSVs and the ledger's journal (text), the offset journal's position
    (its ``source`` is the WAV's absolute path), the PNG names and each
    segment's printed counts."""
    files = {}
    for f in sorted(os.listdir(csv_dir)):
        if f.endswith(".csv") or f == ".inprogress.json":
            with open(os.path.join(csv_dir, f)) as fh:
                files[f] = fh.read()
    offset = None
    if os.path.exists(os.path.join(csv_dir, ".offset.json")):
        with open(os.path.join(csv_dir, ".offset.json")) as fh:
            offset = json.load(fh)["pos"]
    counts = [[int(c), int(n)] for c, n in re.findall(
        r"^Critical bursts this segment: (\d+)\nNon-critical bursts this segment: (\d+)$",
        text, re.M)]
    return {"files": files, "offset_pos": offset, "pngs": sorted(os.listdir(png_dir)),
            "segment_counts": counts}


def compare_monitor(golden: dict, hashes: Sequence[str], outputs: dict) -> dict:
    """G5: the monitor run's :func:`monitor_outputs` equal to the golden
    output's, every CSV and journal byte for byte."""
    matched = check_fixture(golden["fixture"]["hour_sha256"], hashes, golden["config"])
    faults = [{"what": k, "why": "differs"} for k in ("files", "offset_pos", "pngs",
                                                      "segment_counts")
              if outputs[k] != golden[k]]
    crit = sum(c for c, _ in golden["segment_counts"])
    return _raise_faults(faults, {"fixture_hashes_matched": matched,
                                  "segments": len(golden["segment_counts"]),
                                  "critical_jax": crit,
                                  "critical_card": sum(c for c, _ in outputs["segment_counts"]),
                                  "csv_files": sorted(outputs["files"]), "ties": []})
