"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import math
import os
import re

import pytest

from bench_h100.tests.tiny_cells import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert bench["command"] == ["python3", "bench_h100/run.py"]
    assert bench["paths"] == ["bench_h100"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43 200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
        layers.add(m["layer"])
    cells = {w["name"] for w in bench["workloads"]}
    for w in cells:
        reported = [m for m in bench["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        per = [m for m in bench["per_layer"] if w in m.get("workloads", cells)]
        assert per
        for m in per:  # the cell reports the metric it moves
            assert m["moves"] in [r["name"] for r in reported]


def test_every_named_file_exists(bench):
    bench_dir = os.path.join(ROOT, "bench_h100")
    for c in bench["configs"]:
        assert c["file"].startswith("bench_h100/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as fh:
            traffic = json.load(fh)
        assert os.path.exists(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"))
        with open(os.path.join(bench_dir, "limits", w["name"] + ".json")) as fh:
            limits = json.load(fh)
        assert set(limits) == {"front_db_gap", "threshold_db_gap", "event_mismatches", "event_db_gap"}
        assert limits["event_mismatches"] == 0 and all(math.isfinite(v) for v in limits.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(bench_dir, "metrics", m["name"] + ".py")), m["name"]
