"""The port's dashboard against the JAX package's, on the CPU.

The static and template files are byte copies; both WSGI apps serve one
``generate_test_csvs`` fixture (31 days ending yesterday), are called in
the same test with one frozen wall clock, and must answer every endpoint
with the same status, headers and body — the chart PNGs byte for byte.
"""

import contextlib
import datetime
import filecmp
import io
import json
import os

import pytest

from meteor_scatter_tpu.config import DashboardConfig as JDashboardConfig
from meteor_scatter_tpu.dashboard import app as japp
from meteor_scatter_tpu.dashboard import showers as jshowers
from meteor_scatter_tpu.dashboard import store as jstore
from meteor_scatter_tpu.dashboard import testdata as jtestdata
from meteor_scatter_tpu_torch.config import DashboardConfig
from meteor_scatter_tpu_torch.dashboard import app as tapp
from meteor_scatter_tpu_torch.dashboard import showers as tshowers
from meteor_scatter_tpu_torch.dashboard import store as tstore
from meteor_scatter_tpu_torch.dashboard import testdata as ttestdata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("static/script.js", "static/styles.css", "templates/index.html")
REQUESTS = [
    ("GET", "/"),
    ("GET", "/config/slideshow_interval"),
    ("POST", "/update_csv"),
    ("GET", "/api/dynamischer_inhalt"),
    ("GET", "/load_chart/zeiger"),
    ("GET", "/load_chart/tagesverlauf"),
    ("GET", "/load_chart/week"),
    ("GET", "/load_chart/month"),
    ("GET", "/load_chart/bogus"),
    ("GET", "/static/slides/Folie2.png"),
    ("GET", "/static/../app.py"),
    ("GET", "/nope"),
]


def call_wsgi(app, path, method="GET", script_name=None):
    env = {
        "REQUEST_METHOD": method,
        "PATH_INFO": path,
        "SERVER_NAME": "test",
        "SERVER_PORT": "80",
        "wsgi.input": io.BytesIO(b""),
        "wsgi.url_scheme": "http",
    }
    if script_name is not None:
        env["HTTP_X_SCRIPT_NAME"] = script_name
    captured = {}

    def start_response(status, headers):
        captured["status"], captured["headers"] = status, list(headers)

    body = b"".join(app(env, start_response))
    return captured["status"], captured["headers"], body


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(port app, JAX app), each over its own copy of one fixture, with
    ``datetime.now`` in both app modules frozen at one instant."""
    base = tmp_path_factory.mktemp("dash")
    start, end = tstore.calculate_last_month()
    frozen = datetime.datetime.combine(end + datetime.timedelta(days=1), datetime.time(9, 30, 5))

    class Frozen(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return frozen

    pair = []
    with pytest.MonkeyPatch.context() as mp:
        for name, mod, cfg_cls, testdata in (("t", tapp, DashboardConfig, ttestdata),
                                             ("j", japp, JDashboardConfig, jtestdata)):
            mp.setattr(mod, "datetime", Frozen)
            d = base / name
            testdata.generate_test_csvs(str(d / "csv"), start, (end - start).days, seed=3)
            cfg = cfg_cls(csv_folder=str(d / "csv"), csv_storage_path=str(d / "final.csv"))
            pair.append(mod.DashboardApp(cfg, static_dir=str(d / "static")))
        yield pair


def test_static_and_template_files_are_copies():
    for rel in FILES:
        assert filecmp.cmp(os.path.join(ROOT, "meteor_scatter_tpu_torch", "dashboard", rel),
                           os.path.join(ROOT, "meteor_scatter_tpu", "dashboard", rel),
                           shallow=False), rel


@pytest.mark.parametrize("method,path", REQUESTS, ids=[f"{m} {p}" for m, p in REQUESTS])
def test_endpoint_matches_jax(apps, method, path):
    t, j = (call_wsgi(app, path, method) for app in apps)
    assert t == j
    status, headers, body = t
    if path.startswith("/load_chart/") and status == "200 OK":
        url = json.loads(body)["img_url"]
        assert url == f"/static/{path.rsplit('/', 1)[1]}_chart.png"
        png_t, png_j = (call_wsgi(app, url) for app in apps)
        assert png_t == png_j and png_t[2][:8] == b"\x89PNG\r\n\x1a\n"
    want = {"/": "200 OK", "/load_chart/bogus": "400 Bad Request", "/nope": "404 Not Found",
            "/static/../app.py": "403 Forbidden"}.get(path, "200 OK")
    assert status == want, body[:200]


def test_index_reports_the_missing_day_and_script_name(apps):
    t, j = (call_wsgi(app, "/api/dynamischer_inhalt") for app in apps)
    assert t == j and len(json.loads(t[2])["missing_days"]) == 1  # the fixture stops a day early
    t, j = (call_wsgi(app, "/load_chart/week", script_name="/meteor") for app in apps)
    assert t == j and json.loads(t[2])["img_url"] == "/meteor/static/week_chart.png"


def test_store_showers_and_testdata_match_jax(tmp_path):
    start = datetime.date(2026, 7, 20)
    ttestdata.generate_test_csvs(str(tmp_path / "t"), start, 5, seed=9)
    jtestdata.generate_test_csvs(str(tmp_path / "j"), start, 5, seed=9)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "t"):
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name, shallow=False), name
    assert tstore.calculate_last_month(start) == jstore.calculate_last_month(start)
    ts = tstore.LedgerStore(str(tmp_path / "t"), str(tmp_path / "t.csv"))
    js = jstore.LedgerStore(str(tmp_path / "j"), str(tmp_path / "j.csv"))
    assert ts.check_missing_days() == js.check_missing_days()
    assert ts.average_last_24h() == js.average_last_24h()
    for year in (2025, 2026):
        assert [vars(w) for w in tshowers.shower_windows(year)] == [
            vars(w) for w in jshowers.shower_windows(year)]
    a, b = datetime.date(2025, 12, 20), datetime.date(2026, 1, 10)
    assert [vars(w) for w in tshowers.showers_in_range(a, b)] == [
        vars(w) for w in jshowers.showers_in_range(a, b)]


@pytest.mark.parametrize("module", ["dashboard.app", "apps.merge"])
def test_cli_flags_match_jax(module):
    """The same argparse surface: ``--help`` prints the same text."""
    import importlib

    helps = []
    for pkg in ("meteor_scatter_tpu_torch", "meteor_scatter_tpu"):
        mod = importlib.import_module(f"{pkg}.{module}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            mod.main(["--help"])
        helps.append(out.getvalue())
    assert helps[0] == helps[1] and "--" in helps[0]
