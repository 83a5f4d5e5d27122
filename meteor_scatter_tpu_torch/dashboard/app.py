"""The dashboard HTTP application (stdlib WSGI — no Flask dependency).

Same endpoint surface as the reference `app.py`:

* ``GET  /``                        — index page with missing-day report
* ``GET  /config/slideshow_interval`` — slideshow interval JSON (:66-69)
* ``POST /update_csv``              — revalidate the merged CSV (:72-84)
* ``GET  /api/dynamischer_inhalt``  — no-cache missing-days JSON (:115-123)
* ``GET  /load_chart/<type>``       — render chart → static PNG → img_url
  (:127-173), types {zeiger, tagesverlauf, week, month}
* ``GET  /static/...``              — static files

plus the ``X-Script-Name`` reverse-proxy middleware (:203-223) and the
background CSV revalidation job (:48-63).

Run::

    python -m meteor_scatter_tpu_torch.dashboard.app --csv-folder csv-out

The port's copy of `meteor_scatter_tpu/dashboard/app.py` (the port imports
nothing of the JAX package); it touches no device.
"""

from __future__ import annotations

import argparse
import json
import mimetypes
import os
import string
from datetime import datetime
from typing import Callable, List, Tuple
from wsgiref.simple_server import make_server

from meteor_scatter_tpu_torch.config import DashboardConfig
from meteor_scatter_tpu_torch.dashboard import charts
from meteor_scatter_tpu_torch.dashboard.scheduler import IntervalScheduler
from meteor_scatter_tpu_torch.dashboard.store import LedgerStore, calculate_last_month

_HERE = os.path.dirname(os.path.abspath(__file__))


class DashboardApp:
    def __init__(self, cfg: DashboardConfig, static_dir: str | None = None):
        self.cfg = cfg
        self.store = LedgerStore(cfg.csv_folder, cfg.csv_storage_path)
        self.static_dir = static_dir or os.path.join(_HERE, "static")
        os.makedirs(self.static_dir, exist_ok=True)
        # static slideshow slots (reference templates/index.html:51-57)
        from meteor_scatter_tpu_torch.dashboard.slides import ensure_static_slides

        ensure_static_slides(self.static_dir)
        self.scheduler = IntervalScheduler(
            self.store.scheduled_update, cfg.schedule_interval_min
        )
        charts.setup_font()
        # warm the dataframe like initapp.py:21
        self.store.load_or_create()

    # -- WSGI --------------------------------------------------------------

    def __call__(self, environ, start_response):
        # X-Script-Name middleware (reference app.py:203-223)
        script_name = environ.get("HTTP_X_SCRIPT_NAME", "")
        environ["SCRIPT_NAME"] = script_name

        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")

        try:
            if path == "/" and method == "GET":
                return self.index(environ, start_response)
            if path == "/config/slideshow_interval" and method == "GET":
                return self._json(start_response, {"slideshow_interval": self.cfg.slideshow_interval_ms})
            if path == "/update_csv" and method == "POST":
                return self.update_csv(start_response)
            if path == "/api/dynamischer_inhalt" and method == "GET":
                return self.dynamic_content(start_response)
            if path.startswith("/load_chart/") and method == "GET":
                return self.load_chart(environ, start_response, path.split("/", 2)[2])
            if path.startswith("/static/"):
                return self.static_file(start_response, path[len("/static/"):])
            return self._json(start_response, {"error": "not found"}, status="404 Not Found")
        except Exception as e:  # noqa: BLE001 — keep serving
            return self._json(
                start_response, {"error": str(e)}, status="500 Internal Server Error"
            )

    def _json(self, start_response, payload, status="200 OK", headers=None):
        body = json.dumps(payload).encode()
        hdrs = [("Content-Type", "application/json"), ("Content-Length", str(len(body)))]
        if headers:
            hdrs.extend(headers)
        start_response(status, hdrs)
        return [body]

    # -- routes ------------------------------------------------------------

    def index(self, environ, start_response):
        start_date, end_date = calculate_last_month()
        missing = self.store.check_missing_days()
        tpl_path = os.path.join(_HERE, "templates", "index.html")
        tpl = string.Template(open(tpl_path, encoding="utf-8").read())
        missing_html = "".join(f"<li>{d}</li>" for d in missing) or "<li>keine 😊</li>"
        body = tpl.substitute(
            script_root=environ.get("SCRIPT_NAME", ""),
            reload_interval=self.cfg.reload_interval_ms,
            start_date=start_date.isoformat(),
            end_date=end_date.isoformat(),
            missing_days=missing_html,
            time=datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        ).encode("utf-8")
        start_response(
            "200 OK",
            [("Content-Type", "text/html; charset=utf-8"), ("Content-Length", str(len(body)))],
        )
        return [body]

    def update_csv(self, start_response):
        try:
            self.scheduler.trigger()
            return self._json(
                start_response, {"message": "CSV-Datei wurde überprüft und ggf. aktualisiert."}
            )
        except Exception as e:  # noqa: BLE001
            return self._json(
                start_response,
                {"error": f"Fehler bei der Aktualisierung der CSV-Dateien: {e}"},
                status="500 Internal Server Error",
            )

    def dynamic_content(self, start_response):
        missing = self.store.check_missing_days()
        return self._json(
            start_response,
            {"missing_days": missing},
            headers=[
                ("Cache-Control", "no-store, must-revalidate"),
                ("Pragma", "no-cache"),
                ("Expires", "0"),
            ],
        )

    def load_chart(self, environ, start_response, chart_type: str):
        fn = charts.CHART_FUNCTIONS.get(chart_type)
        if fn is None:
            return self._json(
                start_response,
                {"error": f"Ungültiger Chart-Typ: {chart_type}"},
                status="400 Bad Request",
            )
        if chart_type == "zeiger":
            img64 = charts.generate_chart(
                lambda p: charts.create_zeiger_chart(
                    p, gauge_upper=int(self.cfg.gauge_upper), gauge_lower=int(self.cfg.gauge_lower)
                ),
                self.cfg.csv_storage_path,
            )
        else:
            img64 = charts.generate_chart(fn, self.cfg.csv_storage_path)
        if not img64:
            return self._json(
                start_response,
                {"error": f"Fehler beim Erstellen des {chart_type}-Charts."},
                status="500 Internal Server Error",
            )
        import base64

        out_path = os.path.join(self.static_dir, f"{chart_type}_chart.png")
        with open(out_path, "wb") as fh:
            fh.write(base64.b64decode(img64))

        base_url = environ.get("SCRIPT_NAME", "")
        if base_url:
            if not base_url.endswith("/"):
                base_url += "/"
            base_url = base_url.lstrip("/")
        return self._json(start_response, {"img_url": f"/{base_url}static/{chart_type}_chart.png"})

    def static_file(self, start_response, rel: str):
        rel = os.path.normpath(rel)
        if rel.startswith(("..", "/")):
            return self._json(start_response, {"error": "forbidden"}, status="403 Forbidden")
        path = os.path.join(self.static_dir, rel)
        if not os.path.isfile(path):
            return self._json(start_response, {"error": "not found"}, status="404 Not Found")
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        data = open(path, "rb").read()
        start_response("200 OK", [("Content-Type", ctype), ("Content-Length", str(len(data)))])
        return [data]


def initialize_app(cfg: DashboardConfig | None = None) -> DashboardApp:
    """initapp.py:6-35 equivalent: validate config, warm the dataframe,
    build the app."""
    cfg = cfg or DashboardConfig()
    if cfg.reload_interval_ms <= 0:
        raise ValueError("reload_interval must be > 0")
    return DashboardApp(cfg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--csv-folder", default="csv-out")
    p.add_argument("--storage", default="final_dataframe.csv")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--schedule-interval", type=float, default=2.0, help="minutes")
    args = p.parse_args(argv)

    cfg = DashboardConfig(
        csv_folder=args.csv_folder,
        csv_storage_path=args.storage,
        host=args.host,
        port=args.port,
        schedule_interval_min=args.schedule_interval,
    )
    app = initialize_app(cfg)
    app.scheduler.start()
    print(f"Dashboard on http://{args.host}:{args.port}/")
    with make_server(args.host, args.port, app) as httpd:
        httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
