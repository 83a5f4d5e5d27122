"""Web dashboard: aggregates the detection ledger CSVs into charts.

Re-implements the reference webserver feature set (`app.py` + `plot.py` +
`database.py` + `LocalData.py` + templates/static) without Flask — the
HTTP layer is a stdlib WSGI app — while keeping the same endpoints,
chart types (gauge / day / week / month with meteor-shower overlays),
CSV contracts, scheduler behavior, and reverse-proxy support.

The port's copy of `meteor_scatter_tpu/dashboard/` (the port imports nothing
of the JAX package); it touches no device.
"""
