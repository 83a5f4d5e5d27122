"""Synthetic daily-ledger fixture generator.

Equivalent of the reference's `csv_files/create_test_data/tabelle
generieren.py`: one CSV per day, hourly rows at HH:05, ``Anzahl``
uniform in [0, 120], ``Kritisch`` ≤ Anzahl/2.

The port's copy of `meteor_scatter_tpu/dashboard/testdata.py` (the port
imports nothing of the JAX package); it touches no device.
"""

from __future__ import annotations

import datetime
import os

import numpy as np


def generate_test_csvs(
    out_dir: str,
    start: datetime.date,
    days: int,
    seed: int = 0,
    max_count: int = 120,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for d in range(days):
        day = start + datetime.timedelta(days=d)
        path = os.path.join(out_dir, day.strftime("%Y%m%d") + ".csv")
        with open(path, "w") as fh:
            fh.write("Timestamp;Anzahl;Kritisch\n")
            for h in range(24):
                anzahl = int(rng.integers(0, max_count + 1))
                kritisch = int(rng.integers(0, anzahl // 2 + 1))
                ts = datetime.datetime.combine(day, datetime.time(h, 5))
                fh.write(f"{ts:%Y-%m-%d %H:%M:%S};{anzahl};{kritisch}\n")


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--days", type=int, default=31)
    p.add_argument("--start", default="2024-10-15",
                   help="first day of the fixture window (default matches the "
                        "reference testfiles range)")
    p.add_argument("--end-yesterday", action="store_true",
                   help="ignore --start and generate the window ending "
                        "yesterday (dashboard-ready)")
    args = p.parse_args()
    if args.end_yesterday:
        yesterday = datetime.date.today() - datetime.timedelta(days=1)
        start = yesterday - datetime.timedelta(days=args.days - 1)
    else:
        start = datetime.date.fromisoformat(args.start)
    generate_test_csvs(args.out_dir, start, args.days)
    print(f"Wrote {args.days} daily CSVs to {args.out_dir}")
