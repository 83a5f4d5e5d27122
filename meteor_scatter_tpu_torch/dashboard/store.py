"""CSV data layer for the dashboard.

Equivalent of the reference's `database.py`: maintains a merged 30-day
dataframe cache (``final_dataframe.csv``) over the daily ledger CSVs, with
the same self-healing behaviors — recreate when deleted
(`database.py:16-43`), full reload when the newest Timestamp is not
yesterday (`database.py:110-151`), missing-day reporting
(`database.py:261-287`).  Same byte format: ``;`` separator,
``Timestamp;Anzahl;Kritisch`` columns, filenames ``YYYYMMDD.csv``.

The port's copy of `meteor_scatter_tpu/dashboard/store.py` (the port imports
nothing of the JAX package); it touches no device.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import pandas as pd


def calculate_last_month(today: Optional[datetime.date] = None) -> Tuple[datetime.date, datetime.date]:
    """[yesterday − 30 days, yesterday] (reference config.py:84-89)."""
    today = today or datetime.date.today()
    end = today - datetime.timedelta(days=1)
    start = end - datetime.timedelta(days=30)
    return start, end


class LedgerStore:
    def __init__(self, csv_folder: str, storage_path: str = "final_dataframe.csv"):
        self.csv_folder = csv_folder
        self.storage_path = storage_path

    # -- selection ---------------------------------------------------------

    def scan_folder(self) -> List[str]:
        """Daily files named ``YYYYMMDD.csv`` within the last-month window
        (database.py:242-258)."""
        start, end = calculate_last_month()
        out = []
        if not os.path.isdir(self.csv_folder):
            # fresh deployment where the dashboard starts before the
            # monitor created its output folder: an empty scan (and the
            # resulting all-days-missing report) is the self-healing
            # behavior — raising here would kill startup and the index
            # route instead
            return out
        for name in os.listdir(self.csv_folder):
            if not (name.endswith(".csv") and len(name) == 12):
                continue
            try:
                d = datetime.datetime.strptime(name[:8], "%Y%m%d").date()
            except ValueError:
                continue
            if start <= d <= end:
                out.append(name)
        return sorted(out)

    def check_missing_days(self, found: Optional[List[str]] = None) -> List[str]:
        start, end = calculate_last_month()
        if found is None:
            found = self.scan_folder()
        have = {f[:8] for f in found}
        days = [(start + datetime.timedelta(days=i)).strftime("%Y%m%d")
                for i in range((end - start).days + 1)]
        return [d for d in days if d not in have]

    # -- loading / caching -------------------------------------------------

    def load_last_30_days(self) -> Optional[pd.DataFrame]:
        frames = []
        for name in self.scan_folder():
            path = os.path.join(self.csv_folder, name)
            try:
                frames.append(pd.read_csv(path, sep=";", encoding="utf-8"))
            except Exception as e:  # noqa: BLE001 — skip unreadable days like the reference
                print(f"Error loading {name}: {e}")
        if not frames:
            return None
        return pd.concat(frames, ignore_index=True)

    def save(self, df: pd.DataFrame) -> None:
        df.to_csv(self.storage_path, index=False, sep=";", encoding="utf-8")

    def load_or_create(self) -> Optional[pd.DataFrame]:
        """Load the merged cache, rebuilding it from the daily files when
        absent (database.py:16-43)."""
        if os.path.exists(self.storage_path):
            try:
                df = pd.read_csv(self.storage_path, sep=";", encoding="utf-8")
                if df.empty:
                    return None
                return df
            except Exception as e:  # noqa: BLE001
                print(f"Error loading cache: {e}")
                return None
        df = self.load_last_30_days()
        if df is None or df.empty:
            return None
        self.save(df)
        return df

    def update_if_needed(self) -> Optional[pd.DataFrame]:
        """Reload everything iff the cache's newest Timestamp is not
        yesterday (database.py:110-151)."""
        yesterday = datetime.date.today() - datetime.timedelta(days=1)
        try:
            df = pd.read_csv(self.storage_path, sep=";", encoding="utf-8")
        except Exception:  # noqa: BLE001 — missing/corrupt cache → full reload
            return self.load_last_30_days()
        if "Timestamp" not in df.columns:
            return self.load_last_30_days()
        last = pd.to_datetime(df["Timestamp"], errors="coerce").dt.date.max()
        if last != yesterday:
            fresh = self.load_last_30_days()
            return fresh if fresh is not None else df
        return df

    def scheduled_update(self) -> None:
        """The recurring job body (database.py:154-181)."""
        try:
            # no separate cache-exists branch: update_if_needed already
            # treats a missing/corrupt cache as a full reload
            updated = self.update_if_needed()
            if updated is not None:
                self.save(updated)
        except Exception as e:  # noqa: BLE001 — the scheduler must survive
            print(f"Error in scheduled CSV update: {e}")

    # -- stats -------------------------------------------------------------

    def average_last_24h(self) -> int:
        """Rounded mean of ``Anzahl`` over yesterday, for the gauge
        (database.py:187-238); 0 on any problem."""
        try:
            if not os.path.exists(self.storage_path):
                return 0
            df = pd.read_csv(self.storage_path, delimiter=";", dtype=str, skip_blank_lines=True)
            if df.empty or "Anzahl" not in df.columns or "Timestamp" not in df.columns:
                return 0
            ts = pd.to_datetime(df["Timestamp"], errors="coerce")
            today = datetime.date.today()
            start = pd.Timestamp(today - datetime.timedelta(days=1))
            end = pd.Timestamp(today) - pd.Timedelta(seconds=1)
            sel = df[(ts >= start) & (ts <= end)].copy()
            if sel.empty:
                return 0
            vals = pd.to_numeric(sel["Anzahl"], errors="coerce").fillna(0)
            return int(round(vals.mean()))
        except Exception as e:  # noqa: BLE001
            print(f"Error computing 24h average: {e}")
            return 0
