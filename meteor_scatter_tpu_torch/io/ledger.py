"""Hourly CSV ledger with daily rotation and crash-safe resume.

The port's own copy of `meteor_scatter_tpu/io/ledger.py` (the stdlib and
the port's profiler spans, ``journal`` and ``flush``; the port imports
nothing of the JAX package), writing the same bytes.

The reference's durable state is daily CSVs named ``YYYYMMDD.csv`` with
header ``Timestamp;Anzahl;Kritisch`` and one row per hour
(`README.md:46-59`, producer `prime_detection.py:117-123,206-247`).  This
ledger keeps that byte format (`;` separator, ``%Y-%m-%d %H:%M:%S``
timestamps) and adds what the reference lacks (SURVEY.md §5
checkpoint/resume): a sidecar journal of the in-progress hour so a restart
loses at most one flush interval instead of the whole hour
(`prime_detection.py:227-229` resets counts only on flush).
"""

from __future__ import annotations

import json
import os
from datetime import datetime, timedelta
from typing import Optional

from meteor_scatter_tpu_torch.utils.timing import span

SEP = ";"
COLUMNS = ["Timestamp", "Anzahl", "Kritisch"]


class HourlyLedger:
    def __init__(
        self,
        out_dir: str,
        save_interval_min: float = 59.8,
        journal: bool = True,
        now: Optional[datetime] = None,
    ):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.save_interval = timedelta(minutes=save_interval_min)
        self.journal_path = os.path.join(out_dir, ".inprogress.json") if journal else None
        now = now or datetime.now()
        self.hour_start = now
        self.previous_date = now.strftime("%Y-%m-%d")
        self.n_critical = 0
        self.n_non_critical = 0
        self._ensure_file(now)
        self._recover(now)

    # -- file management ---------------------------------------------------

    def current_file(self, now: Optional[datetime] = None) -> str:
        now = now or datetime.now()
        return os.path.join(self.out_dir, now.strftime("%Y%m%d") + ".csv")

    def _ensure_file(self, now: datetime) -> str:
        path = self.current_file(now)
        if not os.path.exists(path):
            with open(path, "w") as fh:
                fh.write(SEP.join(COLUMNS) + "\n")
        return path

    def _recover(self, now: datetime) -> None:
        """Resume in-progress hour counts after a crash.

        A journaled hour that is still open resumes in place.  A *stale*
        journal (its hour became flush-due while the process was dead, or
        the crash landed between "flush due" and the row append) is flushed
        to its own day file instead of discarded — dropping it would lose a
        whole hourly row that an uninterrupted run records (found by the
        round-5 SIGKILL soak test).  The flush is idempotent: if the crash
        landed *between* the row append and the journal reset, the row
        already exists and the journal is discarded instead (hour_start
        values are unique per flush, so a timestamp match identifies the
        exact row).

        Rotation corner: the journal records ``previous_date`` (the day of
        the last add), so recovery can replay the daily-rotation semantics
        an uninterrupted run applies (``maybe_flush`` date-change branch =
        `prime_detection.py:232-247` — counts reset without flushing):

        * a still-open journal resumes *with its recorded previous_date*,
          so if midnight passed while the process was dead, the restarted
          ledger's own next ``add`` fires the rotation and resets the
          counts exactly like an uninterrupted run would — resuming with
          today's date instead would smuggle pre-midnight counts past the
          rotation into the eventual row;
        * a stale journal whose flush-due moment lands on a later calendar
          day than its last add is dropped, not flushed — an uninterrupted
          run hits the rotation before the flush, so flushing would
          fabricate a pre-midnight row no uninterrupted run produces."""
        if self.journal_path and os.path.exists(self.journal_path):
            try:
                with open(self.journal_path) as fh:
                    j = json.load(fh)
                start = datetime.fromisoformat(j["hour_start"])
                j_date = j.get("date") or start.strftime("%Y-%m-%d")
                if now - start < self.save_interval:
                    # journaled hour still open: resume in place (incl. the
                    # last-add date, so a pending rotation still fires)
                    self.hour_start = start
                    self.previous_date = j_date
                    self.n_critical = int(j["critical"])
                    self.n_non_critical = int(j["non_critical"])
                elif (start + self.save_interval).strftime("%Y-%m-%d") != j_date:
                    # flush-due crosses midnight relative to the last add:
                    # rotation would have reset these counts before any
                    # flush — discard the journal
                    self._journal()
                elif not self._row_exists(start):
                    self.hour_start = start
                    self.n_critical = int(j["critical"])
                    self.n_non_critical = int(j["non_critical"])
                    self.flush(now)  # appends the lost row, resets to now
            except (ValueError, KeyError, json.JSONDecodeError):
                pass

    def _row_exists(self, hour_start: datetime) -> bool:
        path = self.current_file(hour_start)
        if not os.path.exists(path):
            return False
        ts = hour_start.strftime("%Y-%m-%d %H:%M:%S")
        with open(path) as fh:
            return any(line.split(SEP, 1)[0] == ts for line in fh)

    def _journal(self) -> None:
        if not self.journal_path:
            return
        tmp = self.journal_path + ".tmp"
        with span("journal"):
            with open(tmp, "w") as fh:
                json.dump(
                    {
                        "hour_start": self.hour_start.isoformat(),
                        "critical": self.n_critical,
                        "non_critical": self.n_non_critical,
                        "date": self.previous_date,
                    },
                    fh,
                )
            os.replace(tmp, self.journal_path)

    # -- accumulation ------------------------------------------------------

    def add(self, critical: int, non_critical: int, now: Optional[datetime] = None) -> None:
        """Accumulate one segment's counts and flush/rotate when due —
        the body of the reference loop steps 4-6 (`prime_detection.py:194-247`)."""
        self.n_critical += int(critical)
        self.n_non_critical += int(non_critical)
        self._journal()
        self.maybe_flush(now)

    def maybe_flush(self, now: Optional[datetime] = None) -> bool:
        now = now or datetime.now()
        flushed = False
        if now - self.hour_start >= self.save_interval:
            self.flush(now)
            flushed = True
        current_date = now.strftime("%Y-%m-%d")
        if current_date != self.previous_date:
            # daily rotation: fresh file, counts reset (prime_detection.py:232-247)
            self.previous_date = current_date
            self._ensure_file(now)
            self.n_critical = 0
            self.n_non_critical = 0
            self._journal()
        return flushed

    def flush(self, now: Optional[datetime] = None) -> None:
        """Append the hourly row ``Timestamp;Anzahl;Kritisch``
        (`prime_detection.py:208-222`) and reset counts."""
        now = now or datetime.now()
        with span("flush"):
            path = self._ensure_file(self.hour_start)
            ts = self.hour_start.strftime("%Y-%m-%d %H:%M:%S")
            with open(path, "a") as fh:
                total = self.n_critical + self.n_non_critical
                fh.write(f"{ts}{SEP}{total}{SEP}{self.n_critical}\n")
        self.n_critical = 0
        self.n_non_critical = 0
        self.hour_start = now
        self._journal()
