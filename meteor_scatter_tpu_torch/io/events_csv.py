"""Per-event exports: detection CSV and Audacity label files.

Counterpart of `meteor_scatter_tpu/io/events_csv.py`, byte-compatible with
the batch analyzer's outputs:

* event CSV with fieldnames t_start,t_stop,dur_s,dB,utc_start,utc_stop
  (`dsp/src/main.py:640-658`),
* Audacity pre-label lines ``{t_start:.2f}\\t{t_stop:.2f}\\tM``
  (`dsp/src/main.py:630-638`).

The event buffer may live on a GPU: its fields are copied to the host
before numpy sees them.
"""

from __future__ import annotations

import csv
import datetime
from dataclasses import dataclass
from typing import List, Optional, Sequence

from meteor_scatter_tpu_torch.models.events import Events
from meteor_scatter_tpu_torch.utils.timing import wait


@dataclass
class OutputDetection:
    """Host-side event record (`dsp/src/main.py:30-37`)."""

    t_start: float
    t_stop: float
    dur_s: float
    dB: float
    utc_start: Optional[datetime.datetime] = None
    utc_stop: Optional[datetime.datetime] = None


def events_to_detections(
    events: Events,
    block_duration_sec: float,
    wav_start_date_time: Optional[datetime.datetime] = None,
    block_offset: int = 0,
) -> List[OutputDetection]:
    """Convert an event buffer (on any device) into host records, applying
    the block→seconds mapping of `main.py:425-426,503-505`."""
    out = []
    with wait("event_count"):
        count = int(events.count)
    with wait("event_fields"):
        start = events.start[:count].cpu().numpy()
        stop = events.stop[:count].cpu().numpy()
        db = events.db_mean[:count].cpu().numpy()
    for i in range(count):
        t0 = (int(start[i]) + block_offset) * block_duration_sec
        t1 = (int(stop[i]) + block_offset) * block_duration_sec
        u0 = u1 = None
        if wav_start_date_time is not None:
            u0 = wav_start_date_time + datetime.timedelta(seconds=t0)
            u1 = wav_start_date_time + datetime.timedelta(seconds=t1)
        out.append(
            OutputDetection(
                t_start=t0, t_stop=t1, dur_s=t1 - t0, dB=float(db[i]), utc_start=u0, utc_stop=u1
            )
        )
    return out


def write_event_csv(path: str, detections: Sequence[OutputDetection]) -> None:
    fieldnames = ["t_start", "t_stop", "dur_s", "dB", "utc_start", "utc_stop"]
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=fieldnames)
        writer.writeheader()
        for det in detections:
            writer.writerow(
                {
                    "t_start": det.t_start,
                    "t_stop": det.t_stop,
                    "dur_s": det.dur_s,
                    "dB": det.dB,
                    "utc_start": det.utc_start.isoformat() if det.utc_start else None,
                    "utc_stop": det.utc_stop.isoformat() if det.utc_stop else None,
                }
            )


def write_audacity_labels(path: str, detections: Sequence[OutputDetection]) -> None:
    with open(path, "w") as fh:
        for det in detections:
            fh.write(f"{det.t_start:.2f}\t{det.t_stop:.2f}\tM\n")
