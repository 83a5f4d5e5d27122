"""Host-side I/O: WAV ingest, the hourly CSV ledger, the event CSV /
Audacity label exports and PNG writing — the names the reference package
exports from its ``io`` package."""

from meteor_scatter_tpu_torch.io.wavio import read_wav, write_wav, stream_wav_blocks  # noqa: F401
from meteor_scatter_tpu_torch.io.ledger import HourlyLedger  # noqa: F401
from meteor_scatter_tpu_torch.io.events_csv import (  # noqa: F401
    OutputDetection,
    write_audacity_labels,
    write_event_csv,
    events_to_detections,
)
from meteor_scatter_tpu_torch.io.png import write_png, colorize  # noqa: F401
