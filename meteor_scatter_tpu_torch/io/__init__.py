"""Host-side I/O: WAV ingest and the event CSV / Audacity label exports."""
