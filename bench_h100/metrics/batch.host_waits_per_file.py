"""Host waits for the device (``cudaStreamSynchronize`` and
``cudaDeviceSynchronize`` calls) a file in the traced part of the window."""


def read(run):
    n = run.traced_requests
    return run.trace.host_waits / n if n else None
