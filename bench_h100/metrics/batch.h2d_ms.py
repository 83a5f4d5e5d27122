"""Device ms of host-to-device copies a file in the traced part of the
window."""


def read(run):
    n = run.traced_requests
    if not n:
        return None
    return run.trace.copy_s("HtoD") * 1e3 / n
