"""The adaptive solver K1's share of its roofline, in %: the least time for
the traced files' solves (``peaks.k1``) over the device time of K1's
kernels (``walk_kernel``, ``rounds_kernel``)."""

from bench_h100 import peaks


def read(run):
    n = run.traced_requests
    if not n:
        return None
    t = sum(run.trace.seconds(run.trace.kernels(name_has=k)) for k in ("walk_kernel", "rounds_kernel"))
    if t <= 0:
        return None
    cfg = run.cell.config
    fs = cfg["sample_rate"]
    nb = int(run.cell.traffic["file_seconds"] * fs) // int(fs * cfg["block_duration_sec"])
    return 100.0 * n * peaks.bound_s(*peaks.k1(nb)) / t
