"""The streaming solve K3's share of its roofline, in %: the least time for
the traced chunks' solves (``peaks.k3``) over the device time of
``stream_solve_kernel``."""

from bench_h100 import peaks


def read(run):
    n = run.traced_requests
    if not n:
        return None
    t = run.trace.seconds(run.trace.kernels(name_has="stream_solve_kernel"))
    if t <= 0:
        return None
    cfg, tr = run.cell.config, run.cell.traffic
    det = cfg["detection"]
    nb = int(round(tr["chunk_seconds"] / det["proc_block_sec"]))
    b, f = peaks.k3(cfg["stations"], nb, int(det["avg_win_sec"] / det["proc_block_sec"]),
                    det["max_events"])
    return 100.0 * n * peaks.bound_s(b, f) / t
