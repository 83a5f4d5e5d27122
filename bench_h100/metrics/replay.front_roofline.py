"""The bins front's projection's share of its roofline, in %: the least
time for the traced chunks' band projections (``peaks.bins_front_gemm``)
over the device time of the kernels that ``aten::mm`` / ``aten::matmul``
launched inside ``stream_process``."""

from bench_h100 import peaks
from bench_h100.drivers import stream_common as sc
from bench_h100.drivers.card_chunks import REQUEST

MM_OPS = ("aten::mm", "aten::matmul", "aten::addmm", "aten::bmm")


def read(run):
    n = run.traced_requests
    if not n:
        return None
    t = run.trace.seconds(run.trace.kernels(op_in=MM_OPS, range_name=REQUEST))
    if t <= 0:
        return None
    cfg, tr = run.cell.config, run.cell.traffic
    det = cfg["detection"]
    fs = cfg["sample_rate"]
    block = int(round(det["proc_block_sec"] * fs))
    rows = cfg["stations"] * (int(tr["chunk_seconds"] * fs) // block)
    b, f = peaks.bins_front_gemm(rows, fs, det["n_fft"], min(det["welch_nperseg"], block), block,
                                 sc.bands(det))
    return 100.0 * n * peaks.bound_s(b, f) / t
