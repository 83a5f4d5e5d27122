"""The batch band projection's share of its roofline, in %: the least time
the card could take for the traced files' GEMMs (``peaks.bandpower_gemm``)
over the device time of the kernels that ``aten::mm`` / ``aten::matmul``
launched inside ``proc_wav_file``."""

from bench_h100 import peaks
from bench_h100.drivers.wav_files import REQUEST

MM_OPS = ("aten::mm", "aten::matmul", "aten::addmm", "aten::bmm")


def read(run):
    n = run.traced_requests
    if not n:
        return None
    t = run.trace.seconds(run.trace.kernels(op_in=MM_OPS, range_name=REQUEST))
    if t <= 0:
        return None
    cfg = run.cell.config
    fs = cfg["sample_rate"]
    block = int(fs * cfg["block_duration_sec"])
    nb = int(run.cell.traffic["file_seconds"] * fs) // block
    b, f = peaks.bandpower_gemm(nb, fs, 2 * cfg["n_fft"], block, [cfg["freq_band"], cfg["noise_band"]])
    return 100.0 * n * peaks.bound_s(b, f) / t
