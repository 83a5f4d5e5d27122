"""Device ms a capture of the kernels inside the port's ``ms.channelize``
span other than the bank's GEMM: the stack of I and Q, the padded framing
copy and the per-row rotation."""

from bench_h100 import iq_work

MM_OPS = ("aten::mm", "aten::matmul", "aten::addmm", "aten::bmm")


def read(run):
    n = run.traced_requests
    if not n:
        return None
    every = run.trace.kernels(range_name=iq_work.CHANNELIZE)
    if not every:
        return None
    gemm = {id(e) for e in run.trace.kernels(op_in=MM_OPS, range_name=iq_work.CHANNELIZE)}
    return 1e3 * run.trace.seconds([e for e in every if id(e) not in gemm]) / n
