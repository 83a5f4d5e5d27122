"""The DDC bank's GEMM's share of its roofline, in %: the least time for
the traced captures' bank products (``iq_work.bank_gemm``) over the device
time of the kernels that ``aten::mm`` / ``aten::matmul`` / ``aten::bmm``
launched inside the port's ``ms.channelize`` span."""

from bench_h100 import iq_work

MM_OPS = ("aten::mm", "aten::matmul", "aten::addmm", "aten::bmm")


def read(run):
    n = run.traced_requests
    if not n:
        return None
    t = run.trace.seconds(run.trace.kernels(op_in=MM_OPS, range_name=iq_work.CHANNELIZE))
    if t <= 0:
        return None
    return 100.0 * n * iq_work.bank_bound_s(run.cell) / t
