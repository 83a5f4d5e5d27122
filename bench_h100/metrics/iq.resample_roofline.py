"""The rational resampler's share of its roofline, in %: the least time for
the traced captures' resampling (``iq_work.resample_conv``: its non-zero
taps only) over the device time of the convolution kernels (launched by an
operator whose name holds ``conv``) inside the port's ``ms.resample`` span."""

from bench_h100 import iq_work


def read(run):
    n = run.traced_requests
    if not n:
        return None
    conv = [e for e in run.trace.kernels(range_name=iq_work.RESAMPLE)
            if any(s.get("cat") == "cpu_op" and "conv" in s.get("name", "")
                   for s in run.trace.host_stack(e))]
    t = run.trace.seconds(conv)
    if t <= 0:
        return None
    return 100.0 * n * iq_work.resample_bound_s(run.cell) / t
