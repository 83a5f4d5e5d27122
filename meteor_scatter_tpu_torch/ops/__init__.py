"""Numerics of the port: windows, framing, band power, FIR filtering and the
DDC channel bank, and the hand-written GPU kernels under
:mod:`meteor_scatter_tpu_torch.ops.kernels`."""

from meteor_scatter_tpu_torch.ops.fir import (  # noqa: F401
    firwin_lowpass,
    firwin_bandpass,
    fir_filter,
    polyphase_decimate,
    resample_poly,
)
