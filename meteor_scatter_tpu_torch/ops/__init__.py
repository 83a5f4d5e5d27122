"""Numerics of the port: windows, framing, band power, Welch PSD,
spectrograms, FIR filtering and the DDC channel bank, and the hand-written
GPU kernels under :mod:`meteor_scatter_tpu_torch.ops.kernels`."""

from meteor_scatter_tpu_torch.ops.window import hann_symmetric, hann_periodic, get_window  # noqa: F401
from meteor_scatter_tpu_torch.ops.framing import frame_signal, num_frames  # noqa: F401
from meteor_scatter_tpu_torch.ops.bandpower import (  # noqa: F401
    band_projection_matrix,
    band_power_db,
    delta_power_db,
)
from meteor_scatter_tpu_torch.ops.welch import welch_psd, welch_freqs  # noqa: F401
from meteor_scatter_tpu_torch.ops.spectrogram import (  # noqa: F401
    spectrogram_scipy,
    spectrogram_mpl,
    spectrogram_db,
)
from meteor_scatter_tpu_torch.ops.fir import (  # noqa: F401
    firwin_lowpass,
    firwin_bandpass,
    fir_filter,
    polyphase_decimate,
    resample_poly,
)
