"""The work of the I/Q front end's two products, for their roofline shares:
counts of the problem (shapes, taps, rates), not of the code, each input
byte read once and each output byte written once; :func:`peaks.bound_s`
turns them into the least time the card could take.

* The DDC bank's GEMM: the (2, m, q) frames of I and Q against the
  (q, 2·C·A) tap table with the mixer folded in, ``A = ceil(taps / q)``
  and ``m = n_out + A − 1`` rows for ``n_out = (n − 1)//q + 1``; the (2,
  2·C·A, m) product written.
* The rational resampler: each of the C·n_out outputs
  (``n_out = ceil(n_in·up/down)``) takes the ``ceil(taps / up)`` taps that
  meet input samples; the stuffed zeros are not work.  Its low-pass has
  ``2·20·max(up, down) + 1`` taps.
"""

from __future__ import annotations

from bench_h100.peaks import bound_s
from bench_h100.reference.channelizer import TAPS_PER_PHASE, stages

CHANNELIZE = "ms.channelize"
RESAMPLE = "ms.resample"


def bank_gemm(n: int, channels: int, decim: int, numtaps: int) -> tuple:
    """(bytes, flops) of the bank's product over an I/Q capture of ``n``
    complex samples."""
    a = -(-numtaps // decim)
    m = (n - 1) // decim + 1 + a - 1
    cols = 2 * channels * a
    return 4.0 * (2 * m * decim + decim * cols + 2 * cols * m), 2.0 * 2 * m * decim * cols


def resample_conv(n_in: int, channels: int, up: int, down: int) -> tuple:
    """(bytes, flops) of the resampler's non-zero taps over (channels, n_in)."""
    numtaps = 2 * TAPS_PER_PHASE * max(up, down) + 1
    n_out = -(-n_in * up // down)
    taps = -(-numtaps // up)
    return 4.0 * (channels * (n_in + n_out) + numtaps), 2.0 * channels * n_out * taps


def _shape(cell) -> tuple:
    cfg = cell.config
    fs = int(cfg["sample_rate"])
    n = int(round(cell.traffic["capture_seconds"] * fs))
    fe = cfg["frontend"]
    decim, up, down = stages(fs, int(fe["audio_rate"]), float(fe["channel_bandwidth"]))
    return n, int(cfg["stations"]), decim, up, down, int(fe["numtaps"])


def bank_bound_s(cell) -> float:
    """Least seconds of one capture's bank product."""
    n, c, decim, _, _, numtaps = _shape(cell)
    return bound_s(*bank_gemm(n, c, decim, numtaps))


def resample_bound_s(cell) -> float:
    """Least seconds of one capture's resampling."""
    n, c, decim, up, down, _ = _shape(cell)
    return bound_s(*resample_conv((n - 1) // decim + 1, c, up, down))
