"""Window functions.

The reference mixes two Hann conventions and parity depends on getting both
right:

* ``np.hanning(M)`` — *symmetric* Hann (endpoints are exactly 0), used by the
  batch analyzer (`dsp/src/main.py:379`) and by matplotlib's
  ``window_hanning`` inside ``plt.specgram`` (`prime_detection.py:66`).
* scipy's ``get_window('hann', M, fftbins=True)`` — *periodic* Hann, used by
  ``scipy.signal.welch`` / ``scipy.signal.spectrogram``
  (`processor.py:206`, `main.py:52`).

Implemented here from first principles on top of numpy so the framework has
no scipy dependency in its compute path.

A copy of `meteor_scatter_tpu/ops/window.py`: importing that module runs
`meteor_scatter_tpu/ops/__init__.py`, which loads JAX, and the port must
import without JAX.
"""

from __future__ import annotations

import numpy as np


def hann_symmetric(m: int, dtype=np.float64) -> np.ndarray:
    """Symmetric Hann window, identical to ``np.hanning(m)``."""
    if m == 1:
        return np.ones(1, dtype=dtype)
    n = np.arange(m, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (m - 1))
    return w.astype(dtype)


def hann_periodic(m: int, dtype=np.float64) -> np.ndarray:
    """Periodic (DFT-even) Hann window, identical to
    ``scipy.signal.get_window('hann', m)``."""
    if m == 1:
        return np.ones(1, dtype=dtype)
    n = np.arange(m, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / m)
    return w.astype(dtype)


def get_window(name: str, m: int, periodic: bool = True, dtype=np.float64) -> np.ndarray:
    if name not in ("hann", "hanning"):
        raise ValueError(f"Unsupported window: {name}")
    return hann_periodic(m, dtype) if periodic else hann_symmetric(m, dtype)
