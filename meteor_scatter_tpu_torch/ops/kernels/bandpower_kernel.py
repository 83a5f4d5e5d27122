"""Fused band power: the CUDA kernel K2 and its plain twin.

Counterpart of `meteor_scatter_tpu/ops/pallas/bandpower_kernel.py`, with
``band_power_db_pallas`` and ``fused_bandpower_delta`` under the same names
and arguments (minus the TPU's ``tile_frames`` and ``interpret``).  One call
computes, per frame, ``p = frame[:L] @ M`` against the windowed
DFT-selector matrix ``M`` (L, n_band + n_noise), then the per-band sums of
``p²`` plus the power floor, ``10·log10`` of each, and their difference:
(band_db, noise_db, delta), each (nf,).  Neither the projection nor the
spectra leave the kernel.

Dispatch is by the device of the frames:

* CUDA tensor → the hand-written kernel ``csrc/bandpower.cu``, built at
  first use; it reads the frames in place from any row stride (a frame
  view of a flat capture is not copied).  Whatever the kernel does not
  take raises; there is no fallback to the twin.
* CPU tensor → :func:`band_power_db_plain`, the same function in plain
  PyTorch (``torch.matmul`` in float32, square, per-band sums, log10).

The batch analyzer keeps its own ``torch.matmul`` band power
(:func:`meteor_scatter_tpu_torch.ops.bandpower.delta_power_db`), as the JAX
analyzer keeps ``jnp.dot``; these entry points are the fused form.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.ops import bandpower
from meteor_scatter_tpu_torch.ops.framing import frame_signal
from meteor_scatter_tpu_torch.ops.kernels import _build

MAX_COLUMNS = 32  # projection columns the kernel keeps per thread
SHARED_BYTES = 232448  # shared memory one block may use on Hopper

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def band_power_db_plain(
    frames: torch.Tensor, projection: torch.Tensor, n_band: int, power_floor: float
) -> Result:
    """Plain PyTorch twin of the kernel: (band_db, noise_db, delta) of the
    frames' first L samples, L = ``projection.shape[0]``; columns
    [0, n_band) of the projection are the signal band, the rest noise."""
    band_db, noise_db = bandpower.band_power_db(
        frames, projection,
        [slice(0, n_band), slice(n_band, projection.shape[1])], power_floor,
    )
    return band_db, noise_db, band_db - noise_db


def _launch(
    frames: torch.Tensor, projection: torch.Tensor, n_band: int, power_floor: float
) -> Result:
    """One launch of ``csrc/bandpower.cu`` on the current stream."""
    global launches
    if not frames.is_cuda:
        raise ValueError(f"band power kernel takes CUDA tensors, got one on {frames.device}")
    if frames.dtype != torch.float32 or frames.dim() != 2 or frames.stride(1) != 1:
        raise ValueError(
            f"frames must be a 2-D float32 tensor with unit column stride, got {frames.dtype} "
            f"of shape {tuple(frames.shape)} and strides {frames.stride()}"
        )
    if (projection.dtype != torch.float32 or projection.dim() != 2
            or projection.device != frames.device or not projection.is_contiguous()):
        raise ValueError(f"projection must be a contiguous 2-D float32 tensor on {frames.device}")
    nf, width = frames.shape
    L, ncols = projection.shape
    if not 0 < L <= width:
        raise ValueError(f"projection rows ({L}) must lie in [1, frame width {width}]")
    if not 0 < ncols <= MAX_COLUMNS or not 0 <= n_band <= ncols:
        raise ValueError(f"the kernel takes 1..{MAX_COLUMNS} projection columns with "
                         f"0 <= n_band <= columns, got {ncols} columns, n_band {n_band}")
    kmax = 16 if ncols <= 16 else 32
    if L * kmax * 4 > SHARED_BYTES:
        raise ValueError(f"a {L} x {kmax} projection does not fit one block's shared memory")
    if nf >= 2**31 or nf * frames.stride(0) + width >= 2**62:
        raise ValueError(f"{nf} frames too many for the kernel's indexing")

    dev = frames.device
    out = torch.empty((3, nf), dtype=torch.float32, device=dev)
    if nf:
        fn = _bind(_build.load("bandpower"))
        with torch.cuda.device(dev):
            err = fn(
                frames.data_ptr(), frames.stride(0), nf, L, projection.data_ptr(), ncols,
                n_band, float(power_floor), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"band power kernel launch failed: CUDA error {err}")
        launches += 1
    return out[0], out[1], out[2]


def _bind(lib: ctypes.CDLL):
    fn = lib.ms_bandpower
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, i, i, p, i, i, ctypes.c_float, p, p]
        fn.restype = ctypes.c_int
    return fn


def band_power_db_pallas(
    frames: torch.Tensor,
    projection: np.ndarray,
    slices: Sequence[slice],
    power_floor: float = 1e-12,
) -> Result:
    """Fused (band_db, noise_db, delta) from raw frames (nf, ≥ L).

    ``projection``/``slices`` come from
    :func:`meteor_scatter_tpu_torch.ops.bandpower.band_projection_matrix`
    with exactly two bands (signal, noise), signal columns first.
    """
    if len(slices) != 2:
        raise ValueError("expected exactly [signal, noise] bands")
    n_band = slices[0].stop - slices[0].start
    n_noise = slices[1].stop - slices[1].start
    L, ncols = projection.shape
    if n_band + n_noise != ncols or slices[0].start != 0 or slices[1].start != n_band:
        raise ValueError("projection/slices mismatch")
    f = frames.to(torch.float32)
    proj = torch.as_tensor(np.ascontiguousarray(projection, dtype=np.float32)).to(f.device)
    if f.device.type == "cpu":
        return band_power_db_plain(f, proj, n_band, power_floor)
    if f.device.type == "cuda":
        return _launch(f, proj, n_band, power_floor)
    raise ValueError(f"band power: tensors on {f.device} are not supported (cpu or cuda)")


def fused_bandpower_delta(
    x: torch.Tensor,
    fs: float,
    n_fft: int,
    block_size: int,
    freq_band: Tuple[float, float],
    noise_band: Tuple[float, float],
    power_floor: float = 1e-12,
) -> Result:
    """End-to-end hot loop with the fused kernel, on ``x``'s device
    (drop-in for :func:`meteor_scatter_tpu_torch.ops.bandpower.delta_power_db`).
    The frames are a view of ``x``: the kernel reads the first
    L = min(block_size, n_fft) samples of each block in place."""
    M, slices = bandpower.band_projection_matrix(
        fs, n_fft, block_size, [freq_band, noise_band]
    )
    frames = frame_signal(x.to(torch.float32), block_size, block_size)
    return band_power_db_pallas(frames, M, slices, power_floor)
