"""The DDC channel bank's per-row phase rotation: the CUDA kernel and its
plain twin.

After the bank's product ``G = hh^T @ frames^T``, laid out
``(..., 2, C, A, m)`` (:func:`meteor_scatter_tpu_torch.ops.fir._bank_apply`),
each output is its frame row's phase rotation summed over the A tap
columns (angle addition: cos(r+b) = cr·cb − sr·sb, sin(r+b) = sr·cb + cr·sb):

    dc[..., c, n] = Σ_a cr[c, n+a]·G[..., 0, c, a, n+a] − sr[c, n+a]·G[..., 1, c, a, n+a]
    ds[..., c, n] = Σ_a sr[c, n+a]·G[..., 0, c, a, n+a] + cr[c, n+a]·G[..., 1, c, a, n+a]

``cr`` / ``sr`` are the (C, ≥ n_out + A − 1) row phases, which may be
column slices of the kept plan's (C, m) tables.  Returns ``(dc, ds)``,
each ``G.shape[:-4] + (C, n_out)``.

Dispatch is by the device of G (:func:`bank_rotate`):

* CUDA tensor → the hand-written kernel ``csrc/bank_rotate.cu``, one
  launch for every batch row and channel, built at first use.  Whatever
  the kernel does not take raises; there is no fallback to the twin.
* CPU tensor → :func:`bank_rotate_plain`, the loop over the A tap columns.

The two are bit-exact: the kernel rounds every product, sum and
difference once, in the twin's order, from accumulators at +0.0 (the
twin's zeros).  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from meteor_scatter_tpu_torch.ops.kernels import _build

MAX_ROWS = 65535  # batch rows x channels: the kernel's grid rows
PER_BLOCK = 1024  # outputs one block of the kernel covers (kThreads x kItems)

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it


def bank_rotate_plain(g: torch.Tensor, cr: torch.Tensor, sr: torch.Tensor,
                      n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: per tap column a, four products,
    a sum and a difference on each (…, C, n_out) slice, in this order."""
    c_n, a_cols = g.shape[-3], g.shape[-2]
    dc = g.new_zeros(g.shape[:-4] + (c_n, n_out))
    ds = torch.zeros_like(dc)
    for a in range(a_cols):
        gc = g[..., 0, :, a, a : a + n_out]  # (..., C, n_out)
        gs = g[..., 1, :, a, a : a + n_out]
        crs = cr[:, a : a + n_out]
        srs = sr[:, a : a + n_out]
        dc = dc + crs * gc - srs * gs
        ds = ds + srs * gc + crs * gs
    return dc, ds


def _launch(g: torch.Tensor, cr: torch.Tensor, sr: torch.Tensor,
            n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/bank_rotate.cu`` on the current stream.  G must
    be a contiguous float32 (..., 2, C, A, m) tensor on a CUDA device with
    m ≥ n_out + A − 1; ``cr`` / ``sr`` float32 (C, ≥ n_out + A − 1) on the
    same device, any row stride, unit column stride.  Anything else raises."""
    global launches
    n_out = int(n_out)
    if not g.is_cuda:
        raise ValueError(f"bank rotation kernel takes CUDA tensors, got one on {g.device}")
    if g.dim() < 4 or g.shape[-4] != 2:
        raise ValueError(f"G must be (..., 2, C, A, m), got shape {tuple(g.shape)}")
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"G must be a contiguous float32 tensor, got {g.dtype} "
                         f"(contiguous={g.is_contiguous()})")
    c_n, a_cols, m = g.shape[-3:]
    batch = g.shape[:-4]
    rows = math.prod(batch) * c_n
    need = n_out + a_cols - 1
    if n_out < 0 or a_cols < 1 or m < need:
        raise ValueError(f"need n_out >= 0, A >= 1 and m >= n_out + A - 1 "
                         f"(n_out={n_out}, A={a_cols}, m={m})")
    if rows > MAX_ROWS or n_out > 2**31 - 1 - PER_BLOCK:
        raise ValueError(f"{rows} rows of {n_out} outputs exceed the kernel's grid")
    for name, t in (("cr", cr), ("sr", sr)):
        if (t.dtype != torch.float32 or t.device != g.device or t.dim() != 2
                or t.shape[0] != c_n or t.shape[1] < need or t.stride(1) != 1):
            raise ValueError(
                f"{name} must be a float32 ({c_n}, >= {need}) tensor on {g.device} with unit "
                f"column stride, got {t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}")
    dc = torch.empty(batch + (c_n, n_out), dtype=torch.float32, device=g.device)
    ds = torch.empty_like(dc)
    if rows == 0 or n_out == 0:
        return dc, ds
    fn = _bind(_build.load("bank_rotate"))
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), cr.data_ptr(), cr.stride(0), sr.data_ptr(), sr.stride(0),
                 dc.data_ptr(), ds.data_ptr(), rows, c_n, a_cols, m, n_out,
                 torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bank rotation kernel launch failed: CUDA error {err}")
    launches += 1
    return dc, ds


def _bind(lib: ctypes.CDLL):
    fn = lib.ms_bank_rotate
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, ll, p, ll, p, p, i, i, i, ll, i, p]
        fn.restype = ctypes.c_int
    return fn


def bank_rotate(g: torch.Tensor, cr: torch.Tensor, sr: torch.Tensor,
                n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rotation on G's device: the kernel on CUDA, the twin on the CPU."""
    dev = g.device
    if dev.type == "cpu":
        return bank_rotate_plain(g, cr, sr, n_out)
    if dev.type == "cuda":
        return _launch(g, cr, sr, n_out)
    raise ValueError(f"bank rotation: tensors on {dev} are not supported (cpu or cuda)")
