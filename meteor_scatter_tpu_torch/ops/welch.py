"""Welch PSD with scipy-compatible semantics, and Welch band sums as
matrix products.

Counterpart of `meteor_scatter_tpu/ops/welch.py`.  The streaming
pipeline's only spectral op is ``scipy.signal.welch(block, fs, nfft=n_fft)``
(`dsp/src/live/backend/processor.py:206`), i.e. scipy *defaults* everywhere
else:

    nperseg=256, window='hann' (periodic), noverlap=nperseg//2,
    detrend='constant', scaling='density', onesided, average='mean'

Re-derived here (no scipy at runtime)::

    seg   = frame(x, nperseg, nperseg - noverlap)
    seg  -= mean(seg, -1)                      # detrend 'constant'
    X     = rfft(seg * win, nfft)
    Pxx   = |X|^2 / (fs * sum(win^2))          # density scaling
    Pxx[..., 1:-1] *= 2 (even nfft) / [..., 1:] *= 2 (odd)   # onesided
    Pxx   = mean over segments

The matrix builders (:func:`welch_band_matrix`, :func:`block_band_matrix`)
are float64 numpy, copied from the JAX package so that they give the same
bits; only the products that use them run in PyTorch (float32, TF32 off).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.device import constant_on
from meteor_scatter_tpu_torch.ops.framing import frame_signal, num_frames
from meteor_scatter_tpu_torch.ops.window import hann_periodic


def welch_freqs(fs: float, nfft: int) -> np.ndarray:
    return np.fft.rfftfreq(nfft, d=1.0 / fs)


def welch_psd(
    x: torch.Tensor,
    fs: float,
    nfft: int,
    nperseg: int = 256,
    noverlap: int | None = None,
    detrend: str = "constant",
) -> torch.Tensor:
    """PSD of the last axis; returns (..., nfft//2 + 1) in power/Hz, on
    ``x``'s device.

    Matches ``scipy.signal.welch(x, fs, nperseg=nperseg, noverlap=noverlap,
    nfft=nfft)`` with a periodic Hann window to f32 accuracy.
    """
    nperseg = min(nperseg, x.shape[-1])  # scipy clamps when input is short
    if noverlap is None:
        # derived AFTER the clamp, as scipy does — deriving first leaves
        # hop <= 0 for short inputs (division by zero / empty framing)
        noverlap = nperseg // 2
    elif noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    hop = nperseg - noverlap

    win = constant_on(hann_periodic(nperseg, dtype=np.float32), x.device)
    seg = frame_signal(x.to(torch.float32), nperseg, hop)
    if detrend == "constant":
        seg = seg - seg.mean(dim=-1, keepdim=True)
    X = torch.fft.rfft(seg * win, n=nfft, dim=-1)
    p = (X.real * X.real + X.imag * X.imag) / (fs * float(np.sum(hann_periodic(nperseg) ** 2)))
    # one-sided doubling: every bin except DC, and except Nyquist when nfft even
    nbins = nfft // 2 + 1
    scale = np.ones(nbins, dtype=np.float32) * 2.0
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    p = p * constant_on(scale, x.device)
    return p.mean(dim=-2)


def welch_band_matrix(
    fs: float,
    nfft: int,
    nperseg: int,
    bands: Tuple[Tuple[float, float], ...],
    compress_rtol: float | None = None,
):
    """Projection matrix computing Welch *band sums* without the full PSD.

    Each band sum Σ_k∈band |X_k|²·c_k per segment is the squared norm of a
    handful of DFT rows; those rows (window, constant detrend, density
    scaling and one-sided doubling folded in) become the columns of one
    (nperseg, 2·total_bins) float32 matrix.  Returns ``(P, slices)``:
    ``seg @ P`` squared and summed over ``slices[b]`` is band ``b``'s Welch
    band sum up to f32 reduction order.

    ``compress_rtol`` replaces each band's factor ``V_b`` by its float64
    eigen-factor ``U_r·√λ_r`` (eigenpairs with λ > compress_rtol·λ_max),
    which keeps every band sum to the truncated eigenmass.
    """
    freqs = welch_freqs(fs, nfft)
    win = hann_periodic(nperseg)  # float64
    norm = fs * float(np.sum(win**2))
    nbins = nfft // 2 + 1
    scale = np.ones(nbins) * 2.0
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0

    n = np.arange(nperseg)
    band_blocks = []
    slices = []
    start = 0
    for band in bands:
        idx = np.nonzero((freqs >= band[0]) & (freqs <= band[1]))[0]
        cols = []
        for k in idx:
            c = np.sqrt(scale[k] / norm)
            ang = 2.0 * np.pi * k * n / nfft
            for basis in (np.cos(ang), np.sin(ang)):  # sign of -sin is squared away
                v = win * basis * c
                v = v - v.mean()  # detrend 'constant' folded in (symmetric)
                cols.append(v)
        V = (
            np.stack(cols, axis=1)
            if cols
            else np.zeros((nperseg, 0), np.float64)
        )
        if compress_rtol is not None and V.shape[1] > 1:
            lam, U = np.linalg.eigh(V @ V.T)  # float64 throughout
            keep = lam > compress_rtol * lam[-1]
            V = U[:, keep] * np.sqrt(lam[keep])
        band_blocks.append(V)
        slices.append((start, start + V.shape[1]))
        start += V.shape[1]
    P = np.concatenate(band_blocks, axis=1).astype(np.float32)
    return P, tuple(slices)


def block_band_matrix(
    fs: float,
    nfft: int,
    nperseg: int,
    block: int,
    bands: Tuple[Tuple[float, float], ...],
    noverlap: int | None = None,
    rtol: float = 1e-10,
):
    """Whole-block Welch band sums as ONE quadratic form per block.

    A block's Welch band level is ``xᵀ M_b x`` with
    ``M_b = Σ_o S_oᵀ V_b V_bᵀ S_o`` (``S_o`` selects segment offset o,
    ``V_b`` the :func:`welch_band_matrix` factor).  ``M_b`` is a
    (block, block) PSD bandlimit operator of numerical rank ≈ 2·(band
    width)·(block duration); its float64 eigen-factor ``U_r·√λ_r`` turns
    framing, window, DFT selection and segment mean into one
    (..., block) @ (block, K) product.

    Returns ``(P, slices, nseg)``: ``‖x_block @ P[:, a:b]‖² / nseg`` is
    band b's Welch level, accurate to the truncated eigenmass (≤ rtol·λmax
    per direction).  Semantics anchor: `dsp/src/live/backend/processor.py:206`
    (scipy.signal.welch per 0.2 s block).
    """
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    nseg = num_frames(block, nperseg, hop)
    if nseg <= 0:
        raise ValueError(f"block {block} shorter than nperseg {nperseg}")
    V_full, v_slices = welch_band_matrix(fs, nfft, nperseg, bands)
    band_blocks = []
    slices = []
    start = 0
    for a, b in v_slices:
        V = V_full[:, a:b].astype(np.float64)
        M = np.zeros((block, block))
        for s in range(nseg):
            o = s * hop
            M[o : o + nperseg, o : o + nperseg] += V @ V.T
        if M.any():
            lam, U = np.linalg.eigh(M)
            keep = lam > rtol * lam[-1]
            U_r = U[:, keep] * np.sqrt(lam[keep])
        else:
            U_r = np.zeros((block, 0))
        band_blocks.append(U_r)
        slices.append((start, start + U_r.shape[1]))
        start += U_r.shape[1]
    P = np.concatenate(band_blocks, axis=1).astype(np.float32)
    return P, tuple(slices), nseg


def block_band_sums_db(
    x3: torch.Tensor,  # (..., block)
    projection: torch.Tensor,  # (block, K) from block_band_matrix, on x3's device
    slices,
    nseg: int,
):
    """Band dB levels per block via :func:`block_band_matrix` — one
    float32 product on the contiguous block tensor.  Equal to the
    segment-framed Welch path up to the factor's truncated eigenmass and
    f32 reduction order."""
    xf = x3.to(torch.float32)
    lead = xf.shape[:-1]
    proj = xf.reshape(-1, xf.shape[-1]) @ projection
    pw = proj.square().reshape(lead + (projection.shape[-1],))
    return [10.0 * torch.log10(pw[..., a:b].sum(dim=-1) / nseg) for a, b in slices]


def welch_band_sums_db(
    x: torch.Tensor,
    nperseg: int,
    projection: torch.Tensor,  # (nperseg, K) from welch_band_matrix, on x's device
    slices,
    noverlap: int | None = None,
):
    """Band dB levels over the last axis via :func:`welch_band_matrix` —
    equal to ``band_sum_db(welch_psd(x, ...), band)`` per band to float32
    summation order.  Returns a list of (...,)-shaped dB tensors.

    When the hop divides ``nperseg`` (the standard 50 % overlap), the mean
    over segments is taken as per-offset *group sums*: the segments at
    offset class r (r·hop, r·hop + nperseg, ...) are one slice and reshape
    of the input, so the overlapped frame tensor is never built.  Otherwise
    the segments are framed (:func:`frame_signal`), projected and averaged.
    The products are float32 (TF32 off).
    """
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    xf = x.to(torch.float32)
    n = xf.shape[-1]
    nseg = num_frames(n, nperseg, hop)
    if nseg > 0 and nperseg % hop == 0:
        sums = None
        for off in range(0, nperseg, hop):
            if n - off < nperseg:
                continue
            nf_r = (n - off - nperseg) // nperseg + 1
            seg = xf[..., off : off + nf_r * nperseg].reshape(xf.shape[:-1] + (nf_r, nperseg))
            pw = (seg @ projection).square()
            s_r = [pw[..., a:b].sum(dim=(-2, -1)) for a, b in slices]
            sums = s_r if sums is None else [s + t for s, t in zip(sums, s_r)]
        return [10.0 * torch.log10(s / nseg) for s in sums]
    seg = frame_signal(xf, nperseg, hop)  # (..., nseg, nperseg)
    proj = seg @ projection
    pw = proj * proj
    return [10.0 * torch.log10(pw[..., a:b].sum(-1).mean(-1)) for a, b in slices]


def band_sum_db(
    psd: torch.Tensor, freqs: np.ndarray, band: Tuple[float, float], floor: float = 0.0
) -> torch.Tensor:
    """10*log10 of the PSD summed over a band (inclusive edges), the
    streaming pipeline's per-block channel level (`processor.py:349-367`).

    The reference emits -inf when the band sum is exactly 0; with floor=0
    ``torch.log10(0) = -inf`` reproduces that (an empty band sums to 0).
    """
    idx = np.nonzero((freqs >= band[0]) & (freqs <= band[1]))[0]
    s = psd[..., constant_on(idx, psd.device)].sum(dim=-1) + floor
    return 10.0 * torch.log10(s)
