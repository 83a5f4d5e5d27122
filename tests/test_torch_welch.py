"""Welch PSD and Welch band sums of the PyTorch port against the JAX
package, on the CPU.

The float64 numpy matrix builders are copies and must give the same bits.
The PSD is a float32 FFT in both packages, summed in different orders by
XLA and by PyTorch (pocketfft), so it agrees to ``PSD_RTOL`` of each
block's largest bin; dB band levels agree to ``DB_ATOL``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meteor_scatter_tpu.ops import welch as jw
from meteor_scatter_tpu_torch.ops import welch as tw

PSD_RTOL = 1e-4
DB_ATOL = 1e-3
BANDS = ((950.0, 1050.0), (650.0, 750.0), (1250.0, 1350.0))


def blocks(n_blocks, block, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_blocks, block)) * 0.05).astype(np.float32)
    t = np.arange(block) / 4000.0
    x[n_blocks // 2] += (0.6 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    return x


@pytest.mark.parametrize("fs,nfft", [(4000, 4096), (4000, 1000), (6000, 257)])
def test_welch_freqs_equal(fs, nfft):
    np.testing.assert_array_equal(tw.welch_freqs(fs, nfft), jw.welch_freqs(fs, nfft))


@pytest.mark.parametrize(
    "shape,nfft,nperseg,noverlap",
    [
        ((12, 800), 4096, 256, None),  # the live detector's 0.2 s block
        ((3, 5, 800), 4096, 256, None),  # batched channels
        ((4, 100), 512, 256, None),  # nperseg clamped to the block, noverlap after it
        ((4, 1000), 1001, 200, 50),  # odd nfft, explicit overlap
        ((2, 700), 256, 128, 0),
    ],
)
def test_welch_psd_matches(shape, nfft, nperseg, noverlap):
    x = blocks(int(np.prod(shape[:-1])), shape[-1], 1).reshape(shape)
    p_t = tw.welch_psd(torch.from_numpy(x), 4000, nfft, nperseg, noverlap)
    p_j = np.asarray(jw.welch_psd(jnp.asarray(x), 4000, nfft, nperseg, noverlap))
    assert p_t.dtype == torch.float32 and tuple(p_t.shape) == p_j.shape
    scale = p_j.max(axis=-1, keepdims=True)
    np.testing.assert_allclose(p_t.numpy() / scale, p_j / scale, rtol=0, atol=PSD_RTOL)


def test_welch_psd_rejects_like_jax():
    x = torch.zeros(4, 800)
    with pytest.raises(ValueError, match="noverlap"):
        tw.welch_psd(x, 4000, 4096, 256, 256)
    with pytest.raises(ValueError, match="nfft"):
        tw.welch_psd(x, 4000, 128, 256)


@pytest.mark.parametrize(
    "band",
    [(950.0, 1050.0), (0.0, 0.0), (1999.0, 2000.0), (1000.3, 1000.4)],  # DC, Nyquist, empty
)
def test_band_sum_db_matches(band):
    x = blocks(10, 800, 2)
    psd_j = jw.welch_psd(jnp.asarray(x), 4000, 4096)
    psd_t = torch.from_numpy(np.array(psd_j))  # one PSD: the band sum alone is compared
    freqs = jw.welch_freqs(4000, 4096)
    got = tw.band_sum_db(psd_t, freqs, band).numpy()
    want = np.asarray(jw.band_sum_db(psd_j, freqs, band))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=DB_ATOL)
    if band == (1000.3, 1000.4):
        assert np.all(got == -np.inf)  # an empty band sums to 0: -inf dB, as the reference


@pytest.mark.parametrize("compress_rtol", [None, 1e-10])
def test_welch_band_matrix_bit_equal(compress_rtol):
    P_t, s_t = tw.welch_band_matrix(4000, 4096, 256, BANDS, compress_rtol)
    P_j, s_j = jw.welch_band_matrix(4000, 4096, 256, BANDS, compress_rtol)
    assert P_t.dtype == P_j.dtype == np.float32 and s_t == s_j
    np.testing.assert_array_equal(P_t, P_j)


@pytest.mark.parametrize("fs,block,nperseg", [(4000, 800, 256), (4000, 400, 256)])
def test_block_band_matrix_bit_equal(fs, block, nperseg):
    P_t, s_t, n_t = tw.block_band_matrix(fs, 4096, nperseg, block, BANDS)
    P_j, s_j, n_j = jw.block_band_matrix(fs, 4096, nperseg, block, BANDS)
    assert s_t == s_j and n_t == n_j
    np.testing.assert_array_equal(P_t, P_j)


def test_block_band_matrix_rejects_short_block():
    with pytest.raises(ValueError, match="shorter"):
        tw.block_band_matrix(4000, 4096, 256, 200, BANDS)


def test_block_band_sums_db_matches_and_equals_welch():
    P, slices, nseg = tw.block_band_matrix(4000, 4096, 256, 800, BANDS)
    x = blocks(12, 800, 3).reshape(3, 4, 800)
    got = tw.block_band_sums_db(torch.from_numpy(x), torch.from_numpy(P), slices, nseg)
    want = jw.block_band_sums_db(jnp.asarray(x), jnp.asarray(P), slices, nseg)
    psd = tw.welch_psd(torch.from_numpy(x), 4000, 4096)
    freqs = tw.welch_freqs(4000, 4096)
    for band, g, w in zip(BANDS, got, want):
        assert tuple(g.shape) == (3, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=DB_ATOL)
        # the block factor equals the framed Welch band level
        np.testing.assert_allclose(g.numpy(), tw.band_sum_db(psd, freqs, band).numpy(),
                                   rtol=0, atol=5e-3)
