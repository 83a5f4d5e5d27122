"""Windows, framing and band power of the PyTorch port against the JAX
package, on the CPU.

The numpy constructors (windows, ``band_projection_matrix``) are copies and
must give the same bits.  Band power is a float32 product over L = 1024
samples per block in both packages, summed in different orders by XLA and
by PyTorch, so dB levels agree to ``DB_ATOL``: a relative error of ~1e-6 in
a band's power is ~4e-6 dB, and 1e-4 dB leaves a wide margin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meteor_scatter_tpu.ops import bandpower as jbp
from meteor_scatter_tpu.ops import framing as jfr
from meteor_scatter_tpu.ops import window as jwin
from meteor_scatter_tpu_torch.ops import bandpower as tbp
from meteor_scatter_tpu_torch.ops import framing as tfr
from meteor_scatter_tpu_torch.ops import window as twin

DB_ATOL = 1e-4
FS = 6000


@pytest.mark.parametrize("m", [1, 2, 7, 1024, 1200])
def test_windows_bit_equal(m):
    np.testing.assert_array_equal(twin.hann_symmetric(m), jwin.hann_symmetric(m))
    np.testing.assert_array_equal(twin.hann_periodic(m), jwin.hann_periodic(m))
    # numpy writes the same window with another formula: equal to rounding
    np.testing.assert_allclose(twin.hann_symmetric(m), np.hanning(m), rtol=0, atol=1e-15)


@pytest.mark.parametrize(
    "fs,n_fft,frame_len,bands",
    [
        (6000, 1024, 1200, [(993.0, 1013.0), (690.0, 710.0)]),  # the analyzer's
        (5000, 512, 500, [(990.0, 1050.0)]),
        (6000, 1024, 1200, [(5000.0, 6000.0), (0.0, 0.0)]),  # band edges at 0 and Nyquist
        (6000, 1024, 1200, [(1000.5, 1000.6)]),  # no bin inside
    ],
)
def test_projection_matrix_bit_equal(fs, n_fft, frame_len, bands):
    m_t, s_t = tbp.band_projection_matrix(fs, n_fft, frame_len, bands)
    m_j, s_j = jbp.band_projection_matrix(fs, n_fft, frame_len, bands)
    assert m_t.dtype == m_j.dtype and m_t.shape == m_j.shape
    np.testing.assert_array_equal(m_t, m_j)
    assert s_t == s_j
    for band in bands:
        np.testing.assert_array_equal(tbp.band_bins(fs, n_fft, band), jbp.band_bins(fs, n_fft, band))


@pytest.mark.parametrize(
    "n,frame_len,hop",
    [(12000, 1200, 1200), (12345, 1200, 1200), (5000, 1024, 512), (5000, 1024, 300),
     (999, 1024, 512), (3000, 100, 1000)],
)
def test_frame_signal_matches(n, frame_len, hop):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    f_t = tfr.frame_signal(torch.from_numpy(x), frame_len, hop)
    f_j = np.asarray(jfr.frame_signal(jnp.asarray(x), frame_len, hop))
    assert tfr.num_frames(n, frame_len, hop) == jfr.num_frames(n, frame_len, hop) == f_j.shape[0]
    assert tuple(f_t.shape) == f_j.shape
    np.testing.assert_array_equal(f_t.numpy(), f_j)


def test_frame_signal_batched_leading_axes():
    x = np.random.default_rng(1).standard_normal((3, 4000)).astype(np.float32)
    f_t = tfr.frame_signal(torch.from_numpy(x), 1024, 300)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(jfr.frame_signal(jnp.asarray(x), 1024, 300)))


def audio(seconds, seed, pcm=False):
    rng = np.random.default_rng(seed)
    t = np.arange(int(FS * seconds)) / FS
    x = rng.standard_normal(len(t)) * 0.5
    m = (t >= 20.0) & (t < 21.0)
    x[m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m])
    return np.round(x * 3000).astype(np.int16) if pcm else x.astype(np.float32)


@pytest.mark.parametrize("pcm", [False, True])
def test_delta_power_db_matches(pcm):
    x = audio(120, 4, pcm)
    args = (FS, 1024, 1200, (993.0, 1013.0), (690.0, 710.0))
    out_t = tbp.delta_power_db(torch.from_numpy(x), *args)
    out_j = jbp.delta_power_db(jnp.asarray(x), *args)
    for a_t, a_j in zip(out_t, out_j):
        assert a_t.dtype == torch.float32 and tuple(a_t.shape) == (600,)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=DB_ATOL)
    # the tone stands far above the noise band in its blocks
    assert float(out_t[2][100:105].min()) > 20.0


# ---- K2: the fused band-power entry points (the kernel's plain twin here) ----

K2_ATOL = (2e-3, 2e-3, 4e-3)  # band, noise, delta: the JAX package's kernel tolerances


@pytest.mark.parametrize("seconds,tone", [(10, True), (7, False)])  # 50 blocks; 35, not a tile multiple
def test_fused_bandpower_matches_jax_kernel(seconds, tone):
    from meteor_scatter_tpu.ops.pallas import bandpower_kernel as jbk
    from meteor_scatter_tpu_torch.ops.kernels import bandpower_kernel as tbk

    rng = np.random.default_rng(seconds)
    x = (rng.standard_normal(FS * seconds) * 0.5).astype(np.float32)
    if tone:
        t = np.arange(FS * seconds) / FS
        m = (t >= 3.0) & (t < 4.0)
        x[m] += (2.0 * np.sin(2 * np.pi * 1003.0 * t[m])).astype(np.float32)
    args = (FS, 1024, 1200, (993.0, 1013.0), (690.0, 710.0))
    got = tbk.fused_bandpower_delta(torch.from_numpy(x), *args)
    want = jbk.fused_bandpower_delta(jnp.asarray(x), *args, interpret=True)
    for g, w, tol in zip(got, want, K2_ATOL):
        assert g.dtype == torch.float32 and tuple(g.shape) == (seconds * 5,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    # on the CPU the twin is the analyzer's own band power, bit for bit
    for g, w in zip(got, tbp.delta_power_db(torch.from_numpy(x), *args)):
        assert torch.equal(g, w)


def test_band_power_db_pallas_checks_its_bands():
    from meteor_scatter_tpu_torch.ops.kernels import bandpower_kernel as tbk

    M, slices = tbp.band_projection_matrix(FS, 1024, 1200, [(993.0, 1013.0), (690.0, 710.0)])
    frames = torch.zeros((3, 1200))
    with pytest.raises(ValueError, match="exactly"):
        tbk.band_power_db_pallas(frames, M, slices[:1])
    with pytest.raises(ValueError, match="mismatch"):
        tbk.band_power_db_pallas(frames, M[:, :-1], slices)
    band, noise, delta = tbk.band_power_db_pallas(frames, M, slices)
    assert torch.equal(delta, band - noise) and torch.all(band == -120.0)  # the 1e-12 floor
