"""FIR designs, filters, resampler and DDC channel bank of the PyTorch port
against the JAX package, on the CPU.

Host-side designs and tables (numpy in both packages) are equal bit for
bit.  Device-side outputs agree within ``REL_TOL`` of each output's largest
magnitude: both run float32 products whose sums XLA and PyTorch take in
different orders (measured up to ~7e-7 here), and each package alone is
held to 1e-5 against float64 in ``tests/test_fir.py``; twice that bounds
the two against each other.  Within the port, the pre-framed bank equals
the flat one and ``channelize_iq`` with a zero Q equals ``channelize``, bit
for bit, as the JAX package pins for itself.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meteor_scatter_tpu.ops import fir as jf
from meteor_scatter_tpu_torch.ops import fir as tf

REL_TOL = 2e-5
FS, N, BW, Q, T = 48_000, 12_000, 400.0, 8, 97


def assert_close_rel(got: torch.Tensor, want, tol=REL_TOL):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def assert_bits_equal(a: torch.Tensor, b: torch.Tensor):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def noise(n, seed, rows=()):
    return np.random.default_rng(seed).standard_normal(rows + (n,)).astype(np.float32)


@pytest.mark.parametrize(
    "args", [(101, 1000.0, 8000.0), (65, 500.0, 6000.0), (257, 200.0, 48000.0), (20, 0.3, 2.0)]
)
def test_firwin_lowpass_bits(args):
    assert np.array_equal(tf.firwin_lowpass(*args), jf.firwin_lowpass(*args))


def test_firwin_bandpass_bits_and_odd_taps():
    for args in [(201, 950.0, 1050.0, 6000.0), (257, 990.0, 1010.0, 48000.0)]:
        assert np.array_equal(tf.firwin_bandpass(*args), jf.firwin_bandpass(*args))
    with pytest.raises(ValueError, match="odd"):
        tf.firwin_bandpass(200, 950.0, 1050.0, 6000.0)


@pytest.mark.parametrize(
    "fs,freqs,q,taps,n",
    [
        (48_000, [1000, 7777, 12000], 8, 97, 12_000),
        (48_000, [-12_000, -1000, 7777], 12, 257, 9_001),  # negative centers: numpy's %
        (2_000_000, [-201_000, 24_000, 149_000], 500, 2001, 20_000),
    ],
)
def test_channel_bank_plan_bits(fs, freqs, q, taps, n):
    plan_t, tables_t = tf.channel_bank_plan(n, fs, np.array(freqs), BW, q, taps, device="cpu")
    plan_j, tables_j = jf.channel_bank_plan(n, fs, np.array(freqs), BW, q, taps)
    assert plan_t == plan_j
    for t, j in zip(tables_t, tables_j):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), np.asarray(j))


def test_channel_bank_plan_rejects_fractional_rates():
    with pytest.raises(ValueError, match="integer sample rate"):
        tf.channel_bank_plan(N, 48_000.5, np.array([1000]), BW, Q, T, device="cpu")
    with pytest.raises(ValueError, match="integer Hz"):
        tf.channel_bank_plan(N, FS, np.array([1000.25]), BW, Q, T, device="cpu")


def test_frame_capture_host_bits():
    plan, _ = tf.channel_bank_plan(N, FS, np.array([1000, 7777]), BW, Q, T, device="cpu")
    for x in (noise(N, 1), noise(N, 2, (2,))):
        assert np.array_equal(tf.frame_capture_host(x, plan), jf.frame_capture_host(x, plan))
    for shards in (1, 3, 5):
        got = tf.frame_capture_sharded_host(noise(N, 3), plan, shards)
        assert np.array_equal(got, jf.frame_capture_sharded_host(noise(N, 3), plan, shards))
    with pytest.raises(ValueError, match="does not match"):
        tf.frame_capture_host(noise(N - 1, 1), plan)
    with pytest.raises(ValueError, match="divide"):
        tf.frame_capture_sharded_host(noise(N, 1), plan, 7)


@pytest.mark.parametrize("mode", ["same", "valid", "full"])
def test_fir_filter_matches_jax(mode):
    x = noise(2000, 4, (3,))
    h = tf.firwin_lowpass(31, 0.2)
    assert_close_rel(tf.fir_filter(torch.from_numpy(x), h, mode), jf.fir_filter(jnp.asarray(x), h, mode))
    with pytest.raises(ValueError):
        tf.fir_filter(torch.from_numpy(x), h, "bogus")


@pytest.mark.parametrize("q", [1, 3, 166])
def test_polyphase_decimate_asymmetric_taps_matches_jax(q):
    x = noise(5000, 4)
    taps = np.random.default_rng(4).standard_normal(57)  # deliberately asymmetric
    got = tf.polyphase_decimate(torch.from_numpy(x), taps, q)
    assert_close_rel(got, jf.polyphase_decimate(jnp.asarray(x), taps, q))
    want = np.convolve(x.astype(np.float64), taps, mode="same")[::q]
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("up,down", [(1, 2), (2, 3), (3, 1), (3, 5), (4, 4)])
def test_resample_poly_matches_jax(up, down):
    x = noise(3001, 5, (2,))
    assert_close_rel(tf.resample_poly(torch.from_numpy(x), up, down),
                     jf.resample_poly(jnp.asarray(x), up, down))


@pytest.mark.parametrize("framed", [False, True])
def test_channelize_matches_jax(framed):
    x = noise(N, 9)
    freqs = np.array([1000, 7777, 12000])
    want = jf.channelize(jnp.asarray(x), FS, freqs, bandwidth=BW, decim=Q, numtaps=T)
    if framed:
        plan, tables = tf.channel_bank_plan(N, FS, freqs, BW, Q, T, device="cpu")
        got = tf.channelize_frames(torch.from_numpy(tf.frame_capture_host(x, plan)), tables, plan)
    else:
        got = tf.channelize(torch.from_numpy(x), FS, freqs, bandwidth=BW, decim=Q, numtaps=T)
    for g, w in zip(got, want):
        assert_close_rel(g, w)


@pytest.mark.parametrize("framed", [False, True])
def test_channelize_iq_matches_jax(framed):
    xr, xi = noise(N, 10), noise(N, 11)
    freqs = np.array([-12_000, -1000, 7777])
    want = jf.channelize_iq(jnp.asarray(xr), jnp.asarray(xi), FS, freqs, bandwidth=BW, decim=Q,
                            numtaps=T)
    if framed:
        plan, tables = tf.channel_bank_plan(N, FS, freqs, BW, Q, T, device="cpu")
        f = torch.from_numpy(tf.frame_capture_host(np.stack([xr, xi]), plan))
        got = tf.channelize_iq_frames(f, tables, plan)
    else:
        got = tf.channelize_iq(torch.from_numpy(xr), torch.from_numpy(xi), FS, freqs,
                               bandwidth=BW, decim=Q, numtaps=T)
    for g, w in zip(got, want):
        assert_close_rel(g, w)
    with pytest.raises(ValueError, match="I/Q shape mismatch"):
        tf.channelize_iq(torch.from_numpy(xr), torch.from_numpy(xi[:-1]), FS, freqs, BW, Q, T)


def test_preframed_equals_flat_bits():
    x, xi = noise(N, 12), noise(N, 13)
    freqs = np.array([-7777, 1000])
    plan, tables = tf.channel_bank_plan(N, FS, freqs, BW, Q, T, device="cpu")
    flat = tf.channelize(torch.from_numpy(x), FS, freqs, bandwidth=BW, decim=Q, numtaps=T)
    framed = tf.channelize_frames(torch.from_numpy(tf.frame_capture_host(x, plan)), tables, plan)
    for a, b in zip(flat, framed):
        assert_bits_equal(a, b)
    flat = tf.channelize_iq(torch.from_numpy(x), torch.from_numpy(xi), FS, freqs, bandwidth=BW,
                            decim=Q, numtaps=T)
    f = torch.from_numpy(tf.frame_capture_host(np.stack([x, xi]), plan))
    for a, b in zip(flat, tf.channelize_iq_frames(f, tables, plan)):
        assert_bits_equal(a, b)


def test_channelize_iq_zero_imag_equals_real_path():
    xr = torch.from_numpy(noise(N, 2))
    freqs = np.array([1000, 7777])
    real = tf.channelize(xr, FS, freqs, bandwidth=BW, decim=Q, numtaps=T)
    iq = tf.channelize_iq(xr, torch.zeros_like(xr), FS, freqs, bandwidth=BW, decim=Q, numtaps=T)
    for a, b in zip(real, iq):  # -0.0 == +0.0: the imaginary part is 0 - ds, not -ds
        assert torch.equal(a, b)


def test_channel_bank_plan_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tf.channel_bank_plan(N, FS, np.array([1000]), BW, Q, T)
