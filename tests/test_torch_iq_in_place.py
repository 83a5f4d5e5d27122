"""The DDC bank's in-place route for interleaved I/Q, on the CPU.

A capture whose I and Q are ``view_as_real(c)[:, 0]`` and ``[:, 1]`` of
one complex64 buffer is channelized from that buffer (its interior frames
are rows of a strided view, I and Q fold into one ``(2q, 2·C·A)`` tap
table), with only the head and tail frames copied, padded.  It agrees with
the planar route and with the JAX package's ``channelize_iq`` within
``tests/test_torch_fir.py``'s ``REL_TOL`` (another float32 summation order:
K = 2q in one product in place of two of K = q), over the framing
geometries that split the capture differently.  Every other pair takes the
planar route with its bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meteor_scatter_tpu.ops import fir as jf
from meteor_scatter_tpu_torch.apps import frontend
from meteor_scatter_tpu_torch.ops import fir

from test_torch_bank_rotate import BW, FREQS, FS, GEOMETRIES
from test_torch_fir import REL_TOL, assert_bits_equal, assert_close_rel


def _geometry(n, q, taps):
    pl, n_out, a_cols, _, m = fir._polyphase_plan(n, np.ones(taps), q)
    r0, r1 = -(-pl // q), min((n + pl) // q, m)
    return pl, a_cols, m, r0, r1


def _ring(n, captures=2, seed=0, dtype=torch.complex64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((captures, n), dtype=dtype, generator=g)


def _plan(n, q, taps):
    return fir.channel_bank_plan(n, FS, FREQS, BW, q, taps, device="cpu")


class _Calls:
    """Wraps ``fir._bank_apply`` and records each call's frames and table."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = fir._bank_apply

        def bank(f, hh, *rest):
            self.calls.append((f, hh))
            return orig(f, hh, *rest)

        monkeypatch.setattr(fir, "_bank_apply", bank)


def test_geometries_cover_each_case():
    tail_past, tail_inside = set(), set()
    for name, (n, q, taps) in GEOMETRIES.items():
        pl, a_cols, m, r0, r1 = _geometry(n, q, taps)
        (tail_past if m * q - pl > n else tail_inside).add(name)
        assert (r1 - a_cols + 1 <= r0) == (name in ("no_interior", "shorter_than_pl"))
    assert tail_past and tail_inside == {"tail_inside_n"}
    pls = {name: (_geometry(*g)[0], g[1]) for name, g in GEOMETRIES.items()}
    assert pls["pl_below_q"][0] < pls["pl_below_q"][1]
    assert pls["pl_above_q"][0] > pls["pl_above_q"][1] and pls["pl_above_q"][0] % 10
    assert pls["pl_multiple_of_q"][0] % pls["pl_multiple_of_q"][1] == 0


@pytest.mark.parametrize("p", [0, 1], ids=["first_capture", "second_capture"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_in_place_matches_planar_and_jax(geometry, p):
    n, q, taps = GEOMETRIES[geometry]
    x = torch.view_as_real(_ring(n, seed=p + 1)[p])
    assert fir.is_interleaved_iq(x[:, 0], x[:, 1]) and x[:, 0].storage_offset() == 2 * n * p
    plan, tables = _plan(n, q, taps)
    got = fir.channelize_iq_interleaved(x[:, 0], tables, plan)
    xr, xi = x[:, 0].contiguous(), x[:, 1].contiguous()
    planar = fir.channelize_iq(xr, xi, FS, FREQS, BW, q, taps)
    want = jf.channelize_iq(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()), FS, FREQS,
                            bandwidth=BW, decim=q, numtaps=taps)
    for g, a, w in zip(got, planar, want):
        assert_close_rel(g, a.numpy(), REL_TOL)
        assert_close_rel(g, w, REL_TOL)


@pytest.mark.parametrize("geometry", ["pl_above_q", "pl_multiple_of_q", "cell_geometry",
                                      "tail_inside_n"])
def test_interior_frames_are_the_capture(geometry, monkeypatch):
    """One product reads its frames from the capture's own storage, at the
    first interior frame; the others read copies of a few frames each."""
    n, q, taps = GEOMETRIES[geometry]
    pl, a_cols, m, r0, r1 = _geometry(n, q, taps)
    ring = _ring(n)
    x = torch.view_as_real(ring[1])
    plan, tables = _plan(n, q, taps)
    calls = _Calls(monkeypatch)
    fir.channelize_iq_interleaved(x[:, 0], tables, plan)
    own = ring.untyped_storage().data_ptr()
    inside = [f for f, _ in calls.calls if f.untyped_storage().data_ptr() == own]
    assert len(inside) == 1
    f = inside[0]
    assert f.shape == (r1 - r0, 2 * q) and f.stride() == (2 * q, 1)
    assert f.storage_offset() == 2 * n + 2 * (r0 * q - pl)
    assert torch.equal(f[0], x[r0 * q - pl: r0 * q - pl + q].reshape(-1))
    copied = sum(g.shape[0] for g, _ in calls.calls if g is not f)
    assert copied == r0 + m - r1 + 2 * (a_cols - 1)
    assert all(hh.shape == (2 * q, 2 * len(FREQS) * a_cols) for _, hh in calls.calls)


def test_bank_takes_the_route_for_an_interleaved_capture(monkeypatch):
    n, q, taps = GEOMETRIES["cell_geometry"]
    x = torch.view_as_real(_ring(n)[1])
    plan, tables = _plan(n, q, taps)
    want = fir.channelize_iq_interleaved(x[:, 0], tables, plan)[0]
    calls = _Calls(monkeypatch)
    got = frontend._bank(x[:, 0], x[:, 1], FS, FREQS, BW, q, taps, "cpu")
    assert_bits_equal(got, want)
    assert calls.calls and all(hh.shape[0] == 2 * q for _, hh in calls.calls)


def _other_pairs(n):
    """Pairs that are not the I and Q of one complex64 buffer."""
    c = torch.view_as_real(_ring(n)[1])
    wide = torch.randn((n, 3), generator=torch.Generator().manual_seed(5))
    c128 = torch.view_as_real(_ring(n, dtype=torch.complex128)[1])
    return {
        "planar": (c[:, 0].contiguous(), c[:, 1].contiguous()),
        "q_before_i": (c[:, 1], c[:, 0]),
        "float64_views": (c128[:, 0], c128[:, 1]),
        "stride_3": (wide[:, 0], wide[:, 1]),
    }


@pytest.mark.parametrize("pair", ["planar", "q_before_i", "float64_views", "stride_3"])
def test_other_pairs_keep_the_planar_route_and_its_bits(pair, monkeypatch):
    n, q, taps = GEOMETRIES["cell_geometry"]
    x, x_im = _other_pairs(n)[pair]
    assert not fir.is_interleaved_iq(x, x_im)
    want = fir.channelize_iq(x, x_im, FS, FREQS, BW, q, taps)[0]
    calls = _Calls(monkeypatch)
    got = frontend._bank(x, x_im, FS, FREQS, BW, q, taps, "cpu")
    assert_bits_equal(got, want)
    assert len(calls.calls) == 1 and calls.calls[0][1].shape[0] == q
