"""The DDC bank's rotation on the CPU: the order the CUDA kernel follows.

``csrc/bank_rotate.cu`` starts each output's accumulators at +0.0 and then,
for each tap column a, computes ``dc = (dc + cr·gc) − sr·gs`` and
``ds = (ds + sr·gc) + cr·gs``, one float32 rounding per operation.  A numpy
float32 emulation of that order equals ``fir._bank_apply``'s CPU loop bit
for bit, over the framing geometries of the in-place route (and the planar
route's (2, …) stack), and on a case built so that products of −0.0
occur.  The kernel itself is held to the loop on the card
(``tests/test_torch_kernels_cuda.py``).  A CPU call launches nothing and
loads no library.

This file imports neither JAX nor the JAX package: the card's tests take
its geometries.
"""

import numpy as np
import pytest
import torch

from meteor_scatter_tpu_torch.ops import fir
from meteor_scatter_tpu_torch.ops.kernels import _build
from meteor_scatter_tpu_torch.ops.kernels import bank_kernel

FS, BW = 48_000, 400.0
FREQS = np.array([-12_000, -1003, 7777])  # negative centres: the lower half of the span

# (n, q, taps) and what each geometry is there for; pl = (taps - 1) // 2
GEOMETRIES = {
    "pl_below_q": (4001, 200, 97),  # pl 48, A 1, a tail frame past n
    "tail_inside_n": (4000, 200, 97),  # every frame past the head ends inside the capture
    "pl_above_q": (4001, 10, 97),  # pl 48 over q 10: five head frames
    "pl_multiple_of_q": (4000, 8, 97),  # pl 48 = 6 q
    "cell_geometry": (6001, 200, 513),  # q 200, pl 256, A 3: the I/Q cell's split
    "no_interior": (500, 200, 513),  # too short for an interior frame: one padded piece
    "shorter_than_pl": (100, 8, 513),
}


def interleaved_capture(n, seed=1, device="cpu"):
    """A complex64 capture of n samples as ``view_as_real``: (n, 2)."""
    g = torch.Generator().manual_seed(seed)
    return torch.view_as_real(torch.randn(n, dtype=torch.complex64, generator=g)).to(device)


class Rotations:
    """Wraps ``bank_kernel.bank_rotate`` and records each call's operands
    and outputs."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = bank_kernel.bank_rotate

        def rotate(g, cr, sr, n_out):
            out = orig(g, cr, sr, n_out)
            self.calls.append(((g, cr, sr, n_out), out))
            return out

        monkeypatch.setattr(bank_kernel, "bank_rotate", rotate)


def emulate(g, cr, sr, n_out):
    """The kernel's order in numpy float32: accumulators at +0.0, then per
    tap column a product, a sum, a product and a difference (or sum)."""
    g, cr, sr = (t.numpy() for t in (g, cr, sr))
    c_n, a_cols = g.shape[-3], g.shape[-2]
    dc = np.zeros(g.shape[:-4] + (c_n, n_out), np.float32)
    ds = np.zeros_like(dc)
    for a in range(a_cols):
        gc = g[..., 0, :, a, a : a + n_out]
        gs = g[..., 1, :, a, a : a + n_out]
        c, s = cr[:, a : a + n_out], sr[:, a : a + n_out]
        dc = np.subtract(np.add(dc, np.multiply(c, gc)), np.multiply(s, gs))
        ds = np.add(np.add(ds, np.multiply(s, gc)), np.multiply(c, gs))
    assert dc.dtype == ds.dtype == np.float32
    return dc, ds


def assert_bits(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("route", ["interleaved", "planar"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_order_equals_the_loop(geometry, route, monkeypatch):
    n, q, taps = GEOMETRIES[geometry]
    plan, tables = fir.channel_bank_plan(n, FS, FREQS, BW, q, taps, device="cpu")
    x = interleaved_capture(n)
    calls = Rotations(monkeypatch)
    if route == "interleaved":
        fir.channelize_iq_interleaved(x[:, 0], tables, plan)
    else:
        fir.channelize_iq(x[:, 0].contiguous(), x[:, 1].contiguous(), FS, FREQS, BW, q, taps)
    assert calls.calls
    for (g, cr, sr, n_out), (dc, ds) in calls.calls:
        assert g.shape[-4:-1] == (2, len(FREQS), plan["a_cols"])
        want_dc, want_ds = emulate(g, cr, sr, n_out)
        assert_bits(dc, want_dc)
        assert_bits(ds, want_ds)


def signed_zero_case(n_out, c_n=3, a_cols=3, seed=7):
    """G (2, 2, C, A, m) and row phases (column slices of wider tables)
    drawn from ±0 and a few exact values, so that products of −0.0 and
    exact cancellations occur.  Also returns the outputs where a sum started
    from the first tap column's product, and not from +0.0, would be −0.0."""
    rng = np.random.default_rng(seed)
    m = n_out + a_cols - 1
    g = torch.from_numpy(rng.choice(np.float32([0.0, -0.0, 1.5, -1.5]), (2, 2, c_n, a_cols, m)))
    cr, sr = (torch.from_numpy(rng.choice(np.float32([0.0, -0.0, 0.5, -0.5]), (c_n, m + 5)))
              [:, 2 : 2 + m] for _ in range(2))
    gn, crn, srn = g.numpy(), cr.numpy(), sr.numpy()
    first = np.subtract(np.multiply(crn[:, :n_out], gn[:, 0, :, 0, :n_out]),
                        np.multiply(srn[:, :n_out], gn[:, 1, :, 0, :n_out]))
    return g, cr, sr, (first == 0) & np.signbit(first)


def test_signed_zeros_keep_the_loops_sign():
    """The loop's outputs carry the emulation's sign of zero, on a case
    where the +0.0 start decides it."""
    n_out = 257
    g, cr, sr, negative_zero = signed_zero_case(n_out)
    dc, ds = bank_kernel.bank_rotate(g, cr, sr, n_out)
    want_dc, want_ds = emulate(g, cr, sr, n_out)
    assert_bits(dc, want_dc)
    assert_bits(ds, want_ds)
    assert negative_zero.any()
    from_zero = emulate(g[..., :1, :], cr, sr, n_out)[0]  # the first column, from +0.0
    assert not np.signbit(from_zero[negative_zero]).any()


def test_cpu_call_launches_nothing_and_loads_no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a CPU call loaded {name}")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    n, q, taps = GEOMETRIES["cell_geometry"]
    plan, tables = fir.channel_bank_plan(n, FS, FREQS, BW, q, taps, device="cpu")
    x = interleaved_capture(n)
    fir.channelize_iq_interleaved(x[:, 0], tables, plan)
    fir.channelize_iq(x[:, 0].contiguous(), x[:, 1].contiguous(), FS, FREQS, BW, q, taps)
    assert bank_kernel.launches == 0
