"""FIR design, filtering, polyphase resampling and the DDC channel bank.

Counterpart of `meteor_scatter_tpu/ops/fir.py`.  An SDR capture at its
native rate is mixed against each beacon channel, lowpassed and
polyphase-decimated to the analysis rate on the device.

* Host half (numpy, copied from the reference so that this module imports
  without JAX; same bits): the window-method designs ``firwin_lowpass`` /
  ``firwin_bandpass``, the polyphase tap split, the DDC bank's tap and
  mixer-phase tables (exact int64 phase arithmetic mod fs, numpy's
  non-negative ``%`` for negative centers), and the host-side framing of a
  capture.  The bank's tables are built once per capture length, rates
  and channels and kept on their device (:func:`channel_bank_plan`).
* Device half (torch): ``fir_filter`` / ``resample_poly`` as
  ``F.conv1d`` (a correlation, so the taps are passed reversed, as the
  reference passes them to ``conv_general_dilated``), ``polyphase_decimate``
  and the channel bank as one float32 ``torch.matmul`` at the output rate
  plus a per-row phase rotation (one hand-written kernel on a card,
  :mod:`meteor_scatter_tpu_torch.ops.kernels.bank_kernel`).  TF32 is off
  (:mod:`meteor_scatter_tpu_torch.device`), as the reference runs these at
  ``Precision.HIGHEST``.

I/Q travels as a ``(re, im)`` pair of float32 tensors, as in the
reference.  A pair that is the I and Q of one complex64 buffer (a GQRX
raw capture's ``view_as_real(iq)[:, 0]`` and ``[:, 1]``) is channelized
in place (:func:`channelize_iq_interleaved`): frame ``ri`` is then 2q
consecutive floats of the buffer, so every frame that needs no padding is
a row of a strided view of the capture, and I and Q fold into one
``(2q, 2·C·A)`` tap table (row 2b for I, ``[Hsin | −Hcos]`` in row 2b+1
for Q), one product with K = 2q in place of two with K = q.  Only the
few head and tail frames that reach past the capture are copied, padded.
That route agrees with the planar one to float32 rounding, not in bits.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device
from meteor_scatter_tpu_torch.ops.kernels import bank_kernel
from meteor_scatter_tpu_torch.utils.timing import span

PLANS_KEPT = 2  # bank plans kept per process; 8 channels of a 600 s, 2 MS/s capture hold 384 MB


def _hamming(m: int) -> np.ndarray:
    n = np.arange(m, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (m - 1))


def firwin_lowpass(numtaps: int, cutoff: float, fs: float = 2.0) -> np.ndarray:
    """Windowed-sinc lowpass; ``cutoff`` in Hz for sample rate ``fs``.
    Normalized to unity gain at DC (scipy.firwin convention)."""
    fc = cutoff / (fs / 2.0)  # normalized to Nyquist
    m = numtaps
    alpha = (m - 1) / 2.0
    n = np.arange(m, dtype=np.float64) - alpha
    h = fc * np.sinc(fc * n) * _hamming(m)
    return h / np.sum(h)


def firwin_bandpass(numtaps: int, f_lo: float, f_hi: float, fs: float) -> np.ndarray:
    """Bandpass as difference of two lowpasses, gain-normalized at the band
    center so the beacon tone passes at unity."""
    if numtaps % 2 == 0:
        raise ValueError("bandpass FIR needs odd numtaps (type-I symmetry)")

    def _lp(cut):  # un-normalized windowed sinc
        fc = cut / (fs / 2.0)
        alpha = (numtaps - 1) / 2.0
        n = np.arange(numtaps, dtype=np.float64) - alpha
        return fc * np.sinc(fc * n) * _hamming(numtaps)

    h = _lp(f_hi) - _lp(f_lo)
    # normalize to unity gain at band center
    fc_mid = 0.5 * (f_lo + f_hi)
    n = np.arange(numtaps, dtype=np.float64)
    gain = abs(np.sum(h * np.exp(-2j * np.pi * fc_mid / fs * n)))
    return h / gain


def fir_filter(x: torch.Tensor, taps: np.ndarray, mode: str = "same") -> torch.Tensor:
    """1-D FIR along the last axis, on ``x``'s device.

    mode 'same' matches np.convolve(x, taps, 'same'); 'valid' drops the
    transient edges; 'full' keeps everything.
    """
    t = len(taps)
    if mode == "same":
        pad = ((t - 1) // 2, t - 1 - (t - 1) // 2)
    elif mode == "valid":
        pad = (0, 0)
    elif mode == "full":
        pad = (t - 1, t - 1)
    else:
        raise ValueError(mode)
    return _conv1d(x, taps, stride=1, pad=pad, lhs_dilation=1)


def _reversed_tap_matrix(taps: np.ndarray, q: int, a_cols: int) -> np.ndarray:
    """(q, a_cols) reversed-tap polyphase matrix (convolution order) — the
    single source of truth for the tap split, shared by the decimator plan
    and the DDC bank tables."""
    t = len(taps)
    rev = np.asarray(taps, np.float64)[::-1]
    h = np.zeros((q, a_cols), np.float64)
    for tap in range(t):
        h[tap % q, tap // q] = rev[tap]
    return h


def _polyphase_plan(n: int, taps: np.ndarray, q: int):
    """Framing math of the polyphase formulation: left pad, output length,
    the (q, A) reversed tap matrix and the padded frame count.  Centering
    matches np.convolve 'same' for odd tap counts; for even tap counts the
    output is the 'SAME' convolution alignment, one sample left of numpy's."""
    t = len(taps)
    pl, pr = (t - 1) // 2, t - 1 - (t - 1) // 2
    n_out = (n + pl + pr - t) // q + 1  # == conv output length
    a_cols = -(-t // q)
    h = _reversed_tap_matrix(taps, q, a_cols)
    m = n_out + a_cols - 1
    return pl, n_out, a_cols, h, m


def _polyphase_frames(x: torch.Tensor, pl: int, m: int, q: int) -> torch.Tensor:
    """(..., m, q) frames of the left-padded signal at the output stride;
    frame o+a holds samples [(o+a)q, (o+a)q + q).  One padded copy; a
    negative right pad crops, and the reshape is a view."""
    n = x.shape[-1]
    xp = F.pad(x.to(torch.float32), (pl, m * q - n - pl))
    return xp.reshape(x.shape[:-1] + (m, q))


def polyphase_decimate(x: torch.Tensor, taps: np.ndarray, q: int) -> torch.Tensor:
    """Anti-alias filter + keep every q-th sample, computed polyphase: the
    filter runs at the *output* rate.  Splitting the (reversed) tap index
    t = a·q + b turns the decimation into ``frames(x) (m, q) @ H (q, A)``,
    one product at the output rate, followed by a sum of the A = ceil(T/q)
    shifted columns.  Same output length, centering and convolution
    semantics as ``fir_filter(x, taps)[..., ::q]``.
    """
    if q == 1:
        return fir_filter(x, taps, mode="same")
    pl, n_out, a_cols, h, m = _polyphase_plan(x.shape[-1], taps, q)
    f = _polyphase_frames(x, pl, m, q)
    g = torch.matmul(f, torch.from_numpy(h.astype(np.float32)).to(f.device))
    y = g[..., :n_out, 0]
    for a in range(1, a_cols):
        y = y + g[..., a : a + n_out, a]
    return y


def resample_poly(x: torch.Tensor, up: int, down: int, numtaps_per_phase: int = 20) -> torch.Tensor:
    """Rational-rate polyphase resampler (scipy.signal.resample_poly
    analog): the input zero-stuffed to ``(n-1)·up + 1`` samples, then one
    strided ``F.conv1d`` (stride ``down``) with the lowpass — the
    reference's ``lhs_dilation`` / window-stride convolution."""
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return x
    max_rate = max(up, down)
    numtaps = 2 * numtaps_per_phase * max_rate + 1
    # cutoff at min(1/up, 1/down) of the upsampled Nyquist
    h = firwin_lowpass(numtaps, 1.0 / max_rate, fs=2.0) * up
    t = len(h)
    n = x.shape[-1]
    n_out = int(math.ceil(n * up / down))
    # left pad centers the filter (phase-preserving); right pad is sized so
    # the strided conv emits exactly n_out samples even when the dilated
    # input (n-1)*up+1 ends short of the last output's support
    pl = (t - 1) // 2
    l_dil = (n - 1) * up + 1
    pr = max((n_out - 1) * down + t - l_dil - pl, 0)
    y = _conv1d(x, h, stride=down, pad=(pl, pr), lhs_dilation=up)
    return y[..., :n_out]


def _conv1d(x: torch.Tensor, taps, stride: int, pad: Tuple[int, int], lhs_dilation: int):
    """True convolution of the last axis with ``taps``: ``F.conv1d`` is a
    correlation, so it gets the taps reversed.  The input is dilated
    (``lhs_dilation - 1`` zeros between samples) and then padded
    ``(left, right)``, as ``conv_general_dilated`` orders the two."""
    k = torch.from_numpy(np.asarray(taps, dtype=np.float32)[::-1].copy()).to(x.device)
    orig_shape = x.shape
    xf = x.to(torch.float32).reshape(-1, 1, orig_shape[-1])  # (N, C=1, W)
    if lhs_dilation > 1:
        n = orig_shape[-1]
        xd = xf.new_zeros(xf.shape[0], 1, (n - 1) * lhs_dilation + 1)
        xd[..., ::lhs_dilation] = xf
        xf = xd
    y = F.conv1d(F.pad(xf, pad), k.reshape(1, 1, -1), stride=stride)
    return y.reshape(orig_shape[:-1] + (y.shape[-1],))


def _bank_tables(
    fs_i: int,
    freqs: list,
    taps: np.ndarray,
    q: int,
    a_cols: int,
    m: int,
    pl: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side tables of the one-product DDC bank (see :func:`channelize`),
    as numpy float32: the (q, 2·C·A) polyphase tap matrix with the
    intra-frame mixer folded in by angle addition, and the (C, m)
    output-rate row phases.  Row phases are exact integer arithmetic mod fs
    for frame row ri at padded offset ``ri·q − pl``."""
    hp = _reversed_tap_matrix(taps, q, a_cols)

    c_n = len(freqs)
    hh = np.zeros((q, 2, c_n, a_cols), np.float64)
    b_idx = np.arange(q, dtype=np.int64)
    for c, fc in enumerate(freqs):
        ang_b = 2.0 * np.pi * ((b_idx * (fc % fs_i)) % fs_i) / fs_i
        hh[:, 0, c, :] = np.cos(ang_b)[:, None] * hp
        hh[:, 1, c, :] = np.sin(ang_b)[:, None] * hp
    hh32 = hh.reshape(q, 2 * c_n * a_cols).astype(np.float32)

    ri = np.arange(m, dtype=np.int64)
    cr = np.empty((c_n, m), np.float32)
    sr = np.empty((c_n, m), np.float32)
    for c, fc in enumerate(freqs):
        p = ((ri * q - pl) * fc) % fs_i
        ang = 2.0 * np.pi * p / fs_i
        cr[c] = np.cos(ang)
        sr[c] = np.sin(ang)
    return hh32, cr, sr


def _bank_apply(
    f: torch.Tensor,  # (..., m, q) frames of the padded signal
    hh: torch.Tensor,
    cr: torch.Tensor,
    sr: torch.Tensor,
    c_n: int,
    a_cols: int,
    n_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device half of the DDC bank: one ``torch.matmul`` + per-row phase
    rotation, in the reference's operation order.

    dc = Σ_a cr·G_cos − sr·G_sin ; ds = Σ_a sr·G_cos + cr·G_sin
    (angle addition: cos(r+b) = cr·cb − sr·sb, sin(r+b) = sr·cb + cr·sb),
    by :func:`~meteor_scatter_tpu_torch.ops.kernels.bank_kernel.bank_rotate`:
    one kernel launch on a card, the a-loop on the CPU, the same bits.
    """
    batch = f.shape[:-2]
    m = f.shape[-2]
    # the product taken transposed, hh^T @ frames^T: G comes out as
    # (..., 2, C, A, m), so the rotation reads every tap column's rows at
    # unit stride (as (m, 2·C·A) they would lie 2·C·A floats apart)
    g = torch.matmul(hh.t(), f.transpose(-1, -2)).reshape(batch + (2, c_n, a_cols, m))
    return bank_kernel.bank_rotate(g, cr, sr, n_out)


def _validated_int_rate_and_freqs(fs: float, center_freqs) -> Tuple[int, list]:
    fs_i = int(round(fs))
    if abs(fs - fs_i) > 1e-6:
        raise ValueError("channelize requires an integer sample rate")
    freqs = [int(round(f)) for f in np.asarray(center_freqs).ravel()]
    if any(abs(f - g) > 1e-9 for f, g in zip(np.asarray(center_freqs).ravel(), freqs)):
        raise ValueError("channel centers must be integer Hz")
    return fs_i, freqs


def channel_bank_plan(
    n: int,
    fs: float,
    center_freqs: np.ndarray,
    bandwidth: float,
    decim: int,
    numtaps: int,
    device: DeviceLike = "cuda",
):
    """Host-side half of the one-product DDC bank, split out so that callers
    can frame a capture on the host (:func:`frame_capture_host`) and upload
    it framed.

    Returns ``(plan, (hh, cr, sr))``: ``plan`` holds the framing geometry
    (n / pl / n_out / a_cols / m / q / c_n for an input of length ``n``) and
    the tables are float32 tensors on ``device`` sized ``(q, 2·C·A)`` /
    ``(C, m)`` / ``(C, m)``.

    The last :data:`PLANS_KEPT` plans are kept, keyed by every argument: a
    call with a key seen before returns the same tables, read-only (no
    caller writes into them), without the host's trigonometry or the
    upload.  A miss builds inside the span ``bank_plan``."""
    dev = resolve_device(device)
    _, freqs = _validated_int_rate_and_freqs(fs, center_freqs)
    plan, tables = _bank_plan_on(int(n), float(fs), tuple(freqs), float(bandwidth), int(decim),
                                 int(numtaps), dev)
    return dict(plan), tables


@functools.lru_cache(maxsize=PLANS_KEPT)
def _bank_plan_on(n: int, fs: float, freqs: tuple, bandwidth: float, decim: int, numtaps: int,
                  dev: torch.device):
    with span("bank_plan"):  # a miss: the tables on the host, then their upload
        h = firwin_lowpass(numtaps, bandwidth / 2.0, fs)
        q, c_n = decim, len(freqs)
        pl, n_out, a_cols, _, m = _polyphase_plan(n, h, q)
        tables = _bank_tables(int(round(fs)), list(freqs), h, q, a_cols, m, pl)
        plan = {"n": n, "pl": int(pl), "n_out": int(n_out), "a_cols": int(a_cols), "m": int(m),
                "q": q, "c_n": c_n}
        return plan, tuple(torch.from_numpy(t).to(dev) for t in tables)


def frame_capture_host(x_np: np.ndarray, plan: dict) -> np.ndarray:
    """Host-side polyphase framing: numpy pad + reshape of a flat capture
    to the ``(..., m, q)`` frames :func:`channelize_frames` /
    :func:`channelize_iq_frames` consume.  Frames sit at stride q == their
    length, so this is a pure copy (no size blowup)."""
    pl, m, q = plan["pl"], plan["m"], plan["q"]
    x_np = np.asarray(x_np, np.float32)
    n = x_np.shape[-1]
    if n != plan["n"]:
        raise ValueError(
            f"capture length {n} does not match the plan's n={plan['n']} — "
            "frames built from a mismatched plan would silently pad or "
            "truncate the capture"
        )
    need = m * q
    pad = [(0, 0)] * (x_np.ndim - 1) + [(pl, max(need - n - pl, 0))]
    xp = np.pad(x_np, pad)
    return xp[..., :need].reshape(x_np.shape[:-1] + (m, q))


def frame_capture(x: torch.Tensor, plan: dict) -> torch.Tensor:
    """:func:`frame_capture_host` on ``x``'s device: the ``(..., m, q)``
    frames of a flat capture, one padded float32 copy and a view."""
    if x.shape[-1] != plan["n"]:
        raise ValueError(f"capture length {x.shape[-1]} does not match the plan's n={plan['n']}")
    return _polyphase_frames(x, plan["pl"], plan["m"], plan["q"])


def frame_capture_sharded_host(x_np: np.ndarray, plan: dict, n_shards: int) -> np.ndarray:
    """Per-time-shard polyphase frames with the ``a_cols−1`` halo frames
    baked in: shard k's rows are global frames ``[k·n_out_loc,
    k·n_out_loc + m_loc)`` (``m_loc = n_out_loc + a_cols − 1``), so a
    time-sharded DDC bank needs no halo exchange.  Returns
    ``(n_shards,) + x.shape[:-1] + (m_loc, q)``."""
    f = frame_capture_host(x_np, plan)
    a_cols, n_out = plan["a_cols"], plan["n_out"]
    if n_out % n_shards:
        raise ValueError(f"n_out ({n_out}) must divide across {n_shards} shards")
    n_out_loc = n_out // n_shards
    m_loc = n_out_loc + a_cols - 1
    return np.stack(
        [f[..., k * n_out_loc : k * n_out_loc + m_loc, :] for k in range(n_shards)]
    )


def channelize_frames(f: torch.Tensor, tables, plan: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`channelize` on pre-framed input (see
    :func:`channel_bank_plan` / :func:`frame_capture_host`) — bit-identical
    output, no framing on the device."""
    dc, ds = _bank_apply(f, *tables, plan["c_n"], plan["a_cols"], plan["n_out"])
    return dc, -ds


def channelize_iq_frames(f: torch.Tensor, tables, plan: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`channelize_iq` on pre-framed input: ``f`` is the framed
    ``(2, ..., m, q)`` stack of (re, im) from
    ``frame_capture_host(np.stack([x_re, x_im]), plan)`` — bit-identical
    output, no framing on the device."""
    dc, ds = _bank_apply(f, *tables, plan["c_n"], plan["a_cols"], plan["n_out"])
    return dc[0] + ds[1], dc[1] - ds[0]


def is_interleaved_iq(x, x_im) -> bool:
    """True where ``x`` and ``x_im`` are the I and Q of one complex64
    buffer: 1-D float32 views of one storage, each at stride 2, Q one float
    after I (``view_as_real(c)[:, 0]`` and ``[:, 1]``), on any device."""
    return (isinstance(x, torch.Tensor) and isinstance(x_im, torch.Tensor)
            and x.dtype == x_im.dtype == torch.float32
            and x.dim() == x_im.dim() == 1 and x.shape == x_im.shape
            and x.stride() == x_im.stride() == (2,)
            and x.untyped_storage().data_ptr() == x_im.untyped_storage().data_ptr()
            and x_im.storage_offset() == x.storage_offset() + 1)


def _iq_tap_table(hh: torch.Tensor) -> torch.Tensor:
    """The (2q, 2·C·A) table that takes interleaved I/Q frames: row 2b is
    ``hh[b] = [Hcos | Hsin]`` for I, row 2b+1 ``[Hsin | −Hcos]`` for Q.
    Its product gives ``G_cos = Gc_I + Gs_Q`` and ``G_sin = Gs_I − Gc_Q``,
    which the rotation turns into ``dc = y_re`` and ``ds = −y_im``."""
    half = hh.shape[1] // 2
    q_rows = torch.cat([hh[:, half:], -hh[:, :half]], dim=1)
    return torch.stack([hh, q_rows], dim=1).reshape(2 * hh.shape[0], hh.shape[1])


def _padded_iq_frames(xs: torch.Tensor, n: int, pl: int, q: int, r_lo: int, r_hi: int):
    """Frames ``[r_lo, r_hi)`` of the zero-padded interleaved capture ``xs``
    (2n floats) as a ``(r_hi − r_lo, 2q)`` copy of only the samples they
    touch."""
    s_lo, s_hi = r_lo * q - pl, r_hi * q - pl
    a, b = max(s_lo, 0), min(s_hi, n)
    f = xs.new_zeros(2 * (s_hi - s_lo))
    if b > a:
        f[2 * (a - s_lo): 2 * (b - s_lo)] = xs[2 * a: 2 * b]
    return f.view(r_hi - r_lo, 2 * q)


def channelize_iq_interleaved(x: torch.Tensor, tables,
                              plan: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`channelize_iq` of an interleaved capture (``x`` the I view of
    :func:`is_interleaved_iq`), read in place: frame ``ri`` holds samples
    ``[ri·q − pl, ri·q − pl + q)``, 2q consecutive floats, so the frames
    ``[r0, r1)`` that lie inside the capture are the rows of one strided
    view of it, and their outputs ``[r0, r1 − A + 1)`` one product against
    :func:`_iq_tap_table`.  The outputs before and after come from padded
    copies of the few frames they read; a capture with no such interior
    takes one padded piece.  Returns ``(y_re, y_im)``, each (C, n_out)."""
    hh, cr, sr = tables
    n, pl, q = plan["n"], plan["pl"], plan["q"]
    c_n, a_cols, n_out, m = plan["c_n"], plan["a_cols"], plan["n_out"], plan["m"]
    xs = x.as_strided((2 * n,), (1,))
    r0 = -(-pl // q)  # the first frame that starts inside the capture
    r1 = min((n + pl) // q, m)  # one past the last that ends inside it
    o1 = r1 - a_cols + 1  # outputs [r0, o1) read interior frames only
    pieces = [(0, r0, False), (r0, o1, True), (o1, n_out, False)] if o1 > r0 else [
        (0, n_out, False)]
    w = _iq_tap_table(hh)
    with span("bank_in_place"):
        dcs, dss = [], []
        for lo, hi, inside in pieces:
            if hi <= lo:
                continue
            r_hi = hi + a_cols - 1
            if inside:
                f = xs.as_strided((r_hi - lo, 2 * q), (2 * q, 1),
                                  xs.storage_offset() + 2 * (lo * q - pl))
            else:
                f = _padded_iq_frames(xs, n, pl, q, lo, r_hi)
            dc, ds = _bank_apply(f, w, cr[:, lo:r_hi], sr[:, lo:r_hi], c_n, a_cols, hi - lo)
            dcs.append(dc)
            dss.append(ds)
        dc, ds = torch.cat(dcs, -1), torch.cat(dss, -1)
    return dc, -ds


def channelize(
    x: torch.Tensor,
    fs: float,
    center_freqs: np.ndarray,
    bandwidth: float,
    decim: int,
    numtaps: int = 257,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-channel DDC bank over a *real* capture: mix each beacon channel
    to baseband (``x·e^{-jφ_c}``), lowpass, and decimate.  Returns the
    complex baseband as a real pair ``(re, im)``, each (n_channels, n_out)
    float32 on ``x``'s device: ``(dc, -ds)`` for the decimated quadrature
    projections

        dc = decim((x · cos φ_c) * h),   ds = decim((x · sin φ_c) * h)

    with φ_c(s) = 2π·fc·s/fs at input-sample index s.

    Nothing runs at the input rate but one product: splitting the input
    index ``s = ri·q + b`` (ri = output-rate frame row, b = intra-frame
    offset) splits the mixer phase by angle addition, so the intra-frame
    factor ``cos/sin(2π·fc·b/fs)`` folds into the polyphase tap matrix per
    channel on the host (:func:`channel_bank_plan`), and the whole bank
    becomes

        frames(x) @ [Hcos | Hsin]        # (m, q) @ (q, 2·C·A)
        y = rotate by per-row phase      # output-rate cos/sin, O(C·m)

    No (C, n) mixer tables or mixed copies of x are made; x is read once.
    """
    plan, tables = channel_bank_plan(
        x.shape[-1], fs, center_freqs, bandwidth, decim, numtaps, device=x.device
    )
    return channelize_frames(frame_capture(x, plan), tables, plan)


def channelize_iq(
    x_re: torch.Tensor,
    x_im: torch.Tensor,
    fs: float,
    center_freqs: np.ndarray,
    bandwidth: float,
    decim: int,
    numtaps: int = 257,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`channelize` for a *complex* (I/Q) capture, passed as the real
    pair ``(x_re, x_im)``.  Channel centers are baseband offsets and may be
    **negative** — the lower half of the captured span, unreachable from a
    real capture.

    With x = xr + j·xi and y = decim(LPF(x·e^{-jφ_c})):

        y_re = decim((xr·cosφ)·h) + decim((xi·sinφ)·h)
        y_im = decim((xi·cosφ)·h) − decim((xr·sinφ)·h)

    Both components ride one stacked frames product.  Returns ``(y_re,
    y_im)``, each ``x_re.shape[:-1] + (C, n_out)``.
    """
    if x_re.shape != x_im.shape:
        raise ValueError(f"I/Q shape mismatch: {tuple(x_re.shape)} vs {tuple(x_im.shape)}")
    plan, tables = channel_bank_plan(
        x_re.shape[-1], fs, center_freqs, bandwidth, decim, numtaps, device=x_re.device
    )
    return channelize_iq_frames(frame_capture(torch.stack([x_re, x_im]), plan), tables, plan)
