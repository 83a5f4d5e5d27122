"""Sharded pipelines over the (station, time) mesh.

Counterpart of `meteor_scatter_tpu/parallel/sharded.py`, with the same
entry points, arguments and outputs.  Each function takes the global
tensor, splits it over the mesh (:func:`~meteor_scatter_tpu_torch.parallel.mesh.shard`),
runs every mesh position's share on that position's device, and returns
global tensors on the mesh's first device with the shapes, dtypes and order
of the JAX outputs.  Data moves between positions only through the three
row operations of :mod:`meteor_scatter_tpu_torch.parallel.halo` and
:func:`~meteor_scatter_tpu_torch.parallel.mesh.unshard`.

On a mesh that spans processes every process calls the function with the
same arguments (the global tensor whole), computes its own positions'
shares, and gets the same global results as one process driving the
whole mesh.

Division of labour (as the JAX layer):

* the *sample-rate* work (framing, band projection, PSD, FIR, the DDC
  bank) runs fully sharded;
* the *block-rate* series (one value per 0.2 s) is ~4 orders of magnitude
  smaller, so the sequential detectors either run per time shard with a
  warm-up halo (:func:`sharded_detect_adaptive`) or on the series gathered
  over the time row, replicated on every position of the row
  (:func:`sharded_detect_adaptive_exact`, :func:`sharded_stream_process`),
  which equals the unsharded result exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.models import streaming
from meteor_scatter_tpu_torch.models.adaptive import (
    adaptive_thresholds,
    adaptive_thresholds_parallel,
)
from meteor_scatter_tpu_torch.ops.bandpower import band_power_db, band_projection_matrix
from meteor_scatter_tpu_torch.ops.fir import (
    _bank_apply,
    _bank_tables,
    _validated_int_rate_and_freqs,
    fir_filter,
    firwin_lowpass,
)
from meteor_scatter_tpu_torch.ops.framing import frame_signal
from meteor_scatter_tpu_torch.ops.spectrogram import _stft_psd
from meteor_scatter_tpu_torch.ops.welch import welch_freqs, welch_psd
from meteor_scatter_tpu_torch.ops.window import hann_periodic
from meteor_scatter_tpu_torch.parallel.halo import halo_exchange, time_all_gather, time_psum
from meteor_scatter_tpu_torch.parallel.mesh import (
    STATION_AXIS,
    TIME_AXIS,
    Mesh,
    shard,
    unshard,
)

ST = (STATION_AXIS, TIME_AXIS)
ST_ = (STATION_AXIS, TIME_AXIS, None)
S_ = (STATION_AXIS, None)


def _each(row, fn):
    """``fn(a)`` at every position of a row that this process holds (None
    elsewhere)."""
    return [None if a is None else fn(a) for a in row]


def _local(grid, fn, n_out: int = 0):
    """``fn(local)`` at every position of this process (None elsewhere);
    with ``n_out``, ``fn`` returns a tuple and the result is a tuple of
    ``n_out`` grids."""
    out = [_each(row, fn) for row in grid]
    if not n_out:
        return out
    return tuple([_each(row, lambda c: c[j]) for row in out] for j in range(n_out))


def _on_devices(mesh: Mesh, *arrays: np.ndarray) -> dict:
    """Each numpy array as a tensor on every distinct device of this
    process's positions (once per device: positions of a virtual mesh
    share one copy)."""
    return {dev: tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
            for dev in {d for _, _, d in mesh.local_positions()}}


def sharded_delta_power(
    x: torch.Tensor,  # (C, S)
    mesh: Mesh,
    fs: float,
    n_fft: int,
    block_size: int,
    freq_band: Tuple[float, float],
    noise_band: Tuple[float, float],
    power_floor: float = 1e-12,
):
    """Blockwise delta power, channels over ``station``, samples over
    ``time``.  Blocks never straddle sample shards (S/n_time must divide by
    block_size), so no halo is needed: local products only.

    Returns (band_db, noise_db, delta), each (C, num_blocks).
    """
    M, slices = band_projection_matrix(fs, n_fft, block_size, [freq_band, noise_band])
    proj = _on_devices(mesh, M)

    def local(xl):  # (C_loc, S_loc)
        frames = frame_signal(xl.to(torch.float32), block_size, block_size)
        band, noise = band_power_db(frames, proj[xl.device][0], slices, power_floor)
        return band, noise, band - noise

    return tuple(unshard(g, mesh, ST) for g in _local(shard(x, mesh, ST), local, 3))


def _global_stats(row, mesh: Mesh, s: int):
    """Per-channel (mean, population std) of a row's whole series, from the
    per-shard sums and sums of squares summed over the row (the JAX layer's
    ``psum`` form), at every position of this process (None elsewhere)."""
    sums = time_psum(_each(row, lambda dl: dl.sum(-1)), mesh, s)
    sums2 = time_psum(_each(row, lambda dl: (dl * dl).sum(-1)), mesh, s)
    n = time_psum(_each(row, lambda dl: torch.tensor(float(dl.shape[-1]), dtype=dl.dtype,
                                                      device=dl.device)), mesh, s)
    out = []
    for sk, s2k, nk in zip(sums, sums2, n):
        if sk is None:
            out.append(None)
            continue
        mean = sk / nk
        out.append((mean, torch.sqrt(torch.clamp(s2k / nk - mean * mean, min=0))))
    return out


def sharded_detect_fixed(
    delta: torch.Tensor,  # (C, B)
    mesh: Mesh,
    threshold_std_factor: float,
):
    """Per-channel global threshold from the sums over the time row;
    returns (above mask (C, B), per-channel thresholds (C,))."""
    above, thr = [], []
    for s, row in enumerate(shard(delta, mesh, ST)):
        a_row, t_row = [], []
        for dl, stats in zip(row, _global_stats(row, mesh, s)):
            if dl is None:
                a_row.append(None)
                t_row.append(None)
                continue
            mean, std = stats
            t = mean + threshold_std_factor * std
            a_row.append(dl > t[:, None])
            t_row.append(t)
        above.append(a_row)
        thr.append(t_row)
    return unshard(above, mesh, ST), unshard(thr, mesh, (STATION_AXIS,))


def sharded_detect_adaptive(
    delta: torch.Tensor,  # (C, B)
    mesh: Mesh,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    warmup_blocks: int | None = None,
):
    """Adaptive detection across time shards with warm-up halo recompute.

    Each shard receives the trailing ``warmup_blocks + window_blocks``
    delta values of its left neighbour, seeds the rolling-statistics ring
    with the first ``window_blocks`` of them at their absolute slots,
    replays the recurrence (:func:`adaptive_thresholds`) over the rest to
    converge the freeze state, then emits thresholds/above for its own
    range.  Shard 0's replay runs over zero padding with *negative*
    absolute block indices, so its output equals the unsharded scan.
    Elsewhere the result is exact whenever the warm-up covers the
    estimation window and the freeze reach.

    Returns (thresholds, above), each (C, B).
    """
    if warmup_blocks is None:
        warmup_blocks = window_blocks + freeze_blocks_after
    # the halo (warm-up replay + ring seed) cannot exceed one shard's block
    # count: halos move between direct neighbours only
    n_time = mesh.shape[TIME_AXIS]
    b_loc = delta.shape[-1] // n_time
    if n_time == 1:
        # no seams: the plain scan from block 0 is already exact
        warmup_blocks = 0
        halo_blocks = 0
    else:
        warmup_blocks = min(warmup_blocks, max(b_loc - window_blocks, 0))
        halo_blocks = warmup_blocks + window_blocks
        if halo_blocks > b_loc:
            raise ValueError(
                f"time shards too small: need >= {window_blocks} blocks/shard "
                f"for the rolling window, have {b_loc}"
            )
    w = window_blocks
    kw = dict(
        threshold_std_factor=threshold_std_factor,
        window_blocks=window_blocks,
        freeze_blocks_before=freeze_blocks_before,
        freeze_blocks_after=freeze_blocks_after,
        fixed_threshold_blocks=fixed_threshold_blocks,
    )

    thr_grid, above_grid = [], []
    for s, row in enumerate(shard(delta, mesh, ST)):
        stats = _global_stats(row, mesh, s)
        haloed = halo_exchange(row, halo_blocks, 0, mesh, s)  # (C_loc, halo + B_loc) each
        t_row, a_row = [None] * n_time, [None] * n_time
        for k, (dl, hl, st) in enumerate(zip(row, haloed, stats)):
            if dl is None:
                continue
            g_mean, g_std = st
            c_loc = dl.shape[0]
            dev, dtype = dl.device, dl.dtype
            i0 = k * b_loc - warmup_blocks
            ring0 = torch.zeros((c_loc, w), dtype=dtype, device=dev)
            if halo_blocks > 0:
                # the true `window` delta values before the replay start,
                # absolute indices i0-w .. i0-1, at their ring slots (floor
                # modulo: shard 0's negative indices included; its seed is
                # zeros, which the scan's count-based mask hides)
                slots = torch.remainder(i0 + torch.arange(w, device=dev), w)
                ring0[:, slots] = hl[:, :w]
                replay = hl[:, w:]  # (C_loc, warmup + B_loc)
            else:
                replay = hl
            fixed_thr = (g_mean + threshold_std_factor * g_std).to(dtype)
            init_carry = (
                ring0,
                torch.full((c_loc,), i0, dtype=torch.int32, device=dev),
                torch.full((c_loc,), -1, dtype=torch.int32, device=dev),
                fixed_thr,
            )
            thr, above, _ = adaptive_thresholds(
                replay, **kw, init_carry=init_carry, global_stats=(g_mean, g_std)
            )
            t_row[k] = thr[:, warmup_blocks:]
            a_row[k] = above[:, warmup_blocks:]
        thr_grid.append(t_row)
        above_grid.append(a_row)
    return unshard(thr_grid, mesh, ST), unshard(above_grid, mesh, ST)


def sharded_detect_adaptive_exact(
    delta: torch.Tensor,  # (C, B)
    mesh: Mesh,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
):
    """Exact adaptive detection on time-sharded data: each channel's whole
    delta series is gathered over the time row and the fixpoint solver
    (:func:`adaptive_thresholds_parallel`) runs on every position of the
    row.  Unlike the warm-up-halo variant (:func:`sharded_detect_adaptive`)
    it equals the unsharded result on every shard.

    Returns (thresholds, above), each (C, B).
    """
    kw = dict(
        threshold_std_factor=threshold_std_factor,
        window_blocks=window_blocks,
        freeze_blocks_before=freeze_blocks_before,
        freeze_blocks_after=freeze_blocks_after,
        fixed_threshold_blocks=fixed_threshold_blocks,
    )
    grid = [time_all_gather(row, 1, mesh, s) for s, row in enumerate(shard(delta, mesh, ST))]
    thr, above = _local(grid, lambda full: adaptive_thresholds_parallel(full, **kw), 2)
    return unshard(thr, mesh, S_), unshard(above, mesh, S_)


def sharded_spectrogram_psd(
    x: torch.Tensor,  # (C, S)
    mesh: Mesh,
    fs: float,
    nperseg: int,
    noverlap: int | None = None,
):
    """Overlapped STFT PSD with seam frames computed from a right halo: the
    distributed overlap-save of the reference's noverlap=NFFT//2
    spectrograms.

    Works for any hop: each shard owns the frames whose start sample falls
    in its range, and frames them from its haloed samples at its own first
    offset.  The right halo is sized for the largest shard share, as the
    JAX layer's static offset table.

    Returns (C, n_frames, nbins) with exactly the unsharded frame count
    ``(S - nperseg)//hop + 1``.
    """
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    n_time = mesh.shape[TIME_AXIS]
    S = x.shape[-1]
    if S % n_time:
        raise ValueError(f"signal length {S} must divide over {n_time} time shards")
    s_loc = S // n_time
    nf_global = (S - nperseg) // hop + 1
    if nf_global <= 0:
        raise ValueError("signal shorter than one frame")

    # per shard: the first global frame starting in shard k, its sample
    # offset inside the shard (in [0, hop)), and the frame count
    firsts = [min(-(-(k * s_loc) // hop), nf_global) for k in range(n_time)] + [nf_global]
    nf_k = [firsts[k + 1] - firsts[k] for k in range(n_time)]
    offs = [firsts[k] * hop - k * s_loc for k in range(n_time)]
    slice_len = max(max(nf_k), 1) * hop + (nperseg - hop)
    right_halo = max(0, max(offs) + slice_len - s_loc)
    if right_halo > s_loc:
        raise ValueError(
            f"time shards too small: frame window needs a {right_halo}-sample "
            f"halo but shards hold only {s_loc} samples"
        )
    win = hann_periodic(nperseg)

    # shards own different frame counts: each pads its frames to the largest
    # count (a static capacity), so every position's tensor has one shape
    cap = max(nf_k)

    def local_psd(hl, k):
        psd = _stft_psd(hl[..., offs[k] : offs[k] + nf_k[k] * hop + (nperseg - hop)],
                        fs, nperseg, noverlap, nperseg, win, detrend_constant=True)
        return torch.cat([psd, psd.new_zeros((psd.shape[0], cap - nf_k[k], psd.shape[2]))], 1)

    grid = []
    for s, row in enumerate(shard(x, mesh, ST)):
        haloed = halo_exchange(_each(row, lambda xl: xl.to(torch.float32)), 0, right_halo, mesh, s)
        grid.append([None if hl is None else local_psd(hl, k) for k, hl in enumerate(haloed)])
    keep = torch.cat([torch.arange(k * cap, k * cap + nf_k[k]) for k in range(n_time)])
    return unshard(grid, mesh, ST_)[:, keep.to(mesh.device)]


def sharded_fir_filter(
    x: torch.Tensor,  # (C, S)
    mesh: Mesh,
    taps: np.ndarray,
):
    """'same'-mode FIR across time shards: each shard convolves its range
    plus (t-1)/2-sample halos from both neighbours, exactly matching the
    unsharded result (zero halos at the stream edges = 'same' padding)."""
    t = len(taps)
    lh = (t - 1) // 2
    rh = t - 1 - lh
    grid = []
    for s, row in enumerate(shard(x, mesh, ST)):
        haloed = halo_exchange(_each(row, lambda xl: xl.to(torch.float32)), lh, rh, mesh, s)
        grid.append(_each(haloed, lambda hl: fir_filter(hl, taps, mode="valid")))
    return unshard(grid, mesh, ST)


def sharded_stream_process(
    cfg,  # DetectionConfig
    state,  # StreamState with per-channel leaves, or None to initialize
    x: torch.Tensor,  # (C, S) flat, or (C, n_blocks, block) pre-blocked
    fs: float,
    mesh: Mesh,
    front: str = "auto",
    impl: str = "auto",
):
    """Time-sharded streaming 3-state machine (the reference's
    `processor.py:444-510` sequential loop).

    The front half (Welch, or the bins-only product with ``front="bins"``)
    runs fully sharded over (station, time); the block-rate series are
    gathered over the time row and the sequential solve runs on every
    position of the row over its station group: the scan twin with
    ``impl="scan"``, the batched episode-jump solvers with ``impl="jump"``
    / ``"hop"`` (``stream_scan_jump`` / ``stream_scan_jump_batch`` over the
    group, where the reference ``vmap``s the one-series solver: one launch
    of the fused kernel K3 per position on a CUDA mesh, the lockstep loops
    on a CPU mesh), or one launch of K3 per position with
    ``impl="fused"`` (its twin on a CPU mesh).  The result equals the unsharded
    :func:`~meteor_scatter_tpu_torch.models.streaming.stream_process` on the
    same device type.  ``"auto"`` resolves by the mesh's device type
    (:func:`~meteor_scatter_tpu_torch.models.streaming.resolve_stream_auto`).

    The carried ``StreamState`` is per channel (leading C axis, see
    ``stream_init_batch``), so chunked long-stream processing carries
    across calls as on one device.  Pre-blocked input shards its blocks
    over time.

    Returns (new_state, events, diags): state and events with per-channel
    leading dims; diags with the full over_noise/threshold series (C, B),
    and with the Welch front the psd waterfall (C, B, nbins) and freqs.
    """
    block = int(round(cfg.proc_block_sec * fs))
    n_time = mesh.shape[TIME_AXIS]
    preblocked = x.dim() == 3
    if preblocked:
        n_ch, B = x.shape[:2]
        if x.shape[-1] != block:
            raise ValueError(
                f"pre-blocked input must have trailing dim {block}, got {x.shape[-1]}"
            )
        if B % n_time:
            raise ValueError(f"blocks per time shard ({B}/{n_time}) must be whole")
    else:
        n_ch, S = x.shape
        if S % n_time or (S // n_time) % block:
            raise ValueError(
                f"samples per time shard ({S}/{n_time}) must be a whole "
                f"number of {block}-sample blocks"
            )
    front, impl = streaming.resolve_stream_auto(front, impl, device=mesh.device)
    if front not in ("welch", "bins"):
        raise ValueError(f"unknown front {front!r} (use 'welch' or 'bins')")
    solvers = {"scan": streaming.stream_scan, "jump": streaming.stream_scan_jump,
               "hop": streaming.stream_scan_jump_batch, "fused": streaming.stream_scan_fused_batch}
    if impl not in solvers:
        raise ValueError(f"unknown impl {impl!r} (use 'scan', 'jump', 'hop' or 'fused')")
    solve = solvers[impl]
    scfg = streaming.StreamConfig.from_config(cfg)
    if state is None:
        state = streaming.stream_init_batch(scfg, n_ch, device=mesh.device)
    headless = front == "bins"
    front_fn = streaming.stream_front_headless if headless else streaming.stream_front

    x_grid = shard(x, mesh, ST_ if preblocked else ST)
    st_grids = [shard(leaf, mesh, (STATION_AXIS,)) for leaf in state]
    outs = []  # per station: (state, events, thr, on_full[, psd_db]) per position
    for s, row in enumerate(x_grid):
        fronts = _each(row, lambda xl: front_fn(cfg, xl, fs))
        on_full = time_all_gather(_each(fronts, lambda f: f[0]), -1, mesh, s)
        pm_full = time_all_gather(_each(fronts, lambda f: f[1]), -1, mesh, s)
        cells = [None] * n_time
        for k in range(n_time):
            if fronts[k] is None:
                continue
            st_k = streaming.StreamState(*(g[s][k] for g in st_grids))
            st2, ev, thr = solve(scfg, st_k, on_full[k], pm_full[k])
            cell = (st2, ev, thr, on_full[k])
            cells[k] = cell if headless else cell + (fronts[k][2]["psd_db"],)
        outs.append(cells)

    def gather(j, spec):
        return unshard([_each(cells, lambda c: c[j]) for cells in outs], mesh, spec)

    def gather_tuple(j, kind):
        return kind(*(unshard([_each(cells, lambda c: c[j][f]) for cells in outs], mesh,
                              (STATION_AXIS,))
                      for f in range(len(kind._fields))))

    new_state = gather_tuple(0, streaming.StreamState)
    events = gather_tuple(1, streaming.StreamEvents)
    diags = {"over_noise": gather(3, S_), "threshold": gather(2, S_)}
    if not headless:
        diags["psd_db"] = gather(4, ST_)
        diags["freqs"] = welch_freqs(fs, cfg.n_fft)
    return new_state, events, diags


def _iq_bank_setup(n, fs, center_freqs, bandwidth, decim, numtaps, n_time):
    """Host-side setup of the time-sharded DDC bank, shared by the flat and
    the pre-framed forms: the local framing geometry, the bank's tables
    (numpy float32) and the exact-integer per-(shard, channel) rotation
    ``(cos θ, sin θ)``, each (n_time, C)."""
    fs_i, freqs = _validated_int_rate_and_freqs(fs, center_freqs)
    q, c_n = int(decim), len(freqs)
    if n % (q * n_time):
        raise ValueError(
            f"samples ({n}) must divide into whole decimation frames per "
            f"time shard (q·n_time = {q * n_time})"
        )
    t = int(numtaps)
    pl = (t - 1) // 2
    a_cols = -(-t // q)
    rh = (a_cols - 1) * q - pl
    if rh < 0:
        raise ValueError("numtaps must be >= 2*decim for the sharded bank")
    s_loc = n // n_time
    n_out_loc = s_loc // q
    m_loc = n_out_loc + a_cols - 1

    h = firwin_lowpass(t, bandwidth / 2.0, fs)
    tables = _bank_tables(fs_i, freqs, h, q, a_cols, m_loc, pl)

    # per-(shard, channel) constant rotation, exact integer phase arithmetic
    ks = np.arange(n_time, dtype=np.int64)[:, None] * s_loc
    ph = (ks * np.asarray(freqs, np.int64)[None, :]) % fs_i
    ang = 2.0 * np.pi * ph / fs_i
    rot = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    return dict(q=q, c_n=c_n, a_cols=a_cols, pl=pl, rh=rh, s_loc=s_loc,
                n_out_loc=n_out_loc, m_loc=m_loc, tables=tables, rot=rot)


def _iq_bank_local(f: torch.Tensor, k: int, dev_tables, plan: dict):
    """One time shard's bank: ``f`` its (2, m_loc, q) frames with the halo
    rows, ``k`` its index.  Returns (y_re, y_im), each (C, n_out_loc)."""
    hh, cr, sr, cth, sth = dev_tables
    dc, ds = _bank_apply(f, hh, cr, sr, plan["c_n"], plan["a_cols"], plan["n_out_loc"])
    y_re = dc[0] + ds[1]  # channelize_iq's combination
    y_im = dc[1] - ds[0]
    c = cth[k][:, None]  # (C, 1): this shard's rotation
    s = sth[k][:, None]
    return c * y_re + s * y_im, c * y_im - s * y_re


def sharded_channelize_iq(
    x_re: torch.Tensor,  # (S,) wideband I component
    x_im: torch.Tensor,  # (S,) wideband Q component
    mesh: Mesh,
    fs: float,
    center_freqs,
    bandwidth: float,
    decim: int,
    numtaps: int = 257,
):
    """Time-sharded one-product DDC bank: BASELINE config 4's wideband I/Q
    front half over the time axis (:func:`~meteor_scatter_tpu_torch.ops.fir.channelize_iq`
    is the single-device form).

    Each time shard frames its samples plus a ``(pl, (A−1)·q − pl)`` halo
    and runs the same polyphase product and row rotation as the unsharded
    bank.  The mixer's phase is linear in the absolute sample index, so the
    only global bookkeeping is one constant complex rotation per (shard,
    channel):

        φ_global(s) = φ_local(s_loc) + φ(k·S_loc)
        ⟹  y_global = e^{−jθ_{k,c}} · y_local,  θ_{k,c} = 2π·((k·S_loc·f_c) mod fs)/fs

    with θ computed in exact integer arithmetic on the host.  Equal to
    :func:`channelize_iq` up to one extra float32 rotation per sample (the
    halo zeros at the stream edges match its 'same' padding).  The station
    axis is replicated over: every station row computes the same bank.

    Returns ``(y_re, y_im)``, each (C, n_out).
    """
    n = x_re.shape[-1]
    if x_re.shape != x_im.shape:
        raise ValueError(f"I/Q shape mismatch: {tuple(x_re.shape)} vs {tuple(x_im.shape)}")
    plan = _iq_bank_setup(n, fs, center_freqs, bandwidth, decim, numtaps, mesh.shape[TIME_AXIS])
    dev_tables = _on_devices(mesh, *plan["tables"], *plan["rot"])
    re_grid, im_grid = shard(x_re, mesh, (TIME_AXIS,)), shard(x_im, mesh, (TIME_AXIS,))
    y_re, y_im = [], []
    for s, (re_row, im_row) in enumerate(zip(re_grid, im_grid)):
        xs = [None if a is None else torch.stack([a.to(torch.float32), b.to(torch.float32)])
              for a, b in zip(re_row, im_row)]
        haloed = halo_exchange(xs, plan["pl"], plan["rh"], mesh, s)  # (2, m_loc·q) each, fresh
        cells = [None if xh is None else
                 _iq_bank_local(xh.reshape(2, plan["m_loc"], plan["q"]), k, dev_tables[xh.device],
                                plan) for k, xh in enumerate(haloed)]
        y_re.append(_each(cells, lambda c: c[0]))
        y_im.append(_each(cells, lambda c: c[1]))
    spec = (None, TIME_AXIS)
    return unshard(y_re, mesh, spec), unshard(y_im, mesh, spec)


def sharded_channelize_iq_frames(
    f_sh: torch.Tensor,  # (n_time, 2, m_loc, q) per-shard frames incl. halo
    mesh: Mesh,
    fs: float,
    center_freqs,
    bandwidth: float,
    decim: int,
    numtaps: int = 257,
):
    """Pre-framed form of :func:`sharded_channelize_iq`: the host bakes
    per-shard polyphase frames *with the halo rows included*
    (:func:`~meteor_scatter_tpu_torch.ops.fir.frame_capture_sharded_host`),
    so no shard frames on the device and no halo moves between shards.
    Bit-identical to the flat form: each shard's frames are a fresh
    contiguous (2, m_loc, q) tensor holding the same values, and the tables
    and rotation are the same, so the bank sees identical inputs.

    Returns ``(y_re, y_im)``, each (C, n_out).
    """
    n_time = mesh.shape[TIME_AXIS]
    if f_sh.dim() != 4 or f_sh.shape[0] != n_time or f_sh.shape[1] != 2:
        raise ValueError(
            f"expected (n_time={n_time}, 2, m_loc, q) pre-framed input, got {tuple(f_sh.shape)}"
        )
    q = int(decim)
    a_cols = -(-int(numtaps) // q)
    m_loc = f_sh.shape[2]
    n_out_loc = m_loc - (a_cols - 1)
    if f_sh.shape[3] != q or n_out_loc < 1:
        # frames built for another decimation, or too few rows for one
        # output, would feed the bank inconsistent tap columns
        raise ValueError(
            f"pre-framed geometry (m_loc={m_loc}, q={f_sh.shape[3]}) does not match the "
            f"bank plan for decim={decim}, numtaps={numtaps} (q={q}, m_loc >= {a_cols})"
        )
    plan = _iq_bank_setup(n_out_loc * q * n_time, fs, center_freqs, bandwidth, decim, numtaps,
                          n_time)
    dev_tables = _on_devices(mesh, *plan["tables"], *plan["rot"])
    y_re, y_im = [], []
    for row in shard(f_sh, mesh, (TIME_AXIS, None, None, None)):
        # a fresh contiguous copy, as the flat form's haloed frames
        cells = [None if fl is None else
                 _iq_bank_local(fl[0].to(torch.float32, copy=True), k, dev_tables[fl.device], plan)
                 for k, fl in enumerate(row)]
        y_re.append(_each(cells, lambda c: c[0]))
        y_im.append(_each(cells, lambda c: c[1]))
    spec = (None, TIME_AXIS)
    return unshard(y_re, mesh, spec), unshard(y_im, mesh, spec)


def sharded_welch_blocks(
    x: torch.Tensor,  # (C, S)
    mesh: Mesh,
    fs: float,
    block_size: int,
    nfft: int,
    nperseg: int = 256,
):
    """Per-block Welch PSDs (the streaming front half, processor.py:206)
    sharded over channels and time; blocks are hop-aligned, so no halo.
    Returns (C, n_blocks, nfft//2 + 1)."""

    def local(xl):
        blocks = frame_signal(xl.to(torch.float32), block_size, block_size)
        return welch_psd(blocks, fs, nfft, nperseg=nperseg)

    return unshard(_local(shard(x, mesh, ST), local), mesh, ST_)
