"""Streaming 3-state detector (Initialization → Detection → Tracking).

Counterpart of `meteor_scatter_tpu/models/streaming.py` (reference:
`dsp/src/live/backend/processor.py:176-510`), with the same names,
arguments and array layouts.  The decision process is one flat carry
advanced block by block; the per-block spectral work (Welch PSD and three
band sums, or the bins-only block projection) runs batched over the whole
chunk before it.

Per-block semantics (as the reference package):

* over-noise level: ms_db − mean(noise1_db, noise2_db)   (`processor.py:393`)
* rolling mean/std over the last ``avg_win`` values *excluding* the current
  block (`processor.py:394-404`)
* threshold = mean + k·std, overridden by the locked threshold while
  Tracking, or while Detection inside the post-tracking lock window
  (`processor.py:406-413`); the lock window and the minimum-duration
  acceptance are exact integer block arithmetic (:func:`lock_tail_blocks`,
  :func:`min_duration_blocks`)
* Initialization: accumulate mean PSD dB until
  ``block_start_sec >= init_detection_wait_sec`` (`processor.py:444-457`)
* Detection→Tracking on ``over_noise > threshold`` with the threshold
  locked at that value (`processor.py:459-471`)
* Tracking appends the current block to the event statistics *before* the
  below-threshold check (`processor.py:475-488`)
* event accepted iff mean ≥ detection_db_over_noise_mean_min and duration
  ≥ detection_dur_min_sec (`processor.py:476-493`)

Solvers: :func:`stream_step` is the per-block oracle formulation;
:func:`stream_scan` runs the block-rate solve (base-threshold prologue,
block machine, event compaction, final ring) as the plain PyTorch twin of
K3 (:func:`meteor_scatter_tpu_torch.ops.kernels.stream_kernel.stream_solve_plain`)
on any device; :func:`stream_scan_fused_batch` runs the same solve on the
series' device, which is one launch of the hand-written CUDA kernel K3 on
a GPU.  The two are bit-exact with each other on one device.  The
episode-jump solvers :func:`stream_scan_jump` and
:func:`stream_scan_jump_batch` (plain PyTorch on any device) jump from
decision to decision instead of walking every block; they give the scan's
thresholds, transitions and event boundaries bit for bit and its dB
statistics to float32 summation order.  Every state and series is batched
over a leading channel axis where the reference uses ``vmap``; an
unbatched call is one channel.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.config import DetectionConfig
from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device
from meteor_scatter_tpu_torch.ops.kernels import stream_kernel
from meteor_scatter_tpu_torch.ops.welch import (
    band_sum_db,
    block_band_matrix,
    block_band_sums_db,
    welch_freqs,
    welch_psd,
)

# State machine encoding
INIT, DETECT, TRACK = 0, 1, 2

# The episode solvers' loop tests on the host whether any channel is still
# undecided once every SYNC_EVERY lockstep iterations (each test waits for
# the device); iterations past a channel's end leave its carry unchanged.
SYNC_EVERY = 4
iterations = 0  # episode-solver lockstep iterations so far; chip_smoke.py resets and reads it
syncs = 0  # host tests of the episode solvers' loop so far


def lock_tail_blocks(after_wait_sec: float, block_sec: float) -> int:
    """Largest integer m with ``m·block_sec < after_wait_sec`` in exact real
    arithmetic: after a track-leave at block j, the locked threshold applies
    in Detection through block ``j + m − 1`` (the reference condition
    ``t_start(j) + W > t_end(i)`` ⟺ ``(i+1−j)·bs < W``, processor.py:406)."""
    return int(math.ceil(after_wait_sec / block_sec - 1e-9)) - 1


def min_duration_blocks(min_dur_sec: float, block_sec: float) -> int:
    """Smallest integer n with ``n·block_sec ≥ min_dur_sec`` in exact real
    arithmetic — the accept rule ``duration ≥ detection_dur_min_sec``
    (processor.py:476-493) with duration = (leave − entry) blocks."""
    return int(math.ceil(min_dur_sec / block_sec - 1e-9))


class StreamConfig(NamedTuple):
    """Static parameters derived from DetectionConfig."""

    block_sec: float
    avg_win: int  # blocks
    init_wait_sec: float
    after_wait_sec: float
    k_std: float
    min_mean_db: float
    min_dur_sec: float
    cap: int

    @staticmethod
    def from_config(cfg: DetectionConfig) -> "StreamConfig":
        return StreamConfig(
            block_sec=cfg.proc_block_sec,
            avg_win=int(cfg.avg_win_sec / cfg.proc_block_sec),
            init_wait_sec=cfg.init_detection_wait_sec,
            after_wait_sec=cfg.after_tracking_wait_sec,
            k_std=cfg.threshold_std_factor,
            min_mean_db=cfg.detection_db_over_noise_mean_min,
            min_dur_sec=cfg.detection_dur_min_sec,
            cap=cfg.max_events,
        )


class StreamEvents(NamedTuple):
    """DetectedMeteor fields (`aggregates.py:66-74`) as fixed-cap tensors."""

    time_start: torch.Tensor
    time_stop: torch.Tensor
    duration: torch.Tensor
    db_min: torch.Tensor
    db_max: torch.Tensor
    db_mean: torch.Tensor
    db_std: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor


class StreamState(NamedTuple):
    """The carry — the flattened union of the reference's three state
    dataclasses plus the rolling history."""

    state: torch.Tensor  # int32: INIT/DETECT/TRACK
    block_idx: torch.Tensor  # int32 absolute block counter
    ring: torch.Tensor  # f32 [avg_win] trailing over-noise values
    locked_threshold: torch.Tensor
    locked_until_block: torch.Tensor  # int32: last block the lock applies to
    track_start_sec: torch.Tensor
    track_start_block: torch.Tensor  # int32 absolute entry block
    # running stats of the tracking history
    tr_count: torch.Tensor
    tr_sum: torch.Tensor
    tr_sumsq: torch.Tensor
    tr_min: torch.Tensor
    tr_max: torch.Tensor
    # initialization-phase PSD accumulation (auto-gain, processor.py:448-454)
    init_sum: torch.Tensor
    init_count: torch.Tensor
    psd_db_mean_from_init: torch.Tensor


def _map(fn: Callable, tup):
    return type(tup)(*(fn(x) for x in tup))


def stream_init(cfg: StreamConfig, dtype=torch.float32, device: DeviceLike = "cuda") -> StreamState:
    """The state before any block: the reference's parameters, with the
    device last, as in every function of the port."""
    dev = resolve_device(device)

    def f(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    def i(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return StreamState(
        state=i(INIT),
        block_idx=i(0),
        ring=torch.zeros(cfg.avg_win, dtype=dtype, device=dev),
        locked_threshold=f(-1.0),
        locked_until_block=i(-1),
        track_start_sec=f(0.0),
        track_start_block=i(0),
        tr_count=i(0),
        tr_sum=f(0.0),
        tr_sumsq=f(0.0),
        tr_min=f(math.inf),
        tr_max=f(-math.inf),
        init_sum=f(0.0),
        init_count=i(0),
        psd_db_mean_from_init=f(0.0),
    )


def stream_init_batch(
    cfg: StreamConfig, n_channels: int, dtype=torch.float32, device: DeviceLike = "cuda"
) -> StreamState:
    """Per-channel initial state: every :func:`stream_init` leaf gains a
    leading (n_channels,) axis."""
    return _map(
        lambda x: x.expand((n_channels,) + x.shape).contiguous(),
        stream_init(cfg, dtype, device=device),
    )


def state_from_numpy(arrays, device: DeviceLike = "cuda") -> StreamState:
    """A :class:`StreamState` on ``device`` from numpy arrays under the
    field names of ``StreamState`` — a mapping, or any object with those
    attributes, such as the JAX package's ``StreamState`` after
    ``np.asarray`` of each leaf.  A stream begun in either package
    continues in the other: dtypes (int32 / float32) and layouts are the
    same in both."""
    dev = resolve_device(device)
    get = arrays.__getitem__ if isinstance(arrays, dict) else functools.partial(getattr, arrays)
    return StreamState(
        *(torch.from_numpy(np.array(get(f))).to(dev) for f in StreamState._fields)
    )


def state_to_numpy(state: StreamState) -> StreamState:
    """The state's leaves as numpy arrays, the inverse of
    :func:`state_from_numpy` (``jax`` ``StreamState(*state_to_numpy(s))``
    hands a stream back to the JAX package)."""
    return _map(lambda t: t.detach().cpu().numpy(), state)


def _empty_events(cap: int, dtype, device) -> StreamEvents:
    zf = torch.zeros(cap, dtype=dtype, device=device)
    return StreamEvents(
        time_start=zf,
        time_stop=zf,
        duration=zf,
        db_min=zf,
        db_max=zf,
        db_mean=zf,
        db_std=zf,
        count=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def stream_step(cfg: StreamConfig, state: StreamState, events: StreamEvents, over_noise, psd_db_mean):
    """Advance one block of one channel.  Returns (state, events,
    effective_threshold)."""
    dtype, dev = over_noise.dtype, over_noise.device
    i = state.block_idx
    bs = torch.tensor(cfg.block_sec, dtype=dtype, device=dev)
    t_start = i.to(dtype) * bs
    lock_tail = lock_tail_blocks(cfg.after_wait_sec, cfg.block_sec)
    min_dur_b = min_duration_blocks(cfg.min_dur_sec, cfg.block_sec)
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.tensor(math.inf, dtype=dtype, device=dev)

    # rolling stats over trailing window (current block excluded)
    w = cfg.avg_win
    cnt = torch.clamp(i, max=w)
    valid = torch.arange(w, device=dev) < cnt
    cnt_f = torch.clamp(cnt, min=1).to(dtype)
    m = torch.where(valid, state.ring, zero).sum() / cnt_f
    m2 = torch.where(valid, state.ring * state.ring, zero).sum() / cnt_f
    std = torch.sqrt(torch.maximum(m2 - m * m, zero))
    base_thr = torch.where(cnt > 0, m + cfg.k_std * std, torch.full_like(m, math.nan))

    thr = torch.where(
        state.state == TRACK,
        state.locked_threshold,
        torch.where(
            (state.state == DETECT) & (i <= state.locked_until_block),
            state.locked_threshold,
            base_thr,
        ),
    )

    # ---- INIT ----
    new_init_sum = state.init_sum + psd_db_mean
    new_init_count = state.init_count + 1
    init_done = t_start >= torch.tensor(cfg.init_wait_sec, dtype=dtype, device=dev)
    psd_mean_from_init = new_init_sum / torch.clamp(new_init_count, min=1).to(dtype)

    # ---- DETECT: enter tracking? ----
    enter_track = over_noise > thr

    # ---- TRACK: update history stats (current block appended first) ----
    tr_count = state.tr_count + 1
    tr_sum = state.tr_sum + over_noise
    tr_sumsq = state.tr_sumsq + over_noise * over_noise
    tr_min = torch.minimum(state.tr_min, over_noise)
    tr_max = torch.maximum(state.tr_max, over_noise)
    leave_track = over_noise < thr

    dur = t_start - state.track_start_sec
    h_cnt = torch.clamp(tr_count, min=1).to(dtype)
    h_mean = tr_sum / h_cnt
    h_std = torch.sqrt(torch.maximum(tr_sumsq / h_cnt - h_mean * h_mean, zero))
    accept = (h_mean >= torch.tensor(cfg.min_mean_db, dtype=dtype, device=dev)) & (
        i - state.track_start_block >= min_dur_b
    )

    is_init = state.state == INIT
    is_detect = state.state == DETECT
    is_track = state.state == TRACK

    emit = is_track & leave_track & accept
    sel = torch.arange(cfg.cap, device=dev) == torch.where(
        emit & (events.count < cfg.cap), events.count, cfg.cap
    )
    events = StreamEvents(
        time_start=torch.where(sel, state.track_start_sec, events.time_start),
        time_stop=torch.where(sel, t_start, events.time_stop),
        duration=torch.where(sel, dur, events.duration),
        db_min=torch.where(sel, tr_min, events.db_min),
        db_max=torch.where(sel, tr_max, events.db_max),
        db_mean=torch.where(sel, h_mean, events.db_mean),
        db_std=torch.where(sel, h_std, events.db_std),
        count=events.count + emit.to(torch.int32),
        overflow=events.overflow | (emit & (events.count >= cfg.cap)),
    )

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    next_state = torch.where(
        is_init,
        torch.where(init_done, i32(DETECT), i32(INIT)),
        torch.where(
            is_detect,
            torch.where(enter_track, i32(TRACK), i32(DETECT)),
            torch.where(leave_track, i32(DETECT), i32(TRACK)),
        ),
    )
    start = is_detect & enter_track
    new_state = StreamState(
        state=next_state,
        block_idx=i + 1,
        ring=torch.where(torch.arange(w, device=dev) == torch.remainder(i, w), over_noise, state.ring),
        locked_threshold=torch.where(start, thr, state.locked_threshold),
        locked_until_block=torch.where(
            is_track & leave_track, i + (lock_tail - 1), state.locked_until_block
        ),
        track_start_sec=torch.where(start, t_start, state.track_start_sec),
        track_start_block=torch.where(start, i, state.track_start_block),
        tr_count=torch.where(start, i32(0), torch.where(is_track, tr_count, state.tr_count)),
        tr_sum=torch.where(start, zero, torch.where(is_track, tr_sum, state.tr_sum)),
        tr_sumsq=torch.where(start, zero, torch.where(is_track, tr_sumsq, state.tr_sumsq)),
        tr_min=torch.where(start, inf, torch.where(is_track, tr_min, state.tr_min)),
        tr_max=torch.where(start, -inf, torch.where(is_track, tr_max, state.tr_max)),
        init_sum=torch.where(is_init, new_init_sum, state.init_sum),
        init_count=torch.where(is_init, new_init_count, state.init_count),
        psd_db_mean_from_init=torch.where(
            is_init & init_done, psd_mean_from_init, state.psd_db_mean_from_init
        ),
    )
    return new_state, events, thr


def _blocked(samples: torch.Tensor, block: int) -> torch.Tensor:
    """Shape audio as ``(..., n_blocks, block)``: flat ``(..., S)`` audio is
    cut into whole blocks (a view), audio already ``(..., n_blocks, block)``
    (ndim ≥ 3) passes as it is."""
    if samples.dim() >= 3 and samples.shape[-1] == block:
        return samples
    n_blocks = samples.shape[-1] // block
    return samples[..., : n_blocks * block].reshape(samples.shape[:-1] + (n_blocks, block))


def _sanitize_levels(on: torch.Tensor) -> torch.Tensor:
    """Clamp ±inf levels (digital-silence / saturated-capture dB) to ±1e15
    and map NaN to −1e15 at the front/solver boundary, as the reference
    package does: finite values pass bit-unchanged, the square of the
    sentinel stays finite in float32, and a degenerate block cannot spread
    NaN through the rolling-window sums.  The three band levels are
    sanitized individually before the band subtraction."""
    big = 1e15
    return torch.clamp(torch.nan_to_num(on, nan=-big), -big, big)


def stream_front(cfg: DetectionConfig, samples: torch.Tensor, fs: float):
    """Vectorized front half (Welch PSD + three band sums for every block
    at once, `processor.py:206,349-393`), batched over any leading dims.

    Returns (over_noise, psd_db_mean, front_diags) with per-block series of
    shape ``samples.shape[:-1] + (n_blocks,)``; audio is accepted flat
    (``(..., S)``) or pre-blocked (``(..., n_blocks, block)``, ndim ≥ 3).
    """
    block = int(round(cfg.proc_block_sec * fs))
    x = _blocked(samples, block)

    psd = welch_psd(x, fs, cfg.n_fft, nperseg=cfg.welch_nperseg)
    psd_db = 10.0 * torch.log10(psd)
    freqs = welch_freqs(fs, cfg.n_fft)

    ms_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.signal_band))
    n1_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.noise_band_1))
    n2_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.noise_band_2))
    over_noise = ms_db - (n1_db + n2_db) / 2.0
    psd_db_mean = psd_db.mean(dim=-1)
    diags = {
        "ms_db": ms_db,
        "noise1_db": n1_db,
        "noise2_db": n2_db,
        "psd_db": psd_db,
        "freqs": freqs,
    }
    return over_noise, psd_db_mean, diags


@functools.lru_cache(maxsize=8)
def _headless_projection(fs: float, nfft: int, nperseg: int, bands, block: int):
    # float64 eigen-factor of the whole-block Welch band operator
    # (block_band_matrix): framing, window, DFT selection and the segment
    # mean folded into one (block, K) factor
    return block_band_matrix(fs, nfft, nperseg, block, bands)


@functools.lru_cache(maxsize=8)
def _headless_projection_on(fs: float, nfft: int, nperseg: int, bands, block: int, device: str):
    P, slices, nseg = _headless_projection(fs, nfft, nperseg, bands, block)
    return torch.from_numpy(P).to(device), slices, nseg


def stream_front_headless(cfg: DetectionConfig, samples: torch.Tensor, fs: float):
    """Bins-only front half: the three Welch band levels as one float32
    product on the raw blocks (:func:`block_band_matrix`) instead of
    zero-padded nfft-point PSDs whose other bins detection never reads.

    Accepts audio flat (``(..., S)``) or pre-blocked (``(..., n_blocks,
    block)``, ndim ≥ 3).  Event decisions depend only on ``over_noise``;
    ``psd_db_mean`` feeds only the visualization auto-gain
    (`processor.py:448-454`), so it is zeros here and no PSD waterfall is
    carried.  Band levels equal the Welch path's to float32 reduction order
    and the factor's truncated eigenmass; a tie at the threshold could in
    principle flip a block, so headless stays opt-in (``front="bins"``,
    ``apps/live.py --headless``).  The projection is built once and kept
    per device.
    """
    block = int(round(cfg.proc_block_sec * fs))
    x = _blocked(samples, block)
    nperseg = min(cfg.welch_nperseg, block)
    P, slices, nseg = _headless_projection_on(
        fs, cfg.n_fft, nperseg,
        (cfg.signal_band, cfg.noise_band_1, cfg.noise_band_2),
        block, str(x.device),
    )
    ms_db, n1_db, n2_db = (_sanitize_levels(v) for v in block_band_sums_db(x, P, slices, nseg))
    over_noise = ms_db - (n1_db + n2_db) / 2.0
    psd_db_mean = torch.zeros_like(over_noise)
    diags = {"ms_db": ms_db, "noise1_db": n1_db, "noise2_db": n2_db}
    return over_noise, psd_db_mean, diags


def solve_params(scfg: StreamConfig) -> dict:
    """The solve's keywords (:func:`stream_kernel.stream_solve_plain`): the
    float constants as the kernel takes them, and the block counts."""
    return dict(
        k_std=float(scfg.k_std),
        block_sec=float(scfg.block_sec),
        init_wait_sec=float(scfg.init_wait_sec),
        min_mean_db=float(scfg.min_mean_db),
        min_dur_b=min_duration_blocks(scfg.min_dur_sec, scfg.block_sec),
        lock_tail=lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec),
        cap=int(scfg.cap),
    )


def _per_channel(solve: Callable, state: StreamState, over_noise, psd_db_mean) -> tuple:
    """``solve(state, over_noise, psd_db_mean)`` of a batched solver (state
    leaves (C, ...), series (C, n)) on a batch as it is, or on one channel
    (1-D series, scalar state) as C = 1 with the channel axis dropped from
    every output (named tuples, dicts and tensors)."""
    if over_noise.dim() != 1:
        return solve(state, over_noise, psd_db_mean)

    def row(out):
        if isinstance(out, dict):
            return {k: v[0] for k, v in out.items()}
        return _map(lambda a: a[0], out) if isinstance(out, tuple) else out[0]

    out = solve(_map(lambda a: a.unsqueeze(0), state), over_noise[None], psd_db_mean[None])
    return tuple(row(o) for o in out)


def _solve(scfg: StreamConfig, state: StreamState, over_noise, psd_db_mean, solve):
    """One chunk of C channels through ``solve`` (the kernel's layout, see
    :mod:`meteor_scatter_tpu_torch.ops.kernels.stream_kernel`); an
    unbatched call (1-D series, scalar state) is C = 1.  Series that are not
    contiguous are copied first; the fronts' are, so on the main path only
    views are taken around the solve."""

    def kernel_layout(st, on, pm):
        st, ev, thr = solve(on.contiguous(), pm.contiguous(), tuple(st), **solve_params(scfg))
        return StreamState(*st), StreamEvents(*ev), thr

    return _per_channel(kernel_layout, state, over_noise, psd_db_mean)


def stream_scan(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: torch.Tensor,  # (n_blocks,) or (C, n_blocks)
    psd_db_mean: torch.Tensor,  # like over_noise
) -> Tuple[StreamState, StreamEvents, torch.Tensor]:
    """The sequential 3-state machine over one chunk — the block-rate back
    half of :func:`stream_process` (reference semantics:
    `processor.py:444-510`).  The whole solve is K3's plain PyTorch twin
    (``stream_solve_plain``) on whatever device the series lie on.  Returns
    (new_state, events,
    per-block thresholds); batched over a leading channel axis, or one
    channel with 1-D series and a scalar state."""
    return _solve(scfg, state, over_noise, psd_db_mean, stream_kernel.stream_solve_plain)


def stream_scan_fused_batch(
    scfg: StreamConfig,
    state: StreamState,        # batched: every leaf has leading dim (C,)
    over_noise: torch.Tensor,  # (C, n_blocks)
    psd_db_mean: torch.Tensor,  # (C, n_blocks)
) -> Tuple[StreamState, StreamEvents, torch.Tensor]:
    """Batched fused form of :func:`stream_scan` — the wide-station solver
    (BASELINE config 5): on a GPU one launch of the CUDA kernel K3 runs
    the whole solve of every channel (prologue, machine, compaction, ring),
    any C, and nothing else is launched; on the CPU the same call runs K3's
    twin.

    Contract: bit-exact vs :func:`stream_scan` on the same device, since
    the kernel is bit-exact against the twin on every output.
    """
    if over_noise.dim() != 2:
        raise ValueError(f"over_noise must be (C, n_blocks), got shape {tuple(over_noise.shape)}")
    return _solve(scfg, state, over_noise, psd_db_mean, stream_kernel.stream_solve)


def stream_scan_fused(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: torch.Tensor,   # (n_blocks,)
    psd_db_mean: torch.Tensor,  # (n_blocks,)
) -> Tuple[StreamState, StreamEvents, torch.Tensor]:
    """Single-series form of :func:`stream_scan_fused_batch` (same
    (new_state, events, thresholds) contract as :func:`stream_scan`)."""
    return _solve(scfg, state, over_noise, psd_db_mean, stream_kernel.stream_solve)


class _Lanes(NamedTuple):
    """Per-channel carry of the episode solvers' lockstep loop, each (C,):
    the next undecided block ``k`` (chunk-relative; the channel is done at
    n), the machine's state, lock and track leaves, and the event count and
    overflow flag."""

    k: torch.Tensor
    s: torch.Tensor
    L: torch.Tensor
    luntil: torch.Tensor
    tstart: torch.Tensor
    tsblk: torch.Tensor
    trc: torch.Tensor
    trs: torch.Tensor
    trss: torch.Tensor
    trmn: torch.Tensor
    trmx: torch.Tensor
    e_cnt: torch.Tensor
    e_ovf: torch.Tensor


def _const(value: float, device) -> torch.Tensor:
    """A float32 constant on ``device``, made by a fill kernel: a tensor
    built from a host value would be a pageable copy, which waits for the
    device."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _pick(cond: torch.Tensor, a: _Lanes, b: _Lanes) -> _Lanes:
    return _Lanes(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _first(mask: torch.Tensor, pos: torch.Tensor, none: int) -> torch.Tensor:
    """Per row, the position of the first true entry of ``mask`` (``pos``
    along its last axis), or ``none`` where the row has none."""
    return torch.where(mask, pos, none).amin(-1)


def _at(a: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``a[c, pos[c]]`` per channel, ``pos`` clamped into the row (a
    position past the end, where nothing was found, reads a value that the
    caller then does not select)."""
    return a.gather(1, torch.clamp(pos, max=a.shape[1] - 1).to(torch.int64)[:, None])[:, 0]


def _file(buf: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor) -> None:
    """Write ``vals`` (R, C) into ``buf`` (R, C, slots) at each channel's
    ``slot``; the last slot is the spare one that takes dropped writes."""
    idx = slot.to(torch.int64)[None, :, None].expand(buf.shape[0], -1, 1)
    buf.scatter_(2, idx, vals[..., None])


def _lockstep(step: Callable, lanes: _Lanes, n: int) -> _Lanes:
    """Advance every channel until none has an undecided block left.  Each
    ``step`` leaves a finished channel's carry as it is, so the host tests
    for the end only once every :data:`SYNC_EVERY` steps."""
    global iterations, syncs
    while True:
        syncs += 1
        if not bool((lanes.k < n).any()):
            return lanes
        for _ in range(SYNC_EVERY):
            lanes = step(lanes)
        iterations += SYNC_EVERY


def _episode_setup(scfg: StreamConfig, state: StreamState, on: torch.Tensor, pm: torch.Tensor):
    """What both episode solvers precompute over a chunk: the rolling base
    thresholds and the extended series (K3's prologue, so the thresholds
    equal the scan's bit for bit), block indices, absolute block times
    (``i·block_sec`` in float32, as the scan), the closed-form INIT prefix
    and the loop's initial carry."""
    C, n = on.shape
    dev = on.device
    base_thr, ext = stream_kernel.ring_base_thresholds(
        state.ring, state.block_idx, on, scfg.avg_win, scfg.k_std)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    iabs = state.block_idx[:, None] + idx
    t_vec = iabs.to(torch.float32) * _const(scfg.block_sec, dev)
    prefix = _init_prefix(scfg, state, pm, t_vec, idx)
    lanes = _Lanes(
        prefix[0], prefix[1], state.locked_threshold, state.locked_until_block,
        state.track_start_sec, state.track_start_block, state.tr_count, state.tr_sum,
        state.tr_sumsq, state.tr_min, state.tr_max,
        torch.zeros(C, dtype=torch.int32, device=dev), torch.zeros(C, dtype=torch.bool, device=dev),
    )
    return base_thr, ext, idx, iabs, t_vec, prefix, lanes


def _init_prefix(scfg: StreamConfig, state: StreamState, psd_db_mean, t_vec, idx):
    """Closed-form INIT prefix shared by the episode-jump solvers
    (processor.py:444-457): accumulate the PSD mean until
    ``block_start_sec >= init_wait_sec``, then hand off to Detection.
    Per channel; returns (k0, s0, isum, icnt, pinit, init_sel)."""
    n = t_vec.shape[1]
    is_init = state.state == INIT
    t_ge = t_vec >= _const(scfg.init_wait_sec, t_vec.device)
    k_switch = _first(t_ge, idx, n)
    any_switch = k_switch < n
    init_hi = torch.where(any_switch, k_switch, n - 1)  # inclusive
    init_sel = is_init[:, None] & (idx <= init_hi[:, None])
    icnt = state.init_count + init_sel.sum(-1, dtype=torch.int32)
    isum = state.init_sum + torch.where(init_sel, psd_db_mean, 0.0).sum(-1)
    pinit = torch.where(is_init & any_switch, isum / torch.clamp(icnt, min=1).to(isum.dtype),
                        state.psd_db_mean_from_init)
    k0 = torch.where(is_init, torch.where(any_switch, k_switch + 1, n), 0)
    s0 = torch.where(is_init, torch.where(any_switch, DETECT, INIT).to(torch.int32), state.state)
    return k0, s0, isum, icnt, pinit, init_sel


def _track_close(scfg, lanes: _Lanes, span: torch.Tensor, vals: torch.Tensor, t_leave, leave_blk,
                 ends: torch.Tensor, events: torch.Tensor):
    """A tracking step's statistics over ``span`` (a mask over ``vals``,
    both (C, m)) added to the running ones, and the event filed where the
    track ends (``ends``) and is accepted.  Returns (trc, trs, trss, trmn,
    trmx, emit)."""
    trc = lanes.trc + span.sum(-1, dtype=torch.int32)
    trs = lanes.trs + torch.where(span, vals, 0.0).sum(-1)
    trss = lanes.trss + torch.where(span, vals * vals, 0.0).sum(-1)
    trmn = torch.minimum(lanes.trmn, torch.where(span, vals, math.inf).amin(-1))
    trmx = torch.maximum(lanes.trmx, torch.where(span, vals, -math.inf).amax(-1))
    h_cnt = torch.clamp(trc, min=1).to(trs.dtype)
    h_mean = trs / h_cnt
    h_std = torch.sqrt(torch.clamp(trss / h_cnt - h_mean * h_mean, min=0.0))
    min_mean = _const(scfg.min_mean_db, trs.device)
    emit = ends & (h_mean >= min_mean) & (
        leave_blk - lanes.tsblk >= min_duration_blocks(scfg.min_dur_sec, scfg.block_sec))
    _file(events, torch.where(emit & (lanes.e_cnt < scfg.cap), lanes.e_cnt, scfg.cap),
          torch.stack([lanes.tstart, t_leave, t_leave - lanes.tstart, trmn, trmx, h_mean, h_std]))
    return trc, trs, trss, trmn, trmx, emit


def _episode_result(scfg, state, ext, n, prefix, lanes: _Lanes, events, thr):
    """The solvers' (new_state, events, thresholds) from the loop's carry."""
    isum, icnt, pinit = prefix[2:5]
    i_end = state.block_idx + n
    new_state = StreamState(
        state=lanes.s, block_idx=i_end,
        ring=stream_kernel.final_ring(ext, state.block_idx, i_end, scfg.avg_win).to(state.ring.dtype),
        locked_threshold=lanes.L, locked_until_block=lanes.luntil,
        track_start_sec=lanes.tstart, track_start_block=lanes.tsblk,
        tr_count=lanes.trc, tr_sum=lanes.trs, tr_sumsq=lanes.trss, tr_min=lanes.trmn,
        tr_max=lanes.trmx, init_sum=isum, init_count=icnt, psd_db_mean_from_init=pinit,
    )
    ev = StreamEvents(*events[:, :, : scfg.cap].unbind(0), count=lanes.e_cnt, overflow=lanes.e_ovf)
    return new_state, ev, thr


def _jump(scfg: StreamConfig, state: StreamState, on: torch.Tensor, pm: torch.Tensor):
    C, n = on.shape
    lock_tail = lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec)
    base_thr, ext, idx, iabs, t_vec, prefix, lanes = _episode_setup(scfg, state, on, pm)
    thr_out = torch.where(prefix[5], base_thr, 0.0)
    events = torch.zeros((7, C, scfg.cap + 1), dtype=on.dtype, device=on.device)

    def step(c: _Lanes) -> _Lanes:
        nonlocal thr_out
        active = c.k < n
        is_det = c.s == DETECT
        from_k = idx >= c.k[:, None]
        # Detection: the first block from k above its threshold, which is
        # the locked value inside the lock window
        thr_vec = torch.where(iabs <= c.luntil[:, None], c.L[:, None], base_thr)
        i_star = _first(from_k & (on > thr_vec), idx, n)
        d_has = i_star < n
        d_sel = from_k & (idx <= torch.where(d_has, i_star, n - 1)[:, None])
        det = c._replace(
            k=torch.where(d_has, i_star + 1, n),
            s=torch.where(d_has, TRACK, DETECT).to(torch.int32),
            L=torch.where(d_has, _at(thr_vec, i_star), c.L),
            tstart=torch.where(d_has, _at(t_vec, i_star), c.tstart),
            tsblk=torch.where(d_has, _at(iabs, i_star), c.tsblk),
            trc=torch.where(d_has, 0, c.trc),
            trs=torch.where(d_has, 0.0, c.trs),
            trss=torch.where(d_has, 0.0, c.trss),
            trmn=torch.where(d_has, math.inf, c.trmn),
            trmx=torch.where(d_has, -math.inf, c.trmx),
        )
        # Tracking: the first block from k below the locked value ends the
        # track; the span up to it, that block included, feeds the statistics
        j = _first(from_k & (on < c.L[:, None]), idx, n)
        t_has = j < n
        t_sel = from_k & (idx <= torch.where(t_has, j, n - 1)[:, None])
        trc, trs, trss, trmn, trmx, emit = _track_close(
            scfg, c, t_sel, on, _at(t_vec, j), _at(iabs, j), active & ~is_det & t_has, events)
        trk = c._replace(
            k=torch.where(t_has, j + 1, n),
            s=torch.where(t_has, DETECT, TRACK).to(torch.int32),
            luntil=torch.where(t_has, _at(iabs, j) + (lock_tail - 1), c.luntil),
            trc=trc, trs=trs, trss=trss, trmn=trmn, trmx=trmx,
            e_cnt=c.e_cnt + emit.to(torch.int32),
            e_ovf=c.e_ovf | (emit & (c.e_cnt >= scfg.cap)),
        )
        thr_out = torch.where((active & is_det)[:, None] & d_sel, thr_vec,
                              torch.where((active & ~is_det)[:, None] & t_sel, c.L[:, None], thr_out))
        return _pick(active & is_det, det, _pick(active & ~is_det, trk, c))

    lanes = _lockstep(step, lanes, n)
    return _episode_result(scfg, state, ext, n, prefix, lanes, events, thr_out)


def stream_scan_jump(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: torch.Tensor,  # (n_blocks,) or (C, n_blocks)
    psd_db_mean: torch.Tensor,  # like over_noise
) -> Tuple[StreamState, StreamEvents, torch.Tensor]:
    """Episode-jump formulation of :func:`stream_scan`: O(episodes) steps
    instead of O(blocks), in plain PyTorch on the series' device.

    The machine's transitions depend only on comparisons of ``over_noise``
    against the precomputable base thresholds and against locked values,
    which are copies of base thresholds chained through lock windows; the
    tracking statistics never feed back into a transition.  So the loop
    jumps from decision to decision: in Detection the next threshold
    crossing is one masked first-index over the chunk, in Tracking the next
    block below the locked value is another, and the tracked span's dB
    statistics are masked reductions over it.

    Channels run in lockstep (the reference ``vmap``s this function): each
    step computes both phases for every channel and keeps each channel's
    own, and a channel whose chunk is decided keeps its carry.  Every step
    costs O(C · n); the host tests for the end once every
    :data:`SYNC_EVERY` steps.  :data:`iterations` and :data:`syncs` count
    both.

    Contract against :func:`stream_scan` on the same inputs: thresholds,
    event count, overflow, ``time_start`` / ``time_stop``, the ring and the
    integer, lock and entry leaves of the state bit for bit; the events' dB
    statistics and durations and the accumulated state sums to float32
    summation order (masked sums against sequential adds).  An event whose
    dB mean sits exactly at ``detection_db_over_noise_mean_min`` could flip
    its acceptance, which is why this stays opt-in (``impl="jump"``).
    Reference semantics anchor: `processor.py:444-510`.
    """
    return _per_channel(functools.partial(_jump, scfg), state, over_noise, psd_db_mean)


def _hop(scfg: StreamConfig, state: StreamState, on: torch.Tensor, pm: torch.Tensor,
         track_hop: int):
    C, n = on.shape
    dev = on.device
    cap, ep_cap = scfg.cap, 4 * scfg.cap + 8
    lock_tail = lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec)
    w_lock = max(lock_tail, 1)
    W = max(w_lock, track_hop)
    big = 2**30
    base_thr, ext, idx, _, t_vec, prefix, lanes = _episode_setup(scfg, state, on, pm)
    i0 = state.block_idx

    # the first base-threshold crossing at or after each block (a NaN base
    # threshold compares False), and one past the end for n
    crossing = torch.where(on > base_thr, idx, n)
    nxt = torch.cummin(crossing.flip(-1), -1).values.flip(-1)
    nxt_ext = torch.cat([nxt, torch.full((C, 1), n, dtype=torch.int32, device=dev)], 1)
    on_pad = torch.cat([on, torch.zeros((C, W), dtype=on.dtype, device=dev)], 1)
    lane = torch.arange(W, dtype=torch.int32, device=dev)
    lock_lane = lane < w_lock
    track_lane = lane < track_hop

    # event rows (time_start, time_stop, duration, db_min, db_max, db_mean,
    # db_std); lock-episode rows (entry block, last block of the lock, both
    # chunk-relative) and locked values.  Episode slot 0 carries the
    # incoming lock window; the last slot of each takes dropped writes.
    events = torch.zeros((7, C, cap + 1), dtype=on.dtype, device=dev)
    ep = torch.stack([torch.full((C, ep_cap + 1), big, dtype=torch.int32, device=dev),
                      torch.full((C, ep_cap + 1), -big, dtype=torch.int32, device=dev)])
    ep[0, :, 0] = -big
    ep[1, :, 0] = state.locked_until_block - i0
    ep_lv = torch.zeros((1, C, ep_cap + 1), dtype=on.dtype, device=dev)
    ep_lv[0, :, 0] = state.locked_threshold
    ep_cnt = torch.ones(C, dtype=torch.int32, device=dev)
    ep_ovf = torch.zeros(C, dtype=torch.bool, device=dev)

    def record(rec, entry, last, value):
        nonlocal ep_cnt, ep_ovf
        slot = torch.where(rec & (ep_cnt < ep_cap), ep_cnt, ep_cap)
        _file(ep, slot, torch.stack([entry, last]))
        _file(ep_lv, slot, value[None])
        ep_ovf = ep_ovf | (rec & (ep_cnt >= ep_cap))
        ep_cnt = ep_cnt + rec.to(torch.int32)

    def step(c: _Lanes) -> _Lanes:
        active = c.k < n
        is_det = c.s == DETECT
        widx = c.k[:, None] + lane
        wv = on_pad.gather(1, widx.to(torch.int64))
        valid = widx < n
        # Detection: a crossing of the locked value inside the (bounded)
        # lock window, else the precomputed next base crossing after it
        rel_until = c.luntil - i0
        lock_first = _first(lock_lane & (widx <= rel_until[:, None]) & valid & (wv > c.L[:, None]),
                            lane, W)
        lock_has = lock_first < W
        j_base = _at(nxt_ext, torch.maximum(c.k, rel_until + 1))
        i_star = torch.where(lock_has, c.k + lock_first, j_base)
        d_has = i_star < n
        enter = is_det & d_has
        # Tracking: the first block below the locked value within the hop
        # window ends the track; else the whole window is tracked
        t_first = _first(track_lane & valid & (wv < c.L[:, None]), lane, W)
        t_has = t_first < W
        j = c.k + torch.where(t_has, t_first, 0)
        span = track_lane & valid & (widx <= torch.where(t_has, j, c.k + (track_hop - 1))[:, None])
        rec = active & ~is_det & t_has
        trc, trs, trss, trmn, trmx, emit = _track_close(
            scfg, c, span, wv, _at(t_vec, j), i0 + j, rec, events)
        record(rec, c.tsblk - i0, j + max(lock_tail - 1, 0), c.L)
        new = _Lanes(
            k=torch.where(is_det, torch.where(d_has, i_star + 1, n),
                          torch.where(t_has, j + 1, torch.clamp(c.k + track_hop, max=n))),
            s=torch.where(is_det, torch.where(d_has, TRACK, DETECT),
                          torch.where(t_has, DETECT, TRACK)).to(torch.int32),
            L=torch.where(enter, torch.where(lock_has, c.L, _at(base_thr, i_star)), c.L),
            luntil=torch.where(~is_det & t_has, (i0 + j) + (lock_tail - 1), c.luntil),
            tstart=torch.where(enter, _at(t_vec, i_star), c.tstart),
            tsblk=torch.where(enter, i0 + i_star, c.tsblk),
            trc=torch.where(enter, 0, torch.where(is_det, c.trc, trc)),
            trs=torch.where(enter, 0.0, torch.where(is_det, c.trs, trs)),
            trss=torch.where(enter, 0.0, torch.where(is_det, c.trss, trss)),
            trmn=torch.where(enter, math.inf, torch.where(is_det, c.trmn, trmn)),
            trmx=torch.where(enter, -math.inf, torch.where(is_det, c.trmx, trmx)),
            e_cnt=c.e_cnt + emit.to(torch.int32),
            e_ovf=c.e_ovf | (emit & (c.e_cnt >= cap)),
        )
        return _pick(active, new, c)

    lanes = _lockstep(step, lanes, n)
    # a chunk that ends mid-track keeps its locked value live to the end
    end_track = lanes.s == TRACK
    record(end_track, lanes.tsblk - i0, torch.full_like(i0, n - 1), lanes.L)

    # the threshold series: per block, the most recent lock episode whose
    # window covers it, else the base threshold.  eidx[i] = (# episode
    # entries < i) − 1, one scatter-add and one int32 prefix sum (entries
    # clip to [0, n]: slot 0's −big counts for every block, an unused
    # slot's big for none)
    ep_en, ep_te, ep_val = ep[0, :, :ep_cap], ep[1, :, :ep_cap], ep_lv[0, :, :ep_cap]
    hist = torch.zeros((C, n + 1), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, torch.clamp(ep_en + 1, 0, n).to(torch.int64),
                      torch.ones_like(ep_en))
    eidx = torch.clamp(torch.cumsum(hist, 1, dtype=torch.int32)[:, :n] - 1, min=0).to(torch.int64)
    covered = idx <= ep_te.gather(1, eidx)
    thr_out = torch.where(covered, ep_val.gather(1, eidx), base_thr)
    return (*_episode_result(scfg, state, ext, n, prefix, lanes, events, thr_out),
            {"thr_degraded": ep_ovf})


def stream_scan_jump_batch(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: torch.Tensor,  # (n_blocks,) or (C, n_blocks)
    psd_db_mean: torch.Tensor,  # like over_noise
    track_hop: int = 128,
    with_diag: bool = False,
):
    """Episode-jump solver built for wide batches: each step is O(window)
    per channel instead of :func:`stream_scan_jump`'s O(n_blocks), in plain
    PyTorch on the series' device.

    * **Detection, unlocked** — the next crossing of the *base* threshold
      does not depend on where the search starts, so the first crossing at
      or after every block is precomputed once (a reverse ``cummin``) and
      the search is one gather.
    * **Detection, inside a lock window** — the window is at most
      ``lock_tail`` blocks, so the crossing of the locked value is one
      fixed-width window and a masked first-index.
    * **Tracking** — ``track_hop`` blocks at a time: one window finds the
      first block below the locked value and adds the span's statistics.
    * **Thresholds** — rebuilt after the loop from the recorded lock
      episodes (entry block, end of the lock window, locked value): per
      block the most recent episode covering it, else the base threshold.

    Channels run in lockstep (the reference ``vmap``s this function), as in
    :func:`stream_scan_jump`.  Contract against :func:`stream_scan`: as
    :func:`stream_scan_jump`, the dB statistics to float32 summation order
    of per-hop sums.  The threshold rebuild keeps ``4·cap + 8`` lock
    episodes per chunk; beyond that the returned thresholds (never the
    events) may take base thresholds inside dropped lock windows.
    ``with_diag=True`` returns a fourth value ``{"thr_degraded": bool per
    channel}``, true iff an episode record was dropped.
    Reference semantics anchor: `processor.py:444-510`.
    """
    out = _per_channel(functools.partial(_hop, scfg, track_hop=track_hop), state, over_noise,
                       psd_db_mean)
    return out if with_diag else out[:3]


def resolve_stream_auto(
    front: str, impl: str, n_channels: int = 1, device: DeviceLike = "cuda"
) -> Tuple[str, str]:
    """Resolve ``front``/``impl`` ``"auto"`` for the device the chunk lies
    on: on a CUDA device the bins front and the fused kernel K3, on the CPU
    the welch front and the scan (the formulation the oracles pin).
    ``n_channels`` (the batch width) is accepted and ignored, as in the
    reference.

    Callers that need the PSD waterfall must pass ``front="welch"``
    explicitly — the bins front computes only the three band levels.
    """
    on_gpu = torch.device(device).type == "cuda"
    if front == "auto":
        front = "bins" if on_gpu else "welch"
    if impl == "auto":
        impl = "fused" if on_gpu else "scan"
    return front, impl


def stream_process(
    cfg: DetectionConfig,
    state: StreamState,
    samples: torch.Tensor,
    fs: float,
    front: str = "auto",
    impl: str = "auto",
) -> Tuple[StreamState, StreamEvents, dict]:
    """Process a chunk of audio (any whole number of blocks) on the device
    the samples and state lie on.

    Vectorized front half (:func:`stream_front` or
    :func:`stream_front_headless`), then the sequential state machine
    (:func:`stream_scan`, :func:`stream_scan_jump`,
    :func:`stream_scan_jump_batch` or :func:`stream_scan_fused`).  Returns
    (new_state, events_found_in_chunk, diagnostics) where diagnostics
    carries the per-block series (over_noise, threshold, band dBs, and the
    psd waterfall with the welch front).

    ``front``/``impl`` default to ``"auto"`` (:func:`resolve_stream_auto`).
    ``impl="jump"`` / ``"hop"`` select the episode-jump solvers
    (:func:`stream_scan_jump`, :func:`stream_scan_jump_batch`): thresholds
    and event boundaries bit-exact against the scan, dB statistics to
    float32 summation order; ``"hop"`` adds ``diags["thr_degraded"]``.
    """
    front, impl = resolve_stream_auto(front, impl, device=samples.device)
    if front not in ("welch", "bins"):
        raise ValueError(f"unknown front {front!r} (use 'welch' or 'bins')")
    if impl not in ("scan", "jump", "hop", "fused"):
        raise ValueError(f"unknown impl {impl!r} (use 'scan', 'jump', 'hop' or 'fused')")
    scfg = StreamConfig.from_config(cfg)
    block = int(round(cfg.proc_block_sec * fs))
    n_blocks = samples.shape[-1] // block
    if n_blocks == 0:
        # the same key schema as a non-empty chunk of this front and
        # solver, with length-0 per-block series
        z = torch.zeros(0, dtype=torch.float32, device=samples.device)
        diags = {"over_noise": z, "threshold": z, "ms_db": z, "noise1_db": z, "noise2_db": z}
        if front == "welch":
            freqs = welch_freqs(fs, cfg.n_fft)
            diags["psd_db"] = torch.zeros((0, len(freqs)), dtype=torch.float32, device=samples.device)
            diags["freqs"] = freqs
        if impl == "hop":
            diags["thr_degraded"] = torch.zeros((), dtype=torch.bool, device=samples.device)
        return state, _empty_events(scfg.cap, torch.float32, samples.device), diags

    if front == "bins":
        over_noise, psd_db_mean, front_diags = stream_front_headless(cfg, samples, fs)
    else:
        over_noise, psd_db_mean, front_diags = stream_front(cfg, samples, fs)
    extra = {}
    if impl == "hop":
        state, events, thresholds, extra = stream_scan_jump_batch(
            scfg, state, over_noise, psd_db_mean, with_diag=True)
    else:
        solve = {"scan": stream_scan, "jump": stream_scan_jump, "fused": stream_scan_fused}[impl]
        state, events, thresholds = solve(scfg, state, over_noise, psd_db_mean)
    diags = {"over_noise": over_noise, "threshold": thresholds, **extra, **front_diags}
    return state, events, diags
