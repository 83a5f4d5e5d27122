"""Fused streaming solve: the CUDA kernel K3 and its plain twin.

Counterpart of `meteor_scatter_tpu/ops/pallas/stream_kernel.py`
(``stream_machine_fused``) and of the ops around it in the JAX package's
fused solver.  One call runs the whole block-rate solve of one chunk of n
blocks for C channels:

1. the rolling-window base threshold (mean + k·std of the last ``w``
   over-noise values, current block excluded; :func:`ring_base_thresholds`);
2. the reference's sequential 3-state live detector
   (`dsp/src/live/backend/processor.py:444-510`; :func:`stream_machine_plain`);
3. the compaction of accepted tracks into fixed-capacity event buffers
   (:func:`compact_emits`);
4. the carry out: every state leaf and the new ring (:func:`final_ring`).

Layout (the kernel's): series ``on`` / ``pm`` are (C, n) float32,
channel-major; ``state`` is the 15 leaves of
:class:`meteor_scatter_tpu_torch.models.streaming.StreamState` in field
order, each (C,) and the ring (C, w).  Returns ``(state', events,
thresholds)``: ``state'`` in the same order, ``events`` the seven
DetectedMeteor fields (C, cap) then ``count`` (C,) int32 (not clamped) and
``overflow`` (C,) bool, ``thresholds`` (C, n).

Dispatch is by the device of the series (:func:`stream_solve`):

* CUDA tensor → the hand-written kernel ``csrc/stream_machine.cu``, one
  launch for all channels, built at first use.  Whatever the kernel does
  not take raises; there is no fallback to the twin.
* CPU tensor → :func:`stream_solve_plain`, the four steps above in plain
  PyTorch.  It is also the solve of
  :func:`meteor_scatter_tpu_torch.models.streaming.stream_scan` on any
  device, and ``chip_smoke.py`` holds the kernel against it on the card.

The kernel is bit-exact against the twin on every output: both round each
float op once, in the same order (the window sums left to right over ring
slots 0 … w−1), and compare against the same float32 constants.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from meteor_scatter_tpu_torch.ops.kernels import _build

INIT, DETECT, TRACK = 0, 1, 2

# dtype of each state leaf, in StreamState field order (the ring is index 2)
STATE_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32, torch.int32,
                torch.float32, torch.int32, torch.int32, torch.float32, torch.float32,
                torch.float32, torch.float32, torch.float32, torch.int32, torch.float32)
TILE = 8192  # blocks of one channel's row staged in shared memory at a time

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it

Result = Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], torch.Tensor]


def ring_base_thresholds(ring, i0, on, w: int, k_std: float):
    """Per-block rolling threshold of every channel: ``ring`` (C, w), ``i0``
    (C,) absolute index of the first block, ``on`` (C, n).  Returns
    (base_thr (C, n), ext (C, w + n)).

    ``ext`` is the incoming ring in absolute block order followed by the
    chunk, so index 0 is absolute block ``i0 - w``.  Ring slot j of row r
    (block i = i0 + r) holds the value at block ``i - w + ((j - i) mod w)``,
    i.e. ``ext[r + ((j - i0 - r) mod w)]``; slots j ≥ min(i, w) are not yet
    written and add 0.  The window sums run left to right over the slots
    j = 0 … w−1, one (C, n) gather and one add each, so every add is
    rounded once in the order the kernel takes.
    """
    C, n = on.shape
    dev, dt = on.device, ring.dtype
    j = torch.arange(w, device=dev)
    i0 = i0.to(torch.int64)
    prev = ring.gather(1, torch.remainder(i0[:, None] - w + j, w))
    ext = torch.cat([prev, on.to(dt)], dim=1)

    r = torch.arange(n, device=dev)[None, :]
    cnt = torch.clamp(i0[:, None] + r, max=w)
    zero = torch.zeros((), dtype=dt, device=dev)
    s = torch.zeros((C, n), dtype=dt, device=dev)
    s2 = torch.zeros((C, n), dtype=dt, device=dev)
    for jj in range(w):
        v = ext.gather(1, r + torch.remainder(jj - i0[:, None] - r, w))
        valid = jj < cnt
        s = s + torch.where(valid, v, zero)
        s2 = s2 + torch.where(valid, v * v, zero)
    cnt_f = torch.clamp(cnt, min=1).to(dt)
    m = s / cnt_f
    m2 = s2 / cnt_f
    std = torch.sqrt(torch.maximum(m2 - m * m, zero))
    k = torch.full((), k_std, dtype=dt, device=dev)  # a fill, not a copy that waits for the device
    return torch.where(cnt > 0, m + k * std, torch.full_like(m, math.nan)), ext


def final_ring(ext: torch.Tensor, i0: torch.Tensor, i_end: torch.Tensor, w: int) -> torch.Tensor:
    """The carry ring after a chunk, per channel: slot s holds the value at
    the largest written block k with k ≡ s (mod w) — one gather over the
    extended series ``ext`` (C, w + n), whose index 0 is absolute block
    ``i0 - w``."""
    s = torch.arange(w, device=ext.device)
    i0, i_end = i0.to(torch.int64)[:, None], i_end.to(torch.int64)[:, None]
    k_last = i_end - w + torch.remainder(s - i_end, w)
    return ext.gather(1, k_last - (i0 - w))


def compact_emits(cap: int, outs) -> Tuple[torch.Tensor, ...]:
    """Turn the per-step outputs (each (C, n)) into fixed-cap event buffers
    (C, cap): the m-th emitting block of a channel lands in slot m.  Slots
    come from a running count of emits and one indexed write; emits past
    ``cap`` are dropped, counted, and flag ``overflow``.  Returns the seven
    fields, ``count`` and ``overflow``."""
    (emit, e_start, e_stop, e_dur, e_min, e_max, e_mean, e_std) = outs
    em = emit != 0
    C = em.shape[0]
    c = torch.cumsum(em.to(torch.int32), dim=1, dtype=torch.int32)
    num = em.sum(dim=1, dtype=torch.int32)
    slot = torch.where(em & (c <= cap), c - 1, cap).to(torch.int64)  # slot cap: dropped
    vals = torch.stack([e_start, e_stop, e_dur, e_min, e_max, e_mean, e_std])
    buf = torch.zeros((7, C, cap + 1), dtype=vals.dtype, device=vals.device)
    buf.scatter_(2, slot.expand(7, -1, -1), vals)
    return (*buf[:, :, :cap].unbind(0), num, num > cap)


def stream_machine_plain(
    on2: torch.Tensor,
    pm2: torch.Tensor,
    bt2: torch.Tensor,
    carry_f: torch.Tensor,
    carry_i: torch.Tensor,
    *,
    block_sec: float,
    init_wait_sec: float,
    min_mean_db: float,
    min_dur_b: int,
    lock_tail: int,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """The block machine: a loop over the n blocks, each step one vector op
    per line on the (C,) channel rows, as the reference's scan body
    (`meteor_scatter_tpu/models/streaming.py:1123-1187`), with the layout
    of the JAX package's ``stream_machine_fused``.

    Series are (n, C) float32, time-major; the carry is ``carry_f`` (8, C)
    float32 rows [locked, tstart, trs, trss, trmn, trmx, isum, pinit] and
    ``carry_i`` (6, C) int32 rows [state, luntil, tsblk, trc, icnt, i0].
    Returns ``(ys, carry_f', carry_i')`` with ys = (thr, emit, tstart,
    t_stop, dur, trmn, trmx, h_mean, h_std), each (n, C); ``emit`` is int32
    and ``carry_i'[5]`` is ``i0 + n``."""
    n, C = on2.shape
    dev = on2.device
    f32, i32 = torch.float32, torch.int32

    def cf(v):
        return torch.tensor(v, dtype=f32, device=dev)

    def ci(v):
        return torch.tensor(v, dtype=i32, device=dev)

    # float constants rounded to float32 once, as the kernel takes them
    bs, init_wait, min_mean = cf(block_sec), cf(init_wait_sec), cf(min_mean_db)
    zero, inf = cf(0.0), cf(float("inf"))
    s_init, s_detect, s_track, i_zero = ci(INIT), ci(DETECT), ci(TRACK), ci(0)

    locked, tstart, trs, trss, trmn, trmx, isum, pinit = carry_f.unbind(0)
    st, luntil, tsblk, trc, icnt, i = carry_i.unbind(0)
    outs = tuple([] for _ in range(9))
    for t in range(n):
        on, pm, bt = on2[t], pm2[t], bt2[t]
        t_start = i.to(f32) * bs

        thr = torch.where(
            st == TRACK, locked, torch.where((st == DETECT) & (i <= luntil), locked, bt)
        )

        new_isum = isum + pm
        new_icnt = icnt + 1
        init_done = t_start >= init_wait
        pinit_new = new_isum / torch.clamp(new_icnt, min=1).to(f32)

        enter_track = on > thr
        n_trc = trc + 1
        n_trs = trs + on
        n_trss = trss + on * on
        n_trmn = torch.minimum(trmn, on)
        n_trmx = torch.maximum(trmx, on)
        leave_track = on < thr

        dur = t_start - tstart
        h_cnt = torch.clamp(n_trc, min=1).to(f32)
        h_mean = n_trs / h_cnt
        h_std = torch.sqrt(torch.maximum(n_trss / h_cnt - h_mean * h_mean, zero))
        accept = (h_mean >= min_mean) & (i - tsblk >= min_dur_b)

        is_init = st == INIT
        is_detect = st == DETECT
        is_track = st == TRACK
        emit = is_track & leave_track & accept

        next_state = torch.where(
            is_init,
            torch.where(init_done, s_detect, s_init),
            torch.where(
                is_detect,
                torch.where(enter_track, s_track, s_detect),
                torch.where(leave_track, s_detect, s_track),
            ),
        )
        start_track = is_detect & enter_track

        for acc, v in zip(outs, (thr, emit.to(i32), tstart, t_start, dur,
                                 n_trmn, n_trmx, h_mean, h_std)):
            acc.append(v)

        locked = torch.where(start_track, thr, locked)
        luntil = torch.where(is_track & leave_track, i + (lock_tail - 1), luntil)
        tstart = torch.where(start_track, t_start, tstart)
        tsblk = torch.where(start_track, i, tsblk)
        trc = torch.where(start_track, i_zero, torch.where(is_track, n_trc, trc))
        trs = torch.where(start_track, zero, torch.where(is_track, n_trs, trs))
        trss = torch.where(start_track, zero, torch.where(is_track, n_trss, trss))
        trmn = torch.where(start_track, inf, torch.where(is_track, n_trmn, trmn))
        trmx = torch.where(start_track, -inf, torch.where(is_track, n_trmx, trmx))
        isum = torch.where(is_init, new_isum, isum)
        icnt = torch.where(is_init, new_icnt, icnt)
        pinit = torch.where(is_init & init_done, pinit_new, pinit)
        st = next_state
        i = i + 1

    ys = tuple(
        torch.stack(acc) if acc else torch.empty((0, C), dtype=dt, device=dev)
        for acc, dt in zip(outs, (f32, i32) + (f32,) * 7)
    )
    carry_f1 = torch.stack([locked, tstart, trs, trss, trmn, trmx, isum, pinit])
    carry_i1 = torch.stack([st, luntil, tsblk, trc, icnt, i])
    return ys, carry_f1, carry_i1


def stream_solve_plain(
    on: torch.Tensor,
    pm: torch.Tensor,
    state: Sequence[torch.Tensor],
    *,
    k_std: float,
    block_sec: float,
    init_wait_sec: float,
    min_mean_db: float,
    min_dur_b: int,
    lock_tail: int,
    cap: int,
) -> Result:
    """Plain PyTorch twin of the kernel (layout in the module docstring):
    base-threshold prologue, block machine, compaction, final ring."""
    (st, i0, ring, locked, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
     isum, icnt, pinit) = state
    n = on.shape[1]
    w = ring.shape[1]
    base_thr, ext = ring_base_thresholds(ring, i0, on, w, k_std)
    carry_f = torch.stack([locked, tstart, trs, trss, trmn, trmx, isum, pinit]).to(torch.float32)
    carry_i = torch.stack([st, luntil, tsblk, trc, icnt, i0]).to(torch.int32)

    def time_major(a):
        return a.t().to(torch.float32).contiguous()

    ys, cf, ci = stream_machine_plain(
        time_major(on), time_major(pm), time_major(base_thr), carry_f, carry_i,
        block_sec=block_sec, init_wait_sec=init_wait_sec, min_mean_db=min_mean_db,
        min_dur_b=min_dur_b, lock_tail=lock_tail,
    )
    events = compact_emits(cap, tuple(y.t() for y in ys[1:]))
    i_end = i0 + n
    new_state = (ci[0], i_end, final_ring(ext, i0, i_end, w).to(ring.dtype), cf[0], ci[1],
                 cf[1], ci[2], ci[3], cf[2], cf[3], cf[4], cf[5], cf[6], ci[4], cf[7])
    return new_state, events, ys[0].t().contiguous()


def _launch(
    on: torch.Tensor,
    pm: torch.Tensor,
    state: Sequence[torch.Tensor],
    *,
    k_std: float,
    block_sec: float,
    init_wait_sec: float,
    min_mean_db: float,
    min_dur_b: int,
    lock_tail: int,
    cap: int,
    tile: int = TILE,
) -> Result:
    """One launch of ``csrc/stream_machine.cu`` on the current stream.
    ``tile`` (a multiple of 32) is the most blocks staged in shared memory
    at once; results do not depend on it.  A window too wide for shared
    memory fails the launch, which raises."""
    global launches
    if not on.is_cuda:
        raise ValueError(f"stream solve kernel takes CUDA tensors, got one on {on.device}")
    if on.dim() != 2 or on.shape[0] < 1:
        raise ValueError(f"series must be (C, n) with C >= 1, got shape {tuple(on.shape)}")
    C, n = on.shape
    if n * C >= 2**31:
        raise ValueError(f"{C} x {n} series too large for int32 block indices")
    if len(state) != len(STATE_DTYPES):
        raise ValueError(f"state must have {len(STATE_DTYPES)} leaves, got {len(state)}")
    ring = state[2]
    w = ring.shape[-1] if ring.dim() == 2 else 0
    if w < 1 or cap < 0 or tile < 32 or tile % 32:
        raise ValueError(
            f"need w >= 1, cap >= 0 and tile a multiple of 32 (w={w}, cap={cap}, tile={tile})")
    dev = on.device
    named = [("over_noise", on, torch.float32, (C, n)), ("psd_db_mean", pm, torch.float32, (C, n))]
    named += [(f"state[{k}]", a, dt, (C, w) if k == 2 else (C,))
              for k, (a, dt) in enumerate(zip(state, STATE_DTYPES))]
    for name, a, dt, shape in named:
        if a.dtype != dt or tuple(a.shape) != shape or a.device != dev or not a.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dt} tensor of shape {shape} on {dev}, got "
                f"{a.dtype} {tuple(a.shape)} on {a.device} (contiguous={a.is_contiguous()})"
            )

    # outputs, carved from three allocations: floats, ints, overflow flags
    fbuf = torch.empty(C * (n + 7 * cap + w + 8), dtype=torch.float32, device=dev)
    ibuf = torch.empty(7 * C, dtype=torch.int32, device=dev)
    overflow = torch.empty(C, dtype=torch.bool, device=dev)
    a, b = C * n, C * (n + 7 * cap)
    thr = fbuf[:a].view(C, n)
    fields = fbuf[a:b].view(7, C, cap).unbind(0)
    ring1 = fbuf[b : b + C * w].view(C, w)
    locked, tstart, trs, trss, trmn, trmx, isum, pinit = fbuf[b + C * w :].view(8, C).unbind(0)
    st, i_end, luntil, tsblk, trc, icnt, count = ibuf.view(7, C).unbind(0)
    new_state = (st, i_end, ring1, locked, luntil, tstart, tsblk, trc, trs, trss, trmn, trmx,
                 isum, icnt, pinit)

    tensors = (on, pm, *state, thr, *fields, count, overflow, *new_state)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    fn = _bind(_build.load("stream_machine"))
    with torch.cuda.device(dev):
        err = fn(
            ptrs, n, C, w, int(cap), tile, float(k_std), float(block_sec),
            float(init_wait_sec), float(min_mean_db), int(min_dur_b), int(lock_tail),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stream solve kernel launch failed: CUDA error {err}")
    launches += 1
    return new_state, (*fields, count, overflow), thr


def _bind(lib: ctypes.CDLL):
    fn = lib.ms_stream_solve
    if fn.argtypes is None:
        i, f = ctypes.c_int, ctypes.c_float
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), i, i, i, i, i, f, f, f, f, i, i,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stream_solve(on: torch.Tensor, pm: torch.Tensor, state: Sequence[torch.Tensor], **kw) -> Result:
    """Run the solve on the series' device: the kernel on CUDA, the twin on
    the CPU (layout and keywords as :func:`stream_solve_plain`)."""
    dev = on.device
    if dev.type == "cpu":
        return stream_solve_plain(on, pm, state, **kw)
    if dev.type == "cuda":
        return _launch(on, pm, state, **kw)
    raise ValueError(f"stream solve: tensors on {dev} are not supported (cpu or cuda)")
