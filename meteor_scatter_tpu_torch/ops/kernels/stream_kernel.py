"""Fused streaming state machine: the CUDA kernel K3 and its plain twin.

Counterpart of `meteor_scatter_tpu/ops/pallas/stream_kernel.py`
(``stream_machine_fused``), with the same arguments (minus ``interpret``)
and return layout.  One call runs the reference's sequential 3-state live
detector (`dsp/src/live/backend/processor.py:444-510`) over n blocks of C
channels: per step the threshold (locked while tracking or inside the lock
tail, else the base threshold), the init PSD-mean accumulation, track
entry / exit, the running track statistics, the accept rule, the emit flag
and the next state.

Layout: series are (n, C) float32, time-major; the carry is ``carry_f``
(8, C) float32 rows [locked, tstart, trs, trss, trmn, trmx, isum, pinit]
and ``carry_i`` (6, C) int32 rows [state, luntil, tsblk, trc, icnt, i0].
Returns ``(ys, carry_f', carry_i')`` with ys = (thr, emit, tstart, t_stop,
dur, trmn, trmx, h_mean, h_std), each (n, C); ``emit`` is int32 and
``carry_i'[5]`` is ``i0 + n``.

Dispatch is by the device of the series:

* CUDA tensor → the hand-written kernel ``csrc/stream_machine.cu``, built
  at first use.  Whatever the kernel does not take raises; there is no
  fallback to the twin.
* CPU tensor → :func:`stream_machine_plain`, the step loop in plain
  PyTorch.  It is also the block machine of
  :func:`meteor_scatter_tpu_torch.models.streaming.stream_scan` on any
  device, and ``chip_smoke.py`` holds the kernel against it on the card.

The kernel is bit-exact against the twin on every output and the carry:
both round each float op once, in the same order, and compare against the
same float32 constants.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from meteor_scatter_tpu_torch.ops.kernels import _build

INIT, DETECT, TRACK = 0, 1, 2

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it

Result = Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]


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
) -> Result:
    """Plain PyTorch twin of the kernel: a loop over the n blocks, each step
    one vector op per line on the (C,) channel rows, as the reference's
    scan body (`meteor_scatter_tpu/models/streaming.py:1123-1187`)."""
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


def _launch(
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
) -> Result:
    """One launch of ``csrc/stream_machine.cu`` on the current stream."""
    global launches
    if not on2.is_cuda:
        raise ValueError(f"stream machine kernel takes CUDA tensors, got one on {on2.device}")
    if on2.dim() != 2 or on2.shape[1] < 1:
        raise ValueError(f"series must be (n, C) with C >= 1, got shape {tuple(on2.shape)}")
    n, C = on2.shape
    if n * C >= 2**31:
        raise ValueError(f"{n} x {C} series too large for int32 block indices")
    for name, a, dt, shape in (
        ("over_noise", on2, torch.float32, (n, C)),
        ("psd_db_mean", pm2, torch.float32, (n, C)),
        ("base_thr", bt2, torch.float32, (n, C)),
        ("carry_f", carry_f, torch.float32, (8, C)),
        ("carry_i", carry_i, torch.int32, (6, C)),
    ):
        if a.dtype != dt or tuple(a.shape) != shape or a.device != on2.device or not a.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dt} tensor of shape {shape} on {on2.device}, got "
                f"{a.dtype} {tuple(a.shape)} on {a.device} (contiguous={a.is_contiguous()})"
            )
    dev = on2.device
    ys_f = torch.empty((8, n, C), dtype=torch.float32, device=dev)
    emit = torch.empty((n, C), dtype=torch.int32, device=dev)
    carry_f1 = torch.empty((8, C), dtype=torch.float32, device=dev)
    carry_i1 = torch.empty((6, C), dtype=torch.int32, device=dev)

    fn = _bind(_build.load("stream_machine"))
    with torch.cuda.device(dev):
        err = fn(
            on2.data_ptr(), pm2.data_ptr(), bt2.data_ptr(), carry_f.data_ptr(),
            carry_i.data_ptr(), n, C, float(block_sec), float(init_wait_sec),
            float(min_mean_db), int(min_dur_b), int(lock_tail), ys_f.data_ptr(),
            emit.data_ptr(), carry_f1.data_ptr(), carry_i1.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stream machine kernel launch failed: CUDA error {err}")
    launches += 1
    thr, ts, tp, du, mn, mx, me, sd = ys_f.unbind(0)
    return (thr, emit, ts, tp, du, mn, mx, me, sd), carry_f1, carry_i1


def _bind(lib: ctypes.CDLL):
    fn = lib.ms_stream_machine
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, f, f, f, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def stream_machine(
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
) -> Result:
    """Run the machine on the series' device: the kernel on CUDA, the twin
    on the CPU (see the module docstring for the layout)."""
    kw = dict(block_sec=block_sec, init_wait_sec=init_wait_sec, min_mean_db=min_mean_db,
              min_dur_b=min_dur_b, lock_tail=lock_tail)
    dev = on2.device
    if dev.type == "cpu":
        return stream_machine_plain(on2, pm2, bt2, carry_f, carry_i, **kw)
    if dev.type == "cuda":
        return _launch(on2, pm2, bt2, carry_f, carry_i, **kw)
    raise ValueError(f"stream machine: tensors on {dev} are not supported (cpu or cuda)")
