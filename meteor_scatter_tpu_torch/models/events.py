"""Fixed-capacity event tensors and mask→event extraction.

Counterpart of `meteor_scatter_tpu/models/events.py`.  Events live in a
fixed-capacity struct-of-arrays with a validity count and an overflow flag
(int32 / float / bool, as in the reference), and every function here runs
on the tensors' device without reading a value back to the host, so a
chunked GPU run never waits on the host between chunks.

JAX's ``.at[i].set(v, mode="drop")`` becomes a ``scatter_`` into a buffer
with one spare slot that collects the dropped writes and is cut off;
``segment_sum`` becomes ``scatter_add_`` the same way.  On the CPU the run
sums are that float ``scatter_add_``, which equals the reference's
``segment_sum``.  On CUDA a float ``scatter_add_`` is atomics in no fixed
order (and so is a float ``torch.cumsum``), so there the run means come
from :func:`fixed_point_run_means`: exact int64 sums (:func:`to_fixed_point`),
the same bits on every run and every device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

I32 = torch.int32


class Events(NamedTuple):
    """Struct-of-arrays event buffer.  Rows < ``count`` are valid.

    ``start``/``stop`` are block indices with *exclusive* stop;
    ``db_mean`` is the mean of the detection series over [start, stop)
    (matching `main.py:501-502`).  ``overflow`` flags dropped events when
    more than the capacity were found.
    """

    start: torch.Tensor  # int32 [..., cap]
    stop: torch.Tensor  # int32 [..., cap] (exclusive)
    db_mean: torch.Tensor  # float [..., cap]
    count: torch.Tensor  # int32 [...]
    overflow: torch.Tensor  # bool [...]

    @property
    def capacity(self) -> int:
        return self.start.shape[-1]


def empty_events(cap: int, dtype=torch.float32, device="cpu") -> Events:
    return Events(
        start=torch.zeros(cap, dtype=I32, device=device),
        stop=torch.zeros(cap, dtype=I32, device=device),
        db_mean=torch.zeros(cap, dtype=dtype, device=device),
        count=torch.zeros((), dtype=I32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def _scatter_drop(cap: int, slot: torch.Tensor, keep: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``zeros(cap).at[where(keep, slot, cap)].set(src, mode="drop")`` along
    the last axis."""
    to = torch.where(keep & (slot < cap), slot, cap).long()
    return src.new_zeros(src.shape[:-1] + (cap + 1,)).scatter_(-1, to, src)[..., :cap]


def set_at(t: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``t.at[i].set(v)`` for a scalar index tensor ``i``."""
    return t.index_put((i.long().reshape(1),), v.reshape(1).to(t.dtype))


def _run_slots(above: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(the first block of each run; each block's run index, int32; its
    output slot, int64, ``cap`` for blocks outside a run or in a run past
    the capacity)."""
    no = above.new_zeros(above.shape[:-1] + (1,))
    is_start = above & ~torch.cat([no, above[..., :-1]], -1)
    run_id = torch.cumsum(is_start.to(I32), -1, dtype=I32) - 1  # valid where above
    return is_start, run_id, torch.where(above & (run_id < cap), run_id, cap).long()


def to_fixed_point(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite values ``x`` (..., n) as int64 fixed point, row by row:
    ``(q, scale)`` with ``q = round(x·scale)`` and ``scale = 2^k`` (float64,
    shape (..., 1)) for the largest ``k`` with ``n·max|x|·2^k < 2^61``, so
    that any sum of a row's ``q`` fits an int64 (at most ``2^61 + n/2``).
    Integer sums are exact in any order: on a card, where float atomics and
    a float ``torch.cumsum`` add in no fixed order, they give the same bits
    on every run and the CPU's.  Raises ``ValueError`` when a row's
    ``n·max|x|`` reaches 2^61 (``k`` would be negative); there is no
    float fallback."""
    n = x.shape[-1]
    x = x.to(torch.float64)
    amax = x.abs().amax(-1, keepdim=True) if n else x.new_zeros(x.shape[:-1] + (1,))
    # frexp: n·max|x| < 2^e exactly (a rounded product only rounds up to 2^e)
    _, e = torch.frexp(amax * n)
    k = 61 - e.to(torch.int64)
    if bool((k < 0).any()):
        raise ValueError("to_fixed_point: n * max|x| reaches 2^61, past the int64 fixed "
                         "point's range at a scale of at least 1")
    scale = ((k + 1023) << 52).view(torch.float64)  # 2^k built from its bits: exact
    return torch.round(x * scale).to(torch.int64), scale


def _fixed_point_means(
    above: torch.Tensor, series: torch.Tensor, seg: torch.Tensor, cap: int
) -> torch.Tensor:
    f64 = torch.float64
    x = torch.where(above, series, 0)
    q, scale = to_fixed_point(torch.where(torch.isfinite(x), x, 0))
    buf = above.shape[:-1] + (cap + 1,)
    qsum = torch.zeros(buf, dtype=torch.int64, device=x.device).scatter_add_(-1, seg, q)[..., :cap]
    # per run: blocks, NaNs, +infs, -infs — int sums, exact in any order
    flags = torch.stack([above, above & torch.isnan(series), above & (series == torch.inf),
                         above & (series == -torch.inf)], -1).to(I32)
    counts = torch.zeros(buf + (4,), dtype=I32, device=x.device).scatter_add_(
        -2, seg.unsqueeze(-1).expand(flags.shape), flags
    )[..., :cap, :]
    cnt, n_nan, n_pinf, n_ninf = counts.unbind(-1)
    mean = qsum.to(f64) / (cnt.clamp(min=1).to(f64) * scale)
    # a non-finite block makes the mean the float sum's: NaN, or ±inf alone
    mean = torch.where(n_ninf > 0, -torch.inf, mean)
    mean = torch.where(n_pinf > 0, torch.inf, mean)
    mean = torch.where((n_nan > 0) | ((n_pinf > 0) & (n_ninf > 0)) | (cnt == 0), torch.nan, mean)
    return mean.to(series.dtype)


def fixed_point_run_means(above: torch.Tensor, series: torch.Tensor, cap: int) -> torch.Tensor:
    """Means of ``series`` over the first ``cap`` maximal runs of ``above``
    (NaN past the last run), deterministic on every device.

    Each row's finite values become int64 fixed point
    (:func:`to_fixed_point`); the runs' ``q`` are summed by an int64
    ``scatter_add_`` (integer addition commutes, so the order of the
    atomics does not matter), converted back in float64, divided by the
    count and rounded to ``series.dtype``.  The result on a card equals the
    result on the CPU bit for bit.  A run holding a NaN, or both
    infinities, gives NaN and one holding one infinity gives it, as the
    float sum does.  Raises ``ValueError`` where :func:`to_fixed_point`
    does.
    """
    return _fixed_point_means(above, series, _run_slots(above, cap)[2], cap)


def events_from_mask(above: torch.Tensor, series: torch.Tensor, cap: int) -> Events:
    """Extract maximal runs of True from ``above`` with per-run mean of
    ``series``.

    Vectorized equivalent of the reference's diff-based run splitting
    (`main.py:408-415`) and of the adaptive detector's consecutive-block
    merging (`main.py:486-489`): both produce exactly the maximal runs.
    A batch ``(..., n)`` is taken row by row (the reference's ``jax.vmap``):
    the buffers are then ``(..., cap)`` and count and overflow ``(...)``.
    The means are a float ``scatter_add_`` on the CPU (the reference's
    ``segment_sum``) and :func:`fixed_point_run_means` on any other device.
    """
    n = above.shape[-1]
    dtype = series.dtype
    dev = above.device
    no = above.new_zeros(above.shape[:-1] + (1,))
    nxt = torch.cat([above[..., 1:], no], -1)
    is_start, run_id, seg = _run_slots(above, cap)
    is_stop = above & ~nxt  # last block of each run
    num = is_start.sum(-1, dtype=I32)

    idx = torch.arange(n, dtype=I32, device=dev).expand(above.shape)
    start = _scatter_drop(cap, run_id, is_start, idx)
    stop = _scatter_drop(cap, run_id, is_stop, idx + 1)

    if dev.type == "cpu":
        buf = above.shape[:-1] + (cap + 1,)
        sums = torch.zeros(buf, dtype=dtype, device=dev).scatter_add_(
            -1, seg, torch.where(above, series, 0).to(dtype)
        )[..., :cap]
        cnts = torch.zeros(buf, dtype=I32, device=dev).scatter_add_(-1, seg, above.to(I32))[..., :cap]
        mean = torch.where(cnts > 0, sums / cnts.clamp(min=1).to(dtype), torch.nan)
    else:
        mean = _fixed_point_means(above, series, seg, cap)

    return Events(
        start=start,
        stop=stop,
        db_mean=mean,
        count=torch.clamp(num, max=cap),
        overflow=num > cap,
    )


def events_from_run_sums(
    s_incl: torch.Tensor, csm: torch.Tensor, above: torch.Tensor, cap: int
) -> Events:
    """Gather-only event extraction from run metadata.

    ``s_incl[i]`` = number of runs started in ``above[:i+1]`` and ``csm[i]``
    = prefix sum of the masked series — both computed inside the fused
    adaptive solver.  The completed-runs count is ``e_incl = s_incl -
    above``, the j-th run's [start, stop) indices are exact integer
    searchsorted lookups on those monotone counts, and per-run sums are two
    gathers into the prefix array.  Equal to :func:`events_from_mask` on
    start/stop/count (means agree to f32 summation-order noise).
    """
    n = s_incl.shape[0]
    dtype = csm.dtype
    e_incl = s_incl - above.to(I32)  # runs fully completed by block i
    num = s_incl[-1]

    j = torch.arange(cap, dtype=I32, device=s_incl.device)
    start = torch.searchsorted(s_incl, j + 1, side="left", out_int32=True)
    stop = torch.searchsorted(e_incl, j + 1, side="left", out_int32=True)  # exclusive

    cs0 = torch.cat([csm.new_zeros(1), csm])
    sums = cs0[stop.clamp(max=n).long()] - cs0[start.clamp(max=n).long()]
    cnt = (stop - start).to(dtype)
    valid = j < num
    mean = torch.where(valid, sums / cnt.clamp(min=1), torch.nan)

    return Events(
        start=torch.where(valid, start, 0),
        stop=torch.where(valid, stop, 0),
        db_mean=mean,
        count=torch.clamp(num, max=cap),
        overflow=num > cap,
    )


def truncate_events(ev: Events, cap: int) -> Events:
    """Restore the fixed-cap contract after merges grew the buffer:
    capacity back to ``cap``, count ≤ cap, overflow set when events beyond
    the cap were dropped (matching :func:`events_from_mask`)."""
    if ev.capacity == cap:
        return ev
    if ev.capacity < cap:
        pad = cap - ev.capacity
        return Events(
            start=torch.nn.functional.pad(ev.start, (0, pad)),
            stop=torch.nn.functional.pad(ev.stop, (0, pad)),
            db_mean=torch.nn.functional.pad(ev.db_mean, (0, pad)),
            count=ev.count,
            overflow=ev.overflow,
        )
    return Events(
        start=ev.start[:cap],
        stop=ev.stop[:cap],
        db_mean=ev.db_mean[:cap],
        count=torch.clamp(ev.count, max=cap),
        overflow=ev.overflow | (ev.count > cap),
    )


def merge_adjacent(
    left: Events, right: Events, right_offset: Union[int, torch.Tensor]
) -> Events:
    """Concatenate two event buffers from adjacent time shards, merging a run
    that spans the seam (left's last event ends exactly where right's first
    begins after offsetting).  The chunked adaptive path uses it to make
    chunked detection equal the whole-series run."""
    cap = left.capacity + right.capacity
    rcap = right.capacity
    dev = left.start.device
    dt = left.db_mean.dtype
    r_start = right.start + right_offset
    r_stop = right.stop + right_offset

    ln = left.count
    l_last = torch.clamp(ln - 1, min=0).long()
    spans = (ln > 0) & (right.count > 0) & (left.stop[l_last] == r_start[0])

    # When spanning: fold right's first event into left's last.
    l_len = left.stop[l_last] - left.start[l_last]
    r_len = r_stop[0] - r_start[0]
    merged_mean = (
        left.db_mean[l_last] * l_len.to(dt) + right.db_mean[0] * r_len.to(dt)
    ) / (l_len + r_len).to(dt)

    l_stop = torch.where(spans, set_at(left.stop, l_last, r_stop[0]), left.stop)
    l_mean = torch.where(spans, set_at(left.db_mean, l_last, merged_mean), left.db_mean)

    # Right events shift down by one when its first was merged away.
    shift = spans.to(I32)
    ar = torch.arange(rcap, dtype=I32, device=dev)
    r_idx = torch.clamp(ar + shift, max=rcap - 1).long()
    rs, rp, rm = r_start[r_idx], r_stop[r_idx], right.db_mean[r_idx]
    r_count = right.count - shift

    # Place right events after left's.
    pos = torch.where(ar < r_count, ln + ar, cap).long()

    def place(left_vals, right_vals):
        out = torch.zeros(cap + 1, dtype=left_vals.dtype, device=dev)
        out[: left.capacity] = left_vals
        return out.scatter_(0, pos, right_vals)[:cap]

    return Events(
        start=place(left.start, rs),
        stop=place(l_stop, rp),
        db_mean=place(l_mean, rm),
        count=ln + r_count,
        overflow=left.overflow | right.overflow,
    )
