"""Adaptive-threshold detector with post-detection freeze.

Counterpart of `meteor_scatter_tpu/models/adaptive.py` (reference:
`dsp/src/main.py:450-522`, ``get_detections_adaptive``).  Per block i:

* first ``fixed_init`` seconds: threshold = global mean + k·global std
  (population std over the *whole* series);
* else if i > freeze_until: threshold = mean + k·std over the trailing
  window ``delta[max(0, i-W) : i]`` (current block excluded);
* else: threshold keeps its previous value (frozen);
* any above-threshold block sets
  ``freeze_until = max(i + freeze_after, max(0, i - freeze_before))``.

Two solvers of :func:`detect_adaptive`, both giving the same above mask:

* ``"parallel"`` — :func:`adaptive_thresholds_parallel`, the fixpoint
  iteration in plain PyTorch, then :func:`events_from_mask`;
* ``"fused"`` — the fused solver of
  :mod:`meteor_scatter_tpu_torch.ops.kernels.adaptive_kernel` (the CUDA
  kernel on a GPU, its plain twin on the CPU), chunked exactly beyond
  ``MAX_FUSED_BLOCKS``, then :func:`events_from_mask` on the whole
  series' above mask.

The sequential recurrence itself, :func:`adaptive_thresholds` (a loop over
blocks with a carry), serves chunked calls and the time-sharded warm start
(:func:`meteor_scatter_tpu_torch.parallel.sharded.sharded_detect_adaptive`);
:func:`adaptive_thresholds_fast` keeps the reference's name for the
prefix-sum formulation and is the fixpoint.
"""

from __future__ import annotations

from typing import Tuple

import torch

from meteor_scatter_tpu_torch.models.events import (
    Events,
    events_from_mask,
    to_fixed_point,
)
from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak
from meteor_scatter_tpu_torch.utils.timing import wait


def adaptive_thresholds(
    delta: torch.Tensor,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    init_carry=None,
    global_stats: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """Scan the freeze/threshold recurrence block by block (the reference's
    ``lax.scan``), on ``delta``'s device.

    ``delta`` is one series ``(B,)`` or a batch ``(C, B)`` scanned row by
    row (the reference's ``jax.vmap``).  Returns ``(thresholds, above,
    carry)``; the carry ``(ring (…, w), i (…), freeze_until (…), prev_thr
    (…))`` holds, per row, the trailing deltas at slots ``i mod w``, the
    absolute index of the next block, the freeze horizon and the last
    threshold.  ``init_carry`` / the returned carry allow chunked execution
    over long streams and warm-started time shards: feed the carry of chunk
    c into chunk c+1.  The caller's carry is not written to.

    ``global_stats=(mean, std)`` (per row) are the whole-series statistics
    of the fixed initial threshold; pass them when processing in chunks
    (the reference computes them over the full file).

    Blocks with an absolute index below 0 (a time shard's warm-up replay
    over shard 0's zero halo) never register as above, so shard 0 stays
    equal to the unsharded scan even when the fixed threshold is negative.
    """
    squeeze = delta.dim() == 1
    d2 = delta[None] if squeeze else delta
    dtype = d2.dtype
    dev = d2.device
    c, n = d2.shape
    w = window_blocks

    def rows(a, dt):
        return torch.as_tensor(a, device=dev).to(dt).reshape(-1).expand(c).clone()

    if global_stats is None:
        g_mean = d2.mean(-1)
        g_std = d2.std(-1, correction=0)
    else:
        g_mean, g_std = (rows(g, dtype) for g in global_stats)
    fixed = g_mean + threshold_std_factor * g_std

    if init_carry is None:
        ring = torch.zeros((c, w), dtype=dtype, device=dev)
        i = torch.zeros(c, dtype=torch.int32, device=dev)
        freeze_until = torch.full((c,), -1, dtype=torch.int32, device=dev)
        prev_thr = fixed.to(dtype)
    else:
        ring0, i0, fz0, thr0 = init_carry
        ring = ring0.to(device=dev, dtype=dtype).reshape(-1, w).expand(c, w).clone()
        i, freeze_until = rows(i0, torch.int32), rows(fz0, torch.int32)
        prev_thr = rows(thr0, dtype)

    slot_ids = torch.arange(w, dtype=torch.int32, device=dev)
    row_ids = torch.arange(c, device=dev)
    thresholds = torch.empty((c, n), dtype=dtype, device=dev)
    above = torch.empty((c, n), dtype=torch.bool, device=dev)
    for b in range(n):
        d = d2[:, b]
        cnt = torch.clamp(i, max=w)
        valid = slot_ids < cnt[:, None]  # the ring fills slots 0..i-1 before wrapping
        cnt_f = torch.clamp(cnt, min=1).to(dtype)
        m = torch.where(valid, ring, 0).sum(-1) / cnt_f
        m2 = torch.where(valid, ring * ring, 0).sum(-1) / cnt_f
        windowed = m + threshold_std_factor * torch.sqrt(torch.clamp(m2 - m * m, min=0))

        in_fixed = i < fixed_threshold_blocks
        can_update = ~in_fixed & (i > freeze_until)
        thr = torch.where(in_fixed, fixed, torch.where(can_update, windowed, prev_thr)).to(dtype)
        hit = (d > thr) & (i >= 0)
        new_freeze = torch.maximum(i + freeze_blocks_after,
                                   torch.clamp(i - freeze_blocks_before, min=0))
        freeze_until = torch.where(hit, new_freeze, freeze_until)
        # floor modulo, as jnp.mod: a negative index seeds the slot it wraps to
        ring[row_ids, torch.remainder(i, w).long()] = d
        thresholds[:, b] = thr
        above[:, b] = hit
        i = i + 1
        prev_thr = thr
    carry = (ring, i, freeze_until, prev_thr)
    if squeeze:
        return thresholds[0], above[0], tuple(a[0] for a in carry)
    return thresholds, above, carry


def adaptive_thresholds_fast(
    delta: torch.Tensor,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same semantics as :func:`adaptive_thresholds` (full-series case) for
    one series ``(B,)``: every block's rolling window mean/std precomputed
    from prefix sums, then the freeze recurrence over them.

    The reference runs that recurrence as a two-scalar ``lax.scan``; here it
    is :func:`adaptive_thresholds_parallel`, whose fixpoint reads the same
    window statistics and holds, at every block, the windowed threshold of
    the last updatable block (else the fixed one), as the scan's carry does:
    the same thresholds and above mask, in a few rounds instead of B steps.

    Returns (thresholds, above), each ``(B,)``.
    """
    return adaptive_thresholds_parallel(
        delta, threshold_std_factor, window_blocks, freeze_blocks_before,
        freeze_blocks_after, fixed_threshold_blocks,
    )


def adaptive_thresholds_parallel(
    delta: torch.Tensor,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    max_rounds: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-scan-free adaptive detector via fixpoint iteration.

    Given a *candidate* set of above-threshold blocks, the whole threshold
    series has a closed vector form —

      freeze_until_i = cummax_{j<=i}( above_j ? max(j+fa, max(0, j-fb)) : -1 )
      updatable_i    = (i > freeze_until_{i-1}) & (i >= fixed_blocks)
      thr_i          = windowed[ last updatable index <= i ]   (gather)

    — so we iterate: thresholds from candidate detections → detections from
    thresholds, until the detection set is stationary.  A stationary point
    equals the sequential solution (after round k the solution is exact up
    to the k-th freeze episode).

    ``delta`` is one series ``(B,)`` or a batch ``(..., B)`` solved row by
    row (the reference's ``jax.vmap``): every statistic is taken over the
    last axis, and one loop runs until no row changes.

    Returns (thresholds, above) in ``delta``'s shape, dtype and device.
    """
    thr, above, _ = _fixpoint(
        delta, threshold_std_factor, window_blocks, freeze_blocks_before,
        freeze_blocks_after, fixed_threshold_blocks, max_rounds,
    )
    return thr, above


def _window_sums(x: torch.Tensor, lo: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``cs[..., i] - cs[..., lo]`` for the prefix sums ``cs`` of ``x`` along
    its last axis (``cs[..., 0] = 0``).

    On the CPU ``cs`` is a float ``torch.cumsum``, as the reference's.  On
    a card a float ``torch.cumsum`` adds in no fixed order (a day's
    thresholds changed bits from run to run), so there the sums are int64
    fixed point (:func:`~meteor_scatter_tpu_torch.models.events.to_fixed_point`):
    the exact window sum rounded to ``x.dtype``, the same bits on every
    run (:func:`window_sums_fixed_point`)."""
    if x.device.type != "cpu":
        return window_sums_fixed_point(x, lo, i)
    cs = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), torch.cumsum(x, -1)], -1)
    return cs[..., i] - cs[..., lo]


def window_sums_fixed_point(x: torch.Tensor, lo: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``sum(x[..., lo[j]:i[j]])`` for every ``j``, exact in int64 fixed
    point and rounded to ``x.dtype``: the same bits on every run and every
    device.  A non-finite value gives what a float prefix difference gives:
    NaN for every window starting after it, its value (NaN or ±inf) for
    the windows before that which hold it."""
    zero = x.new_zeros(x.shape[:-1] + (1,))
    finite = torch.isfinite(x)
    q, scale = to_fixed_point(torch.where(finite, x, 0))
    cq = torch.cat([zero.long(), torch.cumsum(q, -1)], -1)
    s = ((cq[..., i] - cq[..., lo]).to(torch.float64) / scale).to(x.dtype)
    # prefix counts of NaN, +inf, -inf: the float prefix sum's value (each
    # scanned along its last axis: a scan along an outer axis of 3 columns
    # runs as 3 sequential threads on a card)
    flags = torch.stack([torch.isnan(x), x == torch.inf, x == -torch.inf]).to(torch.int32)
    fc = torch.cat([zero.to(torch.int32).expand(flags.shape[:-1] + (1,)),
                    torch.cumsum(flags, -1, dtype=torch.int32)], -1) > 0

    def prefix(j):
        nan, pinf, ninf = fc[..., j]
        v = torch.where(nan | (pinf & ninf), torch.nan,
                        torch.where(pinf, torch.inf, torch.where(ninf, -torch.inf, 0.0)))
        return nan | pinf | ninf, v.to(x.dtype)

    bad_lo, _ = prefix(lo)
    bad_i, v_i = prefix(i)
    return torch.where(bad_lo, torch.nan, torch.where(bad_i, v_i, s))


def _fixpoint(
    delta: torch.Tensor,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    max_rounds: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`adaptive_thresholds_parallel` and the number of rounds it ran
    (each round waits once on the host for its change test)."""
    dtype = delta.dtype
    n = delta.shape[-1]
    w = window_blocks
    if max_rounds is None:
        max_rounds = n

    fixed_thr = (
        delta.mean(-1, keepdim=True)
        + threshold_std_factor * delta.std(-1, correction=0, keepdim=True)
    ).to(dtype)

    # rolling-window stats (current block excluded) via prefix sums
    i = torch.arange(n, device=delta.device)
    lo = torch.clamp(i - w, min=0)
    cnt = (i - lo).to(dtype)
    safe = torch.clamp(cnt, min=1)
    m = _window_sums(delta, lo, i) / safe
    m2 = _window_sums(delta * delta, lo, i) / safe
    std = torch.sqrt(torch.clamp(m2 - m * m, min=0))
    # cnt==0 only at block 0: the sequential scan computes 0+k*0 = 0 there
    windowed = torch.where(cnt > 0, m + threshold_std_factor * std, 0.0)

    new_freeze = torch.maximum(i + freeze_blocks_after, torch.clamp(i - freeze_blocks_before, min=0))
    in_fixed = i < fixed_threshold_blocks

    def thresholds_from(above):
        f = torch.where(above, new_freeze, -1)
        freeze_until = torch.cummax(f, -1).values  # state after block i
        freeze_prev = torch.cat([f.new_full(f.shape[:-1] + (1,), -1), freeze_until[..., :-1]], -1)
        updatable = (i > freeze_prev) & ~in_fixed
        last_upd = torch.cummax(torch.where(updatable, i, -1), -1).values
        frozen = torch.where(last_upd >= 0, windowed.gather(-1, last_upd.clamp(min=0)), fixed_thr)
        return torch.where(in_fixed, fixed_thr, frozen).to(dtype)

    above = delta > thresholds_from(torch.zeros(delta.shape, dtype=torch.bool, device=delta.device))
    with wait("fixpoint_round"):
        changed = bool(above.any())
    rounds = 1
    while changed and rounds < max_rounds:
        new = delta > thresholds_from(above)
        with wait("fixpoint_round"):
            changed = bool((new != above).any())
        above = new
        rounds += 1
    thr = thresholds_from(above)
    return thr, delta > thr, rounds


def detect_adaptive(
    delta: torch.Tensor,
    threshold_std_factor: float,
    block_duration_sec: float,
    threshold_estimation_window_sec: float = 120.0,
    threshold_freeze_before_detection_sec: float = 3.0,
    threshold_freeze_after_detection_sec: float = 20.0,
    threshold_fixed_init_duration_sec: float = 10.0,
    cap: int = 4096,
    impl: str = "auto",
) -> Tuple[Events, torch.Tensor]:
    """Full-series adaptive detection: (events, per-block thresholds).

    Block→seconds conversion (`main.py:503-505`): t_start = start·bd,
    t_stop = (last+1)·bd, dB mean over [start, last+1).

    ``impl``: "parallel" (fixpoint in plain PyTorch), "fused" (the fused
    solver — the CUDA kernel for a CUDA tensor, its plain twin for a CPU
    one; same above mask, thresholds within f32 reduction-order noise;
    series beyond ``MAX_FUSED_BLOCKS`` run as exact sequential chunks), or
    "auto" (fused for a CUDA tensor, parallel for a CPU one).
    """
    bd = block_duration_sec
    kw = dict(
        threshold_std_factor=threshold_std_factor,
        window_blocks=int(threshold_estimation_window_sec / bd),
        freeze_blocks_before=int(threshold_freeze_before_detection_sec / bd),
        freeze_blocks_after=int(threshold_freeze_after_detection_sec / bd),
        fixed_threshold_blocks=int(threshold_fixed_init_duration_sec / bd),
    )
    if impl == "auto":
        impl = "fused" if delta.is_cuda else "parallel"
    if impl == "fused":
        return _detect_adaptive_fused(delta, cap, **kw)
    if impl == "parallel":
        thresholds, above = adaptive_thresholds_parallel(delta, **kw)
        return events_from_mask(above, delta, cap), thresholds
    raise ValueError(f"unknown adaptive solver impl {impl!r} (auto, fused or parallel)")


def _detect_adaptive_fused(delta: torch.Tensor, cap: int, **kw) -> Tuple[Events, torch.Tensor]:
    """Fused-solver detection for any series length: one launch when the
    series fits ``MAX_FUSED_BLOCKS``, otherwise exact chunked execution —
    each chunk gets a ``window_blocks`` delta halo (its rolling-statistics
    history), the carried freeze horizon / standing threshold, and the
    whole-series fixed threshold.  The carries stay on the device: nothing
    here waits on the host between chunks.

    The events come from the whole series' above mask by
    :func:`events_from_mask`, as on the parallel route: their means are the
    reference's ``segment_sum`` on the CPU and exact on a card.  The
    solver's own run sums (a float32 prefix sum of the masked series) would
    carry its rounding into every mean -- 1.7e-4 dB on the first hour of a
    day, past the analyzer's 1e-4 against the JAX package
    (``tests/test_torch_golden.py``)."""
    n = delta.shape[0]
    if n <= ak.MAX_FUSED_BLOCKS:
        thresholds, above, _, _ = ak.adaptive_solver_fused(delta, **kw)
        return events_from_mask(above, delta, cap), thresholds

    k = kw["threshold_std_factor"]
    w = kw["window_blocks"]
    fa = kw["freeze_blocks_after"]
    fb = kw["freeze_blocks_before"]
    fixed_thr = delta.mean() + k * delta.std(correction=0)  # whole-file, two-pass
    chunk = ak.MAX_FUSED_BLOCKS - w

    thr_parts, above_parts = [], []
    freeze_in = torch.full((), -1, dtype=torch.int32, device=delta.device)
    thr_in = fixed_thr
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        halo = w if c0 else 0
        thr_c, above_c, _, _ = ak.adaptive_solver_fused_chunk(
            delta[c0 - halo : c1], c0, freeze_in, fixed_thr, thr_in, halo, **kw
        )
        thr_parts.append(thr_c)
        above_parts.append(above_c)
        ii = torch.arange(c0, c1, dtype=torch.int32, device=delta.device)
        f_c = torch.where(above_c, torch.maximum(ii + fa, torch.clamp(ii - fb, min=0)), -1)
        freeze_in = torch.maximum(freeze_in, f_c.max())
        thr_in = thr_c[-1]
    return events_from_mask(torch.cat(above_parts), delta, cap), torch.cat(thr_parts)
