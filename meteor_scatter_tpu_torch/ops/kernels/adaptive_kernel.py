"""Fused adaptive-threshold solver: the CUDA kernel K1 and its plain twin.

Counterpart of `meteor_scatter_tpu/ops/pallas/adaptive_kernel.py`, with
the same public functions, arguments and return layout.  One call computes
everything between the delta-dB series and the event metadata of the
reference's adaptive detector (`dsp/src/main.py:450-522`): rolling-window
statistics, the freeze-recurrence fixpoint, and the run sums that
:func:`meteor_scatter_tpu_torch.models.events.events_from_run_sums` reads.

Dispatch is by the device of the series:

* CUDA tensor → the hand-written kernel ``csrc/adaptive_solver.cu``, built
  at first use: one cooperative launch across the SMs that solves the
  freeze recurrence by a segmented walk and gives the converged result.
  Whatever the kernel does not take raises; there is no fallback to the
  twin.  That includes a round cap below the solved block count (every app
  path passes none, which is the converged cap): such a cap asks for the
  TPU fixpoint's intermediate iterate, which the kernel does not compute.
  A caller that wants that iterate on the card calls
  :func:`adaptive_solver_plain` itself.
* CPU tensor → :func:`adaptive_solver_plain`, the same chunk solver in
  plain PyTorch (``cumsum``, ``cummax`` and a gather), capped iterate
  included.  ``chip_smoke.py`` also runs it on the GPU, as the reference
  the kernel is held against.

``launches`` counts kernel launches, so a run can show that it went through
the kernel.  ``last_fixup`` is, on the card, the last launch's count of
[untrusted seams, fix-up walks, blocks walked] (a view of the launch's
scratch).

One launch takes at most :data:`MAX_FUSED_BLOCKS` blocks, the JAX
package's cap, so that the chunked path
(`meteor_scatter_tpu_torch.models.adaptive._detect_adaptive_fused`) cuts
a long series at the same seams as the reference.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from meteor_scatter_tpu_torch.ops.kernels import _build
from meteor_scatter_tpu_torch.utils.timing import wait

MAX_FUSED_BLOCKS = 131072
SEGMENT = 1024  # blocks of the series per CTA of the kernel

launches = 0  # kernel launches so far; chip_smoke.py resets and reads it
last_fixup = None  # the fix-up counts of the last launch
_GRID_TOO_LARGE, _NO_COOPERATIVE_LAUNCH = -1, -2  # ms_adaptive_walk's own error codes


def walk_lead(freeze_after: int, segment: int = SEGMENT) -> int:
    """Blocks before its segment at which a CTA starts its speculative walk:
    two freezes and a warp, at most one segment."""
    return min(2 * freeze_after + 32, segment)


Scalar = Union[int, float, torch.Tensor]
Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _shift(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """result[i] = x[i-s]; ``fill`` for i < s."""
    if s == 0:
        return x
    out = torch.full_like(x, fill)
    if s < x.shape[0]:
        out[s:] = x[:-s]
    return out


def windowed_threshold(d: torch.Tensor, i0, halo: int, k_std: float, window: int) -> torch.Tensor:
    """m + k·std over ``d[max(0, i-W) : i)``, the current block excluded, as
    the TPU kernel forms it: exclusive float prefix sums (inclusive sums
    minus the block) and ``cs - shift(cs, W)``; 0 at absolute block 0,
    where the window is empty.  ``i0`` is the absolute index of block
    ``halo``."""
    idx = torch.arange(d.shape[0], dtype=torch.int32, device=d.device)
    iabs = idx - halo + i0
    dd = d * d
    cs = torch.cumsum(d, 0) - d
    cs2 = torch.cumsum(dd, 0) - dd
    cnt = torch.clamp(iabs, max=window).to(torch.float32)
    safe = torch.clamp(cnt, min=1.0)
    m = (cs - _shift(cs, window, 0.0)) / safe
    m2 = (cs2 - _shift(cs2, window, 0.0)) / safe
    std = torch.sqrt(torch.clamp(m2 - m * m, min=0.0))
    return torch.where(cnt > 0, m + k_std * std, 0.0)


def adaptive_solver_plain(
    delta_haloed: torch.Tensor,
    carry_i: torch.Tensor,
    carry_f: torch.Tensor,
    halo: int,
    k_std: float,
    window: int,
    freeze_before: int,
    freeze_after: int,
    fixed_blocks: int,
    max_rounds: int,
) -> Result:
    """Plain PyTorch twin of the kernel, with the TPU kernel's semantics.

    ``carry_i`` = int32 [i0, freeze_until_in], ``carry_f`` = float32
    [fixed_thr, thr_in].  Positions [0, halo) of ``delta_haloed`` are window
    history, [halo, total) are solved.  Returns (thr, above, s_incl, csm)
    for the solved region.
    """
    d = delta_haloed
    total = d.shape[0]
    idx = torch.arange(total, dtype=torch.int32, device=d.device)
    i0, freeze_in = carry_i[0], carry_i[1]
    fixed_thr, thr_in = carry_f[0], carry_f[1]
    valid = idx >= halo
    iabs = idx - halo + i0
    windowed = windowed_threshold(d, i0, halo, k_std, window)

    new_freeze = torch.maximum(iabs + freeze_after, torch.clamp(iabs - freeze_before, min=0))
    in_fixed = iabs < fixed_blocks

    def thresholds_from(above):  # above is already masked to the solved region
        f = torch.where(above, new_freeze, -1)
        freeze_prev = torch.maximum(_shift(torch.cummax(f, 0).values, 1, -1), freeze_in)
        upd = (iabs > freeze_prev) & ~in_fixed & valid
        last_upd = torch.cummax(torch.where(upd, idx, -1), 0).values
        frozen = torch.where(last_upd >= 0, windowed[last_upd.clamp(min=0).long()], thr_in)
        return torch.where(in_fixed, fixed_thr, frozen)

    above = valid & (d > thresholds_from(torch.zeros_like(valid)))
    with wait("fixpoint_round"):
        changed = bool(above.any())
    rounds = 1
    while changed and rounds < max_rounds:
        new = valid & (d > thresholds_from(above))
        with wait("fixpoint_round"):
            changed = bool((new != above).any())
        above = new
        rounds += 1
    thr = thresholds_from(above)

    # run metadata; halo (and anything below the solved region) is masked out
    above = valid & (d > thr)
    is_start = above & ~_shift(above, 1, False)
    s_incl = torch.cumsum(is_start.to(torch.int32), 0, dtype=torch.int32)
    csm = torch.cumsum(torch.where(above, d, 0.0), 0)
    return thr[halo:], above[halo:], s_incl[halo:], csm[halo:]


def _launch(
    d: torch.Tensor,
    carry_i: torch.Tensor,
    carry_f: torch.Tensor,
    halo: int,
    k_std: float,
    window: int,
    freeze_before: int,
    freeze_after: int,
    fixed_blocks: int,
) -> Result:
    """One launch of ``csrc/adaptive_solver.cu`` on the current stream: the
    converged result."""
    global launches, last_fixup
    if not d.is_cuda:
        raise ValueError(f"adaptive solver kernel takes a CUDA tensor, got one on {d.device}")
    total = d.shape[0] if d.dim() == 1 else -1
    if d.dtype != torch.float32 or d.dim() != 1 or not d.is_contiguous():
        raise ValueError(
            f"adaptive solver kernel takes a contiguous 1-D float32 series, got "
            f"{d.dtype} of shape {tuple(d.shape)} (contiguous={d.is_contiguous()})"
        )
    if not 0 <= halo < total:
        raise ValueError(f"halo {halo} must lie in [0, {total}) for a series of {total} blocks")
    if total >= 2**31 // 3:
        raise ValueError(f"series of {total} blocks too long for int32 indexing")
    for c, dt in ((carry_i, torch.int32), (carry_f, torch.float32)):
        if c.dtype != dt or c.shape != (2,) or c.device != d.device or not c.is_contiguous():
            raise ValueError(f"carry must be a contiguous ({dt}, shape (2,)) tensor on {d.device}")
    if min(window, freeze_before, freeze_after, fixed_blocks) < 0:
        raise ValueError("window / freeze / fixed block counts must be >= 0")

    n = total - halo
    dev = d.device
    thr = torch.empty(n, dtype=torch.float32, device=dev)
    s_incl = torch.empty(n, dtype=torch.int32, device=dev)
    csm = torch.empty(n, dtype=torch.float32, device=dev)
    above = torch.empty(total, dtype=torch.bool, device=dev)

    lib = _bind(_build.load("adaptive_solver"))
    scratch = torch.empty(lib.ms_adaptive_walk_scratch_words(total), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ms_adaptive_walk(
            d.data_ptr(), total, halo, carry_i.data_ptr(), carry_f.data_ptr(),
            window, freeze_before, freeze_after, fixed_blocks, float(k_std),
            walk_lead(freeze_after),
            scratch.data_ptr(), above.data_ptr(), thr.data_ptr(), s_incl.data_ptr(),
            csm.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err == _GRID_TOO_LARGE:
        raise RuntimeError(
            f"adaptive solver: {-(-total // SEGMENT)} CTAs for {total} blocks cannot all be "
            f"co-resident on {torch.cuda.get_device_name(dev)} (cooperative launch)")
    if err == _NO_COOPERATIVE_LAUNCH:
        raise RuntimeError("adaptive solver: the device has no cooperative launch")
    if err != 0:
        raise RuntimeError(f"adaptive solver kernel launch failed: CUDA error {err}")
    launches += 1
    last_fixup = scratch[:3]
    return thr, above[halo:], s_incl, csm


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.ms_adaptive_walk.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ms_adaptive_walk.argtypes = [p, i, i, p, p, i, i, i, i, ctypes.c_float, i,
                                         p, p, p, p, p, p]
        lib.ms_adaptive_walk.restype = ctypes.c_int
        lib.ms_adaptive_walk_scratch_words.argtypes = [i]
        lib.ms_adaptive_walk_scratch_words.restype = ctypes.c_longlong
    return lib


def _run(delta_haloed, i0, freeze_in, fixed_thr, thr_in, halo, k_std, window,
         freeze_before, freeze_after, fixed_blocks, max_rounds) -> Result:
    d = delta_haloed.to(torch.float32)
    dev = d.device

    def pack(a, b, dtype):
        # made on the device, never copied from the host: a Python number by
        # a fill, a tensor by a cast, so that a CUDA graph can capture a call
        return torch.stack([
            v.to(device=dev, dtype=dtype).reshape(()) if isinstance(v, torch.Tensor)
            else torch.full((), v, dtype=dtype, device=dev)
            for v in (a, b)
        ])

    args = (
        d, pack(i0, freeze_in, torch.int32), pack(fixed_thr, thr_in, torch.float32),
        int(halo), float(k_std), int(window), int(freeze_before), int(freeze_after),
        int(fixed_blocks), int(max_rounds),
    )
    if dev.type == "cpu":
        return adaptive_solver_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"adaptive solver: tensors on {dev} are not supported (cpu or cuda)")
    # round r of the fixpoint is exact on the first r solved blocks (thr[i]
    # reads only above[< i]), so a cap of at least the solved blocks is the
    # converged result, the one result the kernel computes
    n = d.shape[0] - int(halo)
    if int(max_rounds) < n:
        raise ValueError(
            f"adaptive solver kernel computes the converged result only: max_rounds "
            f"{max_rounds} is below the {n} solved blocks (adaptive_solver_plain "
            f"computes the capped iterate)")
    return _launch(*args[:-1])


def adaptive_thresholds_fused(
    delta: torch.Tensor,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    max_rounds: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for
    :func:`meteor_scatter_tpu_torch.models.adaptive.adaptive_thresholds_parallel`
    (same (thresholds, above) contract), one fused solve.

    Raises ValueError past :data:`MAX_FUSED_BLOCKS` — longer series go
    through the exact chunked path in ``models.adaptive``.
    """
    thr, above, _, _ = adaptive_solver_fused(
        delta,
        threshold_std_factor,
        window_blocks,
        freeze_blocks_before,
        freeze_blocks_after,
        fixed_threshold_blocks,
        max_rounds,
    )
    return thr, above


def adaptive_solver_fused(
    delta: torch.Tensor,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    max_rounds: int | None = None,
) -> Result:
    """Full fused solver: (thresholds, above, runs_started_prefix,
    masked_series_prefix_sum).  The last two feed
    :func:`meteor_scatter_tpu_torch.models.events.events_from_run_sums` so
    event extraction needs no further full-series passes.
    """
    n = delta.shape[0]
    if n > MAX_FUSED_BLOCKS:
        raise ValueError(f"series too long for the fused kernel ({n} blocks)")
    if max_rounds is None:
        max_rounds = n
    fixed_thr = delta.mean() + threshold_std_factor * delta.std(correction=0)
    return _run(
        delta, 0, -1, fixed_thr, fixed_thr, 0, threshold_std_factor, window_blocks,
        freeze_blocks_before, freeze_blocks_after, fixed_threshold_blocks, max_rounds,
    )


def adaptive_solver_fused_chunk(
    delta_haloed: torch.Tensor,
    i0: Scalar,
    freeze_until_in: Scalar,
    fixed_thr: Scalar,
    thr_in: Scalar,
    halo: int,
    threshold_std_factor: float,
    window_blocks: int,
    freeze_blocks_before: int,
    freeze_blocks_after: int,
    fixed_threshold_blocks: int,
    max_rounds: int | None = None,
) -> Result:
    """One chunk of an exact chunked run over an arbitrarily long series.

    ``delta_haloed`` = ``window_blocks`` history blocks (``halo`` of them;
    0 for the first chunk) followed by the chunk's blocks; ``i0`` is the
    absolute index of the first solved block; ``freeze_until_in`` /
    ``thr_in`` carry the freeze horizon and the standing threshold from
    previous chunks; ``fixed_thr`` is the whole-series fixed threshold
    (the reference computes it over the full file, main.py:399-400).  The
    carries may be Python numbers or scalar tensors on the series' device,
    so a chunked GPU run need not wait on the host between chunks.
    Returns (thr, above, s_incl, csm) for the solved region only — run
    indices are chunk-local, so seam-spanning runs merge via
    ``models.events.merge_adjacent`` with ``right_offset=i0``.
    """
    n = delta_haloed.shape[0]
    if n > MAX_FUSED_BLOCKS:
        raise ValueError(f"chunk too long for the fused kernel ({n} blocks)")
    if max_rounds is None:
        max_rounds = n
    return _run(
        delta_haloed, i0, freeze_until_in, fixed_thr, thr_in, halo, threshold_std_factor,
        window_blocks, freeze_blocks_before, freeze_blocks_after, fixed_threshold_blocks,
        max_rounds,
    )
