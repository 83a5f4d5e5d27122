"""The algorithm of K1's walk route, as a numpy model, against the twin.

``csrc/adaptive_solver.cu`` solves the freeze recurrence of a chunk by a
segmented walk instead of fixpoint rounds.  This file models that algorithm
block by block, with the kernel's structure and a small segment:

* segments of ``S`` blocks, one per CTA;
* each segment speculates its walk from ``walk_lead(fa, S)`` blocks before
  it (the chunk's carry where that reaches the chunk's start, else frozen
  at the carried horizon or free, as the carry says);
* a segment is trusted when its speculation and its predecessor's are free
  at the same block of that warm-up stretch;
* one in-order fix-up re-walks from the first untrusted seam under the true
  state, up to a block where the truth is free and the owning segment's
  speculation was free too, and jumps to that segment's exit state;
* the epilogue turns each block's key (the last updatable block) into its
  threshold.

The model takes the rolling threshold from the twin
(``adaptive_kernel.windowed_threshold``) and must reproduce the twin's
``thr``, ``above``, ``s_incl`` and ``csm`` bit for bit; the above mask is
also held against the JAX package's sequential ``adaptive_thresholds_fast``
on the CPU.  The CUDA kernel itself is held against the twin on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meteor_scatter_tpu.models import adaptive as jad
from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as tak

BASE = dict(k=4.0, window=100, fb=3, fa=10, fixed=20)


def series(n, seed, every=60):
    """3 dB noise with 5-block 30 dB bursts every ~``every`` blocks."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal(n) * 3.0).astype(np.float32)
    for s in rng.integers(0, max(n - 5, 1), size=max(n // every, 1)):
        d[s : s + 5] += 30.0
    return d


def walk_model(d, windowed, halo, i0, freeze_in, fixed_thr, thr_in, fb, fa, fixed, S):
    """(thr, above, s_incl, csm, stats) of one chunk by the kernel's walk.

    ``stats``: untrusted seams, walks the fix-up made, blocks it walked."""
    total = d.shape[0]
    idx = np.arange(total)
    iabs = idx - halo + i0
    valid = idx >= halo
    in_fixed = iabs < fixed
    # freeze horizon opened by an above block, in chunk-local indices
    nf = np.maximum(iabs + fa, np.maximum(0, iabs - fb)) - i0 + halo
    # above if the state before the block is free
    free_above = valid & np.where(in_fixed, d > fixed_thr, d > windowed)
    f_in = min(max(freeze_in - i0 + halo, halo - 1), total)
    lead = tak.walk_lead(fa, S)
    G = math.ceil(total / S)
    seg = [(g * S, min(g * S + S, total)) for g in range(G)]
    start = [max(halo, s0 - lead) for s0, _ in seg]

    def walk(i, e, F, key, keys, free, stop=None):
        """Blocks [i, e) from state (F, key); free when i > F.  Stops at the
        first free block where ``stop`` is set; returns (i, F, key)."""
        while i < e:
            if i > F:
                if stop is not None and stop[i]:
                    break
                keys[i], free[i] = i, True
                if free_above[i]:
                    key = -1 if in_fixed[i] else i
                    F = max(F, nf[i])
            else:
                keys[i], free[i] = key, False
                t = fixed_thr if in_fixed[i] else (windowed[key] if key >= 0 else thr_in)
                if d[i] > t:
                    F = max(F, nf[i])
            i += 1
        return i, F, key

    # speculation, every segment on its own
    keys = np.full(total, -1)
    spec_free = np.zeros(total, bool)
    warm_free, exits = [], []
    for (s0, e), a in zip(seg, start):
        k_w, f_w = np.full(total, -1), np.zeros(total, bool)
        _, F, key = walk(a, e, f_in, -1, k_w, f_w)
        keys[s0:e], spec_free[s0:e] = k_w[s0:e], f_w[s0:e]
        warm_free.append(f_w[a:s0] if a < s0 else np.zeros(0, bool))
        exits.append((F, key))
    trusted = [a == halo or bool((warm_free[g] & spec_free[a:s0]).any())
               for g, ((s0, _), a) in enumerate(zip(seg, start))]

    # the in-order fix-up
    stats = [trusted.count(False), 0, 0]
    scratch = np.zeros(total, bool)
    g = next((g for g in range(G) if not trusted[g]), G)
    if g < G:
        i, (F, key) = seg[g][0], exits[g - 1]
        while i < total:
            stats[1] += 1
            j, F, key = walk(i, total, F, key, keys, scratch, stop=spec_free)
            stats[2] += j - i
            if j == total:
                break
            o = j // S
            (F, key), i = exits[o], seg[o][1]
            g = o + 1
            while g < G and trusted[g] and start[g] >= j:
                (F, key), i = exits[g], seg[g][1]
                g += 1

    # epilogue: keys to thresholds, the mask and the run sums
    frozen_thr = np.where(keys >= 0, windowed[np.maximum(keys, 0)], np.float32(thr_in))
    thr = np.where(in_fixed, np.float32(fixed_thr), frozen_thr).astype(np.float32)
    above = valid & (d > thr)
    starts = above & ~np.concatenate([[False], above[:-1]])
    s_incl = np.cumsum(starts).astype(np.int32)
    csm = torch.cumsum(torch.where(torch.from_numpy(above), torch.from_numpy(d), 0.0), 0).numpy()
    return thr[halo:], above[halo:], s_incl[halo:], csm[halo:], stats


def run_case(d, S, halo=0, i0=0, freeze_in=-1, thr_shift=0.0, k=4.0, window=100, fb=3, fa=10,
             fixed=20):
    """The model and the twin on one chunk; asserts they agree bit for bit
    and returns (twin's above mask, the model's fix-up stats)."""
    dt = torch.from_numpy(d)
    fixed_thr = dt.mean() + k * dt.std(correction=0)
    thr_in = (fixed_thr + thr_shift).float()
    carry_i = torch.tensor([i0, freeze_in], dtype=torch.int32)
    carry_f = torch.stack([fixed_thr, thr_in]).float()
    want = tak.adaptive_solver_plain(dt, carry_i, carry_f, halo, k, window, fb, fa, fixed,
                                     d.shape[0])
    windowed = tak.windowed_threshold(dt, i0, halo, k, window).numpy()
    *got, stats = walk_model(d, windowed, halo, i0, freeze_in, np.float32(carry_f[0]),
                             np.float32(carry_f[1]), fb, fa, fixed, S)
    thr_w, ab_w, s_w, c_w = (x.numpy() for x in want)
    np.testing.assert_array_equal(got[0].view(np.int32), thr_w.view(np.int32))
    np.testing.assert_array_equal(got[1], ab_w)
    np.testing.assert_array_equal(got[2], s_w)
    np.testing.assert_array_equal(got[3].view(np.int32), c_w.view(np.int32))
    return ab_w, stats


def sequential_above(d, k, window, fb, fa, fixed):
    """The JAX package's sequential recurrence over a whole series."""
    _, above = jad.adaptive_thresholds_fast(jnp.asarray(d), k, window, fb, fa, fixed)
    return np.asarray(above)


@pytest.mark.parametrize("S", [64, 128, 256])
def test_fresh_series_needs_no_fixup(S):
    """A whole series at the main path's shape of parameters: every seam's
    speculation agrees with its predecessor's, so nothing is re-walked."""
    d = series(3000, 1)
    above, stats = run_case(d, S, **BASE)
    assert stats == [0, 0, 0]
    np.testing.assert_array_equal(above, sequential_above(d, **BASE))


@pytest.mark.parametrize(
    "label,n,kw",
    [
        ("k1.5", 3000, dict(k=1.5, fa=40)),
        ("k1", 3000, dict(k=1.0, fa=40)),
        ("k1.5_short_freeze", 3000, dict(k=1.5)),
        ("fixed0_never_lifts", 3000, dict(fixed=0)),
        ("fa_past_lead_and_segment", 3000, dict(fa=300)),
        ("ragged_total", 2999, {}),
        ("below_one_segment", 100, dict(window=30)),
        ("fixed_region_past_segments", 3000, dict(fixed=400)),
        ("no_freeze", 3000, dict(fb=0, fa=0)),
    ],
)
def test_whole_series_cases(label, n, kw):
    kw = {**BASE, **kw}
    d = series(n, 2)
    if label == "fixed0_never_lifts":
        d[0] = abs(d[0]) + 5.0  # above block 0's zero threshold: a freeze at 0 dB
    above, stats = run_case(d, 128, **kw)
    np.testing.assert_array_equal(above, sequential_above(d, **kw))
    if label in ("k1.5", "k1", "fixed0_never_lifts", "fa_past_lead_and_segment"):
        assert stats[0] > 0 and stats[2] > 0  # the fix-up re-walked
    if label == "fixed0_never_lifts":
        assert above[1:].mean() > 0.3 and stats[2] > 0.8 * n  # one freeze, walked whole


def test_episode_straddling_seams():
    """Bursts that open a freeze a few blocks before a seam and run over it."""
    d = series(3000, 3, every=400)
    for s0 in range(128, 3000, 384):
        d[s0 - 3 : s0 + 2] += 60.0
    above, stats = run_case(d, 128, **BASE)
    np.testing.assert_array_equal(above, sequential_above(d, **BASE))
    assert all(above[s0 - 3 : s0 + 2].all() for s0 in range(128, 3000, 384))


@pytest.mark.parametrize(
    "label,freeze_after_i0,thr_shift,kw",
    [
        ("fresh_carry", -1, 0.0, {}),
        ("frozen_40_blocks", 40, 1.5, {}),
        ("freeze_past_segments", 4 * 128 + 17, -2.0, {}),
        ("low_threshold_past_segments", 6 * 128, -30.0, {}),
        ("window_past_segment", 40, 1.5, dict(window=300)),
        ("k1.5", 40, 1.5, dict(k=1.5)),
    ],
)
def test_haloed_chunk(label, freeze_after_i0, thr_shift, kw):
    """A later chunk: W history blocks, i0 past the first chunk, the freeze
    horizon and the threshold carried in."""
    kw = {**BASE, **kw}
    d = series(3000 + kw["window"], 4)
    i0 = 5000
    freeze_in = -1 if freeze_after_i0 < 0 else i0 + freeze_after_i0
    _, stats = run_case(d, 128, halo=kw["window"], i0=i0, freeze_in=freeze_in,
                        thr_shift=thr_shift, **kw)
    if label in ("freeze_past_segments", "low_threshold_past_segments"):
        assert stats[0] > 0  # segments inside the carried freeze speculated wrongly


def test_haloed_chunk_below_one_segment():
    d = series(150, 5)
    run_case(d, 128, halo=50, i0=9000, freeze_in=9010, thr_shift=1.0, **dict(BASE, window=50))


def test_chunked_walk_equals_whole_series():
    """Two chunks solved by the model, the second with the first's carries,
    give the whole series' above mask (the chunked path's contract)."""
    d = series(2400, 6)
    w, c0 = BASE["window"], 1200
    dt = torch.from_numpy(d)
    k, fb, fa, fixed = BASE["k"], BASE["fb"], BASE["fa"], BASE["fixed"]
    fixed_thr = np.float32(dt.mean() + k * dt.std(correction=0))
    first = walk_model(d[:c0], tak.windowed_threshold(dt[:c0], 0, 0, k, w).numpy(), 0, 0, -1,
                       fixed_thr, fixed_thr, fb, fa, fixed, 128)
    ii = np.arange(c0)
    freeze = int(np.where(first[1], np.maximum(ii + fa, np.maximum(ii - fb, 0)), -1).max())
    chunk = d[c0 - w :]
    second = walk_model(chunk, tak.windowed_threshold(torch.from_numpy(chunk), c0, w, k, w).numpy(),
                        w, c0, freeze, fixed_thr, first[0][-1], fb, fa, fixed, 128)
    np.testing.assert_array_equal(np.concatenate([first[1], second[1]]),
                                  sequential_above(d, k, w, fb, fa, fixed))
