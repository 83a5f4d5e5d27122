"""Spectrogram-domain burst detector + classifier — the "ML path".

Counterpart of `meteor_scatter_tpu/models/image.py` (reference: the deployed
24/7 pipeline `meteor_detect_class/`, `prime_detection.py:61-98` and
`detector_and_classification.py:7-88`).  The same decision process runs on
the dB spectrogram array on the device:

1. the reference's noise-floor cut is the detection threshold: pixels with
   dB above the display vmin inside the 800-1200 Hz display band are the
   "keypoints" (or Harris corners, the ORB-like mode);
2. DBSCAN runs exactly at pixel resolution: the core rule counts L2
   eps-neighbours with one elliptical-stencil convolution, clusters are
   labelled by pointer-jumping min-propagation over the core graph whose
   per-round neighbourhood is the whole eps ellipse, and border keypoints
   join a core's cluster within exact L2 reach;
3. a cluster is critical when its bounding box lasts ≥ 0.5 s (5 reference
   px at 496 px ↔ 25 s).

Every function takes an optional leading segment axis: ``audio`` (S, n)
gives images (S, n_bins, n_frames) and (S, cap) cluster buffers, each
segment as a single call gives it.  The reference's ``lax.while_loop``s
are host loops with one change test a round over all segments (a segment
that has converged is a fixpoint of the round, so further rounds leave it
as it is); :data:`label_rounds` holds the rounds of the last call of each
loop.  The eps ellipse's min is taken as a union of centred rectangles,
one ``max_pool2d`` each on the negated labels (exact: labels stay below
2^24, and the centre pixel always lies inside the window, so the padding
never wins).

Equivalence with the reference is judged at the event/count level — ORB
internals are not reproducible, the hourly Anzahl/Kritisch counts are.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from meteor_scatter_tpu_torch.device import constant_on
from meteor_scatter_tpu_torch.ops.spectrogram import spectrogram_mpl
from meteor_scatter_tpu_torch.utils.timing import span, wait

# Reference rendering scale (detector_and_classification.py:73-78)
_REF_PX_PER_SEC = 496.0 / 25.0
_REF_PX_PER_HZ = 365.0 / 400.0

_INT32_MAX = 2**31 - 1
_INT32_MIN = -(2**31)

# Rounds run by the last call of each label-propagation loop (the
# reference's while_loop trip counts), read by measurement scripts.
label_rounds = {"connected_components": 0, "cluster_core_labels": 0}


class SpectrogramImage(NamedTuple):
    """Device-side equivalent of the rendered spectrogram JPEG."""

    db: torch.Tensor  # (..., n_bins, n_frames) dB, display band only
    vmin: torch.Tensor  # (...) noise-floor derived display cut
    freqs: np.ndarray  # (n_bins,) Hz
    hop_sec: float  # seconds per time pixel
    hz_per_bin: float


class ImageBursts(NamedTuple):
    """Fixed-capacity cluster buffer (rows < count valid)."""

    t_min: torch.Tensor  # frame index of bbox left edge
    t_max: torch.Tensor
    f_min: torch.Tensor  # bin index of bbox bottom edge
    f_max: torch.Tensor
    n_points: torch.Tensor  # member pixels (pre-dilation)
    critical: torch.Tensor  # bool
    count: torch.Tensor
    n_critical: torch.Tensor
    n_non_critical: torch.Tensor
    # clusters beyond the cap were routed to the drop bucket: counts are
    # lower bounds when set
    overflow: torch.Tensor


def spectrogram_image(
    audio: torch.Tensor,
    fs: float,
    n_fft: int = 2048,
    spec_cut_factor: float = 8.0,
    noise_floor_band: Tuple[float, float] = (250.0, 800.0),
    display_band: Tuple[float, float] = (800.0, 1200.0),
) -> SpectrogramImage:
    """Reproduce `plot_spectrogram` (prime_detection.py:61-98) as arrays:
    mpl-specgram PSD, noise-floor power density from the quiet band, and
    the display cut vmin = density_db/(40/23) + cut_factor."""
    freqs, times, pxx = spectrogram_mpl(audio, fs, n_fft, noverlap=n_fft // 2)
    delta_f = fs / n_fft

    nb = (freqs >= noise_floor_band[0]) & (freqs <= noise_floor_band[1])
    bandwidth = float(nb.sum()) * delta_f
    nb_idx = constant_on(np.nonzero(nb)[0], pxx.device)
    # summed over freq AND time (:76)
    band_power = pxx.index_select(-2, nb_idx).sum(dim=(-2, -1))
    power_density_db_hz = 10.0 * torch.log10(band_power / bandwidth)
    vmin = power_density_db_hz / (40.0 / 23.0) + spec_cut_factor

    db_mask = np.nonzero((freqs >= display_band[0]) & (freqs <= display_band[1]))[0]
    pxx_db = 10.0 * torch.log10(pxx.index_select(-2, constant_on(db_mask, pxx.device)))

    return SpectrogramImage(
        db=pxx_db,
        vmin=vmin,
        freqs=freqs[db_mask],
        hop_sec=(n_fft // 2) / fs,
        hz_per_bin=delta_f,
    )


def _jump(lab: torch.Tensor, hw: int) -> torch.Tensor:
    """Three pointer jumps ``l = l[l]`` through each segment's own label
    table, with the background label ``hw`` as a sentinel at index hw."""
    lead = lab.shape[:-2]
    flat = lab.reshape(lead + (hw,))
    flat = torch.cat([flat, flat.new_full(lead + (1,), hw)], dim=-1)
    for _ in range(3):  # 3 jumps per round: path length 8x
        flat = flat.gather(-1, flat)
    return flat[..., :-1].reshape(lab.shape)


def _pool_max(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """SAME-padded (kh, kw) max over an (..., h, w) float image (implicit
    -inf padding)."""
    h, w = x.shape[-2:]
    y = F.max_pool2d(x.reshape(-1, 1, h, w), (kh, kw), stride=1, padding=(kh // 2, kw // 2))
    return y.reshape(x.shape)


def _connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Label 8-connected components of an (..., h, w) bool mask.

    Pointer-jumping min-propagation: every pixel starts with its own id,
    alternately takes the min over its 3×3 neighbourhood (within the mask)
    and jumps through the label table (``l = l[l]``), until stable.
    Returns int32 labels, HW (=out of range) on background pixels."""
    h, w = mask.shape[-2:]
    hw = h * w
    ids = torch.arange(hw, device=mask.device).reshape(h, w)
    labels = torch.where(mask, ids, hw)

    def neighbor_min(lab):
        best = -_pool_max(-lab.to(torch.float32), 3, 3)
        return torch.where(mask, best.to(torch.int64), hw)

    rounds, changed = 0, True
    while changed:
        new = _jump(neighbor_min(labels), hw)
        with wait("label_round"):
            changed = bool((new != labels).any())
        labels = new
        rounds += 1
    label_rounds["connected_components"] = rounds
    return labels.to(torch.int32)


def _ellipse_spans(radius_px: float, px_f: float, px_t: float):
    """Row decomposition of :func:`_ellipse_kernel`: for each row offset dy,
    the half-width wx(dy) of the ellipse row (static host-side ints)."""
    ry = int(math.floor(radius_px / px_f))
    spans = []
    for dy in range(-ry, ry + 1):
        # +1e-9 admits offsets at distance exactly eps despite FP rounding
        # (DBSCAN's ≤-eps rule); the kernel inherits it via _ellipse_kernel
        rem = radius_px * radius_px + 1e-9 - (dy * px_f) ** 2
        if rem < 0:
            continue
        spans.append((dy, int(math.floor(math.sqrt(rem) / px_t))))
    return spans


def _ellipse_rects(spans):
    """The ellipse of ``spans`` as a union of centred rectangles: for each
    distinct half-width wx, (ry, wx) with ry the largest |dy| whose row
    reaches wx.  Exact because wx(dy) does not grow with |dy|."""
    return [(max(abs(dy) for dy, w in spans if w >= wx), wx)
            for wx in sorted({w for _, w in spans})]


def _ellipse_max(x: torch.Tensor, spans) -> torch.Tensor:
    """Max over the eps ellipse of an (..., h, w) float image: one
    ``max_pool2d`` per rectangle of :func:`_ellipse_rects`."""
    best = None
    for ry, wx in _ellipse_rects(spans):
        m = _pool_max(x, 2 * ry + 1, 2 * wx + 1)
        best = m if best is None else torch.maximum(best, m)
    return best


def _ellipse_min(lab: torch.Tensor, spans, big: int) -> torch.Tensor:
    """Min over the L2 eps-ellipse neighbourhood of every pixel — one exact
    adjacency step of the DBSCAN core graph.  The reference pads with
    ``big``; here every window holds its centre pixel (≤ big), so padding
    never decides the min and the implicit padding of the pools gives the
    same values.  Integer labels pass through float32 exactly (< 2^24)."""
    del big  # see above: the centre pixel bounds every window's min
    return (-_ellipse_max(-lab.to(torch.float32), spans)).to(lab.dtype)


def _cluster_core_labels(core: torch.Tensor, spans) -> torch.Tensor:
    """Label the connected components of ``core`` pixels under L2
    eps-adjacency (the DBSCAN core graph) — min-propagation like
    :func:`_connected_components` but each round's neighbourhood is the
    whole eps ellipse, so convergence takes a handful of rounds.  Returns
    int32 labels, HW on non-core pixels."""
    h, w = core.shape[-2:]
    hw = h * w
    ids = torch.arange(hw, device=core.device).reshape(h, w)
    labels = torch.where(core, ids, hw)

    def step(lab):
        best = _ellipse_min(lab, spans, hw)
        return torch.where(core, torch.minimum(lab, best), hw)

    rounds, changed = 0, True
    while changed:
        new = _jump(step(labels), hw)
        with wait("label_round"):
            changed = bool((new != labels).any())
        labels = new
        rounds += 1
    label_rounds["cluster_core_labels"] = rounds
    return labels.to(torch.int32)


def render_intensity(img: SpectrogramImage, vmax: float = 40.0) -> torch.Tensor:
    """The grayscale image the reference detector actually sees: dB clipped
    to [vmin, vmax] (the display window of prime_detection.py:84-85) and
    scaled to 0..255."""
    vmin = img.vmin[..., None, None]
    x = torch.clamp(torch.maximum(img.db, vmin), max=vmax)
    return (x - vmin) / torch.clamp(vmax - vmin, min=1e-6) * 255.0


def corner_keypoints(
    img: SpectrogramImage,
    nfeatures: int = 500,
    k: float = 0.04,
    rel_floor: float = 1e-5,
) -> torch.Tensor:
    """Corner-score keypoint mask — the ORB-like mode.

    The Harris response on the rendered-intensity array with Sobel
    gradients + 3×3 structure-tensor smoothing, gated to visible pixels,
    capped at the strongest ``nfeatures`` via top-k as ORB's retention
    rule.  Returns a bool mask shaped like ``img.db``; feed it to
    :func:`cluster_bursts` as ``keypoint_mask``."""
    gray = render_intensity(img)
    h, w = gray.shape[-2:]

    def conv2(x, kern):
        # cross-correlation with SAME padding, as XLA's conv_general_dilated
        kt = constant_on(np.asarray(kern, dtype=np.float32), x.device)[None, None]
        return F.conv2d(x.reshape(-1, 1, h, w), kt, padding=1).reshape(x.shape)

    sobel_x = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
    sobel_y = [[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]]
    ix = conv2(gray, sobel_x)
    iy = conv2(gray, sobel_y)
    box = [[1.0 / 9.0] * 3] * 3
    sxx = conv2(ix * ix, box)
    syy = conv2(iy * iy, box)
    sxy = conv2(ix * iy, box)
    r = (sxx * syy - sxy * sxy) - k * (sxx + syy) ** 2

    # no non-max suppression, corners gated to visible pixels (see the
    # reference's note at models/image.py:273-281)
    r_max = r.amax(dim=(-2, -1), keepdim=True)
    is_peak = (r > rel_floor * r_max) & (r > 0) & (gray > 0)

    # ORB retention: strongest nfeatures only (fixed shape via top-k)
    lead = r.shape[:-2]
    scores = torch.where(is_peak, r, -math.inf).reshape(lead + (h * w,))
    nf = min(nfeatures, h * w)
    top_vals, top_idx = torch.topk(scores, nf, dim=-1)
    keep = torch.zeros(lead + (h * w,), dtype=torch.bool, device=r.device)
    keep = keep.scatter(-1, top_idx, top_vals > -math.inf)
    return keep.reshape(lead + (h, w))


def _ellipse_kernel(radius_px: float, px_f: float, px_t: float) -> np.ndarray:
    """Bool stencil of grid offsets within ``radius_px`` in the reference's
    rendered-pixel metric: (dy·px_f)² + (dx·px_t)² ≤ r².  Derived from
    :func:`_ellipse_spans` so the core-counting neighbourhood and the
    adjacency/border neighbourhood are the same set of offsets."""
    spans = _ellipse_spans(radius_px, px_f, px_t)
    ry = max(abs(dy) for dy, _ in spans)
    rx = max(wx for _, wx in spans)
    k = np.zeros((2 * ry + 1, 2 * rx + 1), dtype=bool)
    for dy, wx in spans:
        k[dy + ry, rx - wx : rx + wx + 1] = True
    return k


def _conv_count(x: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """SAME-padded 2-D cross-correlation of an (..., h, w) image with a
    static 0/1 stencil (neighbour counting).  Exact in float32: every sum
    is an integer below 2^24, whatever order the library sums in."""
    h, w = x.shape[-2:]
    kt = constant_on(kern.astype(np.float32), x.device)[None, None]
    kh, kw = kern.shape
    y = F.conv2d(x.to(torch.float32).reshape(-1, 1, h, w), kt, padding=(kh // 2, kw // 2))
    return y.reshape(x.shape)


def _segment_reduce(values, seg, n: int, how: str, identity: int) -> torch.Tensor:
    """``jax.ops.segment_{min,max}`` over the last axis into ``n`` slots:
    an empty slot keeps the int32 identity."""
    out = torch.full(values.shape[:-1] + (n,), identity, dtype=torch.int32, device=values.device)
    return out.scatter_reduce_(-1, seg, values, how, include_self=True)


def cluster_bursts(
    img: SpectrogramImage,
    eps_px: float = 30.0,
    min_samples: int = 5,
    critical_min_width_px: float = 5.0,
    cap: int = 64,
    keypoint_mask: torch.Tensor | None = None,
    core_gate: bool = True,
) -> ImageBursts:
    """DBSCAN-equivalent clustering of above-cut spectrogram pixels with the
    reference's pixel-calibrated eps / width thresholds.

    ``keypoint_mask`` overrides the default threshold keypoints (e.g. the
    corner-score mask from :func:`corner_keypoints`).  ``core_gate=True``
    applies the published DBSCAN semantics at pixel resolution (a keypoint
    is core iff ≥ ``min_samples`` keypoints lie within the L2 eps ellipse;
    clusters are core components under eps-adjacency; border keypoints join
    the lowest-id cluster within reach, others are noise).
    ``core_gate=False`` keeps the legacy box dilation + post-hoc
    ``min_samples`` formulation."""
    if keypoint_mask is None:
        with span("keypoints"):
            mask = img.db > img.vmin[..., None, None]  # pixels visible after the cut
    else:
        mask = keypoint_mask
    lead = mask.shape[:-2]
    h, w = mask.shape[-2:]
    hw = h * w
    dev = mask.device

    # grid pixel sizes in the reference's rendered-pixel metric
    px_t = img.hop_sec * _REF_PX_PER_SEC
    px_f = img.hz_per_bin * _REF_PX_PER_HZ

    own = torch.arange(hw, dtype=torch.int32, device=dev)
    flat_mask = mask.reshape(lead + (hw,))
    if core_gate:
        spans = _ellipse_spans(eps_px, px_f, px_t)
        with span("core_count"):
            neigh = _conv_count(mask, _ellipse_kernel(eps_px, px_f, px_t))
            core = mask & (neigh >= min_samples - 0.5)
        with span("core_labels"):
            labels = _cluster_core_labels(core, spans)
        with span("border"):
            is_root, comp = _compact_ids(labels, own, cap)
            # border keypoints join the lowest-id cluster with a core inside
            # their exact L2 eps ellipse; the rest is DBSCAN noise
            comp2d = comp.reshape(lead + (h, w))
            core_comp = torch.where(core, comp2d, cap)
            near = _ellipse_min(core_comp, spans, cap)
            assign = torch.where(core, comp2d, near).reshape(lead + (hw,))
            member = flat_mask & (assign < cap)
            seg = torch.where(member, assign, cap)
    else:
        with span("components"):
            # legacy eps/2 box radii (the round-1..4 dilation window)
            eps_t_sec = (eps_px / 2.0) / _REF_PX_PER_SEC
            eps_f_hz = (eps_px / 2.0) / _REF_PX_PER_HZ
            rt = max(int(round(eps_t_sec / img.hop_sec)), 0)
            rf = max(int(round(eps_f_hz / img.hz_per_bin)), 0)
            dilated = _pool_max(mask.to(torch.float32), 2 * rf + 1, 2 * rt + 1) > 0
            labels = _connected_components(dilated)
            is_root, comp = _compact_ids(labels, own, cap)
            member = flat_mask
            seg = torch.where(member, comp, cap)
    with span("boxes"):
        seg = seg.to(torch.int64)
        n_points = torch.zeros(lead + (cap + 1,), dtype=torch.int32, device=dev).scatter_add_(
            -1, seg, member.to(torch.int32)
        )[..., :cap]

        fi = own // w
        ti = own % w
        t_min = _segment_reduce(torch.where(member, ti, w), seg, cap + 1, "amin",
                                _INT32_MAX)[..., :cap]
        t_max = _segment_reduce(torch.where(member, ti, -1), seg, cap + 1, "amax",
                                _INT32_MIN)[..., :cap]
        f_min = _segment_reduce(torch.where(member, fi, h), seg, cap + 1, "amin",
                                _INT32_MAX)[..., :cap]
        f_max = _segment_reduce(torch.where(member, fi, -1), seg, cap + 1, "amax",
                                _INT32_MIN)[..., :cap]

        # DBSCAN noise rule: under core gating a cluster is one core component
        # (≥ 1 member); the legacy path keeps the post-hoc size filter
        valid = n_points >= (1 if core_gate else min_samples)
        # critical: bbox duration >= 0.5 s (5 reference px), evaluated in seconds;
        # the empty slots' int32 identities wrap as in the reference
        min_dur_sec = critical_min_width_px / _REF_PX_PER_SEC
        width_sec = (t_max - t_min).to(torch.float32) * img.hop_sec
        critical = valid & (width_sec >= min_dur_sec)

        n_clusters = valid.sum(-1, dtype=torch.int32)
        n_crit = critical.sum(-1, dtype=torch.int32)
        # background carries label HW (never a root), so is_root counts exactly
        # the labelled components; any beyond cap landed in the drop bucket
        n_components_total = is_root.sum(-1, dtype=torch.int32)

        bursts = ImageBursts(
            t_min=t_min,
            t_max=t_max,
            f_min=f_min,
            f_max=f_max,
            n_points=torch.where(valid, n_points, 0),
            critical=critical,
            count=n_clusters,
            n_critical=n_crit,
            n_non_critical=n_clusters - n_crit,
            overflow=n_components_total > cap,
        )
    return bursts


def _compact_ids(labels: torch.Tensor, own: torch.Tensor, cap: int):
    """Compact cluster ids from root pixels: (is_root, the (..., hw)
    cluster id of every pixel, ``cap`` past the capacity and off the
    clusters)."""
    hw = own.shape[0]
    flat_lab = labels.reshape(labels.shape[:-2] + (hw,))
    is_root = flat_lab == own
    comp_at_root = torch.cumsum(is_root.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    root_table = torch.where(is_root, comp_at_root, cap).to(torch.int32)
    root_table = torch.cat([root_table, root_table.new_full(root_table.shape[:-1] + (1,), cap)],
                           dim=-1)
    comp = root_table.gather(-1, torch.clamp(flat_lab, max=hw).to(torch.int64))
    # clusters beyond capacity land in the drop bucket
    return is_root, torch.clamp(comp, max=cap)


def detect_and_cluster_bursts(
    audio: torch.Tensor,
    fs: float,
    n_fft: int = 2048,
    spec_cut_factor: float = 8.0,
    eps_px: float = 30.0,
    min_samples: int = 5,
    cap: int = 64,
    keypoint_mode: str = "threshold",
    core_gate: bool = True,
) -> Tuple[SpectrogramImage, ImageBursts]:
    """Segment-level entry point mirroring the reference call pair
    ``plot_spectrogram`` + ``detect_and_cluster_bursts``
    (prime_detection.py:179-189), on the device ``audio`` lies on.

    ``keypoint_mode``: "threshold" (default — above-cut pixels) or
    "corner" (Harris corner keypoints, the ORB-like mode)."""
    with span("spectrogram"):
        img = spectrogram_image(audio, fs, n_fft, spec_cut_factor)
    kp = None
    if keypoint_mode == "corner":
        with span("keypoints"):
            kp = corner_keypoints(img)
    bursts = cluster_bursts(
        img, eps_px=eps_px, min_samples=min_samples, cap=cap, keypoint_mask=kp,
        core_gate=core_gate,
    )
    return img, bursts
