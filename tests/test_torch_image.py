"""The image/cluster path of the PyTorch port against the JAX package and
the DBSCAN oracle, on the CPU.

Tolerances:

* spectrograms: rtol 1e-4 on the PSD and atol 1e-2 dB on ``10·log10`` (the
  frameworks' float32 FFTs round differently); frequencies and times equal;
* ``spectrogram_image``: ``vmin`` within 1e-4 dB (a float32 sum over the
  noise band and all frames, in another order), ``db`` within 1e-2 dB, the
  above-cut mask equal on these fixtures;
* ``cluster_bursts`` given the JAX image's arrays: every ``ImageBursts``
  field equal, empty slots' int32 identities included — integer-exact, no
  tolerance;
* from audio: ``count`` and ``n_critical`` equal (the reference judges this
  path at count level);
* against ``tests/oracles.py::oracle_dbscan``: counts equal, as in
  ``tests/test_image_path.py``.
"""

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

from meteor_scatter_tpu.models import image as jimg
from meteor_scatter_tpu.ops import spectrogram as jspec
from meteor_scatter_tpu_torch.models import image as timg
from meteor_scatter_tpu_torch.ops import spectrogram as tspec

from test_image_path import FS, _oracle_counts, segment_with_bursts

PSD_RTOL, DB_ATOL = 1e-4, 1e-2
VMIN_ATOL, IMG_DB_ATOL = 1e-4, 1e-2

# the fixtures of tests/test_image_path.py (bursts: start, length, Hz, amplitude)
FIXTURES = {
    "long_and_short": dict(bursts=[(5.0, 2.0, 1000.0, 3.0), (20.0, 0.4, 1100.0, 6.0)]),
    "empty": dict(bursts=[], noise=0.2, seed=3),
    "eps_merging": dict(bursts=[(10.0, 0.5, 1000.0, 3.0), (11.0, 0.5, 1000.0, 3.0)]),
    "eight_bursts": dict(bursts=[(2.0 + 3.0 * k, 0.4, 900.0 + 40.0 * k, 6.0) for k in range(8)]),
    "one_burst": dict(bursts=[(10.0, 2.0, 1000.0, 3.0)]),
}


def fixture_audio(name):
    return segment_with_bursts(**FIXTURES[name])


def jax_image(x):
    return jimg.spectrogram_image(jnp.asarray(x), FS)


def port_image_of(img_j):
    """The JAX image's arrays as a port ``SpectrogramImage``."""
    return timg.SpectrogramImage(
        db=torch.from_numpy(np.array(img_j.db)), vmin=torch.from_numpy(np.array(img_j.vmin)),
        freqs=img_j.freqs, hop_sec=img_j.hop_sec, hz_per_bin=img_j.hz_per_bin,
    )


def assert_bursts_equal(b_t, b_j, seg=None):
    """Every field equal in value and shape; the port's dtypes are the
    reference's without x64 (int32, bool) — JAX widens its counts' sums to
    int64 when a test module of the process has turned x64 on."""
    for f in timg.ImageBursts._fields:
        a = getattr(b_t, f)
        a = (a if seg is None else a[seg]).numpy()
        b = np.asarray(getattr(b_j, f))
        assert a.dtype == (np.bool_ if b.dtype == np.bool_ else np.int32), f
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# --- spectrograms ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["scipy", "mpl"])
def test_spectrograms_match_jax(mode):
    rng = np.random.default_rng(4)
    if mode == "scipy":  # tests/test_ops_spectral.py::test_matches_scipy
        fs, n, tone = 6000.0, 4096, 1003.0
        x = np.sin(2 * np.pi * tone * np.arange(int(fs * 4.0)) / fs) * 10 ** 0.5
        x = (x + rng.standard_normal(x.size)).astype(np.float32)
        got = tspec.spectrogram_scipy(torch.from_numpy(x), fs, n)
        want = jspec.spectrogram_scipy(jnp.asarray(x), fs, n)
    else:  # ::test_matches_matplotlib_specgram
        fs, n, tone = 5000.0, 2048, 1000.0
        x = np.sin(2 * np.pi * tone * np.arange(int(fs * 5.0)) / fs) * 10 ** 0.5
        x = (x + rng.standard_normal(x.size)).astype(np.float32)
        got = tspec.spectrogram_mpl(torch.from_numpy(x), fs, n, noverlap=n // 2)
        want = jspec.spectrogram_mpl(jnp.asarray(x), fs, n, noverlap=n // 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    s_t, s_j = got[2].numpy(), np.asarray(want[2])
    assert s_t.shape == s_j.shape and s_t.dtype == np.float32
    np.testing.assert_allclose(s_t, s_j, rtol=PSD_RTOL, atol=1e-30)
    db_t = tspec.spectrogram_db(got[2]).numpy()
    np.testing.assert_allclose(db_t, np.asarray(jspec.spectrogram_db(want[2])), atol=DB_ATOL)


def test_spectrogram_batch_rows_are_single_calls():
    x = np.random.default_rng(5).standard_normal((3, 20000)).astype(np.float32)
    _, _, s = tspec.spectrogram_mpl(torch.from_numpy(x), 5000.0, 2048, noverlap=1024)
    for i in range(3):
        _, _, s_i = tspec.spectrogram_mpl(torch.from_numpy(x[i]), 5000.0, 2048, noverlap=1024)
        torch.testing.assert_close(s[i], s_i, rtol=1e-6, atol=0)


# --- the image ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_spectrogram_image_matches_jax(name):
    x = fixture_audio(name)
    img_j = jax_image(x)
    img_t = timg.spectrogram_image(torch.from_numpy(x), FS)
    assert img_t.hop_sec == img_j.hop_sec and img_t.hz_per_bin == img_j.hz_per_bin
    np.testing.assert_array_equal(img_t.freqs, img_j.freqs)
    assert abs(float(img_t.vmin) - float(img_j.vmin)) <= VMIN_ATOL
    db_t, db_j = img_t.db.numpy(), np.asarray(img_j.db)
    assert db_t.shape == db_j.shape == (164, 145)
    np.testing.assert_allclose(db_t, db_j, atol=IMG_DB_ATOL)
    np.testing.assert_array_equal(db_t > float(img_t.vmin), db_j > float(img_j.vmin))
    g_t = timg.render_intensity(port_image_of(img_j)).numpy()
    np.testing.assert_allclose(g_t, np.asarray(jimg.render_intensity(img_j)), rtol=1e-6, atol=1e-4)


@pytest.fixture(scope="module")
def eight_burst_image():
    return jax_image(fixture_audio("eight_bursts"))


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(core_gate=False),
        dict(min_samples=1),
        dict(min_samples=1, cap=2),
        dict(min_samples=1, cap=2, core_gate=False),
        dict(keypoints="corner"),
    ],
    ids=["core_gate", "legacy", "min_samples_1", "cap2_overflow", "cap2_legacy", "corner_mask"],
)
def test_cluster_bursts_given_jax_image_matches_field_for_field(eight_burst_image, kw):
    img_j = eight_burst_image
    img_t = port_image_of(img_j)
    kw = dict(kw)
    if kw.pop("keypoints", None) == "corner":
        kp_j = jimg.corner_keypoints(img_j)
        kp_t = timg.corner_keypoints(img_t)
        np.testing.assert_array_equal(kp_t.numpy(), np.asarray(kp_j))
        kw["keypoint_mask"] = kp_t
        b_j = jimg.cluster_bursts(img_j, keypoint_mask=kp_j)
    else:
        b_j = jimg.cluster_bursts(img_j, **kw)
    b_t = timg.cluster_bursts(img_t, **kw)
    assert_bursts_equal(b_t, b_j)
    cap = kw.get("cap", 64)
    assert int(b_t.count) < cap or cap == 2
    if cap == 2:
        assert bool(b_t.overflow)
    # the slots past count keep the empty-segment identities
    n = int(b_t.count)
    if n < cap and kw.get("core_gate", True):
        assert (b_t.t_min[n:] == 2**31 - 1).all() and (b_t.f_max[n:] == -(2**31)).all()


@pytest.mark.parametrize("name", ["long_and_short", "empty", "eps_merging", "eight_bursts"])
@pytest.mark.parametrize("mode", ["threshold", "corner"])
def test_detect_and_cluster_counts_match_jax(name, mode):
    x = fixture_audio(name)
    _, b_j = jimg.detect_and_cluster_bursts(jnp.asarray(x), FS, keypoint_mode=mode)
    _, b_t = timg.detect_and_cluster_bursts(torch.from_numpy(x), FS, keypoint_mode=mode)
    for f in ("count", "n_critical", "n_non_critical", "overflow"):
        assert getattr(b_t, f).item() == np.asarray(getattr(b_j, f)).item(), f
    if name == "long_and_short" and mode == "threshold":
        assert (int(b_t.count), int(b_t.n_critical)) == (2, 1)


def test_batch_of_three_is_three_single_calls():
    x = np.stack([fixture_audio(n) for n in ("long_and_short", "empty", "eight_bursts")])
    for mode in ("threshold", "corner"):
        img_b, b_b = timg.detect_and_cluster_bursts(torch.from_numpy(x), FS, keypoint_mode=mode)
        assert img_b.db.shape == (3, 164, 145) and img_b.vmin.shape == (3,)
        for s in range(3):
            img_s, b_s = timg.detect_and_cluster_bursts(torch.from_numpy(x[s]), FS,
                                                        keypoint_mode=mode)
            torch.testing.assert_close(img_b.db[s], img_s.db, rtol=1e-6, atol=1e-5)
            for f in timg.ImageBursts._fields:
                assert torch.equal(getattr(b_b, f)[s], getattr(b_s, f)), (mode, s, f)


def test_label_rounds_recorded():
    x = fixture_audio("eight_bursts")
    timg.detect_and_cluster_bursts(torch.from_numpy(x), FS)
    assert timg.label_rounds["cluster_core_labels"] >= 2
    img = port_image_of(jax_image(x))
    timg.cluster_bursts(img, core_gate=False)
    assert timg.label_rounds["connected_components"] >= 2


# --- the label loops -----------------------------------------------------------


def test_connected_components_matches_scipy_and_jax():
    rng = np.random.default_rng(1)
    masks = rng.random((3, 40, 60)) < 0.25
    got = timg._connected_components(torch.from_numpy(masks)).numpy()
    assert got.dtype == np.int32
    for mask, lab in zip(masks, got):
        np.testing.assert_array_equal(lab, np.asarray(jimg._connected_components(jnp.asarray(mask))))
        want, n = scipy.ndimage.label(mask, structure=np.ones((3, 3)))
        assert (lab[~mask] == mask.size).all()
        pairs = set(zip(lab[mask].ravel(), want[mask].ravel()))
        assert len(pairs) == len({p[0] for p in pairs}) == len({p[1] for p in pairs}) == n


def test_ellipse_rects_cover_the_kernel_and_min_matches_jax():
    # the JAX min only where its reduce_windows compile fast (not 61 rows)
    for radius, px_f, px_t, vs_jax in ((30.0, 2.228, 4.063, True), (12.0, 1.0, 1.0, True),
                                       (30.0, 1.0, 1.0, False)):
        spans = timg._ellipse_spans(radius, px_f, px_t)
        assert spans == jimg._ellipse_spans(radius, px_f, px_t)
        kern = timg._ellipse_kernel(radius, px_f, px_t)
        ry, rx = kern.shape[0] // 2, kern.shape[1] // 2
        union = np.zeros_like(kern)
        for r, w in timg._ellipse_rects(spans):
            union[ry - r : ry + r + 1, rx - w : rx + w + 1] = True
        np.testing.assert_array_equal(union, kern)
        if not vs_jax:
            continue
        rng = np.random.default_rng(int(radius))
        lab = np.where(rng.random((50, 70)) < 0.1, rng.integers(0, 3500, (50, 70)), 3500)
        lab = lab.astype(np.int32)
        got = timg._ellipse_min(torch.from_numpy(lab), spans, 3500).numpy()
        np.testing.assert_array_equal(got, np.asarray(jimg._ellipse_min(jnp.asarray(lab), spans, 3500)))


# --- DBSCAN oracle (counts; no JAX) ----------------------------------------------


def unit_px_image(h, w):
    """Grid pixels of exactly 1×1 reference px (as test_image_path's)."""
    return timg.SpectrogramImage(
        db=torch.zeros((h, w)), vmin=torch.tensor(1.0),
        freqs=np.arange(h) / timg._REF_PX_PER_HZ,
        hop_sec=1.0 / timg._REF_PX_PER_SEC, hz_per_bin=1.0 / timg._REF_PX_PER_HZ,
    )


def ours(mask, **kw):
    b = timg.cluster_bursts(unit_px_image(*mask.shape), keypoint_mask=torch.from_numpy(mask), **kw)
    return int(b.count), int(b.n_critical)


def test_oracle_hand_made_divergence_cases():
    mask = np.zeros((80, 200), bool)
    mask[10:13, 10:18] = True
    mask[50:53, 150:153] = True
    assert ours(mask) == _oracle_counts(mask) == (2, 1)
    # the sparse bridge: DBSCAN keeps two clusters, the legacy box linking one
    mask = np.zeros((20, 120), bool)
    mask[10, 0:8] = True
    mask[8:13, 2:5] = True
    mask[10, 37] = True
    mask[10, 67:75] = True
    mask[8:13, 69:72] = True
    assert ours(mask)[0] == _oracle_counts(mask)[0] == 2
    assert ours(mask, core_gate=False)[0] == 1
    # the box-corner pair: L2 keeps them apart
    mask = np.zeros((80, 80), bool)
    mask[10:13, 10:13] = True
    mask[40:43, 40:43] = True
    assert ours(mask)[0] == _oracle_counts(mask)[0] == 2
    assert ours(mask, core_gate=False)[0] == 1


def fuzzed_clouds():
    rng = np.random.default_rng(42)
    out = []
    for _ in range(6):
        mask = np.zeros((60, 150), bool)
        n_pts = rng.integers(10, 60)
        mask[rng.integers(0, 60, n_pts), rng.integers(0, 150, n_pts)] = True
        for _ in range(rng.integers(1, 4)):
            r0, c0 = rng.integers(0, 55), rng.integers(0, 140)
            mask[r0 : r0 + rng.integers(2, 5), c0 : c0 + rng.integers(2, 9)] = True
        out.append((mask, 30.0, 5))
    rng = np.random.default_rng(1234)
    for _ in range(12):
        min_samples = int(rng.choice([2, 3, 5, 8]))
        eps = float(rng.choice([12.0, 20.0, 30.0]))
        mask = np.zeros((50, 120), bool)
        n_pts = rng.integers(15, 90)
        mask[rng.integers(0, 50, n_pts), rng.integers(0, 120, n_pts)] = True
        for _ in range(rng.integers(0, 3)):
            r0, c0 = rng.integers(0, 45), rng.integers(0, 110)
            mask[r0 : r0 + rng.integers(2, 6), c0 : c0 + rng.integers(2, 7)] = True
        out.append((mask, eps, min_samples))
    return out


FUZZED = fuzzed_clouds()


@pytest.mark.parametrize("trial", range(len(FUZZED)))
def test_fuzzed_clouds_match_oracle(trial):
    mask, eps, min_samples = FUZZED[trial]
    want = _oracle_counts(mask, eps=eps, min_samples=min_samples)
    assert ours(mask, eps_px=eps, min_samples=min_samples) == want


@pytest.mark.parametrize("seed,bursts", [
    (0, [(5.0, 2.0, 1000.0, 4.0), (20.0, 0.4, 1100.0, 6.0)]),
    (1, [(10.0, 1.0, 950.0, 3.0)]),
    (7, []),
])
def test_corner_keypoint_masks_match_oracle(seed, bursts):
    x = segment_with_bursts(bursts, seed=seed)
    img = timg.spectrogram_image(torch.from_numpy(x), FS)
    kp = timg.corner_keypoints(img).numpy()
    want = _oracle_counts(kp, px_f=img.hz_per_bin * timg._REF_PX_PER_HZ,
                          px_t=img.hop_sec * timg._REF_PX_PER_SEC)
    b = timg.cluster_bursts(img, keypoint_mask=torch.from_numpy(kp))
    assert (int(b.count), int(b.n_critical)) == want
