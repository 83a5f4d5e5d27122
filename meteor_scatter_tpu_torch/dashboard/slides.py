"""Static informational slides for the dashboard slideshow.

The reference slideshow cycles the dynamic charts *and* three static slides
(`templates/index.html:51-57` referencing `static/slides/Folie{1,2,3}.png`,
cycled by `static/js/script.js:103-189`).  Those are project-specific
artwork; here equivalent info cards are generated once at app startup with
the dependency-free PNG renderer (`io/png.py`), so deployments need no
binary assets in the repo and the slide slots still exist for operators to
overwrite with their own images (regeneration never clobbers an existing
file).

The port's copy of `meteor_scatter_tpu/dashboard/slides.py` (the port
imports nothing of the JAX package); it touches no device.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from meteor_scatter_tpu_torch.io.png import stamp_text, write_png

W, H = 960, 480
_BG = (18, 18, 28)
_ACCENT = (199, 36, 38)  # the reference UI's OHM red (styles.css:1-30)

# (title, lines) per slide — same informational role as the reference's
# Folie1-3 project cards.
SLIDE_CONTENT: List[Tuple[str, Sequence[str]]] = [
    (
        "meteor scatter detection",
        (
            "forward scatter radio echoes",
            "brams beacon 49.97 mhz",
            "tpu-native dsp pipeline",
        ),
    ),
    (
        "detection method",
        (
            "per-block fft band power vs noise band",
            "adaptive threshold: mean + 4 std",
            "freeze window around detections",
            "events: start, stop, duration, db",
        ),
    ),
    (
        "dashboard",
        (
            "gauge: yesterday hourly average",
            "day / week / month charts",
            "meteor shower calendar overlays",
            "missing days report",
        ),
    ),
]


def _render_slide(title: str, lines: Sequence[str]) -> np.ndarray:
    img = np.zeros((H, W, 3), np.uint8)
    img[:] = _BG
    img[36:44, 48 : W - 48] = _ACCENT  # accent rule under the header area
    stamp_text(img, title, 48, 64, scale=5, color=(240, 240, 240))
    y = 160
    for line in lines:
        stamp_text(img, line, 64, y, scale=3, color=(200, 200, 200))
        y += 56
    stamp_text(img, "meteor-scatter tpu", 48, H - 40, scale=2, color=(120, 120, 130))
    return img


def ensure_static_slides(static_dir: str) -> List[str]:
    """Create ``slides/Folie{1..3}.png`` under ``static_dir`` when absent.
    Returns the slide paths relative to the static root (the URLs the
    frontend cycles)."""
    slide_dir = os.path.join(static_dir, "slides")
    os.makedirs(slide_dir, exist_ok=True)
    rels = []
    for i, (title, lines) in enumerate(SLIDE_CONTENT, start=1):
        rel = f"slides/Folie{i}.png"
        path = os.path.join(slide_dir, f"Folie{i}.png")
        if not os.path.exists(path):  # operator-provided slides win
            write_png(path, _render_slide(title, lines))
        rels.append(rel)
    return rels
