"""Dependency-free PNG writer + colormaps for spectrogram export.

The port's own copy of `meteor_scatter_tpu/io/png.py` (numpy only; the port
imports nothing of the JAX package), so both packages write the same bytes
from the same arrays.  The reference renders every spectrogram through
matplotlib (`prime_detection.py:61-98`, `processor.py:294-343`); here the
dB array is colorized with a viridis-style lookup and written as a
zlib-compressed PNG directly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# 17-anchor approximation of viridis (linear interpolation between rows).
_VIRIDIS = np.array(
    [
        [68, 1, 84], [71, 19, 101], [72, 36, 117], [70, 52, 128],
        [65, 68, 135], [59, 82, 139], [53, 95, 141], [47, 108, 142],
        [42, 120, 142], [37, 132, 142], [33, 145, 140], [30, 156, 137],
        [34, 168, 132], [47, 180, 124], [68, 191, 112], [94, 201, 98],
        [122, 209, 81],
    ],
    dtype=np.float64,
)
_VIRIDIS_TAIL = np.array(
    [[122, 209, 81], [155, 217, 60], [189, 223, 38], [223, 227, 24], [253, 231, 37]],
    dtype=np.float64,
)
_VIRIDIS_FULL = np.concatenate([_VIRIDIS, _VIRIDIS_TAIL[1:]], axis=0)

_GRAY = np.array([[0, 0, 0], [255, 255, 255]], dtype=np.float64)


def colorize(
    values: np.ndarray,
    vmin: float | None = None,
    vmax: float | None = None,
    cmap: str = "viridis",
) -> np.ndarray:
    """Map a 2-D float array to (H, W, 3) uint8 via a colormap, clipping to
    [vmin, vmax] like matplotlib's imshow vmin/vmax."""
    v = np.asarray(values, dtype=np.float64)
    finite = np.isfinite(v)
    if vmin is None:
        vmin = float(v[finite].min()) if finite.any() else 0.0
    if vmax is None:
        vmax = float(v[finite].max()) if finite.any() else 1.0
    if vmax <= vmin:
        vmax = vmin + 1.0
    x = np.clip((v - vmin) / (vmax - vmin), 0.0, 1.0)
    x = np.where(finite, x, 0.0)

    table = _VIRIDIS_FULL if cmap == "viridis" else _GRAY
    pos = x * (len(table) - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, len(table) - 1)
    frac = (pos - lo)[..., None]
    rgb = table[lo] * (1 - frac) + table[hi] * frac
    return rgb.astype(np.uint8)


def upscale_to(rgb: np.ndarray, min_w: int = 640, min_h: int = 320) -> np.ndarray:
    """Integer nearest-neighbor upscale so raw STFT-bin images (often only
    tens of pixels) become readable, without interpolation artifacts."""
    h, w = rgb.shape[:2]
    fy = max(1, int(np.ceil(min_h / h)))
    fx = max(1, int(np.ceil(min_w / w)))
    return np.repeat(np.repeat(rgb, fy, axis=0), fx, axis=1)


# Minimal 5x7 bitmap font (digits, lowercase, a little punctuation) so
# placeholder/label rendering stays dependency-free like the PNG writer.
_FONT = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11110 00001 00001 01110 00001 00001 11110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    "a": "00000 00000 01110 00001 01111 10001 01111",
    "b": "10000 10000 11110 10001 10001 10001 11110",
    "c": "00000 00000 01110 10000 10000 10001 01110",
    "d": "00001 00001 01111 10001 10001 10001 01111",
    "e": "00000 00000 01110 10001 11111 10000 01110",
    "f": "00110 01001 01000 11100 01000 01000 01000",
    "g": "00000 01111 10001 10001 01111 00001 01110",
    "h": "10000 10000 11110 10001 10001 10001 10001",
    "i": "00100 00000 01100 00100 00100 00100 01110",
    "j": "00010 00000 00110 00010 00010 10010 01100",
    "k": "10000 10000 10010 10100 11000 10100 10010",
    "l": "01100 00100 00100 00100 00100 00100 01110",
    "m": "00000 00000 11010 10101 10101 10101 10101",
    "n": "00000 00000 11110 10001 10001 10001 10001",
    "o": "00000 00000 01110 10001 10001 10001 01110",
    "p": "00000 11110 10001 10001 11110 10000 10000",
    "q": "00000 01111 10001 10001 01111 00001 00001",
    "r": "00000 00000 10110 11001 10000 10000 10000",
    "s": "00000 00000 01111 10000 01110 00001 11110",
    "t": "01000 01000 11100 01000 01000 01001 00110",
    "u": "00000 00000 10001 10001 10001 10011 01101",
    "v": "00000 00000 10001 10001 10001 01010 00100",
    "w": "00000 00000 10101 10101 10101 10101 01010",
    "x": "00000 00000 10001 01010 00100 01010 10001",
    "y": "00000 10001 10001 10001 01111 00001 01110",
    "z": "00000 00000 11111 00010 00100 01000 11111",
    ".": "00000 00000 00000 00000 00000 01100 01100",
    ",": "00000 00000 00000 00000 01100 00100 01000",
    ":": "00000 01100 01100 00000 01100 01100 00000",
    "-": "00000 00000 00000 11111 00000 00000 00000",
    "+": "00000 00100 00100 11111 00100 00100 00000",
    "/": "00001 00010 00010 00100 01000 01000 10000",
    "%": "11001 11010 00010 00100 01000 01011 10011",
    "(": "00010 00100 01000 01000 01000 00100 00010",
    ")": "01000 00100 00010 00010 00010 00100 01000",
    " ": "00000 00000 00000 00000 00000 00000 00000",
}


def render_text(text: str, scale: int = 2) -> np.ndarray:
    """Rasterize ``text`` with the built-in 5x7 font → (H, W) uint8 mask
    (255 = ink).  Unknown characters render as a filled box."""
    cols = []
    box = np.ones((7, 5), np.uint8)
    for ch in str(text).lower():
        rows = _FONT.get(ch)
        if rows is None:
            g = box
        else:
            g = np.array(
                [[c == "1" for c in row] for row in rows.split()], np.uint8
            )
        cols.append(g)
        cols.append(np.zeros((7, 1), np.uint8))  # 1-px letter spacing
    if not cols:
        cols = [np.zeros((7, 1), np.uint8)]
    img = np.concatenate(cols[:-1] if len(cols) > 1 else cols, axis=1) * 255
    if scale > 1:
        img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    return img


def stamp_text(rgb: np.ndarray, text: str, x: int, y: int, scale: int = 2,
               color=(255, 255, 255)) -> np.ndarray:
    """Blit ``text`` onto an (H, W, 3) uint8 image at (x, y), clipped to the
    image bounds.  Returns the modified array (in place)."""
    mask = render_text(text, scale)
    h, w = mask.shape
    H, W = rgb.shape[:2]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + h, H), min(x + w, W)
    if y1 <= y0 or x1 <= x0:
        return rgb
    sub = mask[y0 - y : y1 - y, x0 - x : x1 - x] > 0
    for c in range(3):
        ch = rgb[y0:y1, x0:x1, c]
        ch[sub] = color[c]
    return rgb


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an RGB PNG (filter 0, one IDAT)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    h, w, _ = rgb.shape

    raw = np.empty((h, 1 + w * 3), dtype=np.uint8)
    raw[:, 0] = 0  # filter type 0 per scanline
    raw[:, 1:] = rgb.reshape(h, w * 3)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    idat = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", ihdr))
        fh.write(chunk(b"IDAT", idat))
        fh.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read back a PNG written by :func:`write_png` (8-bit RGB, filter 0,
    single IDAT stream) → (H, W, 3) uint8.  Used by tests to assert on
    exported image content without an image library."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, w, h, idat = 8, 0, 0, b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bits, ctype = struct.unpack(">IIBB", payload[:10])
            assert bits == 8 and ctype == 2, "read_png only handles 8-bit RGB"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    assert (raw[:, 0] == 0).all(), "read_png only handles filter type 0"
    return raw[:, 1:].reshape(h, w, 3).copy()


def read_png_size(path: str) -> tuple[int, int]:
    """(width, height) from the IHDR — used by tests."""
    with open(path, "rb") as fh:
        fh.seek(16)
        w, h = struct.unpack(">II", fh.read(8))
    return w, h
