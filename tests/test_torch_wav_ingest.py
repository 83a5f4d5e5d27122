"""The card's WAV ingest (``io/ingest.py``) against ``read_wav``, and the
analyzer's choice between it and the host read.

The piece loop (``StagingRing.fill``) is the same code on the CPU and on
the card: here it runs with a small unpinned ring into a host byte tensor,
so every case below (sample types, channels, chunk layouts, truncation,
frame ranges, pieces that split a sample) holds it to ``read_wav`` sample
for sample, or to the same error.  The tests marked ``cuda`` run the
pinned ring on the card, and ``proc_wav_file``'s card route against its
host route on the same file, bit for bit.  This file imports neither JAX
nor the JAX package; on a GPU machine, from the repo root::

    python -m pytest tests/test_torch_wav_ingest.py --noconftest -q
"""

import os
import struct

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meteor_scatter_tpu_torch.apps import analyze
from meteor_scatter_tpu_torch.io import ingest
from meteor_scatter_tpu_torch.io.wavio import read_wav, wav_layout, write_wav

GUID_TAIL = bytes([0x00, 0x00, 0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38,
                   0x9B, 0x71])


def chunk(cid: bytes, data: bytes) -> bytes:
    return cid + struct.pack("<I", len(data)) + data + b"\x00" * (len(data) & 1)


def write_riff(path, code, n_ch, bits, payload, declared=None, before=(), extensible=False,
               fs=4000):
    """A RIFF/WAVE file: ``fmt `` (WAVE_FORMAT_EXTENSIBLE around ``code``
    with ``extensible``), the ``before`` chunks, then a ``data`` chunk
    that declares ``declared`` bytes (default: the payload's) and holds
    ``payload``."""
    align = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else code, n_ch, fs, fs * align, align,
                      bits)
    if extensible:
        fmt += struct.pack("<HHIH", 22, bits, 0x4, code) + GUID_TAIL
    body = b"WAVE" + chunk(b"fmt ", fmt) + b"".join(chunk(c, d) for c, d in before)
    n = len(payload) if declared is None else declared
    body += b"data" + struct.pack("<I", n) + payload
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def make(kind, path):
    rng = np.random.default_rng(7)
    pcm16 = (rng.standard_normal(4000) * 3000).astype("<i2")
    if kind == "int16":
        write_wav(path, 4000, pcm16)
    elif kind == "float32":
        write_wav(path, 4000, rng.standard_normal(4000).astype(np.float32))
    elif kind == "stereo":
        write_wav(path, 4000, (rng.standard_normal((4000, 2)) * 3000).astype(np.int16))
    elif kind == "extensible":
        write_riff(path, 1, 1, 16, pcm16.tobytes(), extensible=True)
    elif kind == "odd_length":
        write_wav(path, 4000, pcm16[:3999])
    elif kind == "uint8":
        write_riff(path, 1, 1, 8, rng.integers(0, 256, 4001, dtype=np.uint8).tobytes())
    elif kind == "int32_3ch":
        x = rng.integers(-2**31, 2**31, (1500, 3), dtype=np.int64).astype("<i4")
        write_riff(path, 1, 3, 32, x.tobytes())
    elif kind == "float64_stereo_extensible":
        write_riff(path, 3, 2, 64, rng.standard_normal((700, 2)).astype("<f8").tobytes(),
                   extensible=True)
    elif kind == "list_chunk":
        write_riff(path, 1, 1, 16, pcm16.tobytes(),
                   before=[(b"LIST", b"INFOISFT\x05\x00\x00\x00gqrx\x00"), (b"junk", b"abc")])
    elif kind == "truncated":
        write_riff(path, 1, 1, 16, pcm16[:2500].tobytes(), declared=8000)
    elif kind == "long_misaligned":  # many pieces, the last one short
        x = (rng.standard_normal((50_003, 2)) * 3000).astype("<i2")
        write_riff(path, 1, 2, 16, x.tobytes())
    elif kind == "truncated_half_sample":
        write_riff(path, 1, 1, 16, pcm16.tobytes()[:4001], declared=8000)
    elif kind == "stereo_half_frame":
        write_riff(path, 1, 2, 16, pcm16[:3999].tobytes())
    elif kind == "no_data":
        write_riff(path, 1, 1, 16, b"")
        with open(path, "r+b") as fh:  # rename the data chunk
            raw = fh.read().replace(b"data", b"dat_")
            fh.seek(0)
            fh.write(raw)
    elif kind == "unsupported_bits":
        write_riff(path, 1, 1, 24, b"\x00" * 30)
    else:
        raise ValueError(kind)


KINDS = ["int16", "float32", "stereo", "extensible", "odd_length", "uint8", "int32_3ch",
         "float64_stereo_extensible", "list_chunk", "truncated", "long_misaligned"]
FAULTS = ["truncated_half_sample", "stereo_half_frame", "no_data", "unsupported_bits"]


def cpu_ring(piece, slots=3):
    return ingest.StagingRing(piece, slots, pin=False)


def outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the error itself is what is compared
        return "raised", (type(e), str(e))


@pytest.mark.parametrize("piece,slots", [(7, 2), (7, 5), (4096, 3)])
@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("kind", KINDS + FAULTS)
def test_piece_loop_equals_read_wav(tmp_path, kind, mono, piece, slots):
    """Pieces of 7 bytes split samples and frames; 4096 bytes leave a short
    last piece; one to four reads at once.  Equal samples and dtype, or the
    same error."""
    p = str(tmp_path / f"{kind}.wav")
    make(kind, p)
    want = outcome(lambda: read_wav(p, mono=mono))
    got = outcome(lambda: ingest.read_wav_to_device(p, torch.device("cpu"), mono,
                                                    ring=cpu_ring(piece, slots)))
    assert_same_outcome(got, want)


def assert_same_outcome(got, want):
    """``got``: an ``outcome`` of ``read_wav`` (numpy) or of
    ``read_wav_to_device`` (torch); ``want``: one of a ``read_wav``."""
    assert got[0] == want[0]
    if want[0] == "raised":
        assert got[1] == want[1]
        return
    (fs_w, x_w), (fs_g, x_g) = want[1], got[1]
    x_g = x_g.numpy() if isinstance(x_g, torch.Tensor) else x_g
    assert fs_g == fs_w
    assert x_g.dtype == x_w.dtype and x_g.shape == x_w.shape
    np.testing.assert_array_equal(x_g, x_w)


@pytest.mark.parametrize("span", [(None, None), (100, 2000), (-500, None), (3000, 100),
                                  (0, 10**9), (None, 1), (3999, None)])
@pytest.mark.parametrize("kind", ["int16", "stereo", "long_misaligned"])
def test_frame_range_equals_read_wav_slice(tmp_path, kind, span):
    p = str(tmp_path / f"{kind}.wav")
    make(kind, p)
    asked = []

    def cut(fs, n):
        asked.append((fs, n))
        return span

    for mono in (False, True):
        fs, whole = read_wav(p, mono=mono)
        want = whole[span[0]:span[1]]
        _, got = ingest.read_wav_to_device(p, torch.device("cpu"), mono, cut,
                                           ring=cpu_ring(1000))
        assert asked.pop() == (fs, len(whole))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_only_the_range_is_read(tmp_path):
    """A frame range reads its own bytes and no others."""
    p = str(tmp_path / "stereo.wav")
    make("stereo", p)
    reads = []

    class Counting(ingest.StagingRing):
        def fill(self, fd, offset, dst):
            reads.append((offset, len(dst)))
            return super().fill(fd, offset, dst)

    ingest.read_wav_to_device(p, torch.device("cpu"), True, lambda fs, n: (1000, 1500),
                              ring=Counting(64, 3, pin=False))
    with open(p, "rb") as fh:
        offset = wav_layout(fh, p).offset
    assert reads == [(offset + 1000 * 4, 500 * 4)]


@pytest.mark.parametrize("slots", [2, 5])
def test_fill_stops_at_the_end_of_the_file(tmp_path, slots):
    """A file shorter than the range (cut after its chunks were read) gives
    the bytes it has, as ``readinto`` does; a failed read raises."""
    p = tmp_path / "short.bin"
    p.write_bytes(bytes(range(256)) * 2)
    ring = cpu_ring(7, slots)
    dst = torch.zeros(2000, dtype=torch.uint8)
    with open(p, "rb") as fh:
        assert ring.fill(fh.fileno(), 100, dst) == 412
    assert dst[:412].tolist() == list((bytes(range(256)) * 2)[100:])
    assert not dst[412:].any()
    with pytest.raises(OSError):
        ring.fill(-1, 0, dst)


class Routed(Exception):
    pass


@pytest.mark.parametrize("device,export,route", [("cpu", False, "host"), ("cpu", True, "host"),
                                                 ("cuda", True, "host"), ("cuda", False, "card")])
def test_proc_wav_file_route(tmp_path, monkeypatch, device, export, route):
    """The card route only on a CUDA device and without the spectrogram
    export, which reads the samples on the host."""
    p = str(tmp_path / "a.wav")
    make("int16", p)
    taken = []

    def host(*a, **k):
        taken.append("host")
        raise Routed

    def card(*a, **k):
        taken.append("card")
        raise Routed

    monkeypatch.setattr(analyze, "resolve_device", torch.device)
    monkeypatch.setattr(analyze, "read_wav", host)
    monkeypatch.setattr(analyze, "read_wav_to_device", card)
    with pytest.raises(Routed):
        analyze.proc_wav_file(p, device=device, verbose=False, expected_sample_rate=None,
                              outfile_path=str(tmp_path / "spec") if export else None)
    assert taken == [route]


def test_proc_wav_file_routes_a_pipe_to_read_wav(tmp_path, monkeypatch):
    """A named pipe on a CUDA device goes to ``read_wav``, which reads a
    stream; the ingest reads regular files at offsets."""
    p = str(tmp_path / "a.wav")
    os.mkfifo(p)
    taken = []

    def route(name):
        def called(*a, **k):
            taken.append(name)
            raise Routed
        return called

    monkeypatch.setattr(analyze, "resolve_device", torch.device)
    monkeypatch.setattr(analyze, "read_wav", route("host"))
    monkeypatch.setattr(analyze, "read_wav_to_device", route("card"))
    with pytest.raises(Routed):
        analyze.proc_wav_file(p, device="cuda", verbose=False, expected_sample_rate=None)
    assert taken == ["host"]


def test_cpu_route_spans(tmp_path):
    """On the CPU the host route runs: ``read_wav`` holds no
    ``ingest_pinned`` span and the samples are freed in ``free_samples``."""
    p = str(tmp_path / "a.wav")
    rng = np.random.default_rng(3)
    write_wav(p, 6000, (rng.standard_normal(6000 * 30) * 3000).astype(np.int16))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        analyze.proc_wav_file(p, device="cpu", verbose=False)
    names = {e.name for e in prof.events()}
    assert {"ms.read_wav", "ms.upload", "ms.free_samples"} <= names
    assert "ms.ingest_pinned" not in names and "ms.wait.staging_slot" not in names


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned ring copies to the card")
    return torch.device("cuda")


def hour_file(path, seed, seconds=3600, fs=6000, n_ch=1):
    """``seconds`` of noise with a burst of the 1003 Hz tone every ~30 s,
    int16: the archive cell's file when an hour at 6 kHz (43.2 MB)."""
    rng = np.random.default_rng(seed)
    n = seconds * fs
    x = rng.standard_normal(n).astype(np.float32) * 300.0
    t = np.arange(fs * 2) / fs
    for s in rng.integers(0, n - fs * 2, size=seconds // 30):
        x[s : s + fs * 2] += 2000.0 * np.sin(2 * np.pi * 1003.0 * t).astype(np.float32)
    x = np.clip(x, -32768, 32767).astype(np.int16)
    write_wav(path, fs, np.stack([x] * n_ch, axis=1) if n_ch > 1 else x)


@pytest.mark.cuda
def test_card_ingest_equals_read_wav(cuda, tmp_path):
    """An hour through the pinned ring (more pieces than slots), twice
    over the same ring, a frame range, and a stereo file."""
    p = str(tmp_path / "hour.wav")
    hour_file(p, 1)
    _, want = read_wav(p, mono=True)
    assert want.nbytes > ingest.SLOTS * ingest.PIECE_BYTES  # more pieces than slots
    for _ in range(2):
        fs, got = ingest.read_wav_to_device(p, cuda)
        assert fs == 6000 and got.device.type == "cuda" and got.dtype == torch.int16
        assert torch.equal(got.cpu(), torch.from_numpy(want))
    _, got = ingest.read_wav_to_device(p, cuda, True, lambda fs, n: (12_345, 3_000_017))
    assert torch.equal(got.cpu(), torch.from_numpy(want[12_345:3_000_017]))
    q = str(tmp_path / "stereo.wav")
    hour_file(q, 2, seconds=600, n_ch=2)
    for mono in (False, True):
        _, got = ingest.read_wav_to_device(q, cuda, mono)
        assert torch.equal(got.cpu(), torch.from_numpy(np.ascontiguousarray(read_wav(q, mono)[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [(None, None), (61.3, 1799.9)])
def test_proc_wav_file_card_route_equals_host_route(cuda, tmp_path, cut):
    """The same int16 samples reach the same kernels: band power, delta,
    thresholds and detections equal bit for bit; one ``ingest_pinned``
    span a file on the card route, none on the host route (the spectrogram
    export's)."""
    p = str(tmp_path / "hour.wav")
    hour_file(p, 3)
    kw = dict(device=cuda, verbose=False, wav_start_sec=cut[0], wav_end_sec=cut[1])
    runs = []
    for spec in (None, str(tmp_path / "spec")):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            runs.append(analyze.proc_wav_file(p, outfile_path=spec, **kw))
        names = [e.name for e in prof.events()]
        assert names.count("ms.ingest_pinned") == (1 if spec is None else 0)
        assert names.count("ms.free_samples") == (0 if spec is None else 1)
    card, host = runs
    for f in ("band_power", "noise_power", "delta_power", "thresholds"):
        assert np.array_equal(getattr(card, f), getattr(host, f)), f
    assert len(card.detections) > 10
    assert [(d.t_start, d.t_stop, d.dB) for d in card.detections] == \
        [(d.t_start, d.t_stop, d.dB) for d in host.detections]
