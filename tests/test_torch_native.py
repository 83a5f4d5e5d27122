"""The port's native streaming-ingest runtime (``csrc/ms_native.cc`` through
``meteor_scatter_tpu_torch/io/native.py``) on the CPU: the cases of the JAX
package's ``tests/test_native.py`` against the port's module, and the port
held against the JAX runtime on the same WAVs.  Every comparison is exact.
"""

import ctypes
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from meteor_scatter_tpu.io import native as jnative
from meteor_scatter_tpu.io.wavio import write_wav
from meteor_scatter_tpu_torch.io import native as tnative
from meteor_scatter_tpu_torch.ops.kernels import _build


@pytest.fixture(scope="module", autouse=True)
def built():
    if not tnative.native_available():
        pytest.skip("no C++ toolchain")


def pcm(x):
    return x.astype(np.float32) / 32768.0


# --- the ring ------------------------------------------------------------------


def test_ring_push_pop_roundtrip():
    r = tnative.PcmRing(1 << 14)
    assert r.native
    data = (np.arange(1000) % 500 - 250).astype(np.int16)
    assert r.push(data) == 1000 and r.available() == 1000
    np.testing.assert_array_equal(r.pop(1000), pcm(data))
    assert r.available() == 0


def test_ring_wraparound():
    r = tnative.PcmRing(1024)
    data = np.random.default_rng(0).integers(-1000, 1000, 700).astype(np.int16)
    for _ in range(10):  # push/pop cycles crossing the wrap point
        assert r.push(data) == 700
        np.testing.assert_array_equal(r.pop(700), pcm(data))


@pytest.mark.parametrize("native", [True, False])
def test_ring_overflow_drops(native, monkeypatch):
    if not native:
        monkeypatch.setattr(tnative, "load_native", lambda: None)
    r = tnative.PcmRing(256)
    assert r.native == native
    assert r.push(np.ones(1000, np.int16)) == r.capacity == 256
    assert r.dropped() == 1000 - r.capacity


def test_ring_segment_contract():
    r = tnative.PcmRing(1 << 13)
    r.push(np.ones(4000, np.int16))
    assert r.pop_segment(5000) is None  # not enough yet
    r.push(np.ones(1000, np.int16))
    seg = r.pop_segment(5000)
    assert seg is not None and len(seg) == 5000


def test_ring_threaded_producer_consumer():
    r = tnative.PcmRing(1 << 15)
    total = 200_000
    src = (np.arange(total) % 32768 - 16384).astype(np.int16)
    got = []

    def producer():
        i = 0
        while i < total:
            i += r.push(src[i : i + 4096])

    def consumer():
        count = 0
        while count < total:
            out = r.pop(4096)
            if len(out):
                got.append(out)
                count += len(out)

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(np.concatenate(got), pcm(src))


# --- the WAV reader ------------------------------------------------------------


def write_extensible_pcm16(path, fs, x):
    """WAVE_FORMAT_EXTENSIBLE (0xFFFE) header around PCM16 data."""
    data = x.astype("<i2").tobytes()
    sub_guid = struct.pack("<H", 1) + b"\x00\x00" + bytes(
        [0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71]
    )
    fmt = struct.pack("<HHIIHH", 0xFFFE, 1, fs, fs * 2, 2, 16)
    fmt += struct.pack("<HHI", 22, 16, 0x4) + sub_guid
    riff = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    riff += b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


def wav_case(tmp_path, kind):
    """(path, fs, the samples the reader must give) for one WAV format."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / f"{kind}.wav")
    if kind == "int16":
        fs = 6000
        x = (np.sin(np.linspace(0, 300, fs * 3)) * 20000).astype(np.int16)
        write_wav(path, fs, x)
        return path, fs, pcm(x)
    if kind == "float32":
        fs = 4000
        x = np.sin(np.linspace(0, 80, fs)).astype(np.float32)
        write_wav(path, fs, x)
        return path, fs, x
    if kind == "extensible":
        fs = 4000
        x = (np.sin(np.linspace(0, 100, fs)) * 15000).astype(np.int16)
        write_extensible_pcm16(path, fs, x)
        return path, fs, pcm(x)
    fs = 4000  # stereo: the first channel
    st = np.stack([rng.integers(-2000, 2000, 200).astype(np.int16),
                   np.full(200, 7, np.int16)], axis=1)
    write_wav(path, fs, st)
    return path, fs, pcm(st[:, 0])


@pytest.mark.parametrize("kind", ["int16", "float32", "extensible", "stereo"])
def test_reader_formats_match_jax(tmp_path, kind):
    path, fs, want = wav_case(tmp_path, kind)
    outs = []
    for mod in (tnative, jnative):
        rd = mod.NativeWavReader(path)
        assert rd.native and rd.fs == fs and rd.n_frames == len(want)
        chunks = []
        while len(c := rd.read(4096)):
            chunks.append(c)
        rd.close()
        outs.append(np.concatenate(chunks))
    np.testing.assert_array_equal(outs[0], want)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_reader_unsupported_format_fails_open(tmp_path):
    """24-bit PCM (undecodable) must fail at open, not stream zeros."""
    fs = 4000
    data = bytes(300)
    fmt = struct.pack("<HHIIHH", 1, 1, fs, fs * 3, 3, 24)
    riff = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    riff += b"data" + struct.pack("<I", len(data)) + data
    p = tmp_path / "p24.wav"
    p.write_bytes(b"RIFF" + struct.pack("<I", len(riff)) + riff)
    with pytest.raises(IOError):
        tnative.NativeWavReader(str(p))


# --- the pump ------------------------------------------------------------------


def pump_wav(tmp_path, n=40_000, fs=4000, seed=0):
    x = (np.random.default_rng(seed).standard_normal(n) * 8000).astype(np.int16)
    p = str(tmp_path / f"pump{seed}.wav")
    write_wav(p, fs, x)
    return p, x


def drain(pump, ring, seg):
    out = []
    deadline = time.time() + 60
    while time.time() < deadline:
        got = ring.pop_segment(seg)
        if got is not None:
            out.append(got)
        elif not pump.running() and ring.available() < seg:
            break
        else:
            time.sleep(0.001)
    out.append(ring.pop(ring.available()))
    return np.concatenate(out)


@pytest.mark.parametrize("native", [True, False])
def test_pump_bit_exact_with_backpressure(tmp_path, native, monkeypatch):
    """The C++ pump, and the Python fallback that the JAX package pins as its
    twin: a ring far smaller than the file forces waits, never drops."""
    if not native:
        monkeypatch.setattr(tnative, "load_native", lambda: None)
    p, x = pump_wav(tmp_path, seed=3)
    ring = tnative.PcmRing(8192)
    pump = tnative.WavPump(p, ring, chunk_frames=4096)
    assert ring.native == pump.native == native
    got = drain(pump, ring, 2000)
    assert pump.frames_pushed() == len(x)
    assert ring.dropped() == 0, "pump overflow must be backpressure, not drops"
    np.testing.assert_array_equal(got, pcm(x))
    pump.stop()
    pump.stop()  # idempotent


def test_pump_early_stop_no_hang(tmp_path):
    p, _ = pump_wav(tmp_path, n=200_000)
    ring = tnative.PcmRing(4096)
    pump = tnative.WavPump(p, ring, chunk_frames=4096)
    ring.pop(2000)
    pump.stop()  # mid-stream, ring mostly full: must join promptly
    assert not pump.running()


def test_pump_paced(tmp_path):
    # 2 s of audio at 64x realtime -> >= ~31 ms wall
    p, x = pump_wav(tmp_path, n=8000)
    ring = tnative.PcmRing(1 << 14)
    t0 = time.monotonic()
    pump = tnative.WavPump(p, ring, chunk_frames=1024, pace_factor=64.0)
    got = drain(pump, ring, 1024)
    assert len(got) == len(x)
    assert time.monotonic() - t0 >= 0.02, "pacing had no effect"
    pump.stop()


def test_pump_ring_outlives_its_name(tmp_path):
    """The pump holds the ring: dropping the caller's name does not free the
    buffer under the C++ producer."""
    p, x = pump_wav(tmp_path, seed=5)
    ring = tnative.PcmRing(8192)
    pump = tnative.WavPump(p, ring, chunk_frames=4096)
    del ring
    ring = pump._ring
    np.testing.assert_array_equal(drain(pump, ring, 2000), pcm(x))
    pump.stop()


# --- against the JAX runtime, and where the port builds ------------------------


def test_pump_matches_jax(tmp_path):
    p, x = pump_wav(tmp_path, seed=7)
    outs = []
    for mod in (tnative, jnative):
        ring = mod.PcmRing(8192)
        pump = mod.WavPump(p, ring, chunk_frames=3000)
        assert pump.native
        outs.append(drain(pump, ring, 3000))
        pump.stop()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], pcm(x))


def test_library_built_from_port_source():
    lib = tnative.load_native()
    path = Path(lib._name)
    assert path == _build.library_path("ms_native")
    assert path.parent == _build.BUILD_DIR and path.parent.parts[-2:] == ("build", "torch_kernels")
    assert "native" not in path.parent.parts
    assert _build._source("ms_native") == _build.CSRC / "ms_native.cc"
    assert isinstance(lib, ctypes.CDLL) and lib.ms_ring_create.restype is ctypes.c_void_p


def test_failed_build_reports_once_and_falls_back(monkeypatch, capsys):
    def fail(name):
        raise RuntimeError(f"g++ failed building {name} (exit 1):\nerror: oops")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(_build, "load", fail)
    assert tnative.load_native() is None and tnative.load_native() is None
    err = capsys.readouterr().err
    assert err.count("g++ failed building ms_native") == 1 and "error: oops" in err
    assert not tnative.PcmRing(64).native


def test_build_native_and_load_without_auto_build(monkeypatch, tmp_path, capsys):
    """``build_native(quiet)`` and ``load_native(auto_build)`` take the
    reference's parameters; without a build, ``auto_build=False`` gives None
    and leaves a later call free to build."""
    import inspect

    for name in ("build_native", "load_native"):
        assert (list(inspect.signature(getattr(tnative, name)).parameters.items()) ==
                list(inspect.signature(getattr(jnative, name)).parameters.items())), name
    assert tnative.build_native() is True
    assert tnative.load_native(auto_build=False) is not None  # built: it loads

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(_build, "_libs", {})
    assert tnative.load_native(auto_build=False) is None and tnative._tried is False

    def no_compiler():
        raise RuntimeError("g++ not found: put a C++ compiler on PATH")

    monkeypatch.setattr(_build, "_gxx", no_compiler)
    assert tnative.build_native() is False and capsys.readouterr().err == ""
    assert tnative.build_native(quiet=False) is False
    assert "g++ not found" in capsys.readouterr().err
