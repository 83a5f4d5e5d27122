"""ctypes bindings for the native streaming-ingest runtime
(``csrc/ms_native.cc``): lock-free PCM ring buffer, chunked WAV reader and
the background WAV pump — the port's counterpart of
`meteor_scatter_tpu/io/native.py`, with the same classes and behaviour.

The library builds at first use with ``g++`` into ``build/torch_kernels/``
(``ops/kernels/_build.py``, keyed on a hash of the source and flags).
Every entry point keeps the JAX package's pure-Python fallback, so the
framework works without a toolchain; a failed build prints the compiler's
output once before the fallback is taken.
"""

from __future__ import annotations

import ctypes
import sys
import threading
import time
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_native(quiet: bool = True) -> bool:
    """Compile the library (``csrc/ms_native.cc`` with g++, unless a build of
    the same source is there); returns success.  ``quiet=False`` prints the
    compiler's output when the build fails."""
    from meteor_scatter_tpu_torch.ops.kernels import _build

    try:
        _build.build("ms_native")
        return True
    except (RuntimeError, OSError) as e:
        if not quiet:
            print(e, file=sys.stderr)
        return False


def load_native(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if necessary, unless ``auto_build`` is False) the native
    library, else None.  A failed build prints the compiler's output, once a
    process; without ``auto_build`` and without a build, None is returned
    and a later call may still build."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    from meteor_scatter_tpu_torch.ops.kernels import _build

    if not auto_build and not _build.library_path("ms_native").exists():
        return None
    _tried = True
    try:
        lib = _build.load("ms_native")
    except (RuntimeError, OSError) as e:
        # the numpy fallback keeps the framework working; say why it is taken
        print(f"io/native.py: the native runtime is unavailable, using the Python "
              f"fallback: {e}", file=sys.stderr)
        return None

    lib.ms_ring_create.restype = ctypes.c_void_p
    lib.ms_ring_create.argtypes = [ctypes.c_size_t]
    lib.ms_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ms_ring_capacity.restype = ctypes.c_size_t
    lib.ms_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.ms_ring_available.restype = ctypes.c_size_t
    lib.ms_ring_available.argtypes = [ctypes.c_void_p]
    lib.ms_ring_dropped.restype = ctypes.c_uint64
    lib.ms_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.ms_ring_push_i16.restype = ctypes.c_size_t
    lib.ms_ring_push_i16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.ms_ring_pop_f32.restype = ctypes.c_size_t
    lib.ms_ring_pop_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.ms_ring_pop_segment_f32.restype = ctypes.c_int
    lib.ms_ring_pop_segment_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]

    lib.ms_wav_open.restype = ctypes.c_void_p
    lib.ms_wav_open.argtypes = [ctypes.c_char_p]
    lib.ms_wav_info.restype = ctypes.c_int
    lib.ms_wav_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.ms_wav_read_f32.restype = ctypes.c_longlong
    lib.ms_wav_read_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    lib.ms_wav_close.argtypes = [ctypes.c_void_p]

    lib.ms_pump_start.restype = ctypes.c_void_p
    lib.ms_pump_start.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_double,
    ]
    lib.ms_pump_running.restype = ctypes.c_int
    lib.ms_pump_running.argtypes = [ctypes.c_void_p]
    lib.ms_pump_frames.restype = ctypes.c_longlong
    lib.ms_pump_frames.argtypes = [ctypes.c_void_p]
    lib.ms_pump_stop.argtypes = [ctypes.c_void_p]

    _lib = lib
    return lib


def native_available() -> bool:
    return load_native() is not None


class PcmRing:
    """SPSC ring: producer pushes int16, consumer pops float32 blocks.

    Falls back to a numpy ring when the native library is unavailable.
    """

    def __init__(self, capacity_samples: int):
        self._lib = load_native()
        self._dropped_py = 0
        if self._lib is not None:
            self._h = self._lib.ms_ring_create(capacity_samples)
            if not self._h:
                raise MemoryError("ms_ring_create failed")
            self._cap = self._lib.ms_ring_capacity(self._h)
        else:
            self._h = None
            self._cap = 1
            while self._cap < capacity_samples:
                self._cap *= 2
            self._buf = np.zeros(self._cap, np.int16)
            self._head = 0
            self._tail = 0

    @property
    def native(self) -> bool:
        return self._h is not None

    @property
    def capacity(self) -> int:
        return self._cap

    def available(self) -> int:
        if self._h is not None:
            return self._lib.ms_ring_available(self._h)
        return self._head - self._tail

    def dropped(self) -> int:
        if self._h is not None:
            return self._lib.ms_ring_dropped(self._h)
        return self._dropped_py

    def push(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, dtype=np.int16)
        if self._h is not None:
            return self._lib.ms_ring_push_i16(
                self._h, samples.ctypes.data_as(ctypes.c_void_p), len(samples)
            )
        free = self._cap - (self._head - self._tail)
        n = min(len(samples), free)
        idx = (self._head + np.arange(n)) % self._cap
        self._buf[idx] = samples[:n]
        self._head += n
        self._dropped_py += len(samples) - n
        return n

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        if self._h is not None:
            got = self._lib.ms_ring_pop_f32(self._h, out.ctypes.data_as(ctypes.c_void_p), n)
            return out[:got]
        avail = self._head - self._tail
        got = min(n, avail)
        idx = (self._tail + np.arange(got)) % self._cap
        res = self._buf[idx].astype(np.float32) / 32768.0
        self._tail += got
        return res

    def pop_segment(self, seg_samples: int) -> Optional[np.ndarray]:
        """Full segment or None — the monitor's fixed-length grab contract."""
        if self.available() < seg_samples:
            return None
        return self.pop(seg_samples)

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.ms_ring_destroy(self._h)
            self._h = None


class WavPump:
    """Background producer: streams a WAV into a :class:`PcmRing` on a
    dedicated thread (C++ ``std::thread`` when the native library is loaded,
    a Python thread otherwise), so the pipeline consumer overlaps file IO
    with device compute.

    A file producer is replayable, so a full ring applies *backpressure*
    (the pump waits for space) instead of dropping — ring drops remain the
    live-source overflow signal.  PCM16 WAVs round-trip bit-exactly
    through the ring's int16 domain; float32 WAVs quantize to 16 bits.

    ``pace_factor > 0`` throttles to that multiple of realtime (the
    monitor's 30 s-per-30 s deployment cadence at 1.0); 0 pumps as fast as
    the ring drains.
    """

    def __init__(self, path: str, ring: PcmRing, chunk_frames: int = 65536,
                 pace_factor: float = 0.0):
        self._lib = load_native()
        # strong ref: the pump must outlive-order the ring so __del__ joins
        # the producer (which pushes into ring._h) before PcmRing.__del__
        # can free the native buffer
        self._ring = ring
        self._h = None
        self._thread = None
        self._running = False
        self._stop = False
        self._frames = 0
        if self._lib is not None and ring.native:
            self._h = self._lib.ms_pump_start(
                path.encode(), ring._h, chunk_frames, float(pace_factor)
            )
            if not self._h:
                raise IOError(f"cannot start pump for {path}")
        else:
            self._running = True

            def _pump():
                try:
                    # inside the guard: a failed open (file vanished after
                    # the caller's probe) must still clear _running, or
                    # consumers polling running() spin forever
                    reader = NativeWavReader(path)
                except Exception:
                    self._running = False
                    raise
                fs = max(reader.fs, 1)
                t0 = time.monotonic()
                try:
                    while not self._stop:
                        data = reader.read(chunk_frames)
                        if len(data) == 0:
                            break
                        i16 = np.clip(
                            np.rint(data * 32768.0), -32768, 32767
                        ).astype(np.int16)
                        done = 0
                        while done < len(i16) and not self._stop:
                            # only offer what fits: a full-ring push counts
                            # the excess as dropped, and pump overflow is
                            # backpressure, not loss
                            free = ring.capacity - ring.available()
                            if free == 0:
                                time.sleep(0.0002)
                                continue
                            done += ring.push(i16[done : done + free])
                        self._frames += done
                        if pace_factor > 0:
                            target = self._frames / (fs * pace_factor)
                            while (time.monotonic() - t0) < target and not self._stop:
                                time.sleep(min(target - (time.monotonic() - t0), 0.01))
                finally:
                    reader.close()
                    self._running = False

            self._thread = threading.Thread(target=_pump, daemon=True)
            self._thread.start()

    @property
    def native(self) -> bool:
        return self._h is not None

    def running(self) -> bool:
        if self._h is not None:
            return bool(self._lib.ms_pump_running(self._h))
        return self._running

    def frames_pushed(self) -> int:
        if self._h is not None:
            return int(self._lib.ms_pump_frames(self._h))
        return self._frames

    def stop(self) -> None:
        """Signal stop, join the producer, release resources (idempotent,
        safe after EOF)."""
        if self._h is not None:
            self._frames = int(self._lib.ms_pump_frames(self._h))
            self._lib.ms_pump_stop(self._h)
            self._h = None
        elif self._thread is not None:
            self._stop = True
            self._thread.join(timeout=10.0)
            self._thread = None

    def __del__(self):
        try:
            self.stop()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class NativeWavReader:
    """Chunked mono float32 WAV reader (native when available)."""

    def __init__(self, path: str):
        self._lib = load_native()
        self._path = path
        if self._lib is not None:
            self._h = self._lib.ms_wav_open(path.encode())
            if not self._h:
                raise IOError(f"cannot open WAV: {path}")
            fs = ctypes.c_int()
            ch = ctypes.c_int()
            bits = ctypes.c_int()
            nfr = ctypes.c_longlong()
            self._lib.ms_wav_info(self._h, ctypes.byref(fs), ctypes.byref(ch),
                                  ctypes.byref(bits), ctypes.byref(nfr))
            self.fs = fs.value
            self.channels = ch.value
            self.bits = bits.value
            self.n_frames = nfr.value
        else:
            from meteor_scatter_tpu_torch.io.wavio import read_wav

            self._h = None
            self.fs, data = read_wav(path, mono=True)
            if data.dtype == np.int16:
                data = data.astype(np.float32) / 32768.0
            self._data = np.asarray(data, np.float32)
            self.channels = 1
            self.bits = 32
            self.n_frames = len(self._data)
            self._pos = 0

    @property
    def native(self) -> bool:
        return self._h is not None

    def read(self, n_frames: int) -> np.ndarray:
        if self._h is not None:
            out = np.empty(n_frames, np.float32)
            got = self._lib.ms_wav_read_f32(self._h, out.ctypes.data_as(ctypes.c_void_p), n_frames)
            return out[:got]
        got = self._data[self._pos : self._pos + n_frames]
        self._pos += len(got)
        return got

    def close(self) -> None:
        if self._h is not None and self._lib is not None:
            self._lib.ms_wav_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
