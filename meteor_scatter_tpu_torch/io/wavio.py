"""WAV read/write, pure stdlib + numpy.

A copy of `meteor_scatter_tpu/io/wavio.py` (``read_wav``, ``write_wav``,
``stream_wav_blocks``):
importing that module runs `meteor_scatter_tpu/io/__init__.py`, which loads
JAX through `io/events_csv.py`, and the port must import without JAX.  One
difference: the data chunk is read into a ``bytearray``, so the returned
array is writable and ``torch.from_numpy`` takes it without a copy or a
warning.  The chunk walk is shared with :func:`wav_layout`, which finds the
data chunk's bytes in the file for the card's ingest (``io/ingest.py``);
``read_wav`` itself still reads the chunk as it walks, so it reads a pipe
as the JAX package's does.
"""

from __future__ import annotations

import os
import struct
import wave
from dataclasses import dataclass
from typing import BinaryIO, Callable, Iterator, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


@dataclass(frozen=True)
class WavLayout:
    """What a WAV file's chunks say of its samples: the rate, the sample
    type, the channels, and where the data chunk's bytes lie in the file
    (``nbytes`` is short of the chunk's declared size when the file is
    truncated)."""

    fs: int
    dtype: np.dtype
    n_ch: int
    offset: int
    nbytes: int

    def frames(self) -> int:
        """The count of whole frames, or the error ``read_wav``'s numpy views
        raise on a data chunk that is not whole samples or frames."""
        item = self.dtype.itemsize
        if self.nbytes % item:
            np.frombuffer(bytes(self.nbytes % item), dtype=self.dtype)  # raises
        n = self.nbytes // item
        if self.n_ch > 1 and n % self.n_ch:
            np.empty(n, dtype=self.dtype).reshape(-1, self.n_ch)  # raises
        return n // self.n_ch


def _walk_chunks(
    fh: BinaryIO, path: str, data_chunk: Callable[[BinaryIO, int], T]
) -> Tuple[int, np.dtype, int, T]:
    """Walks the RIFF chunks of the open file ``fh`` (``path`` names it in
    errors): (rate, sample type, channels, what ``data_chunk(fh, size)``
    gave for the last ``data`` chunk).  ``data_chunk`` leaves ``fh`` at the
    chunk's end, or at the file's end when the file is truncated."""
    riff, size, wave_id = struct.unpack("<4sI4s", fh.read(12))
    if riff != b"RIFF" or wave_id != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")
    fmt = None
    data = None
    while True:
        hdr = fh.read(8)
        if len(hdr) < 8:
            break
        cid, csize = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            fmt = fh.read(csize)
        elif cid == b"data":
            data = data_chunk(fh, csize)
        else:
            fh.seek(csize + (csize & 1), 1)
            continue
        if csize & 1:
            fh.seek(1, 1)
    if fmt is None or data is None:
        raise ValueError(f"Missing fmt/data chunk: {path}")
    (audio_fmt, n_ch, fs, _brate, _balign, bits) = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = struct.unpack("<H", fmt[24:26])[0]
    if audio_fmt == 1:  # PCM
        dtype = {8: np.uint8, 16: np.int16, 32: np.int32}[bits]
    elif audio_fmt == 3:  # IEEE float
        dtype = {32: np.float32, 64: np.float64}[bits]
    else:
        raise ValueError(f"Unsupported WAV format code {audio_fmt}")
    return fs, np.dtype(dtype), n_ch, data


def _read_chunk(fh: BinaryIO, csize: int) -> bytearray:
    data = bytearray(csize)
    del data[fh.readinto(data) :]  # a truncated file reads short
    return data


def wav_layout(fh: BinaryIO, path: str) -> WavLayout:
    """The :class:`WavLayout` of the open regular file ``fh`` (``path``
    names it in errors): its chunks are walked as in ``read_wav`` and the
    data chunk is skipped, not read.  Unlike ``read_wav`` it needs a file it
    can seek in and take the length of, not a pipe."""
    file_size = os.fstat(fh.fileno()).st_size

    def locate(fh: BinaryIO, csize: int) -> Tuple[int, int]:
        at = fh.tell()
        fh.seek(csize, 1)
        return at, min(csize, file_size - at)

    fs, dtype, n_ch, (offset, nbytes) = _walk_chunks(fh, path, locate)
    return WavLayout(fs, dtype, n_ch, offset, nbytes)


def read_wav(path: str, mono: bool = False) -> Tuple[int, np.ndarray]:
    """Returns (sample_rate, data).  int16/int32/float32 preserved like
    scipy.io.wavfile; shape (n,) for mono, (n, ch) otherwise.  With
    ``mono=True`` multichannel input collapses to its first channel
    (the reference's behavior, processor.py:72-74)."""
    with open(path, "rb") as fh:
        fs, dtype, n_ch, data = _walk_chunks(fh, path, _read_chunk)
    arr = np.frombuffer(data, dtype=dtype)
    if n_ch > 1:
        arr = arr.reshape(-1, n_ch)
        if mono:
            arr = arr[:, 0]
    return fs, arr


def write_wav(path: str, fs: int, data: np.ndarray) -> None:
    """Write mono/multichannel int16 or float32 WAV."""
    data = np.asarray(data)
    n_ch = 1 if data.ndim == 1 else data.shape[1]
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype == np.float32:
        # float WAV via manual chunks (wave module only does PCM)
        payload = data.tobytes()
        with open(path, "wb") as fh:
            byte_rate = fs * n_ch * 4
            fh.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
            fh.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, n_ch, fs, byte_rate, n_ch * 4, 32))
            fh.write(b"data" + struct.pack("<I", len(payload)) + payload)
        return
    if data.dtype != np.int16:
        raise ValueError(f"Unsupported dtype {data.dtype}")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(n_ch)
        wf.setsampwidth(2)
        wf.setframerate(fs)
        wf.writeframes(data.tobytes())


def stream_wav_blocks(path: str, block_samples: int, mono: bool = True) -> Iterator[np.ndarray]:
    """Yield consecutive full blocks of ``block_samples`` samples (a trailing
    partial block is dropped), as the reference package's live input."""
    fs, data = read_wav(path, mono=mono)
    n = (len(data) // block_samples) * block_samples
    for i in range(0, n, block_samples):
        yield data[i : i + block_samples]
