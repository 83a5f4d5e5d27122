"""WAV read/write, pure stdlib + numpy.

A copy of `meteor_scatter_tpu/io/wavio.py` (``read_wav``, ``write_wav``,
``stream_wav_blocks``):
importing that module runs `meteor_scatter_tpu/io/__init__.py`, which loads
JAX through `io/events_csv.py`, and the port must import without JAX.  One
difference: the data chunk is read into a ``bytearray``, so the returned
array is writable and ``torch.from_numpy`` takes it without a copy or a
warning.
"""

from __future__ import annotations

import struct
import wave
from typing import Iterator, Tuple

import numpy as np


def read_wav(path: str, mono: bool = False) -> Tuple[int, np.ndarray]:
    """Returns (sample_rate, data).  int16/int32/float32 preserved like
    scipy.io.wavfile; shape (n,) for mono, (n, ch) otherwise.  With
    ``mono=True`` multichannel input collapses to its first channel
    (the reference's behavior, processor.py:72-74)."""
    with open(path, "rb") as fh:
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
                data = bytearray(csize)
                del data[fh.readinto(data) :]  # a truncated file reads short
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
