"""WAV samples straight onto the card, through a pinned staging ring.

:func:`read_wav_to_device` reads a WAV file's data chunk (or a range of its
frames) in pieces into the slots of a ring of page-locked host memory, and
as each piece is in, queues an asynchronous copy of it into one device byte
buffer: the card's DMA engine takes each piece while the host reads the
next ones, and no host array of the samples is made.  The reads run on
``SLOTS - 1`` threads at once (``os.preadv`` lets the GIL go), since one
thread copies out of the page cache at a fraction of what several do; the
one slot left over is the one whose copy is in flight.  A slot is read
into again only after its last copy has finished (a
``wait("staging_slot")`` span when the host has to wait for it).

The ring is made once per process and device, on first use, and is the
same whatever the file's length: ``SLOTS`` x ``PIECE_BYTES`` of pinned
memory.  Its copies and the kernels that read the samples are ordered on
the device's current stream.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.io.wavio import wav_layout
from meteor_scatter_tpu_torch.utils.timing import wait

# 28 MiB pinned, six reads at once: the best of the sizes under 32 MiB in
# sweeps of slots and piece sizes on an H100 host (PERF.md, section 6)
SLOTS = 7
PIECE_BYTES = 4 << 20

TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def _pread_full(fd: int, view: memoryview, offset: int) -> int:
    """Reads ``len(view)`` bytes of ``fd`` at ``offset`` into ``view``;
    returns the count, short only at the end of the file."""
    got = 0
    while got < len(view):
        n = os.preadv(fd, [view[got:]], offset + got)
        if not n:
            break
        got += n
    return got


class StagingRing:
    """``slots`` (two or more) host buffers of ``piece_bytes`` each
    (page-locked with ``pin``), each with the event of the last copy out of
    it, and ``slots - 1`` reader threads."""

    def __init__(self, piece_bytes: int, slots: int, pin: bool):
        self.host = [torch.empty(piece_bytes, dtype=torch.uint8, pin_memory=pin)
                     for _ in range(slots)]
        self.views = [memoryview(t.numpy()) for t in self.host]
        self.copied: list = [None] * slots
        self.readers = concurrent.futures.ThreadPoolExecutor(slots - 1, "wav_ingest")
        self.lock = threading.Lock()

    def fill(self, fd: int, offset: int, dst: torch.Tensor) -> int:
        """Reads up to ``len(dst)`` bytes of ``fd`` from ``offset`` into the
        byte tensor ``dst``, piece ``j`` in slot ``j % slots``; returns the
        count read (short only when the file is)."""
        size, step, n_slots = len(dst), len(self.views[0]), len(self.host)
        starts = range(0, size, step)
        reads = {}

        def read(j: int) -> None:
            i = j % n_slots
            done = self.copied[i]
            if done is not None and not done.query():
                with wait("staging_slot"):
                    done.synchronize()
            view = self.views[i][: size - starts[j]]
            reads[j] = self.readers.submit(_pread_full, fd, view, offset + starts[j])

        got = 0
        try:
            for j in range(min(n_slots - 1, len(starts))):
                read(j)
            for j, at in enumerate(starts):
                n = reads.pop(j).result()
                dst[at : at + n].copy_(self.host[j % n_slots][:n], non_blocking=True)
                if dst.is_cuda:
                    done = self.copied[j % n_slots]
                    if done is None:
                        done = self.copied[j % n_slots] = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dst.device))
                got += n
                if n < min(step, size - at):
                    break
                if j + n_slots - 1 < len(starts):
                    # the slot of piece j - 1, whose copy went a turn ago
                    read(j + n_slots - 1)
        finally:
            concurrent.futures.wait(reads.values())  # no read left writing a slot
        return got


_rings: Dict[torch.device, StagingRing] = {}
_rings_lock = threading.Lock()


def staging_ring(dev: torch.device) -> StagingRing:
    """The process's pinned ring for the CUDA device ``dev`` (with its
    index), made on first use."""
    with _rings_lock:
        if dev not in _rings:
            _rings[dev] = StagingRing(PIECE_BYTES, SLOTS, pin=True)
        return _rings[dev]


def read_wav_to_device(
    path: str,
    dev: torch.device,
    mono: bool = True,
    cut: Optional[Callable[[int, int], Tuple[Optional[int], Optional[int]]]] = None,
    ring: Optional[StagingRing] = None,
) -> Tuple[int, torch.Tensor]:
    """(sample rate, samples on ``dev`` in the file's dtype), equal element
    for element to ``torch.from_numpy(read_wav(path, mono)[1][start:stop])``,
    or the same error.  ``cut(fs, n)`` gives the frames ``(start, stop)`` of
    the file's ``n`` (all of them without ``cut``); only their bytes are
    read.  ``path`` is a regular file, not a pipe.  ``ring`` is the staging
    ring, by default the process's pinned ring of ``dev``."""
    with open(path, "rb") as fh:
        lay = wav_layout(fh, path)
        n = lay.frames()
        s, e, _ = slice(*(cut(lay.fs, n) if cut else (None, None))).indices(n)
        frame = lay.dtype.itemsize * lay.n_ch
        raw = torch.empty(max(e - s, 0) * frame, dtype=torch.uint8, device=dev)
        ring = ring if ring is not None else staging_ring(raw.device)
        with ring.lock:
            got = ring.fill(fh.fileno(), lay.offset + s * frame, raw)
    x = raw[:got].view(TORCH_DTYPES[lay.dtype])
    if lay.n_ch > 1:
        x = x.view(-1, lay.n_ch)
        if mono:
            x = x[:, 0]
    return lay.fs, x
