"""Signal framing.

Counterpart of `meteor_scatter_tpu/ops/framing.py`.  On a GPU a frame view
of a flat capture costs nothing, so the TPU's interleaved-reshape branch
is not needed:

* hop == frame_len -> a plain reshape (the batch analyzer's case),
* otherwise        -> ``Tensor.unfold``, a strided view.
"""

from __future__ import annotations

import torch


def num_frames(n_samples: int, frame_len: int, hop: int) -> int:
    """Number of full frames: matches the reference block loop
    ``len(x)//block_size`` when hop==frame_len (`main.py:356`) and scipy's
    ``(n - nperseg)//step + 1`` otherwise."""
    if n_samples < frame_len:
        return 0
    return (n_samples - frame_len) // hop + 1


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Frame the last axis of ``x`` into ``(..., n_frames, frame_len)``.

    Only full frames are produced (trailing remainder dropped), matching both
    the reference's block loop and scipy's segmenting.
    """
    nf = num_frames(x.shape[-1], frame_len, hop)
    if nf <= 0:
        return x.new_zeros(x.shape[:-1] + (0, frame_len))
    if hop == frame_len:
        return x[..., : nf * frame_len].reshape(x.shape[:-1] + (nf, frame_len))
    return x.unfold(-1, frame_len, hop)
