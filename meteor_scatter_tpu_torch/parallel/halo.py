"""The operations that move data between the time shards of one mesh row.

Counterpart of `meteor_scatter_tpu/parallel/halo.py` and of the two
collectives the JAX layer calls inside ``shard_map`` (``lax.psum`` and
``lax.all_gather(tiled=True)`` over the time axis).  A row is the list of
one station group's local tensors, time shard 0 first, each on its own
device; every function returns one tensor per position, on that
position's device.  These three are the only places where one position
reads another's data, so a multi-process form replaces only them.

:func:`halo_exchange` is the distributed form of the reference's STFT
overlap (``noverlap = NFFT//2``, prime_detection.py:67 / main.py:53), of
FIR warm-up tails and of the adaptive detector's warm-up replay: a time
shard needs the trailing samples of its left neighbour and/or the leading
samples of its right neighbour to compute its boundary values exactly.

Every result is a new tensor (``torch.cat`` copies), so on a virtual mesh,
where a "received" slice may be the neighbour's own storage, no position
ever writes into another's data.
"""

from __future__ import annotations

from typing import List

import torch

Row = List[torch.Tensor]


def halo_exchange(row: Row, left_halo: int, right_halo: int) -> Row:
    """Pad the last axis of each local shard with its neighbours' data:
    ``cat(left_neighbour_tail, local, right_neighbour_head)``.  The edge
    shards receive zeros, as an unsharded computation sees no samples
    before t=0 or after the end."""
    n = row[0].shape[-1]
    if left_halo > n or right_halo > n:
        raise ValueError(f"halos ({left_halo}, {right_halo}) exceed the {n}-sample shard")
    out = []
    for k, local in enumerate(row):
        parts = []
        if left_halo > 0:
            parts.append(row[k - 1][..., n - left_halo :].to(local.device) if k > 0
                         else local.new_zeros(local.shape[:-1] + (left_halo,)))
        parts.append(local)
        if right_halo > 0:
            parts.append(row[k + 1][..., :right_halo].to(local.device) if k + 1 < len(row)
                         else local.new_zeros(local.shape[:-1] + (right_halo,)))
        out.append(torch.cat(parts, -1))
    return out


def time_psum(row: Row) -> Row:
    """The elementwise sum over the row, summed in shard order (``lax.psum``
    over the time axis), given to every position."""
    total = row[0]
    for local in row[1:]:
        total = total + local.to(total.device)
    return [total.to(local.device, copy=True) for local in row]


def time_all_gather(row: Row, dim: int) -> Row:
    """The row's shards concatenated along ``dim`` in shard order
    (``lax.all_gather(..., tiled=True)`` over the time axis), given to
    every position."""
    return [torch.cat([a.to(local.device) for a in row], dim) for local in row]
