"""The operations that move data between the time shards of one mesh row.

Counterpart of `meteor_scatter_tpu/parallel/halo.py` and of the two
collectives the JAX layer calls inside ``shard_map`` (``lax.psum`` and
``lax.all_gather(tiled=True)`` over the time axis).  A row is the list of
one station group's local tensors, time shard 0 first, each on its own
device; every function returns one tensor per position, on that
position's device.  These three (and ``mesh.unshard``) are the only
places where one position reads another's data, so they alone have a
multi-process form.

:func:`halo_exchange` is the distributed form of the reference's STFT
overlap (``noverlap = NFFT//2``, prime_detection.py:67 / main.py:53), of
FIR warm-up tails and of the adaptive detector's warm-up replay: a time
shard needs the trailing samples of its left neighbour and/or the leading
samples of its right neighbour to compute its boundary values exactly.

Every result is a new tensor (``torch.cat`` copies), so on a virtual mesh,
where a "received" slice may be the neighbour's own storage, no position
ever writes into another's data.

On a mesh that spans processes (``mesh`` and the row's index ``s``
given), a row holds None at the other processes' positions and every
function returns None there.  Data crosses processes only here and in
``mesh.unshard``, through the mesh's
:class:`~meteor_scatter_tpu_torch.parallel.distributed.Link`: the halo by
point-to-point transfers between neighbours, the row sum and gather by one
``all_gather`` over the row's process sub-group.  A row one process holds
runs the in-process form; a process that owns no position of the row
takes no part.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from meteor_scatter_tpu_torch.parallel.distributed import row_group

Row = List[Optional[torch.Tensor]]


def _spans_processes(row: Row, mesh, s: int) -> bool:
    return mesh is not None and mesh.link is not None and len(set(mesh.owners[s])) > 1


def halo_exchange(row: Row, left_halo: int, right_halo: int, mesh=None, s: int = 0) -> Row:
    """Pad the last axis of each local shard with its neighbours' data:
    ``cat(left_neighbour_tail, local, right_neighbour_head)``.  The edge
    shards receive zeros, as an unsharded computation sees no samples
    before t=0 or after the end.  A neighbour in another process sends its
    slice; the receiver knows its shape from its own shard."""
    mine = [k for k, a in enumerate(row) if a is not None]
    if not mine:
        return list(row)
    n = row[mine[0]].shape[-1]
    if left_halo > n or right_halo > n:
        raise ValueError(f"halos ({left_halo}, {right_halo}) exceed the {n}-sample shard")
    remote = {}
    if _spans_processes(row, mesh, s):
        owners, me = mesh.owners[s], mesh.rank
        # one message each way between neighbours in two processes: tags
        # 2s (a tail, to the right) and 2s + 1 (a head, to the left)
        sends, recvs, keys = [], [], []
        for k in mine:
            a = row[k]
            if left_halo and k + 1 < len(row) and owners[k + 1] != me:
                sends.append((a[..., n - left_halo :], owners[k + 1], 2 * s))
            if right_halo and k > 0 and owners[k - 1] != me:
                sends.append((a[..., :right_halo], owners[k - 1], 2 * s + 1))
            if left_halo and k > 0 and owners[k - 1] != me:
                recvs.append((a.shape[:-1] + (left_halo,), a.dtype, a.device, owners[k - 1], 2 * s))
                keys.append((k, "left"))
            if right_halo and k + 1 < len(row) and owners[k + 1] != me:
                recvs.append((a.shape[:-1] + (right_halo,), a.dtype, a.device, owners[k + 1],
                              2 * s + 1))
                keys.append((k, "right"))
        remote = dict(zip(keys, mesh.link.exchange(sends, recvs)))
    out = list(row)
    for k in mine:
        local = row[k]
        parts = []
        if left_halo > 0:
            if (k, "left") in remote:
                parts.append(remote[k, "left"])
            else:
                parts.append(row[k - 1][..., n - left_halo :].to(local.device) if k > 0
                             else local.new_zeros(local.shape[:-1] + (left_halo,)))
        parts.append(local)
        if right_halo > 0:
            if (k, "right") in remote:
                parts.append(remote[k, "right"])
            else:
                parts.append(row[k + 1][..., :right_halo].to(local.device) if k + 1 < len(row)
                             else local.new_zeros(local.shape[:-1] + (right_halo,)))
        out[k] = torch.cat(parts, -1)
    return out


def _row_shards(row: Row, mesh, s: int) -> Row:
    """Every shard of the row, in shard order, on this process: its own as
    they are, the others' from one ``all_gather`` over the row's process
    sub-group (each process's shards stacked, padded to the most a process
    of the row owns)."""
    if not _spans_processes(row, mesh, s):
        return row
    owners, me = mesh.owners[s], mesh.rank
    members = sorted(set(owners))
    held = {r: [k for k, o in enumerate(owners) if o == r] for r in members}
    mine = [row[k] for k in held[me]]
    pad = [torch.zeros_like(mine[0])] * (max(map(len, held.values())) - len(mine))
    got = mesh.link.all_gather(torch.stack([a.to(mine[0].device) for a in mine] + pad),
                               group=row_group(mesh, s))
    shards = list(row)
    for r, ks in held.items():
        if r != me:
            for j, k in enumerate(ks):
                shards[k] = got[members.index(r)][j]
    return shards


def time_psum(row: Row, mesh=None, s: int = 0) -> Row:
    """The elementwise sum over the row, summed in shard order (``lax.psum``
    over the time axis), given to every position.  Across processes the
    shards are gathered first and summed in the same order, never by an
    ``all_reduce``, whose order is the backend's: the result is the
    in-process sum bit for bit."""
    if all(a is None for a in row):
        return list(row)
    shards = _row_shards(row, mesh, s)
    total = shards[0]
    for local in shards[1:]:
        total = total + local.to(total.device)
    return [None if local is None else total.to(local.device, copy=True) for local in row]


def time_all_gather(row: Row, dim: int, mesh=None, s: int = 0) -> Row:
    """The row's shards concatenated along ``dim`` in shard order
    (``lax.all_gather(..., tiled=True)`` over the time axis), given to
    every position."""
    if all(a is None for a in row):
        return list(row)
    shards = _row_shards(row, mesh, s)
    return [None if local is None else torch.cat([a.to(local.device) for a in shards], dim)
            for local in row]
