"""Process-global device mesh used by the application (CLI) paths.

The port of ``streamz_tpu/parallel/mesh.py``.  The CLI calls
:func:`auto_mesh` once at startup: when the process group is up with more
than one rank, a 1-D ``"data"`` mesh over every rank is built, and every
batched application stage (ingest frontend, initial corpus training, eval
embedding batches, long-clip identification) runs sharded over it.  The
application-level analogue of the reference binary being rayon-parallel
end to end (``streamz-rs/src/main.rs:490-508``, ``:750-835``).

Every rank reads the same files and holds the same host arrays, as every
JAX host does; :func:`put_batch_sharded` moves this rank's contiguous slice
of a padded leading axis onto its device, and :func:`fetch` gathers equal
shards back into one host array on every rank.

Library functions take an explicit ``mesh`` argument; only the CLI consults
the process-global here, so tests stay in control of sharding.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from streamz_tpu_torch.device import upload
from streamz_tpu_torch.parallel import comm

_UNSET = object()  # distinct from None: "no mesh" is a cachable decision
_ACTIVE: list = [_UNSET]


def auto_mesh() -> Optional[DeviceMesh]:
    """Build (once) and return the data mesh over every rank, or ``None``
    without a process group of two or more ranks.  ``STREAMZ_TPU_MESH=0``
    disables it, consulted on EVERY call so setting it mid-process wins
    over an already-built mesh; a prior ``set_active_mesh(None)`` stays
    pinned."""
    if os.environ.get("STREAMZ_TPU_MESH", "1") == "0":
        return None
    if _ACTIVE[0] is not _UNSET:
        return _ACTIVE[0]
    if comm.world_size() < 2:
        return None
    _ACTIVE[0] = comm.make_mesh(axis=comm.DATA_AXIS)
    return _ACTIVE[0]


def set_active_mesh(mesh: Optional[DeviceMesh]) -> None:
    _ACTIVE[0] = mesh


def reset_active_mesh() -> None:
    """Forget the built (or pinned) mesh: the next :func:`auto_mesh` decides
    anew (after the process group it was built on is gone)."""
    _ACTIVE[0] = _UNSET


def active_mesh() -> Optional[DeviceMesh]:
    return None if _ACTIVE[0] is _UNSET else _ACTIVE[0]


def pad_rows_to_mesh(mesh: DeviceMesh, *arrays: np.ndarray) -> Tuple[int, tuple]:
    """Zero-pad each array's leading axis to a multiple of the mesh size.

    Returns ``(original_rows, padded_arrays)``.  Padding rows are zeros, so
    downstream masking (length-0 clips / weight-0 windows) drops them.
    """
    n_dev = mesh.size()
    n = arrays[0].shape[0]
    n_pad = -(-max(n, 1) // n_dev) * n_dev
    if n_pad == n:
        return n, arrays
    out = []
    for a in arrays:
        padded = np.zeros((n_pad,) + a.shape[1:], a.dtype)
        if n:
            padded[:n] = a
        out.append(padded)
    return n, tuple(out)


def local_rows(mesh: DeviceMesh, n_rows: int) -> slice:
    """This rank's contiguous slice of a leading axis of ``n_rows``, a
    multiple of the mesh size."""
    n_dev = mesh.size()
    if n_rows % n_dev:
        raise ValueError(f"{n_rows} rows do not split over {n_dev} ranks")
    per = n_rows // n_dev
    r = comm.axis_index(mesh)
    return slice(r * per, (r + 1) * per)


def put_batch_sharded(mesh: DeviceMesh, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """This rank's slice of each array's leading axis (a mesh multiple, as
    :func:`pad_rows_to_mesh` leaves it) on this rank's device."""
    dev = comm.mesh_device(mesh)
    return tuple(upload(np.ascontiguousarray(a[local_rows(mesh, a.shape[0])]), dev)
                 for a in arrays)


def fetch(shard: torch.Tensor, mesh: DeviceMesh) -> np.ndarray:
    """Every rank's equal shard of a leading axis, concatenated in rank
    order, as one host array on every rank (``all_gather``)."""
    return comm.all_gather(shard, mesh, tiled=True).cpu().numpy()
