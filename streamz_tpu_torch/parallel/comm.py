"""The communication layer: collectives over a 1-D device mesh.

The port of ``streamz_tpu/parallel/comm.py`` on ``torch.distributed``.  JAX
is single-controller: one process owns every local device and
``shard_map`` runs the same program on each.  PyTorch's idiom is one
process per device, so the port's "mesh" is a 1-D
:class:`torch.distributed.device_mesh.DeviceMesh` (dim name ``"data"`` or
``"window"``) over the process group, one rank per device, and the
collectives here are eager calls on the mesh's group:

- the lock-serialized gradient application of the reference
  (``streamz-rs/src/main.rs:710``) → :func:`psum` of the gradient sums;
- the shared loss accumulator and file counter → :func:`psum` of scalars;
- the snapshot-then-compute centroid reads → :func:`all_gather`;
- the PCM halo of the window-sharded frontend → :func:`neighbour_exchange`.

:func:`initialize_distributed` bootstraps the group from the CLI's
``--coordinator/--num-processes/--process-id`` (``tcp://``), or from
``torchrun``'s environment with ``STREAMZ_DIST_AUTO=1`` (``env://``).  Each
rank computes on ``cuda:<local rank % device count>`` unless the CPU is
asked for.  The backend is NCCL when each local rank has a card of its
own; gloo under the CPU, and gloo when local ranks outnumber the cards,
since NCCL refuses two ranks on one card.  Tensors stay on the card either
way: gloo reduces and gathers CUDA tensors itself, and where it refuses
them (point-to-point) :func:`neighbour_exchange` stages them through
pinned host memory.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from streamz_tpu_torch.device import resolve_device

# Canonical mesh axis names.
DATA_AXIS = "data"      # files/windows sharded across ranks (the rayon-pool analogue)
WINDOW_AXIS = "window"  # long-clip window-axis sharding (the CP analogue)

# A lost rank leaves the others blocked in a collective: every group
# carries this timeout, so they fail instead of hanging.
DEFAULT_TIMEOUT_S = 600.0

_rank_device: Optional[torch.device] = None  # set by initialize_distributed
_single_host = True  # every rank of the group on this host


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of ranks of the process group, 1 without one."""
    return dist.get_world_size() if initialized() else 1


def single_host() -> bool:
    """Whether every rank of the process group runs on this host (true
    without a group)."""
    return not initialized() or _single_host


def backend() -> Optional[str]:
    """The default group's backend (``"nccl"`` or ``"gloo"``), None without
    a group."""
    return dist.get_backend() if initialized() else None


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_index(mesh: DeviceMesh) -> int:
    """This rank's position along the mesh's axis."""
    return mesh.get_local_rank()


def _group(mesh: DeviceMesh):
    return mesh.get_group()


def psum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, as a new tensor."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(mesh))
    return out


def all_reduce_max(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` replaced in place by its elementwise maximum over the ranks."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(mesh))
    return x


def pmean(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    return psum(x, mesh) / mesh.size()


def all_gather(x: torch.Tensor, mesh: DeviceMesh, *, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x``, stacked on a new leading axis ([n, ...]), or
    concatenated along the leading axis with ``tiled``.  Each rank must
    pass the same shape."""
    n = mesh.size()
    x = x.contiguous()
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=_group(mesh))
    return out.reshape(n * x.shape[0], *x.shape[1:]) if tiled else out


def neighbour_exchange(to_right: torch.Tensor, to_left: torch.Tensor,
                       mesh: DeviceMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """One exchange with both ring neighbours (the two ``ppermute``s of
    ``streamz_tpu/parallel/window_parallel.py:205-216``): send ``to_right``
    to rank ``r+1`` and ``to_left`` to rank ``r-1``, cyclically; return
    ``(from_left, from_right)``, what rank ``r-1`` sent right and rank
    ``r+1`` sent left.  Every rank passes the same shapes.  One
    ``batch_isend_irecv``; under gloo a CUDA tensor goes through pinned host
    memory, since gloo's point-to-point refuses device pointers."""
    n, r = mesh.size(), axis_index(mesh)
    group = _group(mesh)
    dev = to_right.device
    stage = dev.type == "cuda" and dist.get_backend(group) == "gloo"

    def host(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.to("cpu").pin_memory() if stage else t

    send_r, send_l = host(to_right), host(to_left)
    recv_l, recv_r = torch.empty_like(send_r), torch.empty_like(send_l)
    right = dist.get_global_rank(group, (r + 1) % n)
    left = dist.get_global_rank(group, (r - 1) % n)
    ops = [
        dist.P2POp(dist.isend, send_r, right, group, tag=0),
        dist.P2POp(dist.isend, send_l, left, group, tag=1),
        dist.P2POp(dist.irecv, recv_l, left, group, tag=0),
        dist.P2POp(dist.irecv, recv_r, right, group, tag=1),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if stage:
        return recv_l.to(dev), recv_r.to(dev)
    return recv_l, recv_r


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` ranks (all of them by
    default) of the initialized process group, on this rank's device type."""
    if not initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call initialize_distributed "
            "(the CLI's --coordinator/--num-processes/--process-id) first"
        )
    n_all = dist.get_world_size()
    if n_devices is not None:
        if n_devices > n_all:
            # Silent truncation would hand back a smaller mesh than the
            # caller's sharding math assumes (and let a typo like
            # n_devices=80 'succeed').
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{n_all} devices are available"
            )
        n_all = n_devices
    dev_type = _rank_device.type if _rank_device is not None else (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(dev_type, list(range(n_all)), mesh_dim_names=(axis,))


def _is_local(host: str) -> bool:
    """Whether a coordinator host names this machine: a loopback address,
    ``localhost`` or this host's name.  No name is resolved."""
    if host in ("localhost", socket.gethostname()):
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def _local_layout(coordinator: Optional[str], num_processes: int,
                  rank: int) -> Tuple[int, int]:
    """(local rank, local world size): ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``
    where the launcher sets them (``torchrun`` does); else every process on
    this machine when the coordinator is local, one per machine when not."""
    if "LOCAL_RANK" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
        return local_rank, int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
    host = (coordinator or "").rsplit(":", 1)[0].strip("[]")
    if _is_local(host):
        return rank, num_processes
    return 0, 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> Optional[torch.device]:
    """Multi-process bootstrap (``torch.distributed.init_process_group``).

    No-op returning None when the job is single-process (the common case).
    Multi-process launchers pass all three coordinator/process flags
    (``tcp://<coordinator>``); under ``torchrun`` set ``STREAMZ_DIST_AUTO=1``
    to opt into its ``env://`` rendezvous with no flags instead.  Returns
    this rank's device: ``cuda:<local rank % device count>`` unless
    ``device`` is ``'cpu'``.  The group's backend is NCCL when each local
    rank has a card of its own, else gloo.  ``DEFAULT_TIMEOUT_S`` bounds
    every collective, so a lost rank fails the others instead of hanging
    them.
    """
    global _rank_device, _single_host

    given = {
        "--coordinator": coordinator_address,
        "--num-processes": num_processes,
        "--process-id": process_id,
    }
    missing = [k for k, v in given.items() if v is None]
    if len(missing) == 3:
        if os.environ.get("STREAMZ_DIST_AUTO", "0") != "1":
            return None  # single-process job: the common case
        # Explicit opt-in: torchrun's environment names the group.  Failure
        # here is a misconfigured launcher, not a single-process job.
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    elif missing:
        # ANY partial config is a misconfigured launcher, not a
        # single-process job: silently skipping would leave every process
        # training its own divergent model.
        present = [k for k, v in given.items() if v is not None]
        raise ValueError(
            f"{'/'.join(present)} given without {'/'.join(missing)}; "
            "pass all three (or STREAMZ_DIST_AUTO=1 with none, for "
            "torchrun's env:// rendezvous)"
        )
    else:
        init_method = f"tcp://{coordinator_address}"
    local_rank, local_world = _local_layout(coordinator_address, num_processes,
                                            process_id)
    _single_host = local_world == num_processes
    dev = resolve_device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        backend_name = "nccl" if local_world <= n_cards else "gloo"
    else:
        backend_name = "gloo"
    if initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError("torch.distributed is already initialized as another rank")
        _rank_device = dev
        return dev
    dist.init_process_group(
        backend_name, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
        **({"device_id": dev} if backend_name == "nccl" else {}),
    )
    _rank_device = dev
    return dev


def shutdown() -> None:
    """Destroy the process group (a no-op without one)."""
    global _rank_device, _single_host
    if initialized():
        dist.destroy_process_group()
    _rank_device = None
    _single_host = True
