"""Data-parallel training over a ``"data"`` mesh.

The port of ``streamz_tpu/parallel/data_parallel.py``: the multi-device
equivalent of the reference's shared-memory data parallelism (rayon
threads + one RwLock'd model, ``streamz-rs/src/main.rs:750-835``).  Each
rank computes K5's gradient sums on its shard of every step
(``corpus_rows_sums_k5``), **one** ``all_reduce`` of a flat buffer
``[dw1 | db1 | dw2 | db2 | dw3 | db3 | loss_sum, count, 0, 0]`` replaces the
lock-serialized weight update, and every rank applies
``p -= lr / max(count, 1) * grad`` with the GLOBAL count
(``streamz_tpu/parallel/data_parallel.py:39-41``), so the update is the
mean gradient over the global batch whatever the rank count.  Parameters
stay replicated; the update is in place.

A step's rows split as ``P(None, DATA_AXIS)`` splits them: rank ``r`` of
``n`` takes rows ``[r·B/n, (r+1)·B/n)`` of every step.  The sums are taken
in another order than on one device, so parameters agree with a
single-device run up to reduction-order float noise, as the JAX package's
promise is (``streamz_tpu/app/corpus.py:67-69``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from streamz_tpu_torch.nn import train_kernels as tk
from streamz_tpu_torch.parallel import comm
from streamz_tpu_torch.parallel.mesh import put_batch_sharded


def dp_step(params: tk.Params, rows: tk.Rows, num_speakers: tk.NumSpeakers, lr,
            mesh: DeviceMesh) -> torch.Tensor:
    """One data-parallel SGD step on this rank's ``rows`` (a :class:`Batch`,
    or :class:`PoolRows` whose ``n`` may be 0 for a shard of padding only):
    local sums (K5 on CUDA), one all-reduce, the global mean-gradient
    update in place.  Returns the global mean loss as a device scalar.
    Shared by the step and epoch trainers, so the two cannot disagree on
    the update rule."""
    if isinstance(rows, tk.PoolRows) and rows.n == 0:
        # Nothing real on this rank: zero sums, no launch.
        flat = torch.zeros((tk.sums_size(params),), dtype=torch.float32,
                           device=rows.pool_x.device)
    else:
        flat = tk.corpus_rows_sums_k5(params, rows, num_speakers)
    flat = comm.psum(flat, mesh)
    grads, loss_sum, count = tk.split_sums(params, flat)
    return tk._apply_step(params, grads, loss_sum, count, lr)


def _shard(mesh: DeviceMesh, batch, labels, weights) -> tk.Batch:
    """This rank's rows of one step's global batch, on its device."""
    return tk.Batch(*put_batch_sharded(mesh, *map(np.asarray, (batch, labels, weights))))


def make_dp_train_step(mesh: DeviceMesh):
    """A data-parallel SGD step.

    Returns ``step(params, batch, labels, weights, num_speakers, lr) ->
    (params, loss)``: ``batch`` [B, F] f32, ``labels`` [B] int32 and
    ``weights`` [B] f32 are the GLOBAL batch (host arrays, the same on
    every rank, B a multiple of the mesh size), of which each rank takes
    its rows; ``params`` are updated in place.  Semantics match the
    reference's mean-gradient ``train_batch`` (``src/lib.rs:1002-1060``)
    over the global batch."""

    def step(params, batch, labels, weights, num_speakers, lr):
        loss = dp_step(params, _shard(mesh, batch, labels, weights),
                       num_speakers, lr, mesh)
        return params, loss

    return step


def make_dp_train_epoch(mesh: DeviceMesh, *, steps: int):
    """A multi-step trainer: the DP step over pre-batched global data
    ``batches`` [steps, B, F], ``labels`` [steps, B], ``weights``
    [steps, B].  Returns ``epoch(...) -> (params, losses [steps])``."""

    def epoch(params, batches, labels, weights, num_speakers, lr
              ) -> Tuple[tk.Params, torch.Tensor]:
        if len(batches) != steps:
            raise ValueError(f"expected {steps} steps, got {len(batches)}")
        losses: List[torch.Tensor] = []
        for b, lab, w in zip(batches, labels, weights):
            losses.append(dp_step(params, _shard(mesh, b, lab, w), num_speakers, lr, mesh))
        return params, torch.stack(losses)

    return epoch
