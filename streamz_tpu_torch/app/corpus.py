"""Whole-corpus batched training of the labelled files (the initial training
of the default run), on one device or data-parallel over a mesh.

The port of ``streamz_tpu/app/corpus.py``: one shuffled window pool,
batches of 4096.  On one device (``mesh=None``) each step is one launch of
K5's step form on CUDA (``corpus_step_k5``), which gathers the step's rows
from the pool on the card and applies ``p -= lr / max(count, 1) * grad``
in place.  Over a mesh (:mod:`streamz_tpu_torch.parallel.data_parallel`)
the batch rounds up to a mesh multiple and each rank runs K5's sums form
on its slice of every step, then one all-reduce and the update with the
global count.  The pool and its labels go to each rank's device once; per
epoch only the permutation (int32) and the dropout keep mask (one byte per
feature) go up, from pinned buffers without blocking.  Shuffles and
dropout masks come from ``np.random.default_rng(seed)`` in the JAX
package's order, drawn for the unpadded pool only, so both packages and
every rank count train on the same batches.  The per-step losses stay on
the device; the host reads them once, at the end.  On the CPU the same
routes run in plain torch (``train_kernels.rows_plain``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from streamz_tpu_torch import config
from streamz_tpu_torch.device import staged
from streamz_tpu_torch.nn.model import SpeakerNet
from streamz_tpu_torch.nn.train_kernels import PoolRows, corpus_step_k5
from streamz_tpu_torch.parallel import comm
from streamz_tpu_torch.parallel.data_parallel import dp_step
from streamz_tpu_torch.runtime.profiler import span


def build_window_pool(
    feature_map: Dict[str, np.ndarray],
    files: Sequence[Tuple[str, int]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten per-file windows into one labelled pool ([N, F], [N])."""
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    for path, cls in files:
        wins = feature_map.get(path)
        if wins is None or len(wins) == 0:
            continue
        xs.append(np.asarray(wins, np.float32))
        ys.append(np.full(len(wins), cls, np.int32))
    if not xs:
        return (np.zeros((0, config.FEATURE_SIZE), np.float32),
                np.zeros((0,), np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def train_corpus(
    net: SpeakerNet,
    windows: np.ndarray,
    labels: np.ndarray,
    *,
    epochs: int = 5,
    batch_size: int = 4096,
    lr: float = 0.01,
    dropout: float = 0.0,
    mesh: Optional[DeviceMesh] = None,
    seed: int = 0,
) -> List[float]:
    """Large-batch SGD over the whole pool; returns the per-epoch mean
    losses.  ``dropout`` zeroes features with probability p without
    rescaling and skips windows that become all zero (src/lib.rs:119-129,
    :607-609); the masks are drawn for the unpadded pool only.

    With ``mesh``, ``batch_size`` is the GLOBAL batch, rounded up to a mesh
    multiple, and every rank (each holding the same ``windows``) trains its
    slice of each step; the parameters then match a single-device run up to
    the all-reduce's float reduction order."""
    if mesh is not None and batch_size % mesh.size():
        batch_size += mesh.size() - batch_size % mesh.size()
    n = len(windows)
    if n == 0:
        return []
    steps = max(1, -(-n // batch_size))
    n_pad = steps * batch_size
    dev = net.device
    rng = np.random.default_rng(seed)
    params = net.working_params()
    ns = torch.tensor(net.num_speakers, dtype=torch.int32, device=dev)
    pool_x = torch.from_numpy(np.ascontiguousarray(windows, np.float32)).to(dev)
    pool_y = torch.from_numpy(np.ascontiguousarray(labels, np.int32)).to(dev)
    # Positions past n are the epoch's padding: pool row 0, weight 0.
    order = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    keep = (torch.empty((n, pool_x.shape[1]), dtype=torch.uint8, device=dev)
            if dropout > 0.0 else None)
    epoch_losses = []
    for _ in range(int(epochs)):
        with span("corpus.draws"):
            order[:n].copy_(staged(rng.permutation(n).astype(np.int32), dev),
                            non_blocking=True)
            if keep is not None:
                drawn = rng.random((n, pool_x.shape[1]), dtype=np.float32) >= dropout
                keep.copy_(staged(drawn.view(np.uint8), dev), non_blocking=True)
        step_losses = []
        for s in range(steps):
            if mesh is None:
                lo, width = s * batch_size, batch_size
            else:  # this rank's slice of the step, as P(None, DATA_AXIS)
                width = batch_size // mesh.size()
                lo = s * batch_size + comm.axis_index(mesh) * width
            real = min(width, max(n - lo, 0))
            rows = PoolRows(pool_x, pool_y, order[lo:lo + width],
                            None if keep is None else keep[lo:lo + real], real)
            step_losses.append(corpus_step_k5(params, rows, ns, lr) if mesh is None
                               else dp_step(params, rows, ns, lr, mesh))
        epoch_losses.append(torch.stack(step_losses).mean())
    net.params = params
    return [float(v) for v in torch.stack(epoch_losses).tolist()] if epoch_losses else []

