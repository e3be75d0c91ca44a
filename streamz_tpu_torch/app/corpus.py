"""Whole-corpus batched training of the labelled files (the initial training
of the default run), on one device.

The port of ``streamz_tpu/app/corpus.py`` and the single-device case of
``streamz_tpu/parallel/data_parallel.py``: one shuffled window pool,
batches of 4096, each step one K5 launch on CUDA (``corpus_step``) and the
update ``p -= lr / max(count, 1) * grad`` in place.  Shuffles and dropout
masks come from ``np.random.default_rng(seed)`` in the JAX package's order,
so both packages train on the same batches.  The per-step losses stay on
the device; the host reads them once per epoch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.nn.model import SpeakerNet
from streamz_tpu_torch.nn.train import corpus_step


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
    seed: int = 0,
) -> List[float]:
    """Large-batch SGD over the whole pool; returns the per-epoch mean
    losses.  ``dropout`` zeroes features with probability p without
    rescaling and skips windows that become all zero (src/lib.rs:119-129,
    :607-609); the masks are drawn for the unpadded pool only."""
    n = len(windows)
    if n == 0:
        return []
    steps = max(1, -(-n // batch_size))
    n_pad = steps * batch_size
    dev = net.device
    rng = np.random.default_rng(seed)
    params = net.working_params()
    ns = torch.tensor(net.num_speakers, dtype=torch.int32, device=dev)
    losses: List[float] = []
    for _ in range(int(epochs)):
        order = rng.permutation(n)
        idx = np.concatenate([order, np.zeros(n_pad - n, np.int64)])
        x = windows[idx]
        w = (np.arange(n_pad) < n).astype(np.float32)
        if dropout > 0.0:
            keep = rng.random((n,) + x.shape[1:], dtype=np.float32) >= dropout
            x[:n] = x[:n] * keep
            w = w * np.any(x != 0.0, axis=-1)
        xb = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        yb = torch.from_numpy(np.ascontiguousarray(labels[idx], np.int32)).to(dev)
        wb = torch.from_numpy(w.astype(np.float32)).to(dev)
        step_losses = []
        for s in range(steps):
            rows = slice(s * batch_size, (s + 1) * batch_size)
            _, loss = corpus_step(params, xb[rows], yb[rows], wb[rows], ns, lr)
            step_losses.append(loss)
        losses.append(float(torch.stack(step_losses).mean()))
    net.params = params
    return losses
