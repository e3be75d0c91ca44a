"""Host-side training drivers of the reference's orchestration API.

The port of ``streamz_tpu/nn/drivers.py`` as far as the default run needs
it: ``pretrain_from_features`` (``streamz-rs/src/lib.rs:582-628``) and
``train_from_feature_map`` (``src/lib.rs:632-665``).  Each pads a file's
windows to a power-of-two number of chunks and trains them through
:func:`streamz_tpu_torch.nn.train.train_on_windows_impl` (one K6 launch on CUDA).

Keys come from the threefry twin (:mod:`streamz_tpu_torch.nn.prng`) with
the JAX package's process-global counter, so a fresh process draws
``PRNGKey(1)`` first in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.nn import prng
from streamz_tpu_torch.nn import train as T
from streamz_tpu_torch.nn.model import SpeakerNet

_key_counter = [0]


def _fresh_key(seed: Optional[int] = None, device=None) -> torch.Tensor:
    if seed is None:
        _key_counter[0] += 1
        seed = _key_counter[0]
    return prng.PRNGKey(seed, device=device)


def _pad_windows(windows: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int]:
    """Pad [N, F] windows up to batch_size * next_pow2(ceil(N/bs)) rows;
    ``batch_size`` is clamped to >= 1 (src/lib.rs:371, :602)."""
    batch_size = max(1, int(batch_size))
    n = len(windows)
    chunks = max(1, -(-n // batch_size))
    n_pad = config.next_pow2(chunks) * batch_size
    if n_pad == n:
        return np.asarray(windows, np.float32), n
    out = np.zeros((n_pad, windows.shape[1] if n else config.FEATURE_SIZE), np.float32)
    if n:
        out[:n] = windows
    return out, n


def _target_vec(capacity: int, target_class: int, num_classes: int) -> np.ndarray:
    """One-hot iff target_class < num_classes, else all-zero (src/lib.rs:592-594)."""
    v = np.zeros((capacity,), np.float32)
    if 0 <= target_class < min(num_classes, capacity):
        v[target_class] = 1.0
    return v


def pretrain_from_features(
    net: SpeakerNet,
    windows: np.ndarray,
    target_class: int,
    num_classes: int,
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    *,
    key: Optional[torch.Tensor] = None,
) -> float:
    """Train on cached feature windows; returns the mean reported loss."""
    windows = np.asarray(windows, np.float32)
    if windows.ndim != 2 or len(windows) == 0:
        return 0.0
    if 0 <= target_class < num_classes and target_class >= net.num_speakers:
        raise ValueError(
            f"target_class {target_class} is masked: net has "
            f"{net.num_speakers} live speakers (grow with "
            "add_output_class/ensure before training this class)"
        )
    batch_size = max(1, int(batch_size))
    padded, n_valid = _pad_windows(windows, batch_size)
    dev = net.device
    params = net.working_params()
    params, mean_loss = T.train_on_windows_impl(
        params,
        torch.from_numpy(padded).to(dev),
        n_valid,
        torch.from_numpy(_target_vec(net.capacity, target_class, num_classes)).to(dev),
        net.num_speakers,
        (key if key is not None else _fresh_key()).to(dev),
        float(lr),
        float(dropout),
        epochs=int(epochs),
        batch_size=batch_size,
    )
    net.params = params
    return float(mean_loss)


def train_from_feature_map(
    net: SpeakerNet,
    feature_map: Dict[str, np.ndarray],
    files: Sequence[Tuple[str, int]],
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    *,
    key: Optional[torch.Tensor] = None,
) -> float:
    """Per-(path, class) training loop (src/lib.rs:632-665)."""
    base_key = key if key is not None else _fresh_key()
    total, count = 0.0, 0
    for i, (path, cls) in enumerate(files):
        wins = feature_map.get(path)
        if wins is None:
            continue
        loss = pretrain_from_features(
            net, wins, cls, net.output_size(), epochs, lr, dropout, batch_size,
            key=prng.fold_in(base_key, i),
        )
        net.record_training_file(cls, path)
        total += loss
        count += 1
    return total / count if count else 0.0
