"""Host-side training drivers of the reference's orchestration API.

The port of ``streamz_tpu/nn/drivers.py``:

- ``pretrain_from_features`` (``streamz-rs/src/lib.rs:582-628``)
- ``pretrain_network``, a fresh augmentation of the raw PCM every epoch
  (``src/lib.rs:348-397``), on the net's device
- ``train_from_feature_map`` (``src/lib.rs:632-665``)
- ``train_from_files`` with the 0.99^step lr decay (``src/lib.rs:668-732``),
  rebuilt as a deterministic sequential loop, as the JAX package rebuilds
  the reference's rayon loop (SURVEY.md §7.7)

Each pads a file's windows to a power-of-two number of chunks and trains
them through :func:`streamz_tpu_torch.nn.train.train_on_windows_impl` (one
K6 launch on CUDA).  On a card ``pretrain_network`` keeps the clip there
for all its epochs: augment, the frontend (K1 or K2) and K6 per epoch, with
only the loss read back.

Keys come from the threefry twin (:mod:`streamz_tpu_torch.nn.prng`) with
the JAX package's process-global counter, so a fresh process draws
``PRNGKey(1)`` first in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.dsp.augment import augment
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.io.audio import load_and_resample_file
from streamz_tpu_torch.nn import prng
from streamz_tpu_torch.nn import train as T
from streamz_tpu_torch.nn.model import SpeakerNet

_key_counter = [0]


def _fresh_key(seed: Optional[int] = None, device=None) -> torch.Tensor:
    if seed is None:
        _key_counter[0] += 1
        seed = _key_counter[0]
    return prng.PRNGKey(seed, device=device)


def _pad_windows(windows: torch.Tensor, batch_size: int) -> Tuple[torch.Tensor, int]:
    """Pad [N, F] windows with zero rows up to batch_size *
    next_pow2(ceil(N/bs)) rows, on their device; ``batch_size`` is clamped
    to >= 1 (src/lib.rs:371, :602).  Returns (padded, N)."""
    batch_size = max(1, int(batch_size))
    n = int(windows.shape[0])
    n_pad = config.next_pow2(max(1, -(-n // batch_size))) * batch_size
    if n_pad == n:
        return windows, n
    out = torch.zeros((n_pad, windows.shape[1]), dtype=torch.float32,
                      device=windows.device)
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
    windows,
    target_class: int,
    num_classes: int,
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    *,
    key: Optional[torch.Tensor] = None,
) -> float:
    """Train on feature windows [N, F], a host array or a tensor on the
    net's device; returns the mean reported loss."""
    dev = net.device
    windows = torch.as_tensor(windows, dtype=torch.float32).to(dev)
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
    params = net.working_params()
    params, mean_loss = T.train_on_windows_impl(
        params,
        padded,
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


def pretrain_network(
    net: SpeakerNet,
    samples,
    target_class: int,
    num_classes: int,
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    extractor: Optional[FeatureExtractor] = None,
    *,
    key: Optional[torch.Tensor] = None,
) -> float:
    """Raw-PCM trainer with a fresh augmentation every epoch
    (src/lib.rs:348-397); returns the mean of the epochs' losses.

    Per epoch ``e``: ``fold_in(key, e)`` split into the augmentation's key
    and the trainer's, :func:`augment` of the raw-scale PCM, the i16 cast,
    the frontend through ``extractor`` (by default one on the net's
    device) and one epoch of :func:`pretrain_from_features`.  The clip is
    uploaded once for all epochs, as the JAX package does."""
    dev = net.device
    extractor = extractor or FeatureExtractor(device=dev)
    base_key = key if key is not None else _fresh_key()
    feat_dev = extractor.device if extractor.backend != "numpy" else torch.device("cpu")
    pcm = torch.as_tensor(np.asarray(samples)).to(feat_dev, torch.float32)
    total, count = 0.0, 0
    for e in range(int(epochs)):
        k_aug, k_train = prng.split(prng.fold_in(base_key.to(feat_dev), e))
        # The JAX package's astype(np.int16) and the frontend's i16
        # scaling, on the device.
        aug = augment(k_aug, pcm).to(torch.int16).to(torch.float32) / 32767.0
        if extractor.backend == "numpy":
            windows = extractor.extract(aug.numpy())
        else:
            windows = extractor.extract_device(aug)
        if len(windows) == 0:
            continue
        loss = pretrain_from_features(
            net, windows, target_class, num_classes, 1, lr, dropout, batch_size,
            key=k_train,
        )
        total += loss
        count += 1
    return total / count if count else 0.0


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


def train_from_files(
    net: SpeakerNet,
    files: Sequence[Tuple[str, int]],
    num_speakers: int,
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    extractor: Optional[FeatureExtractor] = None,
    *,
    key: Optional[torch.Tensor] = None,
) -> float:
    """Deterministic rebuild of the rayon file loop (src/lib.rs:668-732).

    The lr decays as ``lr * 0.99**step`` with one global step per
    (file, epoch), matching the reference's atomic counter (``:709``) under
    the deterministic sequential order; each (file, epoch) is one
    :func:`pretrain_network` epoch keyed ``fold_in(key, step)``.  Files that
    fail to load are skipped.  Returns the mean loss over the (file,
    epoch) steps (the JAX package returns None)."""
    extractor = extractor or FeatureExtractor(device=net.device)
    base_key = key if key is not None else _fresh_key()
    step = 0
    total = 0.0
    for path, cls in files:
        try:
            _, samples = load_and_resample_file(path)
        except Exception:
            continue
        net.set_dataset_specs(config.DEFAULT_SAMPLE_RATE, 16)
        for _ in range(int(epochs)):
            lr_scaled = lr * (0.99 ** step)
            step += 1
            total += pretrain_network(
                net, samples, cls, num_speakers, 1, lr_scaled, dropout,
                batch_size, extractor, key=prng.fold_in(base_key, step),
            )
            net.record_training_file(cls, path)
    return total / step if step else 0.0
