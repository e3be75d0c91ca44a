"""The incremental open-set discovery loop (the default run mode).

The port of ``streamz_tpu/app/incremental.py``: ``run_incremental`` runs
the device-resident loop (:mod:`streamz_tpu_torch.app.device_loop`) over
the files in list order, ``run_incremental_host`` is the host-stepped
formulation of the same loop that the device loop is tested against, and
``finalize_and_save`` recomputes the stored speaker embeddings, saves
``model.npz`` and prints the summary (``streamz-rs/src/main.rs:840-868``).
Per file, in list order (``src/main.rs:750-835``): skip clips of fewer than
5 windows; embed; while fewer than ``burn_in_limit`` files are processed,
an unlabelled file founds a class without matching (threshold 0.5 during
burn-in, ``--threshold`` after); a labelled file keeps its label; another
joins its best centroid above the threshold or founds a class; train 5
epochs at batch 8 (lr 0.05 for the first 1000 files, then 0.01); update
the speaker's centroid.  ``--max-speakers`` is enforced as documented
(README.md:68): at the cap, an unlabelled file joins its best centroid
instead of spawning a class.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from streamz_tpu_torch import config
from streamz_tpu_torch.app.device_loop import run_incremental_device
from streamz_tpu_torch.dsp.mfcc import DeviceFeatureStore
from streamz_tpu_torch.infer.cosine import (
    compute_speaker_embeddings,
    identify_speaker_from_embedding,
)
from streamz_tpu_torch.infer.embed import (
    average_vectors,
    extract_embedding_from_features,
    normalize,
)
from streamz_tpu_torch.nn import checkpoint, drivers
from streamz_tpu_torch.nn.model import SpeakerNet
from streamz_tpu_torch.parallel.window_parallel import (
    LONG_CLIP_WINDOW_THRESHOLD,
    extract_embedding_sharded,
)
from streamz_tpu_torch.runtime.progress import progress


@dataclasses.dataclass
class IncrementalResult:
    total_loss: float
    processed: int
    speaker_features: Dict[int, List[np.ndarray]]
    speaker_embeddings: Dict[int, np.ndarray]
    # Per processed file: how far its similarities lay from another label.
    decision_margins: List[float] = dataclasses.field(default_factory=list)


def run_incremental(
    net: SpeakerNet,
    train_files: List[Tuple[str, Optional[int]]],
    feature_map: Dict[str, np.ndarray],
    *,
    burn_in_limit: int,
    conf_threshold: float = config.DEFAULT_CONF_THRESHOLD,
    dropout: float = config.DEFAULT_DROPOUT,
    batch_size: int = config.BATCH_SIZE,
    epochs: int = config.INCREMENTAL_EPOCHS,
    max_speakers: Optional[int] = None,
    show_progress: bool = True,
    device_store: Optional[DeviceFeatureStore] = None,
    mesh=None,
) -> IncrementalResult:
    """Mutates ``net`` and the labels inside ``train_files``; returns stats.
    On CUDA each file trains in one K6 launch; with ``device_store`` its
    windows are gathered on the device.  Under a ``mesh`` of two or more
    ranks the loop runs replicated on every rank; ``STREAMZ_SHARD_DISCOVERY``
    set to anything but ``"0"`` asks for the JAX package's sharded scan,
    which is not ported, and raises."""
    shard = os.environ.get("STREAMZ_SHARD_DISCOVERY")
    if mesh is not None and mesh.size() > 1 and shard not in (None, "0"):
        raise NotImplementedError(
            f"STREAMZ_SHARD_DISCOVERY={shard!r} asks for the sharded discovery "
            "scan, which streamz_tpu_torch does not port yet; unset it (or set "
            "it to 0) to run the discovery loop replicated on every rank")
    total_loss, processed, sf, se, margins = run_incremental_device(
        net, train_files, feature_map,
        burn_in_limit=burn_in_limit, conf_threshold=conf_threshold,
        dropout=dropout, batch_size=batch_size, epochs=epochs,
        max_speakers=max_speakers, show_progress=show_progress,
        device_store=device_store,
    )
    return IncrementalResult(total_loss=total_loss, processed=processed,
                             speaker_features=sf, speaker_embeddings=se,
                             decision_margins=margins)


def run_incremental_host(
    net: SpeakerNet,
    train_files: List[Tuple[str, Optional[int]]],
    feature_map: Dict[str, np.ndarray],
    *,
    burn_in_limit: int,
    conf_threshold: float = config.DEFAULT_CONF_THRESHOLD,
    dropout: float = config.DEFAULT_DROPOUT,
    batch_size: int = config.BATCH_SIZE,
    epochs: int = config.INCREMENTAL_EPOCHS,
    max_speakers: Optional[int] = None,
    show_progress: bool = True,
    mesh=None,
) -> IncrementalResult:
    """The host-stepped formulation of the same loop, one host decision per
    file: the oracle the device loop is held to.  Every file trains through
    ``drivers.pretrain_from_features`` with a fresh key (K6 on CUDA).  With
    ``mesh`` a clip of at least ``LONG_CLIP_WINDOW_THRESHOLD`` windows takes
    its embedding sharded over the ranks
    (``streamz_tpu/app/incremental.py:177-182``)."""
    # Seed the centroids from the model's stored embeddings
    # (src/main.rs:715-734).
    speaker_embeddings: Dict[int, np.ndarray] = {
        i: np.asarray(mean, np.float32) for i, (mean, _, _) in enumerate(net.embeddings)
    }
    speaker_features: Dict[int, List[np.ndarray]] = {}
    total_loss = 0.0
    count = 0  # the reference's loss_count atomic: the processed-file clock

    for i in progress(range(len(train_files)), desc="incremental", enabled=show_progress):
        path, label = train_files[i]
        windows = feature_map.get(path)
        if windows is None:
            print(f"Missing audio for {path}")
            continue
        if len(windows) < 5:
            print(f"Skipping {path}, too short")
            continue
        if mesh is not None and len(windows) >= LONG_CLIP_WINDOW_THRESHOLD:
            # Already L2-normalized (its call-site contract).
            emb = extract_embedding_sharded(net, windows, mesh)
        else:
            emb = normalize(extract_embedding_from_features(net, windows))

        burn_phase = count < burn_in_limit
        threshold = 0.5 if burn_phase else conf_threshold
        at_cap = max_speakers is not None and net.output_size() >= max_speakers
        if burn_phase and label is None and not at_cap:
            # Burn-in unlabelled files always found a class without
            # matching (src/main.rs:779-786).
            speaker_id = net.output_size()
            net.add_output_class()
            net.record_training_file(speaker_id, path)
            label = speaker_id
        elif label is not None:
            speaker_id = label
        else:
            matched = identify_speaker_from_embedding(emb, speaker_embeddings, threshold)
            if matched is None or matched >= net.output_size():
                if at_cap:
                    # --max-speakers: the best centroid wins outright.
                    matched = identify_speaker_from_embedding(emb, speaker_embeddings, -2.0)
                    if matched is None:
                        matched = 0
                else:
                    net.add_output_class()
                    matched = net.output_size() - 1
            speaker_id = matched
            label = matched
        train_files[i] = (path, label)

        lr = config.LR_EARLY if count < config.LR_SWITCH_COUNT else config.LR_LATE
        total_loss += drivers.pretrain_from_features(
            net, windows, speaker_id, net.output_size(), epochs, lr, dropout, batch_size)
        net.record_training_file(speaker_id, path)

        speaker_features.setdefault(speaker_id, []).append(emb)
        speaker_embeddings[speaker_id] = average_vectors(speaker_features[speaker_id])
        count += 1
        if count % 100 == 0:
            # Re-sync every centroid from its files (src/main.rs:216-241).
            for sid, feats in speaker_features.items():
                speaker_embeddings[sid] = average_vectors(feats)

    return IncrementalResult(total_loss=total_loss, processed=count,
                             speaker_features=speaker_features,
                             speaker_embeddings=speaker_embeddings)


def finalize_and_save(
    net: SpeakerNet,
    result: IncrementalResult,
    model_path: str = config.MODEL_PATH,
    feature_map=None,
    store: Optional[DeviceFeatureStore] = None,
    mesh=None,
) -> None:
    """Recompute the stored embeddings (the run's in-memory windows where
    the feature cache has none, gathered on the device from ``store``, or
    pooled over ``mesh``), save the model, print the summary."""
    new_embeddings = compute_speaker_embeddings(net, feature_map=feature_map, store=store,
                                                mesh=mesh)
    for i, (embed_v, mean, std) in enumerate(new_embeddings):
        norm = float(np.linalg.norm(embed_v))
        print(
            f"Saving Speaker {i} -> mean_sim: {mean:.4f}, "
            f"std_sim: {std:.4f}, norm: {norm:.4f}"
        )
    net.set_embeddings(new_embeddings)
    checkpoint.save(net, model_path)
    print(f"Computed {len(net.embeddings)} embeddings for {net.output_size()} speakers")
    if result.processed > 0:
        print(f"Average training loss: {result.total_loss / result.processed:.4f}")
