"""The incremental open-set discovery loop (the default run mode).

The port of ``streamz_tpu/app/incremental.py``: ``run_incremental`` runs
the device-resident loop (:mod:`streamz_tpu_torch.app.device_loop`) over
the files in list order, and ``finalize_and_save`` recomputes the stored
speaker embeddings, saves ``model.npz`` and prints the summary
(``streamz-rs/src/main.rs:840-868``).  ``--max-speakers`` is enforced as
documented (README.md:68): at the cap, an unlabelled file joins its best
centroid instead of spawning a class.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from streamz_tpu_torch import config
from streamz_tpu_torch.app.device_loop import run_incremental_device
from streamz_tpu_torch.infer.cosine import compute_speaker_embeddings
from streamz_tpu_torch.nn import checkpoint
from streamz_tpu_torch.nn.model import SpeakerNet


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
) -> IncrementalResult:
    """Mutates ``net`` and the labels inside ``train_files``; returns stats.
    On CUDA each file trains in one K6 launch."""
    total_loss, processed, sf, se, margins = run_incremental_device(
        net, train_files, feature_map,
        burn_in_limit=burn_in_limit, conf_threshold=conf_threshold,
        dropout=dropout, batch_size=batch_size, epochs=epochs,
        max_speakers=max_speakers, show_progress=show_progress,
    )
    return IncrementalResult(total_loss=total_loss, processed=processed,
                             speaker_features=sf, speaker_embeddings=se,
                             decision_margins=margins)


def finalize_and_save(
    net: SpeakerNet,
    result: IncrementalResult,
    model_path: str = config.MODEL_PATH,
    feature_map=None,
) -> None:
    """Recompute the stored embeddings (the run's in-memory windows where
    the feature cache has none), save the model, print the summary."""
    new_embeddings = compute_speaker_embeddings(net, feature_map=feature_map)
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
