"""``--check-embeddings``: embedding-quality report
(``streamz-rs/src/main.rs:243-279``); the port of
``streamz_tpu/app/embedquality.py``."""

from __future__ import annotations

from streamz_tpu_torch.infer.cosine import compute_speaker_embeddings
from streamz_tpu_torch.nn.model import SpeakerNet


def _report(items) -> None:
    total = 0.0
    for i, (_mean, mean_sim, std_sim) in enumerate(items):
        total += mean_sim
        print(
            f"Speaker {i}: mean similarity {mean_sim:.4f}, "
            f"std dev {std_sim:.4f}"
        )
    print(f"Average mean similarity: {total / len(items):.4f}")


def print_embedding_quality(net: SpeakerNet, extractor=None) -> None:
    """The stored embeddings' similarity stats, or, where ``model.npz``
    has none, those recomputed from the speakers' files."""
    if net.embeddings:
        print("Saved embeddings found in model.npz:")
        _report(net.embeddings)
        return
    embeds = compute_speaker_embeddings(net, extractor)
    if not embeds:
        print("No embeddings available to evaluate")
        return
    _report(embeds)
