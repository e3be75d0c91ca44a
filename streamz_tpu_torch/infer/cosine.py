"""Cosine-similarity centroid matching with the reference's adaptive gate.

The port of ``streamz_tpu/infer/cosine.py``:

- ``cosine_similarity`` and ``cosine_matrix_many``: cosine of one or many
  embeddings vs many centroids, zero when either norm is zero
  (``streamz-rs/src/lib.rs:1532-1541``);
- ``identify_speaker_from_embedding`` (``src/lib.rs:1499-1529``): best
  centroid by cosine, the threshold relaxed to ``0.7 * threshold`` under 20
  speakers, ``None`` for "new speaker";
- ``identify_sims_cosine``: the adaptive per-speaker gate of
  ``identify_speaker_cosine_feats`` (``src/lib.rs:1634-1661``) on a
  precomputed similarity row — reject ``sim < mean_sim - 2*std_sim``; accept
  when ``sim > 0.35`` and (``sim > mean_sim + std_sim*f`` or ``sim > 0.5``)
  with ``f = 0.3`` under 200 speakers else 1.0; the winner must also beat the
  caller's threshold; ``identify_embedding_cosine``,
  ``identify_speaker_cosine`` (raw PCM, ``src/lib.rs:1604-1631``) and
  ``identify_speaker_cosine_feats`` apply it to one clip;
- ``compute_speaker_embeddings`` (``src/lib.rs:1555-1599``): per-speaker
  centroid = normalized mean of per-file median embeddings, plus mean/std
  of the files' cosine to it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from streamz_tpu_torch.dsp.features import load_cached_features, save_cached_features
from streamz_tpu_torch.infer.embed import (
    batch_median_embeddings,
    extract_embedding,
    extract_embedding_from_features,
    normalize,
)
from streamz_tpu_torch.io import audio
from streamz_tpu_torch.nn.model import SpeakerNet

SpeakerStats = Tuple[np.ndarray, float, float]  # (mean, mean_sim, std_sim)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine of two vectors; zero when either norm is zero."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    na = float(np.sqrt((a * a).sum()))
    nb = float(np.sqrt((b * b).sum()))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(a @ b) / (na * nb)


def cosine_matrix_many(embs: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Cosine of many embeddings vs many centroids, zero-norm safe. [n, s]"""
    embs = np.asarray(embs, np.float32)
    centroids = np.asarray(centroids, np.float32)
    ne = np.sqrt((embs * embs).sum(axis=1))          # [n]
    nc = np.sqrt((centroids * centroids).sum(axis=1))  # [s]
    dots = embs @ centroids.T                        # [n, s]
    denom = ne[:, None] * nc[None, :]
    return np.where(denom > 0.0, dots / np.where(denom == 0.0, 1.0, denom), 0.0)


def identify_speaker_from_embedding(
    emb: np.ndarray,
    speaker_embeddings: Dict[int, np.ndarray],
    threshold: float,
) -> Optional[int]:
    """Best-centroid match with the <20-speaker relaxation (src/lib.rs:1499-1529).
    Returns the speaker id, or ``None`` for "create a new speaker"."""
    if not speaker_embeddings:
        return None
    ids = list(speaker_embeddings.keys())
    centroids = np.stack([np.asarray(speaker_embeddings[i], np.float32) for i in ids])
    sims = cosine_matrix_many(np.asarray(emb, np.float32)[None, :], centroids)[0]
    best = int(np.argmax(sims))
    dynamic_threshold = threshold * 0.7 if len(ids) < 20 else threshold
    if float(sims[best]) > dynamic_threshold:
        return ids[best]
    return None


def identify_sims_cosine(
    sims: np.ndarray,
    speaker_embeds: Sequence[SpeakerStats],
    threshold: float,
):
    """The adaptive gate on a precomputed ``[n_speakers]`` cosine row.
    Returns the speaker id, or None for "unknown"."""
    if not speaker_embeds:
        return None
    sims = np.asarray(sims, np.float32)
    mean_sims = np.array([m for _, m, _ in speaker_embeds], np.float32)
    std_sims = np.array([s for _, _, s in speaker_embeds], np.float32)

    factor = 0.3 if len(speaker_embeds) < 200 else 1.0
    not_rejected = sims >= (mean_sims - 2.0 * std_sims)
    dynamic = mean_sims + std_sims * factor
    accepted = (sims > 0.35) & ((sims > dynamic) | (sims > 0.5)) & not_rejected

    # The reference loop's exact semantics: float64 compare against the
    # threshold, strict greater-than, first index wins ties.
    cand = np.flatnonzero(accepted & (sims.astype(np.float64) > threshold))
    if cand.size == 0:
        return None
    return int(cand[np.argmax(sims[cand])])


def identify_embedding_cosine(emb: np.ndarray, speaker_embeds: Sequence[SpeakerStats],
                              threshold: float) -> Optional[int]:
    """The adaptive gate on a precomputed clip embedding (need not be
    normalized: cosine is scale-invariant)."""
    if not speaker_embeds:
        return None
    centroids = np.stack([np.asarray(m, np.float32) for m, _, _ in speaker_embeds])
    sims = cosine_matrix_many(np.asarray(emb, np.float32)[None, :], centroids)[0]
    return identify_sims_cosine(sims, speaker_embeds, threshold)


def identify_speaker_cosine(net: SpeakerNet, speaker_embeds: Sequence[SpeakerStats],
                            sample, threshold: float, extractor=None) -> Optional[int]:
    """The adaptive gate on raw PCM through the median tanh-h2 embedding
    (src/lib.rs:1604-1631)."""
    if not speaker_embeds:
        return None
    return identify_embedding_cosine(extract_embedding(net, sample, extractor),
                                     speaker_embeds, threshold)


def identify_speaker_cosine_feats(net: SpeakerNet, speaker_embeds: Sequence[SpeakerStats],
                                  windows: np.ndarray, threshold: float) -> Optional[int]:
    """The adaptive gate on precomputed windows through the mean ReLU-h2
    embedding (src/lib.rs:1634-1661)."""
    if not speaker_embeds:
        return None
    return identify_embedding_cosine(extract_embedding_from_features(net, windows),
                                     speaker_embeds, threshold)


def compute_speaker_embeddings(
    net: SpeakerNet, extractor=None, feature_map=None, store=None, mesh=None
) -> List[SpeakerStats]:
    """Per-speaker (mean, mean_sim, std_sim) from the feature cache
    (src/lib.rs:1555-1599): each listed file's windows are loaded from
    ``feature_cache/`` or computed with ``extractor`` and cached; a file
    that fails to load is skipped.  With ``feature_map`` (this run's
    path → windows), an existing cache file still wins, and a missing one
    takes the map's windows and publishes them to the cache instead of
    decoding the file again.  With ``store`` (the ingest stage's
    path-keyed ``DeviceFeatureStore``) those map-sourced clips are gathered
    on the device; a clip read from the cache carries a key that misses.
    One stats entry per live class; a class without files gets a zero
    centroid.  With ``mesh`` the pooled embedding batches shard their clip
    axis over the ranks (``streamz_tpu/infer/cosine.py:186-249``)."""
    per_speaker_wins: List[List[np.ndarray]] = []
    flat_keys: List[object] = []
    file_lists: List[List[str]] = list(net.file_lists[: net.output_size()])
    file_lists += [[] for _ in range(net.output_size() - len(file_lists))]
    for files in file_lists:
        wins_list: List[np.ndarray] = []
        for path in files:
            from_map = (feature_map is not None and feature_map.get(path) is not None
                        and not audio.feature_cache_path(path).exists())
            if from_map:
                wins = feature_map[path]
                try:
                    save_cached_features(path, wins)
                except Exception:
                    pass  # publishing is best-effort; the windows are in hand
            else:
                try:
                    wins = load_cached_features(path, extractor)
                except Exception:
                    # The reference skips a file it cannot load (src/lib.rs:1569).
                    continue
            wins_list.append(wins)
            flat_keys.append(path if from_map else object())
        per_speaker_wins.append(wins_list)

    flat = [w for wins in per_speaker_wins for w in wins]
    it = iter(batch_median_embeddings(net, flat, store=store, keys=flat_keys, mesh=mesh))

    out: List[SpeakerStats] = []
    for wins_list in per_speaker_wins:
        embeds = [next(it) for _ in wins_list]
        if not embeds:
            out.append((np.zeros((net.embedding_size(),), np.float32), 0.0, 0.0))
            continue
        mean = normalize(np.mean(embeds, axis=0))
        sims = cosine_matrix_many(np.stack(embeds), mean[None, :])[:, 0]
        mean_sim = float(sims.mean())
        std_sim = float(np.sqrt(((sims - mean_sim) ** 2).mean()))
        out.append((mean, mean_sim, std_sim))
    return out
