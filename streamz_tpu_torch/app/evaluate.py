"""``--eval`` mode: accuracy/precision/recall/F1 against stored centroids.

Rebuild of ``streamz-rs/src/main.rs:522-625``.  Note the documented asymmetry:
eval matches with *plain* ``sim > threshold`` (``:589``), not the adaptive
gate used during training.  Metric formulas reproduce ``:613-623`` exactly:

    accuracy  = correct / max(len(targets), 1)
    precision = TP / max(TP + FP, 1)
    recall    = TP / max(TP + FN, 1)
    f1        = 2PR / max(P + R, 1e-6)

``--eval-split`` support: when ``target_files.txt`` is absent, a fraction of
the *labeled* training entries (the tail of the list, deterministic) is used
as the evaluation set — this flag is documented in the reference README
(README.md:72) but dead in its code; implemented for real here.

The port of ``streamz_tpu/app/evaluate.py`` on one device.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from streamz_tpu_torch.infer.cosine import cosine_matrix_many
from streamz_tpu_torch.infer.embed import batch_clip_embeddings
from streamz_tpu_torch.io import filelists as fl
from streamz_tpu_torch.nn.model import SpeakerNet


def evaluate(
    net: SpeakerNet,
    feature_map: Dict[str, np.ndarray],
    target_files: List[Tuple[str, int]],
    threshold: float,
    *,
    verbose: bool = True,
    store=None,
) -> Dict[str, float]:
    """Run the evaluation loop; returns the metrics dict.

    The file-vs-centroid similarities are one [n_files x n_speakers] GEMM
    (``cosine_matrix_many``), not a per-centroid Python loop — the O(S)
    work per file is only the verbose logging.

    With ``store`` (the ingest stage's
    :class:`~streamz_tpu_torch.dsp.mfcc.DeviceFeatureStore`, path-keyed,
    built from the SAME ``feature_map`` this call reads) the embedding
    batches gather the features on the device instead of uploading them
    again — the same embeddings bit for bit.
    """

    def log(msg: str) -> None:
        if verbose:
            print(msg, file=sys.stderr)

    # Batched clip embeddings vs the [S x dim] centroid matrix.
    centroid_list = [np.asarray(mean, np.float32) for mean, _, _ in net.embeddings]
    log(f"Total speaker embeddings available: {len(centroid_list)}")

    true_positive = false_positive = false_negative = correct = 0

    # All clip embeddings in a few bucketed device calls (the per-clip
    # device round trip would dominate wall time otherwise).
    present = [(p, c) for p, c in target_files if feature_map.get(p) is not None]
    embeddings = batch_clip_embeddings(
        net, [feature_map[p] for p, _ in present],
        store=store, keys=[p for p, _ in present],
    )
    emb_by_path = {p: e for (p, _), e in zip(present, embeddings)}
    if centroid_list and present:
        sim_matrix = cosine_matrix_many(np.stack(embeddings), np.stack(centroid_list))
    else:
        sim_matrix = np.zeros((len(present), len(centroid_list)), np.float32)
    sims_by_path = {p: sim_matrix[i] for i, (p, _) in enumerate(present)}

    for path, true_class in target_files:
        windows = feature_map.get(path)
        if windows is None:
            log(f"No features found for {path}")
            continue
        embedding = emb_by_path[path]
        emb_norm = float(np.linalg.norm(embedding))
        log(
            f"\nEvaluating file: {path}\nTrue class: {true_class}"
            f"\nEmbedding norm: {emb_norm:.6f}"
        )

        sims = sims_by_path[path]
        # Per-speaker work only under verbose: the f-string below is
        # evaluated per (file, speaker), which at the 1000-speaker scale
        # is millions of pure-Python formats the docstring promises are
        # logging-only.  The decision itself is one argmax (first max ==
        # the loop's strict-greater winner; > threshold on the max ==
        # "any candidate exceeded it").
        if verbose:
            for sid in range(len(centroid_list)):
                log(f"  -> Similarity to speaker {sid}: {float(sims[sid]):.6f}")
        best_id: Optional[int] = None
        if len(centroid_list):
            cand = int(np.asarray(sims[: len(centroid_list)]).argmax())
            if float(sims[cand]) > threshold:
                best_id = cand

        if best_id == true_class:
            correct += 1
            true_positive += 1
        elif best_id is None:
            false_negative += 1
            log("  -> Unclassified")
        else:
            false_positive += 1
            log(
                f"  -> Misclassified: predicted speaker {best_id}, "
                f"true speaker {true_class}"
            )

    total = max(len(target_files), 1)
    accuracy = correct / total
    precision = true_positive / max(true_positive + false_positive, 1)
    recall = true_positive / max(true_positive + false_negative, 1)
    f1 = 2.0 * precision * recall / max(precision + recall, 1e-6)

    print("\nEvaluation complete:")
    print(f"  Accuracy:  {100.0 * accuracy:.2f}%")
    print(f"  Precision: {100.0 * precision:.2f}%")
    print(f"  Recall:    {100.0 * recall:.2f}%")
    print(f"  F1-score:  {100.0 * f1:.2f}%")
    return {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "correct": correct,
        "true_positive": true_positive,
        "false_positive": false_positive,
        "false_negative": false_negative,
    }


def resolve_eval_targets(
    train_files: List[Tuple[str, object]],
    target_files: List[Tuple[str, int]],
    eval_split: float,
) -> List[Tuple[str, int]]:
    """Resolve the evaluation set from the ALREADY-LOADED (and precached)
    lists: ``target_files`` when present, else the tail ``eval_split``
    fraction of the labeled training entries.

    Takes the in-memory lists, not the list *files*, because
    ``precache_mp3_files``/``precache_target_files`` rewrite MP3 entries to
    their cache-WAV paths in place and the feature map is keyed by those
    rewritten paths.  CONSCIOUS FIX of a reference bug (QUIRKS.md): the
    reference RE-loads the raw list inside eval mode (``src/main.rs:525``)
    and looks those original MP3 paths up in the precached-keyed map
    (``:573``), silently evaluating zero files for any hand-written MP3
    target list."""
    if target_files:
        return list(target_files)
    labeled = [(p, c) for p, c in train_files if c is not None]
    if not labeled or eval_split <= 0.0:
        return []
    n_eval = max(1, int(round(len(labeled) * min(eval_split, 1.0))))
    return labeled[-n_eval:]


def build_eval_targets(
    train_file_list: str,
    target_file_list: str,
    eval_split: float,
) -> List[Tuple[str, int]]:
    """File-path variant of :func:`resolve_eval_targets` (loads the lists
    fresh; callers that precached MP3 entries must use the in-memory
    variant instead)."""
    return resolve_eval_targets(
        fl.load_train_files(train_file_list),
        fl.load_target_files(target_file_list),
        eval_split,
    )
