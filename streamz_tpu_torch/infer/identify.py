"""Speaker identification by summed or gated per-window votes.

The port of ``streamz_tpu/infer/identify.py`` on one device, through the
FP32 ``nn/model.forward`` (as the JAX identifiers run XLA's forward):

- ``identify_speaker``: the argmax of the window softmax sums
  (``streamz-rs/src/lib.rs:1285-1303``);
- ``identify_speaker_with_threshold(_feats)``: confidence = best sum /
  window count, ``None`` below the threshold or when ``output_size <= 1``
  (``src/lib.rs:1307-1377``);
- ``identify_speaker_list`` and its batched form
  ``identify_speaker_list_batch`` (``src/lib.rs:1383-1411``): a window
  votes for its argmax class when that probability clears the threshold;
  speakers come back sorted by descending vote count, ties in ascending
  id.  The batched form is the pipeline the JAX package's ``bench.py``
  times: frontend → ``forward`` → gated votes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.dsp.features import extract_with
from streamz_tpu_torch.nn.model import Params, SpeakerNet, forward


def _probs(net: SpeakerNet, windows: np.ndarray) -> torch.Tensor:
    """[W, capacity] softmax probabilities of the windows."""
    with torch.inference_mode():
        return forward(net.params, torch.from_numpy(np.asarray(windows, np.float32))
                       .to(net.device), net.num_speakers)


def identify_speaker(net: SpeakerNet, sample, extractor=None) -> int:
    """Argmax of the summed window softmax of raw PCM (src/lib.rs:1285-1303);
    0 without speakers or windows."""
    if not net.num_speakers:
        return 0
    windows = extract_with(extractor, sample)
    if len(windows) == 0:
        return 0
    sums = _probs(net, windows).sum(dim=0).cpu().numpy()
    return int(sums[: net.num_speakers].argmax())


def identify_speaker_with_threshold_feats(
    net: SpeakerNet, windows: np.ndarray, threshold: float
) -> Optional[int]:
    """Thresholded voting on precomputed windows (src/lib.rs:1346-1377): a
    single-speaker net always answers ``None`` (:1316-1318); a bare [F]
    vector is one window."""
    if net.output_size() <= 1:
        return None
    windows = np.asarray(windows, np.float32)
    if windows.ndim == 1:
        windows = windows.reshape(1, -1)
    if len(windows) == 0:
        return None
    sums = _probs(net, windows).sum(dim=0).cpu().numpy()[: net.num_speakers]
    best_idx = int(sums.argmax())
    confidence = float(sums[best_idx]) / len(windows)
    return best_idx if confidence >= threshold else None


def identify_speaker_with_threshold(
    net: SpeakerNet, sample, threshold: float, extractor=None
) -> Optional[int]:
    """Thresholded voting on raw PCM (src/lib.rs:1307-1343)."""
    if net.output_size() <= 1:
        return None
    return identify_speaker_with_threshold_feats(
        net, extract_with(extractor, sample), threshold)


def identify_speaker_list(
    net: SpeakerNet, sample, threshold: float, extractor=None
) -> List[int]:
    """All speakers present in raw PCM, by gated per-window votes
    (src/lib.rs:1383-1411)."""
    windows = extract_with(extractor, sample)
    if len(windows) == 0 or net.num_speakers == 0:
        return []
    return _list_from_probs(_probs(net, windows).cpu().numpy(), net.num_speakers,
                            threshold)


def _sorted_from_counts(counts: np.ndarray, num_speakers: int) -> List[int]:
    """Speakers with at least one vote, by descending count, ties in
    ascending id."""
    return sorted(
        (i for i in range(num_speakers) if counts[i] > 0),
        key=lambda i: (-counts[i], i),
    )


def _list_from_probs(probs: np.ndarray, num_speakers: int, threshold: float) -> List[int]:
    """The vote-count/sort tail of ``identify_speaker_list`` on one clip's
    [W, >= num_speakers] probabilities.  The gate compares in f32, as the
    reference's f32 ``prob >= threshold`` does."""
    probs = probs[:, :num_speakers]
    best = probs.argmax(axis=1)
    best_val = probs.max(axis=1)
    counts = np.bincount(
        best[best_val >= np.float32(threshold)], minlength=num_speakers
    )
    return _sorted_from_counts(counts, num_speakers)


def _vote_counts_batch(
    params: Params,
    windows: torch.Tensor,
    n_valid: torch.Tensor,
    num_speakers: int,
    threshold: float,
) -> torch.Tensor:
    """Per-clip gated vote counts for padded clip batches.

    windows: [B, W_pad, F]; n_valid: [B] → counts [B, capacity].  A padding
    window never votes.  The gate compares in f32.
    """
    probs = forward(params, windows, num_speakers)       # [B, W, cap]
    best_val, best = probs.max(dim=-1)                   # [B, W]
    valid = torch.arange(windows.shape[1], device=windows.device)[None, :] < n_valid[:, None]
    gate = valid & (best_val >= torch.tensor(threshold, dtype=torch.float32))
    counts = torch.zeros(probs.shape[0], probs.shape[-1], dtype=torch.int64,
                         device=probs.device)
    return counts.scatter_add_(1, best, gate.to(torch.int64))


def identify_speaker_list_batch(
    net: SpeakerNet, clips, threshold: float, extractor
) -> List[List[int]]:
    """Batched ``identify_speaker_list`` over many PCM clips.

    One frontend call per length bucket (``extractor``), then one gated
    vote-count call per power-of-two window-count bucket on the net's
    device.  Per-clip results are the descending-count / ascending-id
    speaker lists.
    """
    clips = list(clips)
    if not clips or net.num_speakers == 0:
        return [[] for _ in clips]
    wins = extractor.extract_batch([np.asarray(c) for c in clips])
    out: List[List[int]] = [[] for _ in clips]
    buckets: dict = {}
    feat = next((w.shape[1] for w in wins if len(w)), None)
    for i, w in enumerate(wins):
        if len(w):
            buckets.setdefault(config.next_pow2(len(w)), []).append(i)
    ns = net.num_speakers
    for n_pad, idxs in buckets.items():
        lens = np.asarray([len(wins[i]) for i in idxs], np.int64)
        batch = np.zeros((len(idxs), n_pad, feat), np.float32)
        for row, i in enumerate(idxs):
            batch[row, : len(wins[i])] = wins[i]
        with torch.inference_mode():
            counts = _vote_counts_batch(
                net.params,
                torch.from_numpy(batch).to(net.device),
                torch.from_numpy(lens).to(net.device),
                ns, threshold,
            ).cpu().numpy()
        for row, i in enumerate(idxs):
            out[i] = _sorted_from_counts(counts[row], ns)
    return out
