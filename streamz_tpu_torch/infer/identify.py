"""Speaker identification by gated per-window votes.

The port of the batched vote pipeline of ``streamz_tpu/infer/identify.py``
(``identify_speaker_list``, ``streamz-rs/src/lib.rs:1383-1411``): a window
votes for its argmax class when that probability clears the threshold;
speakers come back sorted by descending vote count, ties in ascending id.
This is the pipeline the JAX package's ``bench.py`` times: frontend →
``forward`` → gated votes.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.nn.model import Params, SpeakerNet, forward


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
