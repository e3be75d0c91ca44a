"""Clip-level embeddings: ReLU-h2 windows pooled per clip, L2-normalized.

The port of the pooling paths of ``streamz_tpu/infer/embed.py``:
``batch_clip_embeddings`` mean-pools (``streamz-rs/src/lib.rs:1450-1471``)
and ``batch_median_embeddings`` median-pools (``src/lib.rs:1474-1495``),
both over clips bucketed by power-of-two window count and padded to a
power-of-two clip count, one call per bucket on the net's device;
``extract_embedding_from_features`` mean-pools one clip.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.nn.model import Params, SpeakerNet, forward_embedding


def normalize(v: np.ndarray) -> np.ndarray:
    """L2-normalize when the norm exceeds 1e-6 (src/lib.rs:132-139)."""
    v = np.asarray(v, np.float32)
    norm = float(np.sqrt((v * v).sum()))
    if norm > 1e-6:
        return v / norm
    return v.copy()


def average_vectors(vectors) -> np.ndarray:
    """Mean of vectors, L2-normalized (src/lib.rs:144-159)."""
    vectors = [np.asarray(v, np.float32) for v in vectors]
    if not vectors:
        return np.zeros((0,), np.float32)
    return normalize(np.mean(vectors, axis=0))


def _fembed_mean_batch(
    params: Params, windows: torch.Tensor, n_valid: torch.Tensor
) -> torch.Tensor:
    """Masked mean ReLU-h2 embeddings. windows: [B, W_pad, F]; n_valid: [B]
    → [B, h2]."""
    e = forward_embedding(params, windows)  # [B, W, h2]
    mask = torch.arange(windows.shape[1], device=windows.device)[None, :] < n_valid[:, None]
    e = e * mask[..., None]
    return e.sum(dim=1) / torch.clamp(n_valid[:, None].to(e.dtype), min=1.0)


def _fembed_median_batch(
    params: Params, windows: torch.Tensor, n_valid: torch.Tensor
) -> torch.Tensor:
    """Masked exact median ReLU-h2 embeddings: padding rows sort to +inf and
    the two middle order statistics of the true count are averaged (the
    reference's even/odd midpoint rule, src/lib.rs:1483-1492)."""
    e = forward_embedding(params, windows)  # [B, W, h2]
    W = windows.shape[1]
    mask = (torch.arange(W, device=windows.device)[None, :] < n_valid[:, None])[..., None]
    s = torch.sort(torch.where(mask, e, torch.full((), float("inf"), device=e.device)),
                   dim=1).values
    n = torch.clamp(n_valid, min=1)
    B, _, H = s.shape
    lo = torch.gather(s, 1, ((n - 1) // 2).view(B, 1, 1).expand(B, 1, H))
    hi = torch.gather(s, 1, (n // 2).view(B, 1, 1).expand(B, 1, H))
    return ((lo + hi) / 2.0)[:, 0, :]


def _batch_pooled(
    net: SpeakerNet, clips, kernel: Callable[..., torch.Tensor]
) -> List[np.ndarray]:
    """Shared scaffold: bucket clips by power-of-two window count, pad each
    bucket's clip axis to a power of two (n_valid = 0 rows are masked
    no-ops), run ``kernel`` once per bucket and L2-normalize on the host."""
    arrs = [np.asarray(c, np.float32) for c in clips]
    out: List[np.ndarray] = [None] * len(arrs)  # type: ignore[list-item]
    buckets: dict = {}
    feat = next((a.shape[1] for a in arrs if a.ndim == 2 and len(a)), None)
    for i, a in enumerate(arrs):
        if len(a) == 0:
            out[i] = np.zeros((net.embedding_size(),), np.float32)
            continue
        buckets.setdefault(config.next_pow2(len(a)), []).append(i)
    params = net.params
    for n_pad, idxs in buckets.items():
        B_pad = config.next_pow2(len(idxs))
        lens = np.zeros((B_pad,), np.int64)
        batch = np.zeros((B_pad, n_pad, feat), np.float32)
        for row, i in enumerate(idxs):
            lens[row] = len(arrs[i])
            batch[row, : len(arrs[i])] = arrs[i]
        with torch.inference_mode():
            embs = kernel(
                params,
                torch.from_numpy(batch).to(net.device),
                torch.from_numpy(lens).to(net.device),
            ).cpu().numpy()
        for row, i in enumerate(idxs):
            out[i] = normalize(embs[row])
    return out


def batch_clip_embeddings(net: SpeakerNet, clips) -> List[np.ndarray]:
    """Mean-pooled ReLU-h2 embeddings for many clips in few device calls,
    each L2-normalized (the per-clip ``extract_embedding_from_features``
    contract, batched)."""
    return _batch_pooled(net, clips, _fembed_mean_batch)


def batch_median_embeddings(net: SpeakerNet, clips) -> List[np.ndarray]:
    """Median-pooled ReLU-h2 embeddings for many clips, bucketed and
    batched, each L2-normalized."""
    return _batch_pooled(net, clips, _fembed_median_batch)


def extract_embedding_from_features(net: SpeakerNet, feats: np.ndarray) -> np.ndarray:
    """Mean-pooled ReLU-h2 embedding of one clip, L2-normalized
    (src/lib.rs:1450-1471)."""
    feats = np.asarray(feats, np.float32)
    if len(feats) == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    with torch.inference_mode():
        e = forward_embedding(net.params, torch.from_numpy(feats).to(net.device))
        emb = e.mean(dim=0).cpu().numpy()
    return normalize(emb)
