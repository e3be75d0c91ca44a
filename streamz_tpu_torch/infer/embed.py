"""Clip-level embeddings: windows pooled per clip, L2-normalized.

The port of ``streamz_tpu/infer/embed.py``, with the reference's
intentional asymmetries between call sites: ``extract_embedding`` pools the
tanh-h2 head of raw PCM with a per-dimension median
(``streamz-rs/src/lib.rs:1418-1447``), ``extract_embedding_from_features``
the ReLU-h2 head with a mean (``src/lib.rs:1450-1471``) and
``median_embedding_from_features`` the ReLU-h2 head with a median
(``src/lib.rs:1474-1495``).  ``batch_clip_embeddings`` and
``batch_median_embeddings`` are the last two over many clips, bucketed by
power-of-two window count and padded to a power-of-two clip count, one
call per bucket on the net's device; with the ingest stage's
``DeviceFeatureStore`` a bucket gathers its rows on the device, and with a
``mesh`` each rank pools its share of a bucket's clips and the embeddings
come back to every rank (``streamz_tpu/infer/embed.py:72-226``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.device import upload
from streamz_tpu_torch.dsp.features import extract_with
from streamz_tpu_torch.dsp.mfcc import DeviceFeatureStore
from streamz_tpu_torch.nn.model import Params, SpeakerNet, embed, forward_embedding
from streamz_tpu_torch.parallel.mesh import fetch, pad_rows_to_mesh, put_batch_sharded


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


average_features = average_vectors  # src/lib.rs:162-164


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
    return _masked_median(forward_embedding(params, windows), n_valid)


def _masked_median(e: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Per-clip median over the first ``n_valid`` rows of e [B, W, H] → [B, H],
    the midpoint of the two middle order statistics for an even count (as
    ``jnp.median``)."""
    W = e.shape[1]
    mask = (torch.arange(W, device=e.device)[None, :] < n_valid[:, None])[..., None]
    s = torch.sort(torch.where(mask, e, torch.full((), float("inf"), device=e.device)),
                   dim=1).values
    n = torch.clamp(n_valid, min=1)
    B, _, H = s.shape
    lo = torch.gather(s, 1, ((n - 1) // 2).view(B, 1, 1).expand(B, 1, H))
    hi = torch.gather(s, 1, (n // 2).view(B, 1, 1).expand(B, 1, H))
    return ((lo + hi) / 2.0)[:, 0, :]


def _batch_pooled(
    net: SpeakerNet, clips, kernel: Callable[..., torch.Tensor],
    store: Optional[DeviceFeatureStore] = None, keys: Optional[Sequence] = None,
    mesh=None,
) -> List[np.ndarray]:
    """Shared scaffold: bucket clips by power-of-two window count, pad each
    bucket's clip axis to a power of two (n_valid = 0 rows are masked
    no-ops), run ``kernel`` once per bucket and L2-normalize on the host.

    With ``store`` and ``keys`` (``keys[i]`` is clip ``i``'s store key) a
    bucket whose clips hit is gathered on the device, and only its missed
    clips are packed on the host and scattered in; a bucket with no hit is
    packed on the host whole.  The rows are the same either way, so are the
    embeddings.  With ``mesh`` the clip axis is further padded to the mesh,
    each rank pools its slice and an all-gather returns every embedding to
    every rank; a mesh takes no store."""
    if mesh is not None and store is not None:
        raise ValueError("the device feature store is off under a mesh")
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
    dev = net.device
    for n_pad, idxs in buckets.items():
        B_pad = config.next_pow2(len(idxs))
        lens = np.zeros((B_pad,), np.int64)
        for row, i in enumerate(idxs):
            lens[row] = len(arrs[i])
        batch_d = None
        if store is not None and keys is not None:
            batch_d, misses = store.gather_partial([keys[i] for i in idxs], n_pad,
                                                   n_rows=B_pad)
            if batch_d is not None and misses:
                pack = np.zeros((len(misses), n_pad, feat), np.float32)
                for j, (r, _) in enumerate(misses):
                    pack[j, : lens[r]] = arrs[idxs[r]]
                batch_d = store.scatter_rows(batch_d, pack, [r for r, _ in misses])
        lens_d = None
        if batch_d is None:
            batch = np.zeros((B_pad, n_pad, feat), np.float32)
            for row, i in enumerate(idxs):
                batch[row, : len(arrs[i])] = arrs[i]
            if mesh is not None:
                _, (batch, lens_p) = pad_rows_to_mesh(mesh, batch, lens)
                batch_d, lens_d = put_batch_sharded(mesh, batch, lens_p)
            else:
                batch_d = torch.from_numpy(batch).to(dev)
        with torch.inference_mode():
            embs = kernel(params, batch_d, upload(lens, dev) if lens_d is None else lens_d)
            embs = embs.cpu().numpy() if mesh is None else fetch(embs, mesh)
        for row, i in enumerate(idxs):
            out[i] = normalize(embs[row])
    return out


def batch_clip_embeddings(net: SpeakerNet, clips, store=None, keys=None,
                          mesh=None) -> List[np.ndarray]:
    """Mean-pooled ReLU-h2 embeddings for many clips in few device calls,
    each L2-normalized (the per-clip ``extract_embedding_from_features``
    contract, batched).  ``store``/``keys``/``mesh``: see
    :func:`_batch_pooled`; ``store`` only where ``clips[i]`` is the ingest
    output of ``keys[i]``."""
    return _batch_pooled(net, clips, _fembed_mean_batch, store, keys, mesh)


def batch_median_embeddings(net: SpeakerNet, clips, store=None, keys=None,
                            mesh=None) -> List[np.ndarray]:
    """Median-pooled ReLU-h2 embeddings for many clips, bucketed and
    batched, each L2-normalized (:func:`median_embedding_from_features`
    per clip, the even-count midpoint rule included).  ``store``/``keys``
    as :func:`batch_clip_embeddings`: a clip read from the feature cache
    must carry a key that misses."""
    return _batch_pooled(net, clips, _fembed_median_batch, store, keys, mesh)


def _one_clip(net: SpeakerNet, feats: np.ndarray, pool) -> np.ndarray:
    feats = np.asarray(feats, np.float32)
    if len(feats) == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    with torch.inference_mode():
        emb = pool(torch.from_numpy(feats).to(net.device)).cpu().numpy()
    return normalize(emb)


def extract_embedding(net: SpeakerNet, sample, extractor=None) -> np.ndarray:
    """Median-pooled tanh-h2 embedding of raw PCM, L2-normalized
    (src/lib.rs:1418-1447); ``extractor`` defaults to the process-global
    one."""
    windows = extract_with(extractor, sample)
    n = torch.tensor([len(windows)], device=net.device)
    return _one_clip(net, windows,
                     lambda x: _masked_median(embed(net.params, x)[None], n)[0])


def extract_embedding_from_features(net: SpeakerNet, feats: np.ndarray) -> np.ndarray:
    """Mean-pooled ReLU-h2 embedding of one clip, L2-normalized
    (src/lib.rs:1450-1471): the variant the discovery loop and ``--eval``
    use."""
    return _one_clip(net, feats, lambda x: forward_embedding(net.params, x).mean(dim=0))


def median_embedding_from_features(net: SpeakerNet, feats: np.ndarray) -> np.ndarray:
    """Median-pooled ReLU-h2 embedding of one clip, L2-normalized
    (src/lib.rs:1474-1495)."""
    n = torch.tensor([len(feats)], device=net.device)
    return _one_clip(net, feats, lambda x: _masked_median(
        forward_embedding(net.params, x)[None], n)[0])
