"""Cosine k-means over speaker embeddings (``--cluster-embeddings``).

The port of ``streamz_tpu/infer/cluster.py``, a rebuild of
``cluster_embeddings`` (``streamz-rs/src/lib.rs:1668-1713``): initial
centers are k distinct embeddings drawn by a random permutation, each
embedding joins the center of largest cosine, centers become the
normalized mean of their members, and an empty cluster is reseeded with a
random embedding.  The permutation and the reseeding draws
(``randint(fold_in(key, i))``) come from the threefry twin
(:mod:`streamz_tpu_torch.nn.prng`), so the labels equal the JAX package's.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from streamz_tpu_torch.device import resolve_device
from streamz_tpu_torch.nn import prng


def _kmeans(embeds: torch.Tensor, key: torch.Tensor, k: int, iterations: int) -> torch.Tensor:
    n = embeds.shape[0]
    norms = torch.linalg.norm(embeds, dim=1, keepdim=True)
    unit = embeds / torch.clamp(norms, min=1e-12)
    centers = embeds[prng.permutation(key, n)[:k]]
    zero = torch.zeros((), device=embeds.device)
    assign = torch.zeros(n, dtype=torch.int64, device=embeds.device)
    for i in range(max(iterations, 1)):
        cnorm = torch.linalg.norm(centers, dim=1, keepdim=True)
        sims = unit @ (centers / torch.clamp(cnorm, min=1e-12)).T  # [n, k]
        # Zero-norm rows or centers have cosine 0 (src/lib.rs:1536-1539).
        sims = torch.where((norms > 0) & (cnorm.T > 0), sims, zero)
        assign = torch.argmax(sims, dim=1)  # the first of equal maxima
        one_hot = torch.nn.functional.one_hot(assign, k).to(embeds.dtype)  # [n, k]
        counts = one_hot.sum(dim=0)
        means = (one_hot.T @ embeds) / torch.clamp(counts[:, None], min=1.0)
        mnorm = torch.linalg.norm(means, dim=1, keepdim=True)
        means = torch.where(mnorm > 1e-6, means / torch.clamp(mnorm, min=1e-12), means)
        rand_idx = prng.randint(prng.fold_in(key, i), (k,), 0, n).to(torch.int64)
        centers = torch.where((counts > 0)[:, None], means, embeds[rand_idx])
    return assign


def cluster_embeddings(embeds, k: int, iterations: int, *, seed: int = 0,
                       device=None) -> List[int]:
    """Cluster embeddings into k groups on ``device`` (``cuda`` unless
    ``'cpu'`` is asked for); returns each embedding's cluster id."""
    embeds = np.asarray(embeds, np.float32)
    if k < 0:
        raise ValueError(f"k must be non-negative, got {k}")
    if len(embeds) == 0 or k == 0:
        return []
    dev = resolve_device(device)
    k = min(k, len(embeds))
    with torch.inference_mode():
        assign = _kmeans(torch.from_numpy(embeds).to(dev), prng.PRNGKey(seed, device=dev),
                         int(k), int(iterations))
    return [int(a) for a in assign.cpu().tolist()]
