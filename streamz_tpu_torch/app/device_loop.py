"""The discovery loop with its decision state on the device.

The port of the single-device path of ``streamz_tpu/app/device_loop.py``.
Per file, in list order, and without waiting on the host, it runs the
reference's hot loop C (``streamz-rs/src/main.rs:750-835``):

    embed (masked mean ReLU-h2, normalized)    src/main.rs:764-768
    → cosine match vs the current centroids    src/lib.rs:1499-1529
    → burn-in / labelled / new-class decision  src/main.rs:779-800
    → 5-epoch batch-8 training, one K6 launch  src/main.rs:802-815
    → centroid running-sum update              src/main.rs:818-824

The class count, the centroid sums and counts and every per-file result
stay on the device; the host reads them once, at the end.  Burn-in,
threshold and learning rate depend only on the file's index, so the host
knows them.  Capacity is pre-sized once (``ensure_capacity``), so class
growth is arithmetic on the device scalar.

Each file trains at its own window bucket ``next_pow2(ceil(n/8)) * 8``.
The JAX package pads the files of one dispatch to the dispatch's largest
bucket only to bound its compiles; the trainer draws the same bits for
every pad size (the threefry counter layout, a stable argsort, masked
padding rows), so the labels do not depend on it.

Two knobs of the JAX loop have no counterpart, and need none on one card:
``MAX_SCAN_FILES`` (``streamz_tpu/app/device_loop.py:56``) caps the files
of one ``lax.scan`` dispatch to bound the compiled variants and the
padding; here nothing is compiled per shape and each file is its own K6
launch, queued without waiting, so there is no dispatch to cap.
``_resolve_scan_backend`` (``:330``) measures the single-device scan
against the SPMD one that shards a file's windows over a mesh.  The SPMD
scan is not ported yet: under a mesh this loop runs replicated on every
rank, each rank computing the same labels (the JAX package's
``STREAMZ_SHARD_DISCOVERY=0`` route, ``:87-103``), and asking for the
sharded scan raises (``app/incremental.run_incremental``).

With the ingest stage's ``DeviceFeatureStore`` each file's windows are
gathered on the device from the frontend's own output; a file the store
misses is packed on the host and scattered in alone.  The gathered rows
equal the host-packed ones bit for bit (the frontend zeroes every frame
past a clip's window count), so labels, parameters and margins are those
of the run without a store.  Without a store every file's windows go up in
one upload.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.dsp.mfcc import DeviceFeatureStore
from streamz_tpu_torch.infer.embed import average_vectors
from streamz_tpu_torch.nn import prng
from streamz_tpu_torch.nn.drivers import _fresh_key
from streamz_tpu_torch.nn.model import SpeakerNet, forward_embedding
from streamz_tpu_torch.nn.train import train_on_windows_impl
from streamz_tpu_torch.runtime.progress import progress


def _file_step(state, windows, n_valid, label, burn, threshold, lr, key,
               seed_cent, seed_mask, max_speakers, dropout, epochs, batch_size):
    """One file of the loop on the device; ``state`` is
    (params, num_speakers, run_sum, run_cnt), updated in place.  Returns
    device tensors: the speaker id, the mean loss, the embedding and the
    decision margin."""
    params, ns, run_sum, run_cnt = state
    dev = windows.device
    W = windows.shape[0]
    capacity = params["b3"].shape[0]

    # Clip embedding: masked mean ReLU-h2, L2-normalized.
    valid = (torch.arange(W, device=dev) < n_valid).to(torch.float32)
    s = (forward_embedding(params, windows) * valid[:, None]).sum(0) / max(n_valid, 1)
    norm = torch.sqrt((s * s).sum())
    emb = torch.where(norm > 1e-6, s / norm, s)

    # Cosine match against every centroid key (src/lib.rs:1499-1529): an
    # explicitly labelled file can seed an id at or beyond the live count.
    seen = run_cnt > 0
    cent = torch.where(seen[:, None], run_sum, seed_cent)
    valid_id = seed_mask | seen
    denom = torch.sqrt((emb * emb).sum()) * torch.sqrt((cent * cent).sum(dim=1))
    sims = torch.where(denom > 0.0, (cent @ emb) / torch.where(denom == 0.0, 1.0, denom),
                       torch.zeros((), device=dev))
    sims = torch.where(valid_id, sims, torch.full((), float("-inf"), device=dev))
    n_ids = valid_id.sum()
    best = torch.argmax(sims)  # the first of equal maxima
    # The relaxed threshold in f32 arithmetic, as the JAX package computes it.
    relaxed = float(np.float32(0.7) * np.float32(threshold))
    dyn = torch.where(n_ids < 20, relaxed, float(np.float32(threshold)))
    matched_ok = (n_ids > 0) & (sims.gather(0, best.reshape(1))[0] > dyn)
    in_range = best < ns

    # Label decision (src/main.rs:779-800 and the --max-speakers rule): at
    # the cap the best centroid wins outright, range unchecked.
    at_cap = ns >= max_speakers
    is_labeled = label >= 0
    new_burn = (~at_cap) & burn & (not is_labeled)
    unl = (~new_burn) & (not is_labeled)
    new_class = unl & ~(matched_ok & in_range) & ~at_cap
    best_forced = torch.where(n_ids > 0, best, torch.zeros_like(best))
    if is_labeled:
        sid = torch.full((), label, dtype=torch.int64, device=dev)
    else:
        sid = torch.where(new_burn | new_class, ns.to(torch.int64),
                          torch.where(matched_ok & in_range, best, best_forced))
    ns_new = (ns + (new_burn | new_class).to(ns.dtype)).contiguous()

    # How far the similarities lie from changing the decision: the gap
    # between the two best centroids and, below the cap, the best one's
    # distance to the threshold; +inf where no similarity decides.
    top = torch.topk(sims, min(2, capacity)).values
    gap = top[0] - top[-1] if capacity > 1 else torch.full((), float("inf"), device=dev)
    gap = torch.where(torch.isnan(gap), float("inf"), gap)  # one candidate: -inf - -inf
    margin = torch.where(at_cap, gap, torch.minimum(gap, (top[0] - dyn).abs()))
    decides = (~new_burn) & (n_ids > 0) & (not is_labeled)
    margin = torch.where(decides, margin, float("inf"))

    # Train: one-hot target only when the class is live (src/lib.rs:592-594).
    cols = torch.arange(capacity, device=dev)
    tvec = ((cols == sid) & (sid < ns_new)).to(torch.float32)
    _, loss = train_on_windows_impl(
        params, windows, n_valid, tvec, ns_new, key, lr, dropout,
        epochs=epochs, batch_size=batch_size,
    )

    run_sum.index_add_(0, sid.reshape(1), emb[None, :])
    run_cnt.index_add_(0, sid.reshape(1), torch.ones(1, device=dev))
    ns.copy_(ns_new)
    return sid, loss, emb, margin


def _store_windows(store: DeviceFeatureStore, path: str, windows: np.ndarray,
                   w_pad: int, dev: torch.device) -> torch.Tensor:
    """A file's [w_pad, F] windows gathered from the store, or, on a miss,
    packed on the host and scattered in (metered in ``store.stats``)."""
    wins, missing = store.gather_partial([path], w_pad)
    if missing:
        pack = np.zeros((1, w_pad, windows.shape[1]), np.float32)
        pack[0, : len(windows)] = windows
        wins = store.scatter_rows(torch.zeros(pack.shape, device=dev),
                                  pack, [0])
    return wins[0]


def run_incremental_device(
    net: SpeakerNet,
    train_files: List[Tuple[str, Optional[int]]],
    feature_map: Dict[str, np.ndarray],
    *,
    burn_in_limit: int,
    conf_threshold: float,
    dropout: float,
    batch_size: int,
    epochs: int,
    max_speakers: Optional[int],
    show_progress: bool = True,
    device_store: Optional[DeviceFeatureStore] = None,
):
    """Run the loop over the files in list order on the net's device.

    Returns ``(total_loss, processed, speaker_features, speaker_embeddings,
    margins)`` and mutates ``net`` and the labels in ``train_files`` as the
    JAX package's loop does.  ``margins[k]`` says how far processed file
    k's similarities lay from another label (+inf where none decided it).
    ``device_store`` (path-keyed, built from this ``feature_map``) feeds
    the files' windows on the device.
    """
    jobs = []  # (file index, path, label, windows)
    for i, (path, label) in enumerate(train_files):
        windows = feature_map.get(path)
        if windows is None:
            print(f"Missing audio for {path}")
            continue
        if len(windows) < 5:
            print(f"Skipping {path}, too short")
            continue
        jobs.append((i, path, label, np.asarray(windows, np.float32)))

    h2 = net.embedding_size()
    seed_embeddings = {
        i: np.asarray(mean, np.float32) for i, (mean, _, _) in enumerate(net.embeddings)
    }
    if not jobs:
        return 0.0, 0, {}, seed_embeddings, []

    # Pre-size capacity: every unlabelled file could spawn a class, and
    # explicit labels must be addressable.
    n_unlabeled = sum(1 for _, _, label, _ in jobs if label is None)
    max_label = max((label for _, _, label, _ in jobs if label is not None), default=-1)
    max_sp = 2**30 if max_speakers is None else int(max_speakers)
    needed = min(net.num_speakers + n_unlabeled, max(max_sp, net.num_speakers))
    needed = max(needed, max_label + 1)
    net.ensure_capacity(max(needed, 1))
    capacity = net.capacity

    dev = net.device
    seed_cent = np.zeros((capacity, h2), np.float32)
    seed_mask = np.zeros((capacity,), bool)
    for i, mean in seed_embeddings.items():
        if i < capacity:
            seed_cent[i] = mean
            seed_mask[i] = True
    seed_cent_d = torch.from_numpy(seed_cent).to(dev)
    seed_mask_d = torch.from_numpy(seed_mask).to(dev)

    params = net.working_params()
    ns = torch.tensor(net.num_speakers, dtype=torch.int32, device=dev)
    run_sum = torch.zeros((capacity, h2), device=dev)
    run_cnt = torch.zeros((capacity,), device=dev)
    state = (params, ns, run_sum, run_cnt)
    max_sp_d = torch.tensor(max_sp, dtype=torch.int32, device=dev)
    keys = prng.fold_in(_fresh_key(device=dev), torch.arange(len(jobs), device=dev))
    if device_store is None:
        # Every file's windows in one upload: a copy from pageable host
        # memory waits for the device, so a copy per file would wait on
        # every file.
        flat = torch.from_numpy(np.concatenate([w for _, _, _, w in jobs])).to(dev)
        starts = np.cumsum([0] + [len(w) for _, _, _, w in jobs])

    outs = []
    for k, (_, path, label, windows) in enumerate(
        progress(jobs, desc="incremental", enabled=show_progress)
    ):
        n = len(windows)
        w_pad = config.next_pow2(-(-n // batch_size)) * batch_size
        if device_store is None:
            padded = torch.zeros((w_pad, windows.shape[1]), device=dev)
            padded[:n] = flat[starts[k]:starts[k] + n]
        else:
            padded = _store_windows(device_store, path, windows, w_pad, dev)
        burn = k < burn_in_limit
        outs.append(_file_step(
            state, padded, n,
            -1 if label is None else int(label), burn,
            0.5 if burn else conf_threshold,
            config.LR_EARLY if k < config.LR_SWITCH_COUNT else config.LR_LATE,
            keys[k], seed_cent_d, seed_mask_d, max_sp_d, dropout, epochs,
            batch_size,
        ))

    # The one synchronization: fetch everything at once.
    sids = torch.stack([o[0] for o in outs]).cpu().numpy()
    losses = torch.stack([o[1] for o in outs]).cpu().numpy()
    embs = torch.stack([o[2] for o in outs]).cpu().numpy()
    margins = torch.stack([o[3] for o in outs]).cpu().tolist()
    net.params = params
    net.num_speakers = int(ns)
    while len(net.file_lists) < net.num_speakers:
        net.file_lists.append([])

    speaker_features: Dict[int, List[np.ndarray]] = {}
    for (i, path, _, _), sid, emb in zip(jobs, sids, embs):
        sid = int(sid)
        train_files[i] = (path, sid)
        net.record_training_file(sid, path)
        speaker_features.setdefault(sid, []).append(emb)

    speaker_embeddings = dict(seed_embeddings)
    for sid, feats in speaker_features.items():
        speaker_embeddings[sid] = average_vectors(feats)
    return (float(losses.sum()), len(jobs), speaker_features, speaker_embeddings,
            margins)
