"""Window-axis sharding for very long recordings: the MFCC analogue of
context/sequence parallelism.

The port of ``streamz_tpu/parallel/window_parallel.py``.  The reference's
"long sequence" story is chunking audio into i.i.d. 800-sample windows and
aggregating per-clip statistics (``streamz-rs/src/lib.rs:1285-1303`` vote
sums, ``:1450-1471`` embedding means).  The only cross-window coupling is
the radius-1 Δ/ΔΔ stencil (``src/lib.rs:212-228``) and the per-clip
pooling, so a long clip shards its window axis across the mesh's ranks,
each rank runs the FP32 ``forward`` (or ``forward_embedding``) on its
windows, masked, and one ``all_reduce`` merges the vote sums or the pooled
embedding statistics.

For the MFCC frontend itself each rank takes a contiguous slice of the
clip's 400-sample PCM blocks plus a halo, exchanged once with its two ring
neighbours (:func:`streamz_tpu_torch.parallel.comm.neighbour_exchange`):
2 blocks from the left and 3 from the right cover the window overlap
(window ``w`` spans blocks ``w`` and ``w+1``) and the radius-2 Δ/ΔΔ
dependency.  Each rank computes its ``wl + 4`` base frames from its
``wl + 5`` extended blocks with the same frontend base as the bucket path
(K1 on the card, the plain formulation on the CPU), then the edge-clamped
Δ/ΔΔ gathers and the z-norm in torch ops.  See
:func:`mfcc_features_pcm_sharded` and the fused
:func:`identify_speaker_pcm_sharded` / :func:`extract_embedding_pcm_sharded`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from streamz_tpu_torch import config
from streamz_tpu_torch.dsp import mfcc, mfcc_kernel
from streamz_tpu_torch.nn.model import forward, forward_embedding
from streamz_tpu_torch.parallel import comm
from streamz_tpu_torch.parallel.mesh import fetch, pad_rows_to_mesh, put_batch_sharded

Base = Callable[[torch.Tensor], torch.Tensor]


def make_sharded_vote_step(mesh: DeviceMesh):
    """Vote-sum aggregation with windows sharded across the mesh.

    ``step(params, windows, valid, num_speakers) -> (prob_sums, count)``,
    ``windows`` [W, F] and ``valid`` [W] the padded host arrays (W a mesh
    multiple), the same on every rank: each rank's masked softmax sums over
    its rows, all-reduced, reproduce ``identify_speaker``'s global sum
    (src/lib.rs:1290-1297).
    """

    def step(params, windows, valid, num_speakers):
        x, v = put_batch_sharded(mesh, windows, valid)
        probs = forward(params, x, num_speakers) * v[:, None]
        out = comm.psum(torch.cat([probs.sum(dim=0), v.sum().reshape(1)]), mesh)
        return out[:-1], out[-1]

    return step


def make_sharded_embedding_step(mesh: DeviceMesh):
    """Mean ReLU-h2 clip embedding with windows sharded across the mesh.

    ``step(params, windows, valid) -> [h2]``: the all-reduced embedding
    sums over the global window count (``extract_embedding_from_features``,
    src/lib.rs:1450-1471); L2 normalization stays with the caller.
    """

    def step(params, windows, valid):
        x, v = put_batch_sharded(mesh, windows, valid)
        emb = forward_embedding(params, x) * v[:, None]
        out = comm.psum(torch.cat([emb.sum(dim=0), v.sum().reshape(1)]), mesh)
        return out[:-1] / torch.clamp(out[-1], min=1.0)

    return step


# A 10-minute 44.1 kHz clip is ~66k hop-400 windows; the JAX package
# measured the single-device forward faster than paying the collective
# below ~16k windows.  The app layers (incremental loop, identify voting,
# ingest) route clips at or above this many windows through the sharded
# programs here.
LONG_CLIP_WINDOW_THRESHOLD = 16384


def _pad_to_mesh(windows, mesh: DeviceMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Ceil-to-mesh leading-axis padding + a valid-row mask.

    An empty input keeps the model's feature width (so the forward GEMM
    shapes stay consistent) and yields an all-zero mask; a bare [F] vector
    is ONE window.
    """
    windows = np.asarray(windows, np.float32)
    if windows.ndim == 1:
        windows = (windows.reshape(1, -1) if windows.size
                   else windows.reshape(0, config.FEATURE_SIZE))
    n, (padded,) = pad_rows_to_mesh(mesh, windows)
    valid = (np.arange(len(padded)) < n).astype(np.float32)
    return padded, valid


def vote_sums_sharded(net, windows, mesh: DeviceMesh) -> np.ndarray:
    """Global softmax vote sums over mesh-sharded windows: the engine behind
    :func:`identify_speaker_sharded` and the ``mesh`` path of
    ``identify_speaker_with_threshold_feats``.  Returns ``[num_speakers]``."""
    padded, valid = _pad_to_mesh(windows, mesh)
    with torch.inference_mode():
        sums, _ = make_sharded_vote_step(mesh)(net.params, padded, valid,
                                               net.num_speakers)
    return sums.cpu().numpy()[: net.num_speakers]


def identify_speaker_sharded(net, windows, mesh: DeviceMesh) -> int:
    """``identify_speaker`` with the window axis sharded across the mesh."""
    if len(windows) == 0 or net.num_speakers == 0:
        # Empty vote sums: argmax would raise where the unsharded
        # identify_speaker returns 0 (src/lib.rs:1302 unwrap_or(0)).
        return 0
    return int(vote_sums_sharded(net, windows, mesh).argmax())


def extract_embedding_sharded(net, windows, mesh: DeviceMesh) -> np.ndarray:
    """Mean ReLU-h2 clip embedding sharded over the mesh, L2-normalized
    (the ``extract_embedding_from_features`` call-site contract)."""
    from streamz_tpu_torch.infer.embed import normalize

    if len(windows) == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    padded, valid = _pad_to_mesh(windows, mesh)
    with torch.inference_mode():
        emb = make_sharded_embedding_step(mesh)(net.params, padded, valid)
    return normalize(emb.cpu().numpy())


# ---------------------------------------------------------------------------
# The PCM-halo sharded frontend.
# ---------------------------------------------------------------------------


def default_base(device: torch.device) -> Base:
    """The frontend base the bucket path runs under a mesh, where no probe
    runs: K1 on a card, the plain formulation on the CPU."""
    return mfcc_kernel.mfcc_base_v4 if device.type == "cuda" else mfcc.mfcc_base


def _shard_pcm(samples, mesh: DeviceMesh) -> Tuple[torch.Tensor, int, int]:
    """Pad a clip to the mesh times a power-of-two count ``wl >= 4`` of
    400-sample blocks (every shard holds the right halo's 3 blocks, and
    ``n_win + 1`` blocks fit) and put this rank's ``wl`` blocks on its
    device.  Returns ``(pcm_local [wl*400], n_win, wl)``."""
    f32 = mfcc._to_f32(np.asarray(samples))
    n = len(f32)
    n_win = mfcc.window_count_host(n)
    n_dev = mesh.size()
    wl = 4
    while n_dev * wl < n_win + 1:
        wl *= 2
    pcm = np.zeros((n_dev * wl * config.HOP_SIZE,), np.float32)
    # The buffer holds n_win+1 blocks, enough for every window; the clip's
    # trailing partial block feeds none, so copy only what fits.
    m = min(n, pcm.size)
    pcm[:m] = f32[:m]
    (local,) = put_batch_sharded(mesh, pcm)
    return local, n_win, wl


def _local_frontend(pcm_local: torch.Tensor, n_win: int, wl: int, mesh: DeviceMesh,
                    base: Base) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's frames ``g in [r*wl, (r+1)*wl)``: ``(feats [wl, 60],
    valid [wl])``, bit-equal per frame to the unsharded frontend on the
    same base (``streamz_tpu/parallel/window_parallel.py:191-257``)."""
    block = config.HOP_SIZE
    dev = pcm_local.device
    blocks = pcm_local.reshape(wl, block)
    if mesh.size() > 1:
        # One exchange with both neighbours.  The cyclic wrap at the clip's
        # edges delivers garbage blocks, but the clamped gathers below never
        # read a frame computed from them.
        left, right = comm.neighbour_exchange(blocks[-2:], blocks[:3], mesh)
    else:
        left = torch.zeros((2, block), dtype=blocks.dtype, device=dev)
        right = torch.zeros((3, block), dtype=blocks.dtype, device=dev)
    ext = torch.cat([left, blocks, right])  # blocks s-2 .. s+wl+2
    base_ext = base(ext.reshape(1, -1))[0]  # frames s-2 .. s+wl+1, [wl+4, 20]

    # Edge-clamped base frames B[g] = base[clip(g, 0, n_win-1)]: the
    # unsharded clamp_tail + edge-replicated central_diff semantics.
    s = comm.axis_index(mesh) * wl
    top = max(n_win - 1, 0)
    g_ext = s - 2 + torch.arange(wl + 4, device=dev)
    src = torch.clamp(g_ext, 0, top)
    b_ext = base_ext[torch.clamp(src - (s - 2), 0, wl + 3)]
    d1_raw = (b_ext[2:] - b_ext[:-2]) / 2.0  # index j -> frame g = s-1+j

    g_own = s + torch.arange(wl, device=dev)

    def d1c(h):
        return d1_raw[torch.clamp(torch.clamp(h, 0, top) - (s - 1), 0, wl + 1)]

    base_own = b_ext[2: wl + 2]
    d1_own = d1c(g_own)
    d2_own = (d1c(g_own + 1) - d1c(g_own - 1)) / 2.0
    feats = torch.cat([base_own, d1_own, d2_own], dim=-1)

    mean = feats.mean(dim=-1, keepdim=True)
    var = ((feats - mean) ** 2).mean(dim=-1, keepdim=True)
    std = torch.clamp(torch.sqrt(var), min=1e-6)
    feats = (feats - mean) / std

    valid = g_own < n_win
    feats = torch.where(valid[:, None], feats, torch.zeros((), device=dev))
    return feats, valid.to(torch.float32)


def mfcc_features_pcm_sharded(samples, mesh: DeviceMesh,
                              base: Optional[Base] = None) -> np.ndarray:
    """The full MFCC+Δ+ΔΔ frontend with the PCM block axis sharded across
    the mesh: the features :func:`streamz_tpu_torch.dsp.mfcc.extract_features`
    gives through the same ``base`` (default :func:`default_base`).
    Returns ``[n_windows, 60]`` float32 on every rank."""
    pcm, n_win, wl = _shard_pcm(samples, mesh)
    if n_win == 0:
        return np.zeros((0, config.FEATURE_SIZE), np.float32)
    with torch.inference_mode():
        feats, _ = _local_frontend(pcm, n_win, wl, mesh, base or default_base(pcm.device))
        return fetch(feats, mesh)[:n_win].copy()


def identify_speaker_pcm_sharded(net, samples, mesh: DeviceMesh,
                                 base: Optional[Base] = None) -> int:
    """``identify_speaker`` (src/lib.rs:1285-1303) over the sharded
    frontend: each rank's frames → forward → one all-reduce of the vote
    sums."""
    if net.num_speakers == 0:
        return 0  # empty vote sums: argmax would raise
    pcm, n_win, wl = _shard_pcm(samples, mesh)
    if n_win == 0:
        return 0  # src/lib.rs:1302 unwrap_or(0)
    with torch.inference_mode():
        feats, valid = _local_frontend(pcm, n_win, wl, mesh, base or default_base(pcm.device))
        probs = forward(net.params, feats, net.num_speakers) * valid[:, None]
        sums = comm.psum(probs.sum(dim=0), mesh)
    return int(sums.cpu().numpy()[: net.num_speakers].argmax())


def extract_embedding_pcm_sharded(net, samples, mesh: DeviceMesh,
                                  base: Optional[Base] = None) -> np.ndarray:
    """Mean ReLU-h2 clip embedding (src/lib.rs:1450-1471) over the sharded
    frontend, one all-reduce, L2-normalized on the host."""
    from streamz_tpu_torch.infer.embed import normalize

    pcm, n_win, wl = _shard_pcm(samples, mesh)
    if n_win == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    with torch.inference_mode():
        feats, valid = _local_frontend(pcm, n_win, wl, mesh, base or default_base(pcm.device))
        emb = forward_embedding(net.params, feats) * valid[:, None]
        out = comm.psum(torch.cat([emb.sum(dim=0), valid.sum().reshape(1)]), mesh)
        emb = out[:-1] / torch.clamp(out[-1], min=1.0)
    return normalize(emb.cpu().numpy())
