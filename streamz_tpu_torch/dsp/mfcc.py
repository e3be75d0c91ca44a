"""MFCC frontend in plain PyTorch: the formulation K1's kernel is held to.

The port of ``streamz_tpu/dsp/mfcc.py``.  The hop being exactly half the
window lets the 800-point real DFT be computed from *non-overlapping*
400-sample blocks with one GEMM and a shifted add (see
:func:`streamz_tpu_torch.dsp.mel.dft_block_matrices`), so the frontend is:

    PCM [B, T] → blocks [B, nb, 400]
      → DFT GEMM [400, 802] → parity-sign halo combine → power [B, W, 401]
      → mel GEMM → log → DCT GEMM → [B, W, 20]
      → Δ/ΔΔ stencil + per-frame z-norm → [B, W, 60]

:func:`mfcc_base` here is the plain version of the hand-written CUDA kernel
in :mod:`streamz_tpu_torch.dsp.mfcc_kernel`; the CPU tests and the card
comparison use it, and on a card the main path runs the kernel instead.
Ragged clip lengths are handled with a per-clip window count and masking,
with host-side bucketing of the padded length.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.device import resolve_device, upload
from streamz_tpu_torch.dsp import mel as melmod

_BLOCK = config.HOP_SIZE  # 400

Core = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@lru_cache(maxsize=8)
def _constants(device: torch.device):
    """(dft_top [400, 802], sign [401], fb_t [401, 26], dct_t [26, 20]) f32
    on ``device``.  One fused cos|sin projection: the bottom-role bases are
    parity-signed copies (Cb = (-1)^k Ct), so each block needs one GEMM."""
    ct, st = melmod.dft_block_matrices()
    consts = (
        np.concatenate([ct, st], axis=1),
        melmod.bin_parity_sign(),
        melmod.mel_filterbank().T,
        melmod.dct2_matrix().T,
    )
    return tuple(
        torch.as_tensor(np.ascontiguousarray(c), dtype=torch.float32, device=device)
        for c in consts
    )


def window_count(n_samples: torch.Tensor) -> torch.Tensor:
    """Number of hop-400 windows in a clip (src/lib.rs:288-291)."""
    n = torch.as_tensor(n_samples)
    return torch.where(
        n >= config.WINDOW_SIZE,
        torch.div(n - config.WINDOW_SIZE, config.HOP_SIZE, rounding_mode="floor") + 1,
        torch.zeros_like(n),
    )


def window_count_host(n_samples: int) -> int:
    """Pure-Python twin of :func:`window_count` for host-side routing."""
    if n_samples < config.WINDOW_SIZE:
        return 0
    return (n_samples - config.WINDOW_SIZE) // config.HOP_SIZE + 1


def mfcc_base(pcm: torch.Tensor) -> torch.Tensor:
    """Base MFCCs for every candidate window. pcm: [B, T] f32 → [B, W, 20]
    where W = max(T//400 - 1, 0).  No masking or deltas."""
    dft_top, sign, fb_t, dct_t = _constants(pcm.device)
    B, T = pcm.shape
    nb = T // _BLOCK
    nbins = config.N_FFT_BINS
    blocks = pcm[:, : nb * _BLOCK].reshape(B, nb, _BLOCK)

    parts = blocks @ dft_top  # [B, nb, 802]
    cos_p = parts[..., :nbins]
    sin_p = parts[..., nbins:]

    # Window t = block_t (top role) + block_{t+1} (bottom role); the bottom
    # role is the parity-signed top projection.
    re = cos_p[:, :-1] + sign * cos_p[:, 1:]
    im = sin_p[:, :-1] + sign * sin_p[:, 1:]
    power = re * re + im * im  # [B, W, 401]

    mel_log = torch.log(torch.clamp(power @ fb_t, min=1e-12))
    return mel_log @ dct_t


def deltas_and_norm(base: torch.Tensor, n_win: torch.Tensor) -> torch.Tensor:
    """Δ/ΔΔ stencil + per-frame z-norm with per-clip edge clamping.

    base: [B, W, 20]; n_win: [B] valid-window counts.  Returns [B, W, 60]
    with invalid frames zeroed.
    """
    B, W, C = base.shape
    if W == 0:
        return base.new_zeros((B, 0, 3 * C))
    n_win = n_win.to(base.device)
    valid = (torch.arange(W, device=base.device)[None, :] < n_win[:, None])[..., None]
    last = torch.clamp(n_win - 1, min=0).view(B, 1, 1).expand(B, 1, C)

    def clamp_tail(x):
        # Replicate each clip's last valid frame into the padding region so
        # an edge-padded central difference is edge-clamped at the per-clip
        # boundary.
        return torch.where(valid, x, torch.gather(x, 1, last))

    def central_diff(x):
        xp = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
        return (xp[:, 2:] - xp[:, :-2]) / 2.0

    base_c = clamp_tail(base)
    d1 = clamp_tail(central_diff(base_c))
    d2 = central_diff(d1)
    feats = torch.cat([base_c, d1, d2], dim=-1)  # [B, W, 60]

    mean = feats.mean(dim=-1, keepdim=True)
    var = ((feats - mean) ** 2).mean(dim=-1, keepdim=True)
    std = torch.clamp(torch.sqrt(var), min=1e-6)
    feats = (feats - mean) / std
    return torch.where(valid, feats, torch.zeros((), device=feats.device))


def mfcc_features(pcm: torch.Tensor, n_samples: torch.Tensor) -> torch.Tensor:
    """Full plain frontend: [B, T] f32 PCM + [B] lengths → [B, W, 60]."""
    return deltas_and_norm(mfcc_base(pcm), window_count(n_samples))


mfcc_features.base = mfcc_base  # every core names its base (the PCM-halo route)


# ---------------------------------------------------------------------------
# Host-side ragged-batch wrapper with length bucketing.
# ---------------------------------------------------------------------------


def _bucket_len(n: int) -> int:
    """Round a sample count up to a power-of-two number of 400-blocks."""
    return config.next_pow2(max(4, -(-n // _BLOCK))) * _BLOCK


def _to_f32(samples: np.ndarray) -> np.ndarray:
    samples = np.asarray(samples)
    if np.issubdtype(samples.dtype, np.integer):
        return samples.astype(np.float32) / 32767.0
    return samples.astype(np.float32)


def extract_features_device(pcm: torch.Tensor, core: Optional[Core] = None) -> torch.Tensor:
    """One clip already on its device, f32 at the [-1, 1] scale ([T]) →
    [n_windows, 60] on that device: zero-padded to its length bucket as
    :func:`extract_features_batch` pads it, so both give the same features
    for the same samples."""
    core = core or mfcc_features
    n = int(pcm.shape[0])
    batch = torch.zeros((1, _bucket_len(n)), dtype=torch.float32, device=pcm.device)
    batch[0, :n] = pcm
    lens = torch.full((1,), n, dtype=torch.int64, device=pcm.device)
    with torch.inference_mode():
        feats = core(batch, lens)
    return feats[0, : window_count_host(n)].clone()


def extract_features(
    samples: np.ndarray, core: Optional[Core] = None, device=None
) -> np.ndarray:
    """Single clip → [n_windows, 60] float32."""
    return extract_features_batch([samples], core=core, device=device)[0]


class DeviceFeatureStore:
    """The frontend's outputs kept on the device, indexed for reuse there.

    The port of ``streamz_tpu/dsp/mfcc.py:DeviceFeatureStore`` on one
    device.  Its mesh arguments, for one process driving several cards, are
    not ported yet; a multi-process run (one rank per device) turns the
    store off, as the JAX package does on more than one host
    (``streamz_tpu/cli.py:129-135``).  :func:`extract_features_batch`
    computes the features on the device and returns host copies; handed a
    store it also keeps each bucket's ``[B, W, 60]`` output alive and
    records where each clip's rows lie, so that the discovery loop,
    ``--eval`` and finalize assemble their batches on the device instead of
    uploading again the features just downloaded.

    A gathered row equals the host zero-packed row bit for bit:
    :func:`deltas_and_norm` zeroes every frame past a clip's window count.

    ``max_bytes`` bounds the residency: a bucket that would push the total
    past it is not registered, its clips miss, and every consumer packs
    them on the host.  Call :meth:`release` when the consumers are done.
    """

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = max_bytes
        self._bytes = 0
        self._buckets: List[torch.Tensor] = []
        self._index: dict = {}  # key -> (bucket_id, row, n_win)
        # host_pack_*: feature bytes consumers uploaded to repair misses
        # (scatter_rows), the misses only.  dropped_*: buckets refused by
        # the max_bytes cap.
        self.stats = {
            "host_pack_bytes": 0, "host_pack_rows": 0,
            "dropped_buckets": 0, "dropped_bytes": 0,
        }

    def add_bucket(self, feats_dev: torch.Tensor, keys, n_wins) -> None:
        """Register one bucket's device output; ``keys[row]`` names the clip
        in row ``row``.  A bucket past ``max_bytes`` is dropped."""
        nb = feats_dev.numel() * feats_dev.element_size()
        if self.max_bytes is not None and self._bytes + nb > self.max_bytes:
            self.stats["dropped_buckets"] += 1
            self.stats["dropped_bytes"] += nb
            return
        self._bytes += nb
        bid = len(self._buckets)
        self._buckets.append(feats_dev)
        for row, key in enumerate(keys):
            self._index[key] = (bid, row, int(n_wins[row]))

    def rekey(self, mapping) -> None:
        """Replace each key ``k`` by ``mapping[k]`` (e.g. clip index → file
        path, the consumers' key space); keys not in ``mapping`` drop."""
        self._index = {mapping[k]: v for k, v in self._index.items() if k in mapping}

    def lookup(self, key):
        """``(bucket_id, row, n_win)`` for a clip, or None."""
        return self._index.get(key)

    def bucket(self, bid: int) -> torch.Tensor:
        return self._buckets[bid]

    def release(self) -> None:
        """Drop the device tensors; later lookups miss."""
        self._buckets = []
        self._index = {}
        self._bytes = 0

    def gather(self, keys, w_pad: int, *, n_rows: Optional[int] = None):
        """All or nothing: the gathered ``[n_rows, w_pad, feat]`` tensor when
        every key hits, else None (the caller packs the batch on the host)."""
        if any(self._index.get(k) is None for k in keys):
            return None
        return self.gather_partial(keys, w_pad, n_rows=n_rows)[0]

    def gather_partial(self, keys, w_pad: int, *, n_rows: Optional[int] = None):
        """Assemble ``[n_rows, w_pad, feat]`` on the device, row ``r``
        holding ``keys[r]``'s windows.  Returns ``(wins, missing)``:
        ``missing`` lists the ``(row, key)`` pairs not in the store, whose
        rows stay zero for :meth:`scatter_rows`; ``wins`` is None when no
        key hits.  ``w_pad`` must hold every gathered clip's window count;
        rows past ``len(keys)`` stay zero."""
        hits, missing = [], []
        for row, key in enumerate(keys):
            h = self._index.get(key)
            if h is None:
                missing.append((row, key))
            else:
                hits.append((row, h))
        if not hits:
            return None, missing
        first = self._buckets[hits[0][1][0]]
        R = len(keys) if n_rows is None else int(n_rows)
        wins = torch.zeros((R, w_pad, first.shape[2]), dtype=first.dtype,
                           device=first.device)
        groups: dict = {}
        for row, (bid, srow, _) in hits:
            dsts, srcs = groups.setdefault(bid, ([], []))
            dsts.append(row)
            srcs.append(srow)
        for bid, (dsts, srcs) in groups.items():
            bucket = self._buckets[bid]
            w = min(int(bucket.shape[1]), w_pad)
            idx = upload(np.asarray(srcs + dsts, np.int64), bucket.device)
            src, dst = idx[: len(srcs)], idx[len(srcs):]
            wins[:, :w].index_copy_(0, dst, bucket[:, :w].index_select(0, src))
        return wins, missing

    def scatter_rows(self, wins: torch.Tensor, rows_host: np.ndarray, dst_rows):
        """``wins[dst_rows[j]] = rows_host[j]`` on the device: the miss
        repair of :meth:`gather_partial`.  ``rows_host`` is the host-packed
        ``[n_miss, w_pad, feat]`` windows of the missing clips only;
        ``stats['host_pack_bytes']`` meters its bytes."""
        n = len(dst_rows)
        if n == 0:
            return wins
        self.stats["host_pack_bytes"] += int(rows_host.nbytes)
        self.stats["host_pack_rows"] += n
        dst = upload(np.asarray(dst_rows, np.int64), wins.device)
        return wins.index_copy_(0, dst, upload(rows_host, wins.device))


def extract_features_batch(
    clips: Sequence[np.ndarray], core: Optional[Core] = None, device=None,
    store: Optional[DeviceFeatureStore] = None, mesh=None,
    allow_pcm_sharded: Optional[bool] = None,
) -> List[np.ndarray]:
    """Many ragged clips → list of [n_windows_i, 60] arrays.

    Clips are grouped by padded-length bucket and each group runs as one
    batched call on ``device`` (``cuda`` unless ``'cpu'`` is asked for).
    ``core`` selects the frontend (default: the plain formulation;
    :class:`streamz_tpu_torch.dsp.features.FeatureExtractor` passes K1's).
    With ``store`` each bucket's device output is also registered there,
    under the clip's position in ``clips``.

    With ``mesh`` (a 1-D mesh over the process group; ``device`` is then
    this rank's), each bucket's clip axis is zero-padded to the mesh, every
    rank runs the frontend on its slice of the clips, and the features come
    back to every rank through an all-gather: the frontend is per clip, so
    the result does not depend on the rank count.  Clips of at least
    ``LONG_CLIP_WINDOW_THRESHOLD`` windows take the PCM-halo window-sharded
    frontend instead (:mod:`streamz_tpu_torch.parallel.window_parallel`),
    through the same core's base, when ``allow_pcm_sharded`` (default: the
    plain core only, as the JAX package's rule is).  A mesh takes no store.
    """
    if not clips:
        return []
    if mesh is not None and store is not None:
        raise ValueError("the device feature store is off under a mesh")
    dev = resolve_device(device)
    if allow_pcm_sharded is None:
        allow_pcm_sharded = core is None or core is mfcc_features
    core = core or mfcc_features
    f32 = [_to_f32(c) for c in clips]
    out: List[np.ndarray] = [None] * len(clips)  # type: ignore[list-item]

    shard_long = allow_pcm_sharded and mesh is not None and mesh.size() > 1
    buckets: dict[int, list[int]] = {}
    for i, c in enumerate(f32):
        if shard_long:
            from streamz_tpu_torch.parallel import window_parallel as wp

            if window_count_host(len(c)) >= wp.LONG_CLIP_WINDOW_THRESHOLD:
                out[i] = wp.mfcc_features_pcm_sharded(c, mesh, base=core.base)
                continue
        buckets.setdefault(_bucket_len(len(c)), []).append(i)
    for tlen, idxs in buckets.items():
        batch = np.zeros((len(idxs), tlen), np.float32)
        lens = np.zeros((len(idxs),), np.int64)
        for row, i in enumerate(idxs):
            batch[row, : len(f32[i])] = f32[i]
            lens[row] = len(f32[i])
        n_wins = [window_count_host(int(n)) for n in lens]
        with torch.inference_mode():
            if mesh is not None:
                from streamz_tpu_torch.parallel.mesh import (
                    fetch, pad_rows_to_mesh, put_batch_sharded,
                )

                _, (batch_p, lens_p) = pad_rows_to_mesh(mesh, batch, lens)
                feats = fetch(core(*put_batch_sharded(mesh, batch_p, lens_p)), mesh)
            else:
                feats_dev = core(
                    torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev)
                )
                if store is not None:
                    store.add_bucket(feats_dev, idxs, n_wins)
                feats = feats_dev.cpu().numpy()
        for row, i in enumerate(idxs):
            out[i] = feats[row, : n_wins[row]].copy()
    return out
