"""Real streaming mode: hop-400 chunked live speaker identification.

The port of ``streamz_tpu/app/stream.py``.  PCM arrives in chunks of any
size; features, forward passes and vote sums are kept *incrementally* on
the device, and the rolling identification is available at any time with
``identify_speaker_with_threshold`` semantics (``src/lib.rs:1307-1343``:
confidence = best vote sum / window count).

Design:

- The hop (400) is half the window (800), so every new 400-sample block
  yields exactly one new analysis window: the split-block DFT of
  :func:`streamz_tpu_torch.dsp.mfcc.mfcc_base`.  The carry holds the
  previous block's DFT projection, so no PCM is projected twice.
- The Δ/ΔΔ stencil reaches 2 base frames ahead (``src/lib.rs:212-228``), so
  a frame is *finalized* (features emitted, vote counted) once 2 further
  frames exist: a fixed 2-frame (800-sample) lookahead.  The carry keeps
  the last 4 base MFCC frames.
- :func:`finalize_step` flushes the 2 pending frames with the end-of-clip
  edge clamp, which makes the streamed feature sequence equal to the
  offline frontend's on the same PCM: streaming is a latency mode, not an
  approximation.
- The step is written once over a leading slot axis ``[S, ...]``:
  :class:`StreamingIdentifier` is S = 1, the multi-stream server
  (:mod:`streamz_tpu_torch.app.serve`) S = its slot count.  Each dispatch
  takes up to ``block_batch`` blocks per slot with a per-slot count, and
  every data-dependent index is a gather with device index tensors, so a
  dispatch never reads a device value back to the host.
- The vote sums are f32 with Kahan compensation and the window count is
  int32: a plain f32 ``+=`` stops absorbing new windows once the sums reach
  about 2^24 times the increment (~42 h of audio).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamz_tpu_torch import config
from streamz_tpu_torch.dsp.mfcc import _constants, _to_f32
from streamz_tpu_torch.io import g711
from streamz_tpu_torch.nn.model import forward

_BLOCK = config.HOP_SIZE

# (proj [S, 802], has_prev [S] f32, tail [S, 4, 20], n_base [S] i32,
#  votes [S, cap] f32, votes_comp [S, cap] f32, count [S] i32)
Carry = Tuple[torch.Tensor, ...]


def zero_carry(n_slots: int, capacity: int, device) -> Carry:
    """The carry of ``n_slots`` fresh streams."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    S = n_slots
    return (z(S, 2 * config.N_FFT_BINS), z(S), z(S, 4, config.MFCC_SIZE),
            z(S, dtype=torch.int32), z(S, capacity), z(S, capacity),
            z(S, dtype=torch.int32))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[s, idx[s, j]]`` for x [S, L, C] and idx [S, n]: [S, n, C]."""
    return torch.gather(x, 1, idx.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


def _znorm(feats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-frame z-norm with the population variance; invalid frames 0."""
    mean = feats.mean(dim=-1, keepdim=True)
    var = ((feats - mean) ** 2).mean(dim=-1, keepdim=True)
    std = torch.clamp(torch.sqrt(var), min=1e-6)
    return torch.where(valid[..., None], (feats - mean) / std,
                       torch.zeros((), device=feats.device))


def stream_step(params, carry: Carry, blocks: torch.Tensor, n_new: torch.Tensor,
                num_speakers: int):
    """One dispatch: up to k new hop blocks for every slot.

    ``blocks`` [S, k, 400] f32 (rows past a slot's count are padding),
    ``n_new`` [S] int32 on the device.  Returns (carry', feats [S, k, 60],
    vmask [S, k]); row j of a slot holds global frame ``n_base - 2 + j``,
    valid when finalized by this dispatch.
    """
    proj, has_prev, tail, n_base, votes, vcomp, count = carry
    S, k, _ = blocks.shape
    dev = blocks.device
    dft_top, sign, fb_t, dct_t = _constants(dev)
    nbins = config.N_FFT_BINS

    proj_new = blocks @ dft_top  # [S, k, 802]
    all_proj = torch.cat([proj[:, None], proj_new], dim=1)  # [S, k+1, 802]
    cos_p, sin_p = all_proj[..., :nbins], all_proj[..., nbins:]
    re = cos_p[:, :-1] + sign * cos_p[:, 1:]
    im = sin_p[:, :-1] + sign * sin_p[:, 1:]
    power = re * re + im * im  # [S, k, 401]
    mel_log = torch.log(torch.clamp(power @ fb_t, min=1e-12))
    new_base = mel_log @ dct_t  # [S, k, 20]

    # Frame j pairs all_proj[j] with all_proj[j+1]; without a previous block
    # the j=0 pair is bogus, so the first valid frame starts at ``start``.
    # m = number of genuinely new base frames.
    n_new = n_new.long()
    start = (has_prev <= 0).long()
    m = torch.clamp(n_new - start, min=0)
    ar = torch.arange(k, device=dev)

    # Left-align the valid new frames, then stitch them after the tail:
    # seq position p holds global frame g = n_base - 4 + p.
    rolled = _rows(new_base, (ar[None] + start[:, None]) % k)
    seq = torch.cat([tail, rolled], dim=1)  # [S, 4 + k, 20]

    # Frames finalized this step: g in [n_base - 2, n_base + m - 2).
    nb = n_base.long()[:, None]
    mm = m[:, None]
    g = nb - 2 + ar[None]  # [S, k]
    valid = (g >= 0) & (g < nb + mm - 2)
    last = nb + mm - 1

    def b_at(x):  # edge-clamped base frame at global index x
        pos = torch.minimum(torch.clamp(x, min=0), last) - (nb - 4)
        return _rows(seq, torch.clamp(pos, 0, k + 3))

    def d1_at(x):  # Δ at global x, bottom-clamped like the offline path
        xc = torch.clamp(x, min=0)
        return (b_at(xc + 1) - b_at(xc - 1)) / 2.0

    d1 = d1_at(g)
    d2 = (d1_at(g + 1) - d1_at(g - 1)) / 2.0
    feats = _znorm(torch.cat([b_at(g), d1, d2], dim=-1), valid)

    probs = forward(params, feats, num_speakers)  # [S, k, cap]
    vmask = valid.to(torch.float32)
    step_sum = (probs * vmask[..., None]).sum(dim=1)
    # Kahan step: add the compensated increment, carry the rounding residue.
    y = step_sum - vcomp
    t = votes + y
    vcomp = (t - votes) - y
    votes = t
    count = count + valid.sum(dim=1, dtype=torch.int32)

    new_tail = _rows(seq, torch.clamp(mm, 0, k) + torch.arange(4, device=dev)[None])
    last_proj = _rows(all_proj, torch.clamp(n_new, 0, k)[:, None])[:, 0]
    carry_out = (
        last_proj,
        torch.maximum(has_prev, (n_new > 0).to(torch.float32)),
        new_tail,
        (n_base + m).to(torch.int32),
        votes,
        vcomp,
        count,
    )
    return carry_out, feats, vmask


def finalize_step(params, carry: Carry, num_speakers: int):
    """Flush the <= 2 pending frames of every slot with the end-of-stream
    edge clamp.  Returns (votes [S, cap], count [S], feats [S, 2, 60],
    vmask [S, 2])."""
    _, _, tail, n_base, votes, vcomp, count = carry
    dev = tail.device
    n_t = n_base.long()[:, None]  # total base frames in the stream
    g = n_t - 2 + torch.arange(2, device=dev)[None]
    valid = (g >= 0) & (g < n_t)

    def clip(x):
        return torch.minimum(torch.clamp(x, min=0), n_t - 1)

    def b_at(x):  # tail[i] holds global frame n_t - 4 + i
        return _rows(tail, torch.clamp(clip(x) - (n_t - 4), 0, 3))

    d1 = (b_at(g + 1) - b_at(g - 1)) / 2.0

    # As the offline pipeline: Δ is edge-clamped *before* ΔΔ (clamp_tail
    # between the two stencils in deltas_and_norm), so ΔΔ at the last
    # frames uses Δ(clip(g±1, 0, n_t-1)).
    def d1_at(x):
        xc = clip(x)
        return (b_at(xc + 1) - b_at(xc - 1)) / 2.0

    d2 = (d1_at(g + 1) - d1_at(g - 1)) / 2.0
    feats = _znorm(torch.cat([b_at(g), d1, d2], dim=-1), valid)
    probs = forward(params, feats, num_speakers)
    vmask = valid.to(torch.float32)
    votes = votes + ((probs * vmask[..., None]).sum(dim=1) - vcomp)
    count = count + valid.sum(dim=1, dtype=torch.int32)
    return votes, count, feats, vmask


def packed_votes(votes: torch.Tensor, count: torch.Tensor) -> np.ndarray:
    """``[..., capacity + 1]`` f32 on the host (the vote row, then the count):
    one device-to-host copy per readback."""
    return torch.cat([votes, count.to(torch.float32)[..., None]], dim=-1).cpu().numpy()


class Staging:
    """Host staging for the one host-to-device copy of a dispatch.

    Each dispatch ships one byte buffer: the slot counts [S] int32, then
    the blocks [S, k, 400] in the wire's dtype.  On CUDA two pinned buffers
    alternate and a buffer is refilled only after the copy that read it
    has completed (its CUDA event), so the host never writes under a copy
    in flight; the device side is one buffer, reused in stream order.  On
    the CPU the host buffer is the tensor.
    """

    def __init__(self, device: torch.device, n_slots: int, k: int):
        self.S, self.k = n_slots, k
        self.cuda = device.type == "cuda"
        nbytes = 4 * n_slots + n_slots * k * _BLOCK * 4
        depth = 2 if self.cuda else 1
        self._host = [torch.zeros(nbytes, dtype=torch.uint8, pin_memory=self.cuda)
                      for _ in range(depth)]
        self._events = [torch.cuda.Event() if self.cuda else None for _ in range(depth)]
        self._pending = [False] * depth
        self._dev = (torch.empty(nbytes, dtype=torch.uint8, device=device)
                     if self.cuda else None)
        self._i = 0
        self._n = 0
        self._dtype = torch.float32

    def host(self, dtype) -> Tuple[np.ndarray, np.ndarray]:
        """Zeroed numpy views (counts [S] int32, blocks [S, k, 400] of
        ``dtype``) of the next buffer, once its previous copy is done."""
        self._i = (self._i + 1) % len(self._host)
        if self._pending[self._i]:
            self._events[self._i].synchronize()
            self._pending[self._i] = False
        self._dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        head = 4 * self.S
        self._n = head + self.S * self.k * _BLOCK * np.dtype(dtype).itemsize
        raw = self._host[self._i][: self._n].numpy()
        raw.fill(0)
        return raw[:head].view(np.int32), raw[head:].view(dtype).reshape(self.S, self.k, _BLOCK)

    def ship(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The filled buffer on the device in one copy: (counts, blocks)."""
        buf = self._host[self._i][: self._n]
        if self.cuda:
            dst = self._dev[: self._n]
            dst.copy_(buf, non_blocking=True)
            self._events[self._i].record()
            self._pending[self._i] = True
        else:
            dst = buf
        head = 4 * self.S
        return (dst[:head].view(torch.int32),
                dst[head:].view(self._dtype).view(self.S, self.k, _BLOCK))


def check_capacity_growth(old_cap: int, new_cap: int) -> int:
    """Validate a hot-swap capacity change; returns the pad width (>= 0).

    Growth only appends output columns (src/lib.rs:797-821), so speaker ids
    stay stable; a shrink would drop accumulated votes and is refused.
    """
    if new_cap < old_cap:
        raise ValueError(
            f"model capacity shrank ({old_cap} -> {new_cap}); votes "
            "for existing speakers would be dropped"
        )
    return new_cap - old_cap


def grow_vote_carry(carry: Carry, pad: int) -> Carry:
    """Zero-pad the capacity-wide carry entries (4 = vote sums, 5 = their
    Kahan compensation) to a grown capacity; the rest pass through."""
    return carry[:4] + (F.pad(carry[4], (0, pad)), F.pad(carry[5], (0, pad)), carry[6])


def vote_verdict(
    votes: np.ndarray, count: float, output_size: int, threshold: float
) -> Optional[Tuple[int, float]]:
    """``identify_speaker_with_threshold`` semantics on accumulated vote
    sums (src/lib.rs:1307-1343): ``None`` for single-speaker nets, empty
    streams, or below-threshold confidence."""
    if output_size <= 1 or count <= 0:
        return None  # src/lib.rs:1311-1315
    sums = votes[:output_size]
    best = int(sums.argmax())
    conf = float(sums[best]) / count
    if conf < threshold:
        return None
    return best, conf


class StreamingIdentifier:
    """Hop-400 chunked live identification over a PCM stream.

    >>> sid = StreamingIdentifier(net, threshold=0.5)
    >>> for chunk in microphone():      # arbitrary chunk sizes
    ...     sid.feed(chunk)
    ...     print(sid.current())        # rolling (speaker, confidence)
    >>> sid.finalize()                  # exact offline-parity result

    Runs on the model's device.  ``feed`` enqueues its dispatches and reads
    nothing back (unless ``collect_features``); ``current`` is one packed
    device-to-host copy of the votes and the count.
    """

    def __init__(self, net, threshold: float = config.DEFAULT_CONF_THRESHOLD,
                 block_batch: int = 16, collect_features: bool = False):
        self.net = net
        self.threshold = float(threshold)
        self.k = int(block_batch)
        self.collect_features = collect_features
        self.features: List[np.ndarray] = []
        self._rem = np.zeros((0,), np.float32)
        self._finalized = False
        self._carry = zero_carry(1, net.capacity, net.device)
        self._stage = Staging(net.device, 1, self.k)

    # -- model hot-swap --------------------------------------------------------

    def update_model(self, net) -> None:
        """Swap in an updated model without dropping the stream.

        Speaker ids are stable (growth only appends output columns,
        ``src/lib.rs:797-821``), so votes already accumulated keep their
        meaning; capacity growth zero-pads the vote carries.  Frames already
        finalized were scored by the old model.
        """
        if self._finalized:
            raise RuntimeError("stream already finalized")
        pad = check_capacity_growth(self.net.capacity, net.capacity)
        if pad:
            self._carry = grow_vote_carry(self._carry, pad)
        self.net = net

    # -- feeding -------------------------------------------------------------

    def feed(self, pcm, encoding: Optional[str] = None) -> None:
        """Accept the next PCM chunk (i16, f32, or G.711 bytes with
        ``encoding='ulaw'``/``'alaw'``, expanded to exact i16 on the host;
        the multi-stream server ships the bytes to the device instead)."""
        if self._finalized:
            # Not an assert: under python -O a post-finalize feed would
            # re-finalize the flushed lookahead frames and double-count.
            raise RuntimeError("stream already finalized")
        if encoding is not None:
            if isinstance(pcm, (bytes, bytearray)):
                pcm = np.frombuffer(pcm, np.uint8)
            pcm = g711.decode(pcm, encoding)
        self._rem = np.concatenate([self._rem, _to_f32(np.asarray(pcm))])
        while len(self._rem) >= _BLOCK:
            n_blocks = min(len(self._rem) // _BLOCK, self.k)
            take = n_blocks * _BLOCK
            counts, blocks = self._stage.host(np.float32)
            counts[0] = n_blocks
            blocks[0, :n_blocks] = self._rem[:take].reshape(n_blocks, _BLOCK)
            self._rem = self._rem[take:]
            xn, xb = self._stage.ship()
            with torch.no_grad():
                self._carry, feats, vmask = stream_step(
                    self.net.params, self._carry, xb, xn, self.net.num_speakers)
            if self.collect_features:
                self._collect(feats, vmask)

    def _collect(self, feats: torch.Tensor, vmask: torch.Tensor) -> None:
        f = feats[0].cpu().numpy()
        m = vmask[0].cpu().numpy() > 0
        if m.any():
            self.features.append(f[m])

    # -- results -------------------------------------------------------------

    def current(self) -> Optional[Tuple[int, float]]:
        """Rolling identification over the frames finalized so far."""
        vc = packed_votes(self._carry[4][0], self._carry[6][0])
        return vote_verdict(vc[:-1], float(vc[-1]), self.net.output_size(),
                            self.threshold)

    def finalize(self) -> Optional[Tuple[int, float]]:
        """Flush the lookahead frames and return the final identification,
        equal to running the offline pipeline on the whole stream."""
        if not self._finalized:
            self._finalized = True
            with torch.no_grad():
                votes, count, feats, vmask = finalize_step(
                    self.net.params, self._carry, self.net.num_speakers)
            self._carry = self._carry[:4] + (votes, torch.zeros_like(votes), count)
            if self.collect_features:
                self._collect(feats, vmask)
        return self.current()

    def streamed_features(self) -> np.ndarray:
        """All finalized feature frames (requires ``collect_features``)."""
        if not self.features:
            return np.zeros((0, config.FEATURE_SIZE), np.float32)
        return np.concatenate(self.features)
