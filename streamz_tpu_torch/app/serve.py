"""Multi-stream batched serving: N concurrent live streams in one dispatch.

The port of ``streamz_tpu/app/serve.py`` on one device.  Its multi-host
guard is ported: in a multi-process run (a process group of two or more
ranks) the identifier refuses, as the JAX package does on more than one
host, and serving runs one server per process behind
:mod:`streamz_tpu_torch.app.fleet`.  Its ``mesh`` argument, slot-sharding
one process's identifier over several cards, is not ported yet.  A single
hop-400 stream keeps the
card a fraction of a percent busy, so serving batches many independent
streams into every dispatch: the streaming step of
:mod:`streamz_tpu_torch.app.stream` over a leading slot axis, one dispatch
per tick for the whole fleet.  Slots come and go without changing any
shape: occupancy is data (``n_new = 0`` slots are algebraic no-ops).

Host-side, each slot keeps only a short PCM remainder; ``tick()`` drains up
to ``block_batch`` hop blocks from every slot per dispatch, in one
host-to-device copy from a pinned staging buffer of the wire's dtype (f32,
i16, or G.711 bytes converted on the device).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from streamz_tpu_torch import config
from streamz_tpu_torch.app.stream import (
    Staging,
    check_capacity_growth,
    finalize_step,
    grow_vote_carry,
    packed_votes,
    stream_step,
    vote_verdict,
    zero_carry,
)
from streamz_tpu_torch.dsp.mfcc import _to_f32
from streamz_tpu_torch.io import g711
from streamz_tpu_torch.parallel import comm

_BLOCK = config.HOP_SIZE


def _linear_to_f32(x: torch.Tensor) -> torch.Tensor:
    """Linear PCM values to the [-1, 1] scale: ``x / 32767`` as a division,
    not a reciprocal multiply, for bit parity with the host conversion
    (``dsp.mfcc._to_f32``).  The divisor is a tensor on ``x``'s device: a
    CUDA division by a host scalar multiplies by the reciprocal, which
    rounds some quotients to the neighbouring float."""
    return x.to(torch.float32) / torch.full((), 32767.0, device=x.device)


def step_i16(params, carry, blocks_i16, n_new, num_speakers):
    """The step on raw int16 blocks, converted on the device: half the
    host-to-device bytes of f32, bit for bit the host conversion."""
    return stream_step(params, carry, _linear_to_f32(blocks_i16), n_new, num_speakers)


def step_u8(params, carry, codes_u8, n_new, num_speakers, table):
    """The step on G.711-companded bytes: a gather from the 256-entry decode
    table yields the exact linear value (as f32), then the i16 wire's
    division, so a companded byte is bit-identical to host-decoding it to
    i16 and shipping that."""
    lin = table.index_select(0, codes_u8.reshape(-1).long()).view(codes_u8.shape)
    return stream_step(params, carry, _linear_to_f32(lin), n_new, num_speakers)


class MultiStreamIdentifier:
    """Serve ``n_streams`` concurrent live identification streams batched.

    >>> srv = MultiStreamIdentifier(net, n_streams=64, threshold=0.5)
    >>> sid = srv.open()                  # claim a slot
    >>> srv.feed(sid, chunk)              # per-stream PCM, any chunk size
    >>> srv.tick()                        # ONE device dispatch for all slots
    >>> srv.current(sid)                  # rolling (speaker, confidence)
    >>> srv.finalize(sid)                 # exact offline-parity result
    >>> srv.close(sid)                    # slot becomes reusable

    Runs on the model's device; the carry, the slot zeroing and the slot
    extraction for ``finalize`` stay there.
    """

    def __init__(
        self,
        net,
        n_streams: int,
        threshold: float = config.DEFAULT_CONF_THRESHOLD,
        block_batch: int = 16,
    ):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if comm.world_size() > 1:
            # Feeds and verdicts are host-local: multi-process serving is
            # one server per process (streamz_tpu/app/serve.py:140-150).
            raise NotImplementedError(
                "MultiStreamIdentifier is single-process: run one server "
                "per host via streamz_tpu_torch.app.fleet (one "
                "`python -m streamz_tpu_torch.app.fleet --checkpoint m.npz` per "
                "host + FleetClient round-robin in front)"
            )
        self.net = net
        self.threshold = float(threshold)
        self.k = int(block_batch)
        self.n_streams = self.n_slots = int(n_streams)
        self.device = net.device
        S = self.n_slots
        self._step, self._step_i16, self._step_u8 = stream_step, step_i16, step_u8
        self._carry = zero_carry(S, net.capacity, self.device)
        self._stage = Staging(self.device, S, self.k)
        # host state per slot; _renc tags a uint8 remainder with its G.711
        # encoding ('ulaw' | 'alaw'), None for linear PCM remainders.
        self._rem: List[np.ndarray] = [np.zeros((0,), np.float32) for _ in range(S)]
        self._renc: List[Optional[str]] = [None] * S
        self._tables: Dict[str, torch.Tensor] = {}
        self._open = [False] * S
        self._final: Dict[int, Optional[Tuple[int, float]]] = {}
        # observability counters (stats())
        self._n_dispatches = 0
        self._bytes_shipped = 0
        self._wire_counts: Dict[str, int] = {"u8": 0, "i16": 0, "f32": 0}
        # Host verdict snapshot [S, cap+1] (votes row + count), valid only
        # between refresh_verdicts() and the next carry advance; None serves
        # current() from a per-slot device readback.
        self._vcache: Optional[np.ndarray] = None

    def _table(self, enc: str) -> torch.Tensor:
        """Device-resident G.711 decode table."""
        tab = self._tables.get(enc)
        if tab is None:
            tab = torch.as_tensor(g711.TABLES[enc][0], device=self.device)
            self._tables[enc] = tab
        return tab

    def warm_up(self) -> None:
        """Run every wire's step and a slot's flush once on scratch state and
        wait for them: a fresh process loads its kernels and libraries at
        their first launch (more than a second on a card), which would
        otherwise fall on the first stream's first verdict.  The live carry
        and the counters are untouched."""
        S, k, dev = self.n_slots, self.k, self.device
        carry = zero_carry(S, self.net.capacity, dev)
        n_new = torch.zeros((S,), dtype=torch.int32, device=dev)
        params, ns = self.net.params, self.net.num_speakers
        with torch.no_grad():
            stream_step(params, carry, torch.zeros((S, k, _BLOCK), device=dev), n_new, ns)
            step_i16(params, carry, torch.zeros((S, k, _BLOCK), dtype=torch.int16,
                                                device=dev), n_new, ns)
            step_u8(params, carry, torch.zeros((S, k, _BLOCK), dtype=torch.uint8, device=dev),
                    n_new, ns, self._table("ulaw"))
            votes, count, _, _ = finalize_step(params, tuple(c[:1] for c in carry), ns)
        packed_votes(votes[0], count[0])  # waits for all of it
        packed_votes(carry[4], carry[6])

    # -- slot lifecycle ------------------------------------------------------

    def open(self) -> int:
        """Claim a free slot and return its stream id."""
        for sid in range(self.n_streams):
            if not self._open[sid]:
                self._open[sid] = True
                self._final.pop(sid, None)
                return sid
        raise RuntimeError(f"all {self.n_streams} stream slots in use")

    def close(self, sid: int) -> None:
        """Release a slot: its carry is zeroed on the device for the next
        stream."""
        self._check(sid)
        self._open[sid] = False
        self._final.pop(sid, None)
        self._rem[sid] = np.zeros((0,), np.float32)
        self._renc[sid] = None
        for c in self._carry:
            c[sid] = 0
        if self._vcache is not None:
            self._vcache[sid] = 0.0  # mirror the zeroed row; cache stays valid

    def _check(self, sid: int) -> None:
        if not (0 <= sid < self.n_slots) or not self._open[sid]:
            raise KeyError(f"stream {sid} is not open")

    # -- model hot-swap --------------------------------------------------------

    def update_model(self, net) -> None:
        """Swap in an updated model for the whole fleet without dropping a
        stream.  Same-capacity swaps are free (the parameters are an
        argument of every dispatch); capacity growth zero-pads every slot's
        vote carry.  Already-finalized slots keep their verdicts."""
        pad = check_capacity_growth(self.net.capacity, net.capacity)
        self._vcache = None  # capacity/verdict basis may change
        if pad:
            self._carry = grow_vote_carry(self._carry, pad)
        self.net = net

    # -- feeding -------------------------------------------------------------

    def feed(self, sid: int, pcm, encoding: Optional[str] = None) -> None:
        """Buffer the next PCM chunk (i16, f32, or G.711 bytes) for ``sid``.

        int16 chunks stay int16 on the host and convert on the device.  With
        ``encoding='ulaw'`` or ``'alaw'`` the chunk is raw G.711-companded
        bytes, kept as uint8 and expanded on the device.
        """
        self._check(sid)
        if sid in self._final:
            raise RuntimeError(f"stream {sid} already finalized")
        if isinstance(pcm, (bytes, bytearray)):
            pcm = np.frombuffer(pcm, np.uint8)
        pcm = np.asarray(pcm)
        buf, tag = self._rem[sid], self._renc[sid]
        if encoding is not None:
            if encoding not in g711.TABLES:
                raise ValueError(f"unknown G.711 encoding {encoding!r}")
            if pcm.dtype != np.uint8:
                raise TypeError("G.711 chunks must be uint8 bytes")
            if len(buf) == 0 or tag == encoding:
                self._rem[sid] = np.concatenate([buf.astype(np.uint8), pcm])
                self._renc[sid] = encoding
                return
            # The remainder holds another representation: expand the chunk
            # (exact i16 values) and fall through to the linear rules.
            pcm = g711.decode(pcm, encoding)
        elif pcm.dtype == np.uint8:
            raise TypeError(
                "uint8 chunks are ambiguous: pass encoding='ulaw'/'alaw' "
                "for G.711 bytes, or convert linear PCM to int16/float32"
            )
        if tag is not None:
            # Linear PCM after G.711 bytes: expand the buffered bytes
            # (exact) and continue on the linear wire.
            buf = g711.decode(buf, tag)
            self._renc[sid] = None
        if pcm.dtype == np.int16 and (buf.dtype == np.int16 or len(buf) == 0):
            self._rem[sid] = np.concatenate([buf.astype(np.int16), pcm])
        else:
            self._rem[sid] = np.concatenate([_to_f32(buf), _to_f32(pcm)])

    def pending_blocks(self) -> int:
        """Max number of full hop blocks buffered on any slot."""
        return max((len(r) // config.HOP_SIZE for r in self._rem), default=0)

    def buffered_samples(self, sid: int) -> int:
        """Host-buffered samples waiting on one slot (backpressure
        accounting, :mod:`streamz_tpu_torch.app.server`)."""
        self._check(sid)
        return len(self._rem[sid])

    def stats(self) -> Dict[str, object]:
        """Serving counters: dispatches, bytes shipped to the device, the
        per-wire dispatch histogram, slot occupancy and host backlog."""
        return {
            "dispatches": self._n_dispatches,
            "bytes_shipped": self._bytes_shipped,
            "wire_dispatches": dict(self._wire_counts),
            "open_slots": sum(self._open),
            "n_streams": self.n_streams,
            "n_slots": self.n_slots,
            "pending_blocks": self.pending_blocks(),
            "buffered_samples": sum(len(r) for r in self._rem),
        }

    def tick(self, drain: bool = True) -> int:
        """Process buffered PCM for all slots in batched dispatches.

        Each dispatch drains up to ``block_batch`` hop blocks per slot; with
        ``drain`` (default) dispatches repeat until no slot holds a full
        block.  Returns the number of dispatches issued.
        """
        block = config.HOP_SIZE
        S, k = self.n_slots, self.k
        dispatches = 0
        while True:
            counts = np.array(
                [0 if sid in self._final else len(self._rem[sid]) // block
                 for sid in range(S)],
                np.int32,
            )
            counts = np.minimum(counts, k)
            if not counts.any():
                return dispatches
            # One dtype per dispatch, the narrowest that covers every
            # contributing slot exactly:
            #   u8  - all slots hold G.711 bytes of the same encoding;
            #   i16 - no f32 remainder (G.711 slots host-expand to their
            #         exact i16 values, so mixing u8 and i16 loses nothing);
            #   f32 - anything else.
            # Downgrades are transient: a slot returns to its narrow wire
            # whenever its remainder empties.
            live = [sid for sid in range(S) if counts[sid]]
            tags = {self._renc[sid] for sid in live}
            wire_u8 = (
                len(tags) == 1
                and None not in tags
                and all(self._rem[sid].dtype == np.uint8 for sid in live)
            )
            wire_i16 = not wire_u8 and all(
                self._rem[sid].dtype != np.float32 for sid in live
            )
            dtype = np.uint8 if wire_u8 else np.int16 if wire_i16 else np.float32
            host_counts, blocks = self._stage.host(dtype)
            host_counts[:] = counts
            for sid in live:
                nb = int(counts[sid])
                take = nb * block
                chunk = self._rem[sid][:take]
                if chunk.dtype == np.uint8 and not wire_u8:
                    chunk = g711.decode(chunk, self._renc[sid])
                if dtype == np.float32:
                    chunk = _to_f32(chunk)
                blocks[sid, :nb] = chunk.reshape(nb, block)
                self._rem[sid] = self._rem[sid][take:]
            xn, xb = self._stage.ship()
            params, ns = self.net.params, self.net.num_speakers
            with torch.no_grad():
                if wire_u8:
                    self._carry, _, _ = self._step_u8(
                        params, self._carry, xb, xn, ns, self._table(next(iter(tags))))
                else:
                    step = self._step_i16 if wire_i16 else self._step
                    self._carry, _, _ = step(params, self._carry, xb, xn, ns)
            dispatches += 1
            self._vcache = None  # carry advanced; snapshot is stale
            self._n_dispatches += 1
            self._bytes_shipped += blocks.nbytes + counts.nbytes
            self._wire_counts["u8" if wire_u8 else "i16" if wire_i16 else "f32"] += 1
            if not drain:
                return dispatches

    # -- results -------------------------------------------------------------

    def _verdict(self, votes, count) -> Optional[Tuple[int, float]]:
        return vote_verdict(votes, count, self.net.output_size(), self.threshold)

    def refresh_verdicts(self) -> None:
        """Pull every slot's rolling-verdict inputs to the host in ONE
        device-to-host copy of ``[S, capacity + 1]``; until the carry next
        advances, ``current()`` is served from this snapshot.  Votes change
        only at dispatches, so a post-tick snapshot is exact until the next
        working tick."""
        self._vcache = packed_votes(self._carry[4], self._carry[6])

    def current(self, sid: int) -> Optional[Tuple[int, float]]:
        """Rolling identification for one stream (finalized frames so far)."""
        self._check(sid)
        if sid in self._final:
            return self._final[sid]
        if self._vcache is not None:
            vc = self._vcache[sid]
        else:
            vc = packed_votes(self._carry[4][sid], self._carry[6][sid])
        return self._verdict(vc[:-1], float(vc[-1]))

    def finalize(self, sid: int) -> Optional[Tuple[int, float]]:
        """Flush ``sid``'s lookahead frames; equal to the offline pipeline on
        that stream's full PCM.  Drains every slot's buffered full blocks
        first (other streams advance by exactly the audio they were fed)."""
        self._check(sid)
        if sid in self._final:
            return self._final[sid]
        self.tick()
        slot = tuple(c[sid:sid + 1] for c in self._carry)  # on the device
        with torch.no_grad():
            votes, count, _, _ = finalize_step(self.net.params, slot, self.net.num_speakers)
        vc = packed_votes(votes[0], count[0])
        res = self._verdict(vc[:-1], float(vc[-1]))
        self._final[sid] = res
        return res
