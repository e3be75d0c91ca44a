"""Network serving daemon: live speaker identification over TCP.

The port of ``streamz_tpu/app/server.py``.  A socket server in front of
:class:`~streamz_tpu_torch.app.serve.MultiStreamIdentifier` speaking the
JAX daemon's length-prefixed binary protocol, byte for byte, so clients in
any language (and the JAX package's :class:`StreamClient`) stream PCM and
read rolling and final verdicts.

Design:

- **One device owner.**  Once the server is started, only the ticker
  thread touches the card: it drains the clients' buffered PCM into the
  identifier, runs every batched dispatch, finalizes and closes slots, and
  reloads the model.  Client threads parse frames and buffer host arrays.
- **No client waits on a tick.**  Where the JAX daemon serializes every
  identifier call under one lock, so that CURRENT and FEED wait out a whole
  dispatch and its readback, here:

  * FEED appends to a per-slot host queue (bounded by
    ``max_buffered_samples`` with the JAX daemon's error text and
    ``overflows`` counter); the ticker drains the queues into the
    identifier under its own lock.
  * CURRENT reads a verdict snapshot that the ticker publishes at the end
    of each working tick under a small swap lock.  Each entry carries its
    slot's generation, so a recycled slot never serves the previous
    stream's verdict; a poll that lands mid-tick reads the pre-tick
    snapshot, so verdicts change only at tick boundaries.
  * FINALIZE is handed to the ticker, which drains the slot's queue first
    and replies through a future.

  The verdicts and the wire are the JAX daemon's.
- **Batched ticks.**  The ticker drains every connection's blocks in shared
  dispatches every ``tick_interval`` seconds, and at once when a FINALIZE
  or a disconnect is waiting.  Before the first connection is accepted it
  runs every wire once on scratch state, so that the first stream's first
  verdict does not wait for the process to load its kernels.
- **Narrow wires end to end.**  The FEED frame carries the wire tag (f32 /
  i16 / G.711 mu-law / A-law); G.711 bytes go to the device-side table
  expansion, one byte per sample all the way to the card.
- **Model hot-reload.**  With ``watch_model`` the ticker polls the
  checkpoint's stat signature (mtime_ns, size, inode, so that a rollback
  that keeps an older mtime still reloads) and swaps the fleet's model in
  place, loaded onto the server's device: no stream is dropped, no socket
  closed.  A file is loaded once its signature has held for one poll.

Wire protocol (all integers little-endian)::

    frame   := opcode:u8  length:u32  payload[length]

    client -> server
      0x01 FEED      payload = wire:u8 + samples
                     wire 0 = f32, 1 = i16, 2 = G.711 mu-law, 3 = A-law
                     (no reply; a failed FEED is reported as the ERROR
                     reply to the NEXT CURRENT/FINALIZE, keeping the
                     request/response pairing strict)
      0x02 CURRENT   -> VERDICT(final=0) over frames finalized so far
      0x03 FINALIZE  -> VERDICT(final=1), exact offline parity
      0x04 STATS     -> STATS json; with payload ``reset-ticks`` the
                     server also starts a fresh tick-latency window
                     after reporting

    server -> client
      0x81 VERDICT   payload = speaker:i32 (-1 = none) + confidence:f32
                               + final:u8
      0x82 STATS     payload = utf-8 json
      0x7f ERROR     payload = utf-8 message, replacing a VERDICT reply
                               (the connection stays open); protocol
                               violations (bad opcode, oversized frame)
                               close the connection instead
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future, TimeoutError as FutureTimeout
from typing import Dict, List, Optional, Tuple

import numpy as np

from streamz_tpu_torch import config
from streamz_tpu_torch.app.serve import MultiStreamIdentifier
from streamz_tpu_torch.io import g711

OP_FEED = 0x01
OP_CURRENT = 0x02
OP_FINALIZE = 0x03
OP_STATS = 0x04
OP_VERDICT = 0x81
OP_STATS_REPLY = 0x82
OP_ERROR = 0x7F

_WIRES = {0: ("f32", None), 1: ("i16", None), 2: ("u8", "ulaw"), 3: ("u8", "alaw")}
_HDR = struct.Struct("<BI")
_VERDICT = struct.Struct("<ifB")

MAX_FRAME = 1 << 24  # 16 MiB: ~3 min of f32 PCM in one frame is plenty


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes or return None on EOF."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, opcode: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(opcode, len(payload)) + payload)


def recv_frame(sock: socket.socket):
    """Read one frame; returns (opcode, payload) or None on EOF."""
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    opcode, length = _HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise ValueError(f"frame length {length} exceeds {MAX_FRAME}")
    payload = _recv_exact(sock, length) if length else b""
    if payload is None:
        return None
    return opcode, payload


class SpeakerServer:
    """Serve live identification streams over TCP.

    >>> srv = SpeakerServer(net, port=0)       # 0 = ephemeral
    >>> srv.start()
    >>> srv.port                                # the bound port
    >>> ...                                     # clients connect and stream
    >>> srv.stop()

    One TCP connection is one stream slot, claimed on accept and released on
    disconnect.  ``n_streams`` bounds the fleet; an at-capacity connect
    receives an ERROR frame and is closed.  The server runs on the model's
    device (``self.device``); reloads load onto it.  ``mesh`` (a
    ``LocalMesh``) shards the identifier's slots over several devices of
    this process (``streamz_tpu/app/server.py:138-150``).
    """

    def __init__(
        self,
        net,
        host: str = "127.0.0.1",
        port: int = 0,
        n_streams: int = 64,
        threshold: float = config.DEFAULT_CONF_THRESHOLD,
        block_batch: int = 16,
        tick_interval: float = 0.02,
        watch_model: Optional[str] = None,
        watch_interval: float = 1.0,
        max_buffered_samples: int = 30 * config.DEFAULT_SAMPLE_RATE,
        idle_timeout: Optional[float] = None,
        mesh=None,
    ):
        self.ident = MultiStreamIdentifier(
            net, n_streams=n_streams, threshold=threshold, block_batch=block_batch,
            mesh=mesh)
        self.device = net.device
        self._host, self._requested_port = host, int(port)
        self.max_buffered_samples = int(max_buffered_samples)
        self.tick_interval = float(tick_interval)
        self.watch_model = watch_model
        self.watch_interval = float(watch_interval)
        # Idle reaping: with idle_timeout set, a connection that sends no
        # frame for that many seconds is dropped and its slot released, so
        # silent peers cannot park the fleet at capacity (None keeps slots
        # for the life of the connection).
        self.idle_timeout = None if idle_timeout is None else float(idle_timeout)
        # Lock order: _lock (the identifier; the ticker, accept's open,
        # stats) before _qlock (per-slot host state) before _vlock (the
        # verdict snapshot).  Client threads never take _lock for FEED or
        # CURRENT.
        self._lock = threading.Lock()
        self._qlock = threading.Lock()
        self._vlock = threading.Lock()
        self._wake = threading.Event()  # a FINALIZE or close is waiting
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._threads: list = []  # accept + ticker only
        self._client_threads: set = set()  # self-pruning on disconnect
        self._conns: Dict[int, socket.socket] = {}  # sid -> socket
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()
        self._n_accepted = 0
        self._n_rejected = 0
        self._n_overflows = 0
        self._n_idle_dropped = 0
        # Per-slot host state, under _qlock.
        self._gen: Dict[int, int] = {}  # sid -> generation of its stream
        self._next_gen = 0
        self._queues: Dict[int, List[Tuple[np.ndarray, Optional[str]]]] = {}
        self._queued: Dict[int, int] = {}  # samples in the queue
        self._backlog: Dict[int, int] = {}  # samples in the identifier
        self._finalized: set = set()
        self._sticky_errors: Dict[int, str] = {}  # sid -> failed-FEED message
        self._commands: deque = deque()  # (op, sid, Future) for the ticker
        # The verdict snapshot CURRENT reads: sid -> (generation, verdict).
        self._verdicts: Dict[int, Tuple[int, Optional[Tuple[int, float]]]] = {}
        self._model_sig: Optional[tuple] = None  # (mtime_ns, size, inode)
        self._pending_sig: Optional[tuple] = None
        self._n_reloads = 0
        # Host wall time of every WORKING tick (>= 1 dispatch), bounded;
        # stats() exports p50/p95/p99.
        self._tick_times: deque = deque(maxlen=4096)

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        if self._listener is None:
            raise RuntimeError("server not started")
        return self._listener.getsockname()[1]

    def start(self) -> None:
        if self._listener is not None:
            raise RuntimeError("server already started")
        if self.watch_model and os.path.exists(self.watch_model):
            self._model_sig = self._stat_sig()
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, self._requested_port))
        ls.listen(128)
        self._listener = ls
        # The ticker warms every wire up before the first connection is
        # accepted (connections wait in the listen backlog meanwhile).
        warmed: Future = Future()
        ticker = threading.Thread(target=self._tick_loop, args=(warmed,), daemon=True)
        ticker.start()
        self._threads.append(ticker)
        try:
            warmed.result()
        except Exception:
            self.stop()
            raise
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        self._threads.append(self._accept_thread)

    def stop(self) -> None:
        """Stop accepting, close every connection, join the threads."""
        self._stop.set()
        self._wake.set()
        if self._listener is not None:
            # close() alone does not wake a thread blocked in accept() on
            # Linux (the join below would wait out its timeout); shutdown()
            # does.
            for end in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                        self._listener.close):
                try:
                    end()
                except OSError:
                    pass
        # Join the accept thread BEFORE snapshotting connections: a socket
        # accepted concurrently with stop() is then either closed by the
        # loop's own stop check or registered.
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        with self._conns_lock:
            socks = list(self._conns.values())
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        for t in list(self._client_threads) + self._threads:
            t.join(timeout=5.0)
        self._threads = []
        self._accept_thread = None
        self._client_threads.clear()

    def serve_forever(self) -> None:
        """Block until interrupted (the CLI ``--serve`` entry).

        ^C and SIGTERM give the same graceful stop: close the listener and
        every connection, join the threads.  The previous SIGTERM handler is
        restored on exit; off the main thread no handler is installed.
        """
        import signal

        prev = None
        installed = False
        if threading.current_thread() is threading.main_thread():
            try:
                prev = signal.signal(signal.SIGTERM, lambda *_: self._stop.set())
                installed = True
            except (ValueError, OSError):
                pass
        try:
            while not self._stop.is_set():
                self._stop.wait(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            if installed:
                # prev is None when non-Python code installed the previous
                # handler; passing None back would raise and skip stop().
                signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
            self.stop()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            s = self.ident.stats()
        with self._qlock:  # FEEDs still queued are buffered samples too
            s["buffered_samples"] += sum(self._queued.values())
        with self._conns_lock:
            s["connections"] = len(self._conns)
        s["accepted"] = self._n_accepted
        s["rejected"] = self._n_rejected
        s["overflows"] = self._n_overflows
        s["idle_dropped"] = self._n_idle_dropped
        s["model_reloads"] = self._n_reloads
        tt = list(self._tick_times)
        if tt:
            p50, p95, p99 = np.percentile(np.asarray(tt) * 1e3, (50, 95, 99))
            s["tick_ms_p50"] = round(float(p50), 2)
            s["tick_ms_p95"] = round(float(p95), 2)
            s["tick_ms_p99"] = round(float(p99), 2)
            s["ticks_measured"] = len(tt)
        return s

    # -- client threads ------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            if self._stop.is_set():
                # Raced stop(): it joins this thread before closing the
                # registered connections, so a late accept is closed here.
                try:
                    conn.close()
                except OSError:
                    pass
                return
            sid = None
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if self.idle_timeout is not None:
                    conn.settimeout(self.idle_timeout)
                try:
                    with self._lock:
                        sid = self.ident.open()
                        with self._qlock:
                            gen = self._next_gen
                            self._next_gen += 1
                            self._gen[sid] = gen
                            self._queues[sid], self._queued[sid] = [], 0
                            self._backlog[sid] = 0
                            self._finalized.discard(sid)
                            self._sticky_errors.pop(sid, None)
                except RuntimeError as e:  # fleet at capacity
                    self._n_rejected += 1
                    try:
                        send_frame(conn, OP_ERROR, str(e).encode())
                    except OSError:
                        pass
                    # Close unconditionally: a failed ERROR send must not
                    # leak the fd.
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
                self._n_accepted += 1
                with self._conns_lock:
                    self._conns[sid] = conn
                t = threading.Thread(target=self._client_loop, args=(conn, sid, gen),
                                     daemon=True)
                self._client_threads.add(t)
                t.start()
            except Exception as e:
                # Per-connection setup failure: release what was claimed and
                # keep accepting.
                print(f"[serve] accept setup failed, dropping connection: {e}")
                if sid is not None:
                    with self._conns_lock:
                        self._conns.pop(sid, None)
                    self._submit("close", sid)
                try:
                    conn.close()
                except OSError:
                    pass

    def _client_loop(self, conn: socket.socket, sid: int, gen: int) -> None:
        try:
            while not self._stop.is_set():
                try:
                    frame = recv_frame(conn)
                except socket.timeout:
                    # idle_timeout elapsed with no frame: reap the slot.
                    self._n_idle_dropped += 1
                    break
                except (ValueError, OSError):
                    break  # protocol violation / socket error: drop
                if frame is None:
                    break  # EOF
                opcode, payload = frame
                try:
                    self._handle(conn, sid, gen, opcode, payload)
                except (BrokenPipeError, ConnectionError, OSError):
                    break
                except Exception:
                    break  # protocol violation: drop the connection
        finally:
            with self._conns_lock:
                self._conns.pop(sid, None)
            try:
                conn.close()
            except OSError:
                pass
            self._submit("close", sid)
            self._client_threads.discard(threading.current_thread())

    def _submit(self, op: str, sid: int) -> Future:
        """Hand a slot operation to the ticker, the card's one user."""
        fut: Future = Future()
        with self._qlock:
            self._commands.append((op, sid, fut))
        self._wake.set()
        return fut

    def _await(self, fut: Future):
        while True:
            try:
                return fut.result(timeout=0.25)
            except FutureTimeout:
                if self._stop.is_set():
                    raise RuntimeError("server stopping") from None

    def _handle(self, conn: socket.socket, sid: int, gen: int, opcode: int,
                payload: bytes) -> None:
        if opcode == OP_FEED:
            try:
                self._enqueue(sid, payload)
            except Exception as e:
                # FEED has no reply frame; surface the failure as the ERROR
                # reply to this stream's next CURRENT/FINALIZE.
                with self._qlock:
                    self._sticky_errors.setdefault(sid, str(e))
        elif opcode in (OP_CURRENT, OP_FINALIZE):
            with self._qlock:
                sticky = self._sticky_errors.pop(sid, None)
            if sticky is not None:
                send_frame(conn, OP_ERROR, sticky.encode())
                return
            if opcode == OP_CURRENT:
                with self._vlock:
                    entry = self._verdicts.get(sid)
                res = entry[1] if entry is not None and entry[0] == gen else None
            else:
                try:
                    res = self._await(self._submit("finalize", sid))
                except Exception as e:
                    send_frame(conn, OP_ERROR, str(e).encode())
                    return
            self._send_verdict(conn, res, final=opcode == OP_FINALIZE)
        elif opcode == OP_STATS:
            reply = json.dumps(self.stats()).encode()
            if payload == b"reset-ticks":
                # A fresh tick-latency window AFTER reporting: a bench
                # separates warm-up ticks from the steady state this way.
                self._tick_times.clear()
            send_frame(conn, OP_STATS_REPLY, reply)
        else:
            raise ValueError(f"unknown opcode 0x{opcode:02x}")

    def _enqueue(self, sid: int, payload: bytes) -> None:
        """Parse a FEED payload and queue its samples for the ticker."""
        if not payload:
            raise ValueError("FEED frame needs a wire tag byte")
        wire = _WIRES.get(payload[0])
        if wire is None:
            raise ValueError(f"unknown wire tag {payload[0]}")
        kind, encoding = wire
        dtype = {"f32": np.dtype("<f4"), "i16": np.dtype("<i2"), "u8": np.uint8}[kind]
        pcm = np.frombuffer(payload[1:], dtype)
        with self._qlock:
            if sid in self._finalized:
                raise RuntimeError(f"stream {sid} already finalized")
            # Transport-level backpressure: a client flooding PCM faster
            # than ticks drain must not grow host memory without bound.
            buffered = self._backlog.get(sid, 0) + self._queued.get(sid, 0)
            if buffered + pcm.size > self.max_buffered_samples:
                self._n_overflows += 1
                raise ValueError(
                    f"stream {sid} backlog {buffered + pcm.size} "
                    f"samples exceeds max_buffered_samples="
                    f"{self.max_buffered_samples}; feed slower or "
                    "raise the limit"
                )
            self._queues[sid].append((pcm, encoding))
            self._queued[sid] += pcm.size

    @staticmethod
    def _send_verdict(conn, res, final: bool) -> None:
        speaker, conf = (-1, 0.0) if res is None else res
        send_frame(conn, OP_VERDICT, _VERDICT.pack(int(speaker), float(conf), final))

    # -- the ticker: the card's one user ---------------------------------------

    def _drain(self, sids=None) -> None:
        """Move queued PCM into the identifier (``_lock`` held)."""
        with self._qlock:
            todo = {}
            for sid in (list(self._queues) if sids is None else sids):
                if self._queues.get(sid):
                    todo[sid] = self._queues[sid]
                    self._queues[sid] = []
                    self._backlog[sid] += self._queued[sid]
                    self._queued[sid] = 0
        for sid, items in todo.items():
            for pcm, encoding in items:
                try:
                    self.ident.feed(sid, pcm, encoding=encoding)
                except Exception as e:
                    with self._qlock:
                        self._sticky_errors.setdefault(sid, str(e))

    def _publish(self) -> None:
        """Refresh the verdict snapshot from one readback (``_lock`` held)."""
        self.ident.refresh_verdicts()
        with self._qlock:
            gens = dict(self._gen)
            for sid in gens:
                self._backlog[sid] = self.ident.buffered_samples(sid)
        snap = {sid: (gen, self.ident.current(sid)) for sid, gen in gens.items()}
        with self._vlock:
            self._verdicts = snap

    def _run_commands(self) -> None:
        """FINALIZE and close requests, in arrival order (``_lock`` held)."""
        while True:
            with self._qlock:
                if not self._commands:
                    return
                op, sid, fut = self._commands.popleft()
            try:
                if op == "finalize":
                    self._drain([sid])
                    res = self.ident.finalize(sid)
                    with self._qlock:
                        self._finalized.add(sid)
                    self._publish()
                else:
                    try:
                        self.ident.close(sid)
                    except KeyError:
                        pass
                    with self._qlock:
                        for d in (self._gen, self._queues, self._queued, self._backlog,
                                  self._sticky_errors):
                            d.pop(sid, None)
                        self._finalized.discard(sid)
                    with self._vlock:
                        self._verdicts.pop(sid, None)
                    res = None
            except Exception as e:
                fut.set_exception(e)
            else:
                fut.set_result(res)

    def _tick_loop(self, warmed: Future) -> None:
        try:
            with self._lock:
                self.ident.warm_up()
        except Exception as e:
            warmed.set_exception(e)
            return
        warmed.set_result(None)
        last_watch = 0.0
        while not self._stop.is_set():
            self._wake.clear()
            # The ticker drives ALL device work; an exception escaping it
            # would halt every stream while the server keeps accepting.
            # Transient device errors are logged and the next tick retries.
            try:
                t0 = time.perf_counter()
                with self._lock:
                    self._drain()
                    self._run_commands()
                    n_dispatched = self.ident.tick()
                    if n_dispatched:
                        self._publish()
                if n_dispatched:
                    # Host wall time of a working tick: lock wait, drain,
                    # dispatch and the verdict-snapshot readback.
                    self._tick_times.append(time.perf_counter() - t0)
            except Exception as e:
                print(f"[serve] tick failed, retrying next tick: {e}")
            now = time.monotonic()
            if self.watch_model and now - last_watch >= self.watch_interval:
                last_watch = now
                try:
                    self._maybe_reload()
                except Exception as e:
                    print(f"[serve] model watch failed, will retry: {e}")
            self._wake.wait(self.tick_interval)
        with self._qlock:
            pending, self._commands = list(self._commands), deque()
        for _, _, fut in pending:
            fut.set_exception(RuntimeError("server stopping"))

    def _stat_sig(self) -> tuple:
        """The watched checkpoint's change signature, (mtime_ns, size,
        inode): a rollback that keeps an older mtime (``mv model.bak
        model.npz``) changes the inode, and a rewrite within one coarse
        timestamp tick the size or inode."""
        st = os.stat(self.watch_model)
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def _maybe_reload(self) -> None:
        """Hot-swap the model when the watched checkpoint changes.

        Two-poll stability gate: a changed signature is remembered on the
        first sighting and loaded only once a later poll sees the same
        value, so a checkpoint mid-write is never loaded.  Load failures are
        skipped and retried on the next change.
        """
        try:
            sig = self._stat_sig()
        except OSError:
            return
        if sig == self._model_sig:
            return
        if self._pending_sig != sig:
            self._pending_sig = sig  # first sighting: wait one poll
            return
        from streamz_tpu_torch.nn import checkpoint

        try:
            net = checkpoint.load(self.watch_model, device=self.device)
        except Exception as e:
            print(f"[serve] model reload failed, will retry: {e}")
            return
        try:
            with self._lock:
                self.ident.update_model(net)
                self._publish()
        except ValueError as e:  # capacity shrink: refuse, keep serving
            print(f"[serve] model reload rejected: {e}")
            self._model_sig = sig  # don't retry this file version
            self._pending_sig = None
            return
        self._model_sig = sig
        self._pending_sig = None
        self._n_reloads += 1
        print(f"[serve] model hot-swapped ({net.num_speakers} speakers, "
              f"capacity {net.capacity})")


class StreamClient:
    """Minimal blocking client for :class:`SpeakerServer` (tests, examples;
    the protocol is trivially reimplementable in any language)."""

    WIRE = {"f32": 0, "i16": 1, "ulaw": 2, "alaw": 3}

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    @staticmethod
    def _linear_i16(pcm):
        """Full-scale linear i16 from i16/float/int samples.  Floats are the
        server's f32 scale ([-1, 1], the inverse of its /32767 conversion):
        scale, round, clip.  Wider ints are clipped, never wrapped."""
        pcm = np.asarray(pcm)
        if pcm.dtype == np.int16:
            return pcm
        if np.issubdtype(pcm.dtype, np.floating):
            return np.clip(np.round(pcm * 32767.0), -32768, 32767).astype(np.int16)
        return np.clip(pcm, -32768, 32767).astype(np.int16)

    def feed(self, pcm, wire: Optional[str] = None) -> None:
        """Send one PCM chunk.  ``wire`` picks the transport dtype; samples
        are CONVERTED to it when they arrive in another representation
        (floats scale to full-range i16, i16/floats G.711-compand for the
        'ulaw'/'alaw' wires; already-companded bytes pass through raw)."""
        if isinstance(pcm, (bytes, bytearray)):
            raw = bytes(pcm)
            if wire not in ("ulaw", "alaw"):
                raise ValueError("raw bytes need wire='ulaw'/'alaw'")
        else:
            pcm = np.asarray(pcm)
            if wire is None:
                if pcm.dtype == np.uint8:
                    raise ValueError("uint8 samples are ambiguous: pass wire='ulaw'/'alaw'")
                wire = "i16" if pcm.dtype == np.int16 else "f32"
            if pcm.dtype == np.uint8:
                if wire in ("ulaw", "alaw"):
                    raw = pcm.tobytes()  # already-companded G.711 bytes
                else:
                    raise ValueError(
                        "uint8 samples are ambiguous: pass wire='ulaw'/"
                        "'alaw' for G.711 bytes"
                    )
            elif wire == "f32":
                if np.issubdtype(pcm.dtype, np.integer):
                    # The f32 wire carries the [-1, 1] float scale; full-range
                    # ints convert with the i16 wire's /32767.
                    raw = (pcm.astype("<f4") / np.float32(32767.0)).tobytes()
                else:
                    raw = pcm.astype("<f4").tobytes()
            elif wire == "i16":
                raw = self._linear_i16(pcm).astype("<i2").tobytes()
            else:  # linear samples onto a G.711 wire: compand client-side
                enc = g711.ulaw_encode if wire == "ulaw" else g711.alaw_encode
                raw = enc(self._linear_i16(pcm)).tobytes()
        send_frame(self.sock, OP_FEED, bytes([self.WIRE[wire]]) + raw)

    def _verdict(self, opcode):
        send_frame(self.sock, opcode)
        frame = recv_frame(self.sock)
        if frame is None:
            raise ConnectionError("server closed the connection")
        op, payload = frame
        if op == OP_ERROR:
            raise RuntimeError(payload.decode())
        if op != OP_VERDICT:
            raise ValueError(f"unexpected reply opcode 0x{op:02x}")
        speaker, conf, final = _VERDICT.unpack(payload)
        res = None if speaker < 0 else (speaker, conf)
        return res, bool(final)

    def current(self):
        return self._verdict(OP_CURRENT)[0]

    def finalize(self):
        return self._verdict(OP_FINALIZE)[0]

    def stats(self, reset_ticks: bool = False) -> Dict[str, object]:
        send_frame(self.sock, OP_STATS, b"reset-ticks" if reset_ticks else b"")
        frame = recv_frame(self.sock)
        if frame is None:
            raise ConnectionError("server closed the connection")
        op, payload = frame
        if op == OP_ERROR:
            raise RuntimeError(payload.decode())
        return json.loads(payload.decode())

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
