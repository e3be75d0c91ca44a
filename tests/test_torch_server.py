"""The port's TCP serving daemon (app/server.py) against the JAX daemon.

The network layer is a transparent transport over the port's
:class:`MultiStreamIdentifier`: every verdict over a socket equals the
in-process streaming result on the same PCM; slots recycle on disconnect;
an at-capacity connect gets an ERROR frame; the model watcher swaps
checkpoints without dropping a connection.  The wire is the JAX daemon's:
the JAX ``StreamClient`` gets the same verdicts from this server as from
the JAX one, and the reverse.  Two departures from the JAX daemon are held
here: with a tick held open, CURRENT and FEED still answer within 1 s
(CURRENT with the pre-tick verdict), and a recycled slot never serves its
previous stream's verdict.  Every socket, join and wait has a timeout.
"""

import os
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from streamz_tpu.app import server as jserver
from streamz_tpu.nn.model import SpeakerNet as JNet
from streamz_tpu_torch import cli as tcli
from streamz_tpu_torch.app import server as server_mod
from streamz_tpu_torch.app.server import OP_ERROR, SpeakerServer, StreamClient, recv_frame
from streamz_tpu_torch.app.stream import StreamingIdentifier
from streamz_tpu_torch.io import g711
from streamz_tpu_torch.nn import checkpoint
from streamz_tpu_torch.nn.model import SpeakerNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def net():
    return SpeakerNet.new(output=5, seed=0, device="cpu")


@pytest.fixture()
def server(net):
    srv = SpeakerServer(net, port=0, n_streams=4, threshold=0.0, tick_interval=0.005)
    srv.start()
    yield srv
    srv.stop()


def _clip(seed=0, seconds=1.0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3000, size=int(44100 * seconds)).astype(np.int16)


def _offline(net, clip, **kw):
    ref = StreamingIdentifier(net, threshold=0.0)
    ref.feed(clip, **kw)
    return ref.finalize()


def _assert_verdict_close(got, ref):
    if ref is None:
        assert got is None
        return
    assert got is not None and got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)


def _wait_for(pred, timeout=20.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _gate_ticks(srv):
    """Make ``srv``'s ticks blockable: clearing the returned ``gate`` holds
    the next tick inside the identifier (with the ticker's lock) until it
    is set again; ``entered`` is set when a tick is held."""
    gate, entered = threading.Event(), threading.Event()
    gate.set()
    real_tick = srv.ident.tick

    def gated_tick(*a, **kw):
        if not gate.is_set():
            entered.set()
            gate.wait(timeout=30)
        return real_tick(*a, **kw)

    srv.ident.tick = gated_tick
    return gate, entered


# -- the JAX file's cases ---------------------------------------------------------


def test_round_trip_matches_offline(net, server):
    clip = _clip(seed=1)
    with StreamClient("127.0.0.1", server.port) as c:
        for i in range(0, len(clip), 4096):
            c.feed(clip[i:i + 4096])
        _assert_verdict_close(c.finalize(), _offline(net, clip))


def test_concurrent_clients_are_independent(net, server):
    clips = [_clip(seed=s) for s in range(3)]
    results = {}

    def run(idx):
        with StreamClient("127.0.0.1", server.port) as c:
            clip = clips[idx]
            for i in range(0, len(clip), 2048):
                c.feed(clip[i:i + 2048])
            results[idx] = c.finalize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i, clip in enumerate(clips):
        _assert_verdict_close(results[i], _offline(net, clip))


def test_rolling_current_and_wire_tags(net, server):
    clip = _clip(seed=7)
    with StreamClient("127.0.0.1", server.port) as c:
        c.feed(clip[:8192])
        assert _wait_for(lambda: c.current() is not None)  # before finalize
        c.feed(clip[8192:])
        got = c.finalize()
    codes = g711.ulaw_encode(clip)
    with StreamClient("127.0.0.1", server.port) as c:
        c.feed(codes.tobytes(), wire="ulaw")
        got_u8 = c.finalize()
    _assert_verdict_close(got_u8, _offline(net, g711.decode(codes, "ulaw")))
    _assert_verdict_close(got, _offline(net, clip))


def test_slot_recycled_after_disconnect_and_at_capacity_rejected(net):
    srv = SpeakerServer(net, port=0, n_streams=1, tick_interval=0.005)
    srv.start()
    try:
        c1 = StreamClient("127.0.0.1", srv.port, timeout=10)
        c1.feed(_clip(seed=3)[:2048])
        c2 = StreamClient("127.0.0.1", srv.port, timeout=10)
        frame = recv_frame(c2.sock)  # ERROR, then the server closes
        assert frame is not None and frame[0] == OP_ERROR
        assert b"slots in use" in frame[1]
        c2.close()
        c1.finalize()
        c1.close()

        def fresh_slot():
            try:
                with StreamClient("127.0.0.1", srv.port, timeout=10) as c:
                    return c.current() is None  # a fresh slot has no votes
            except (RuntimeError, OSError):
                return False  # still at capacity
        assert _wait_for(fresh_slot, step=0.02), "slot was not recycled"
    finally:
        srv.stop()


def test_stats_frame(net, server):
    with StreamClient("127.0.0.1", server.port) as c:
        c.feed(_clip(seed=4)[:4096])
        c.finalize()
        s = c.stats()
    for key in ("dispatches", "bytes_shipped", "wire_dispatches", "open_slots",
                "n_streams", "n_slots", "pending_blocks", "buffered_samples",
                "connections", "accepted", "rejected", "overflows", "idle_dropped",
                "model_reloads"):
        assert key in s
    assert s["connections"] >= 1 and s["accepted"] >= 1
    assert s["n_slots"] == 4 and s["dispatches"] >= 1
    assert set(s["wire_dispatches"]) == {"u8", "i16", "f32"}


def test_bad_feed_keeps_connection(net, server):
    clip = _clip(seed=5)
    with StreamClient("127.0.0.1", server.port) as c:
        c.feed(clip[:4096])
        assert c.finalize() is not None
        c.feed(clip[:400])  # a finalized stream: the sticky error
        with pytest.raises(RuntimeError, match="finalized"):
            c.current()
        send_bad = struct.pack("<BI", 0x01, 3) + b"\x09ab"  # unknown wire tag
        c.sock.sendall(send_bad)
        with pytest.raises(RuntimeError, match="unknown wire tag"):
            c.current()
        assert c.stats()["accepted"] >= 1


def test_backpressure_cap(net):
    """A client flooding past ``max_buffered_samples`` gets the overflow as
    the sticky ERROR, the chunk is dropped, and the stream keeps serving."""
    srv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0,
                        tick_interval=10.0, max_buffered_samples=10_000)
    srv.start()
    try:
        with StreamClient("127.0.0.1", srv.port, timeout=30) as c:
            c.feed(_clip(seed=8)[:8000])
            c.feed(_clip(seed=8)[:8000])  # 16000 > cap: dropped
            with pytest.raises(RuntimeError, match="max_buffered_samples"):
                c.current()
            assert c.stats()["overflows"] == 1
            _assert_verdict_close(c.finalize(), _offline(net, _clip(seed=8)[:8000]))
    finally:
        srv.stop()


def test_cli_serve_mode_on_cpu(net, tmp_path):
    """``python -m streamz_tpu_torch --serve 0 --device cpu``: loads
    model.npz, prints the bound port, serves the in-process verdicts, and
    exits 0 on SIGTERM."""
    checkpoint.save(net, str(tmp_path / "model.npz"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "streamz_tpu_torch", "--serve", "0",
         "--serve-streams", "4", "--threshold", "0", "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port = None
        reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")),
                                  daemon=True)
        reader.start()
        assert _wait_for(lambda: any(ln.startswith("Serving") for ln in lines), timeout=120,
                         step=0.05), "".join(lines)[-3000:]
        line = next(ln for ln in lines if ln.startswith("Serving"))
        assert line.startswith("Serving 4 stream slots on 127.0.0.1:")
        assert "(5 speakers; watching model.npz)" in line
        port = int(line.split("127.0.0.1:")[1].split()[0])
        clip = _clip(seed=9)
        with StreamClient("127.0.0.1", port, timeout=60) as c:
            for i in range(0, len(clip), 8192):
                c.feed(clip[i:i + 8192])
            got = c.finalize()
        _assert_verdict_close(got, _offline(net, clip))
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_cli_serve_needs_a_card_unless_cpu_is_asked(tmp_path, monkeypatch, capsys):
    """``--serve`` defaults to cuda and fails at start without a card; the
    serving flags are no longer reported as unported, and a partial set of
    the multi-host flags is refused before anything starts."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["--serve", "0", "--serve-streams", "2"]) == 1
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "not yet ported" not in err
    with pytest.raises(ValueError, match="--coordinator given without"):
        tcli.main(["--serve", "0", "--coordinator", "h:1"])
    # On the CPU without model.npz: the load fails, nothing is served.
    assert tcli.main(["--serve", "0", "--device", "cpu"]) == 1
    assert "Failed to load model" in capsys.readouterr().err


def _save_grown(path, seed, extra):
    grown = SpeakerNet.new(output=5, seed=seed, device="cpu")
    for _ in range(extra):
        grown.add_output_class()
    checkpoint.save(grown, path)
    return grown


def test_model_hot_reload_and_rollback(net, tmp_path):
    """A grown checkpoint swaps in without dropping the live connection (the
    stream's verdict equals the oracle doing the same swap); a rollback
    with an OLDER mtime and a new inode swaps in too."""
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    srv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0, tick_interval=0.005,
                        watch_model=path, watch_interval=0.02)
    srv.start()
    try:
        clip = _clip(seed=6)
        with StreamClient("127.0.0.1", srv.port, timeout=30) as c:
            c.feed(clip[:len(clip) // 2])
            assert _wait_for(lambda: c.current() is not None)
            time.sleep(0.05)
            grown = _save_grown(path, 0, 4)
            os.utime(path)
            assert _wait_for(lambda: c.stats()["model_reloads"] >= 1, timeout=30)
            assert srv.ident.net.num_speakers == grown.num_speakers
            assert srv.ident.net.device == srv.device
            c.feed(clip[len(clip) // 2:])
            got = c.finalize()
        ref = StreamingIdentifier(net, threshold=0.0)
        ref.feed(clip[:len(clip) // 2])
        ref.update_model(srv.ident.net)
        ref.feed(clip[len(clip) // 2:])
        _assert_verdict_close(got, ref.finalize())

        bak = str(tmp_path / "model.bak")
        rolled = _save_grown(bak, 1, 4)
        old = time.time() - 3600
        os.utime(bak, (old, old))
        os.replace(bak, path)
        assert _wait_for(lambda: srv.stats()["model_reloads"] >= 2, timeout=30)
        np.testing.assert_array_equal(srv.ident.net.params["w1"].numpy(),
                                      rolled.params["w1"].numpy())
    finally:
        srv.stop()


def test_ticker_survives_device_errors(net, monkeypatch):
    """An exception escaping a tick is logged and retried: the stream
    completes."""
    srv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0, tick_interval=0.005)
    fails = {"n": 2}
    real_tick = srv.ident.tick

    def flaky_tick(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("injected device failure")
        return real_tick(*a, **kw)

    monkeypatch.setattr(srv.ident, "tick", flaky_tick)
    srv.start()
    try:
        clip = _clip(seed=11)
        with StreamClient("127.0.0.1", srv.port, timeout=30) as c:
            c.feed(clip)
            assert _wait_for(lambda: fails["n"] == 0), "ticker died before retrying"
            _assert_verdict_close(c.finalize(), _offline(net, clip))
    finally:
        srv.stop()


def test_at_capacity_reject_always_closes(net, monkeypatch):
    """A failed ERROR send to an at-capacity client still closes the socket."""
    srv = SpeakerServer(net, port=0, n_streams=1, threshold=0.0, tick_interval=0.05)
    real_send = server_mod.send_frame

    def failing_send(sock, opcode, payload=b""):
        if opcode == OP_ERROR:
            raise BrokenPipeError("client already gone")
        return real_send(sock, opcode, payload)

    monkeypatch.setattr(server_mod, "send_frame", failing_send)
    srv.start()
    try:
        c1 = StreamClient("127.0.0.1", srv.port, timeout=10)
        time.sleep(0.05)
        c2 = StreamClient("127.0.0.1", srv.port, timeout=10)
        assert _wait_for(lambda: srv.stats()["rejected"] >= 1, timeout=10)
        assert srv.stats()["rejected"] == 1
        c2.sock.settimeout(5.0)
        assert c2.sock.recv(1) == b""  # EOF, not a hang
        c2.close()
        c1.close()
    finally:
        srv.stop()


def test_c_client_end_to_end(net, tmp_path):
    """The bundled C client (examples/client.c) feeds i16 PCM over the wire
    and reads back the in-process verdict."""
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        pytest.skip("no C compiler")
    exe = str(tmp_path / "client")
    subprocess.run([cc, "-O2", "-o", exe, os.path.join(REPO, "examples", "client.c")],
                   check=True, timeout=120)
    srv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0, tick_interval=0.005)
    srv.start()
    try:
        clip = _clip(seed=13)
        out = subprocess.run([exe, "127.0.0.1", str(srv.port)],
                             input=clip.astype("<i2").tobytes(), capture_output=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr.decode()
        parts = out.stdout.decode().split()
        ref = _offline(net, clip)
        assert parts[0] == "speaker" and int(parts[1]) == ref[0]
        np.testing.assert_allclose(float(parts[3]), ref[1], rtol=1e-4)
    finally:
        srv.stop()


def test_protocol_fuzz_server_stays_healthy(net):
    """Garbage frames cost only the offending connection."""
    srv = SpeakerServer(net, port=0, n_streams=4, threshold=0.0, tick_interval=0.005)
    srv.start()
    try:
        rng = np.random.default_rng(99)
        for trial in range(20):
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
            try:
                kind = trial % 4
                if kind == 0:  # random opcode + small random payload
                    payload = rng.bytes(int(rng.integers(0, 64)))
                    s.sendall(struct.pack("<BI", int(rng.integers(0x05, 0x7F)),
                                          len(payload)) + payload)
                elif kind == 1:  # oversized declared length
                    s.sendall(struct.pack("<BI", 0x01, (1 << 24) + 1))
                elif kind == 2:  # truncated header
                    s.sendall(b"\x01\x02")
                    s.shutdown(socket.SHUT_WR)
                else:  # pure junk
                    s.sendall(rng.bytes(int(rng.integers(1, 256))))
                s.settimeout(5)
                try:
                    while s.recv(4096):
                        pass
                except OSError:
                    pass
            finally:
                s.close()
        clip = _clip(seed=21)
        with StreamClient("127.0.0.1", srv.port, timeout=30) as c:
            for i in range(0, len(clip), 8192):
                c.feed(clip[i:i + 8192])
            _assert_verdict_close(c.finalize(), _offline(net, clip))
    finally:
        srv.stop()


def test_idle_timeout_reaps_slot(net):
    srv = SpeakerServer(net, port=0, n_streams=1, threshold=0.0, tick_interval=0.005,
                        idle_timeout=0.5)
    srv.start()
    try:
        c = StreamClient("127.0.0.1", srv.port, timeout=10)
        c.feed(_clip(seed=1, seconds=0.2))
        assert _wait_for(lambda: (lambda s: s["open_slots"] == 0 and s["idle_dropped"] >= 1)(
            srv.stats()), step=0.05)
        c.close()
        with StreamClient("127.0.0.1", srv.port, timeout=10) as c2:
            clip = _clip(seed=2, seconds=0.3)
            c2.feed(clip)
            _assert_verdict_close(c2.finalize(), _offline(net, clip))
    finally:
        srv.stop()


def test_client_converts_linear_pcm_onto_narrow_wires(net, server):
    clip = _clip(seed=9, seconds=0.6)
    fclip = clip.astype(np.float32) / 32767.0
    with StreamClient("127.0.0.1", server.port) as a, \
            StreamClient("127.0.0.1", server.port) as b:
        a.feed(clip)
        b.feed(fclip, wire="i16")
        assert b.finalize() == a.finalize()
    with StreamClient("127.0.0.1", server.port) as a, \
            StreamClient("127.0.0.1", server.port) as b:
        a.feed(g711.ulaw_encode(clip).tobytes(), wire="ulaw")
        b.feed(fclip, wire="ulaw")
        assert b.finalize() == a.finalize()
    assert StreamClient._linear_i16(np.array([2.0, -2.0, 0.5], np.float32)).tolist() == [
        32767, -32768, 16384]
    assert StreamClient._linear_i16(np.array([70000, -70000], np.int32)).tolist() == [
        32767, -32768]


def test_stats_report_tick_latency_percentiles(net, server):
    with StreamClient("127.0.0.1", server.port) as c:
        for seed in range(3):
            c.feed(_clip(seed=seed, seconds=0.3))
            c.current()
        assert _wait_for(lambda: "ticks_measured" in c.stats(), step=0.05)
        s = c.stats(reset_ticks=True)
        assert s["ticks_measured"] >= 1
        assert 0 < s["tick_ms_p50"] <= s["tick_ms_p95"] <= s["tick_ms_p99"]
        assert "ticks_measured" not in c.stats()  # a fresh window


def test_corrupt_checkpoint_dropin_never_takes_down_serving(net, tmp_path):
    """Corrupt files over the watched checkpoint are skipped: the daemon
    keeps serving on the old model, and a later good checkpoint swaps in."""
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    srv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0, tick_interval=0.005,
                        watch_model=path, watch_interval=0.02)
    srv.start()
    try:
        with StreamClient("127.0.0.1", srv.port, timeout=30) as c:
            clip = _clip(seed=9)
            c.feed(clip[:len(clip) // 3])
            with open(path, "rb") as f:
                good = f.read()
            rng = np.random.default_rng(3)
            flips = set(rng.integers(0, len(good), 40).tolist())
            for i, blob in enumerate([
                    good[:len(good) // 2], b"\x00" * 1024,
                    bytes(b ^ (1 << int(rng.integers(0, 8))) if k in flips else b
                          for k, b in enumerate(good))]):
                time.sleep(0.05)
                with open(path, "wb") as f:
                    f.write(blob)
                os.utime(path)
                time.sleep(0.15)  # several watch polls see the bad file
                c.feed(clip[len(clip) // 3:][:4410])
                assert _wait_for(lambda: c.current() is not None), f"corruption {i}"
                assert c.stats()["model_reloads"] == 0, f"corruption {i}"
            time.sleep(0.05)
            _save_grown(path, 0, 1)
            os.utime(path)
            assert _wait_for(lambda: c.stats()["model_reloads"] >= 1, timeout=30)
            assert c.finalize() is not None
    finally:
        srv.stop()


# -- the wire across the two packages ----------------------------------------------


def _drive(client_cls, port, clip, wire):
    with client_cls("127.0.0.1", port, timeout=120) as c:
        pcm = g711.ulaw_encode(clip).tobytes() if wire == "ulaw" else clip
        for i in range(0, len(pcm), 8192):
            c.feed(pcm[i:i + 8192], wire=wire)
        mid = c.current()
        return mid, c.finalize()


def test_jax_client_and_port_server_and_the_reverse(net):
    """The JAX ``StreamClient`` gets the same verdicts from the port's
    server as from the JAX server, on the i16, f32 and mu-law wires; the
    port's client gets the same from both; all equal the port's oracle."""
    jsrv = jserver.SpeakerServer(JNet.new(output=5, seed=0), port=0, n_streams=2,
                                 threshold=0.0, tick_interval=0.005)
    tsrv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0, tick_interval=0.005)
    jsrv.start()
    tsrv.start()
    try:
        clip = _clip(seed=31, seconds=0.8)
        for wire in ("i16", "f32", "ulaw"):
            fed = clip.astype(np.float32) / 32767.0 if wire == "f32" else clip
            finals = {}
            for cname, ccls in (("jax", jserver.StreamClient), ("port", StreamClient)):
                for sname, srv in (("jax", jsrv), ("port", tsrv)):
                    _, finals[cname, sname] = _drive(ccls, srv.port, fed, wire)
            ref = _offline(net, g711.ulaw_decode(g711.ulaw_encode(clip))
                           if wire == "ulaw" else fed)
            for got in finals.values():
                _assert_verdict_close(got, ref)
            assert finals["jax", "port"] == finals["port", "port"]
            assert finals["jax", "jax"] == finals["port", "jax"]
    finally:
        tsrv.stop()
        # Wake the JAX server's accept() first: its stop() only closes the
        # listener, which leaves the accept thread to its join timeout.
        try:
            jsrv._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        jsrv.stop()


# -- the two departures from the JAX daemon ----------------------------------------


def test_current_and_feed_answer_while_a_tick_is_held(net):
    """With the ticker held inside a tick (holding its lock), FEED is
    accepted and CURRENT answers within 1 s with the pre-tick verdict; once
    the tick is released nothing fed during it was lost."""
    srv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0, tick_interval=0.005)
    gate, entered = _gate_ticks(srv)
    srv.start()
    try:
        clip = _clip(seed=41, seconds=1.5)
        a, b, c_ = clip[:22050], clip[22050:44100], clip[44100:]
        with StreamClient("127.0.0.1", srv.port, timeout=30) as c:
            c.feed(a)
            assert _wait_for(lambda: c.current() is not None)
            pre = c.current()
            gate.clear()
            assert entered.wait(timeout=10)  # the next tick is held
            t0 = time.perf_counter()
            c.feed(b)
            c.feed(c_)
            got = c.current()  # replies only after both FEEDs were handled
            dt = time.perf_counter() - t0
            assert dt < 1.0, dt
            assert got == pre  # verdicts change only at tick boundaries
            assert srv._queued[0] == len(b) + len(c_)  # both queued, none refused
            gate.set()
            final = c.finalize()
        _assert_verdict_close(final, _offline(net, clip))
    finally:
        gate.set()
        srv.stop()


def test_recycled_slot_never_serves_the_previous_verdict(net):
    """A new stream on a recycled slot reads no verdict of its predecessor:
    before it is fed, while a tick is held, and from a stale snapshot entry
    of the old generation."""
    srv = SpeakerServer(net, port=0, n_streams=1, threshold=0.0, tick_interval=0.005)
    gate, entered = _gate_ticks(srv)
    srv.start()
    try:
        with StreamClient("127.0.0.1", srv.port, timeout=30) as c:
            c.feed(_clip(seed=42))
            assert _wait_for(lambda: c.current() is not None)
            old = c.current()
            old_gen = srv._gen[0]
        assert _wait_for(lambda: srv.stats()["open_slots"] == 0)  # the slot is free
        with StreamClient("127.0.0.1", srv.port, timeout=30) as c2:
            assert c2.current() is None  # served: not refused, and no old verdict
            assert srv._gen[0] != old_gen
            # A stale entry of the old generation in the snapshot is ignored.
            with srv._vlock:
                srv._verdicts[0] = (old_gen, old)
            assert c2.current() is None
            gate.clear()
            c2.feed(_clip(seed=43, seconds=0.5))
            assert entered.wait(timeout=10)
            t0 = time.perf_counter()
            assert c2.current() is None
            assert time.perf_counter() - t0 < 1.0
            gate.set()
            assert _wait_for(lambda: c2.current() is not None)
    finally:
        gate.set()
        srv.stop()
