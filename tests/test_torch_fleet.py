"""The port's serving fleet (app/fleet.py) on the CPU.

The cases of the JAX package's ``tests/test_fleet.py``: real server
processes (``python -m streamz_tpu_torch.app.fleet --device cpu``, each its
own Python and torch) behind round-robin placement give every stream the
verdict of a single in-process fleet, because streams are independent of
their slot; a dead server is skipped and its streams migrate; a child that
cannot load its checkpoint is reported before READY; the launcher parses
READY among other output and times out on a silent child.  Every wait has
a timeout.
"""

import os
import subprocess as sp
import sys
import time

import numpy as np
import pytest

from streamz_tpu_torch.app.fleet import FleetClient, LocalFleet, _ChildDrain
from streamz_tpu_torch.app.serve import MultiStreamIdentifier
from streamz_tpu_torch.nn import checkpoint
from streamz_tpu_torch.nn.model import SpeakerNet

_CHILD_ENV = {
    # The children import the port from the repo, not an install, and share
    # the CPU with the other test workers.
    "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    + os.pathsep + os.environ.get("PYTHONPATH", ""),
    "OMP_NUM_THREADS": "1",
}


def _clip(seed, seconds=0.6):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3000, size=int(44100 * seconds)).astype(np.int16)


def _assert_verdict_close(got, ref):
    if ref is None:
        assert got is None
        return
    assert got is not None and got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    net = SpeakerNet.new(output=5, seed=0, device="cpu")
    path = str(tmp_path_factory.mktemp("fleet") / "model.npz")
    checkpoint.save(net, path)
    return net, path


def test_two_process_fleet_matches_single_host(ckpt):
    """4 streams round-robined over 2 server processes: every verdict equals
    the single in-process fleet's, and both servers got streams."""
    net, path = ckpt
    clips = [_clip(s) for s in range(4)]
    ident = MultiStreamIdentifier(net, n_streams=4, threshold=0.0)
    ref = []
    for c in clips:
        sid = ident.open()
        ident.feed(sid, c)
        ref.append(ident.finalize(sid))
        ident.close(sid)

    with LocalFleet(path, n_servers=2, n_streams=2, threshold=0.0, tick_interval=0.005,
                    env=_CHILD_ENV, device="cpu") as fleet:
        endpoints = fleet.start(timeout=120)
        assert len(endpoints) == 2
        with FleetClient(endpoints, timeout=60.0) as client:
            fids = [client.open() for _ in clips]
            assert {client.home(f) for f in fids} == set(endpoints)
            for fid, c in zip(fids, clips):
                for i in range(0, len(c), 4096):
                    client.feed(fid, c[i:i + 4096])
            got = [client.finalize(f) for f in fids]
            stats = client.stats()
    assert len(stats) == 2
    assert all(s["dispatches"] > 0 for s in stats)
    for g, r in zip(got, ref):
        _assert_verdict_close(g, r)


def test_fleet_failover_skips_dead_server_and_migrates(ckpt):
    """Kill one of two servers mid-session: open() skips it, reopen()
    migrates a dead stream, a re-feed reproduces its verdict, and with
    every server dead open() raises."""
    _, path = ckpt
    clip = _clip(7)
    with LocalFleet(path, n_servers=2, n_streams=4, threshold=0.0, tick_interval=0.005,
                    env=_CHILD_ENV, device="cpu") as fleet:
        endpoints = fleet.start(timeout=120)
        with FleetClient(endpoints, timeout=60.0) as client:
            fid = client.open()
            i0 = endpoints.index(client.home(fid))
            client.feed(fid, clip)
            ref = client.finalize(fid)
            assert ref is not None
            fleet.stop_server(i0)
            healthy = endpoints[1 - i0]
            f2, f3 = client.open(), client.open()
            assert client.home(f2) == client.home(f3) == healthy
            assert client.reopen(fid) == healthy
            client.feed(fid, clip)
            _assert_verdict_close(client.finalize(fid), ref)
            client.close(f2)
            client.close(f3)
            fleet.stop_server(1 - i0)
            with pytest.raises(ConnectionError, match="no healthy endpoint"):
                client.open()


def test_fleet_client_round_robin_and_errors():
    with pytest.raises(ValueError):
        FleetClient([])
    with pytest.raises(ValueError):
        LocalFleet("x.npz", n_servers=0)


@pytest.mark.parametrize("device,missing", [("cpu", True), ("meta", False)])
def test_fleet_server_exits_before_ready(ckpt, tmp_path, device, missing):
    """A child that cannot load its checkpoint, or is given a device it
    cannot use, dies before READY; the launcher reports it."""
    path = str(tmp_path / "missing.npz") if missing else ckpt[1]
    fleet = LocalFleet(path, n_servers=1, env=_CHILD_ENV, device=device)
    with pytest.raises(RuntimeError, match="before READY"):
        fleet.start(timeout=120)
    fleet.stop()


def test_ready_parsed_when_child_logs_before_and_after():
    """A log line just before READY must not strand READY in the reader's
    buffer, and a child that keeps logging after READY must never block on
    a full pipe."""
    child = (
        "import sys\n"
        "sys.stdout.write('WARNING: noisy library\\n'\n"
        "                 'FLEET_READY host=127.0.0.9 port=7777\\n')\n"
        "sys.stdout.flush()\n"
        "for i in range(4000):\n"
        "    print('[serve] tick failed, retrying next tick: e%d' % i)\n"
        "print('DRAINED_OK')\n"
    )
    p = sp.Popen([sys.executable, "-c", child], stdout=sp.PIPE, stderr=sp.STDOUT, text=True)
    try:
        d = _ChildDrain(p)
        assert LocalFleet._read_ready(p, d, time.monotonic() + 60) == ("127.0.0.9", 7777)
        assert p.wait(timeout=60) == 0
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not any("DRAINED_OK" in ln for ln in d.tail):
            time.sleep(0.05)
        assert any("DRAINED_OK" in ln for ln in d.tail)
    finally:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10)


def test_ready_timeout_on_silent_child():
    p = sp.Popen([sys.executable, "-c", "import time; time.sleep(600)"],
                 stdout=sp.PIPE, stderr=sp.STDOUT, text=True)
    try:
        d = _ChildDrain(p)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="did not become ready"):
            LocalFleet._read_ready(p, d, time.monotonic() + 3)
        assert time.monotonic() - t0 < 30
    finally:
        p.kill()
        p.wait(timeout=10)


def test_children_run_the_port_on_the_asked_device(ckpt, monkeypatch):
    """The launcher spawns the port's module with ``--device``; the JAX
    flags are all passed as the JAX launcher passes them."""
    seen = {}

    class FakePopen:
        def __init__(self, argv, **kw):
            seen["argv"] = argv
            raise OSError("not spawned")

    monkeypatch.setattr(sp, "Popen", FakePopen)
    fleet = LocalFleet(ckpt[1], n_servers=1, device="cpu", watch_model=True)
    with pytest.raises(OSError):
        fleet.start(timeout=5)
    argv = seen["argv"]
    assert argv[1:3] == ["-m", "streamz_tpu_torch.app.fleet"]
    assert argv[argv.index("--device") + 1] == "cpu"
    for flag in ("--checkpoint", "--host", "--port", "--n-streams", "--threshold",
                 "--tick-interval", "--watch-model"):
        assert flag in argv
