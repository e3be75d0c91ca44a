"""Entry points of the port: one forward step and the multi-device dry run.

The port of the repository's ``__graft_entry__.py``.  :func:`entry` returns
an end-to-end forward step of the flagship pipeline and its inputs: raw
PCM → MFCC+Δ+ΔΔ frontend → SpeakerNet → per-clip vote sums (the device side
of ``identify_speaker``, ``streamz-rs/src/lib.rs:1285-1303``;
``__graft_entry__.py:33-52``).

:func:`dryrun_multichip` runs the five multi-device programs of
``__graft_entry__.py:166-385`` on the port and reports each one:

  dp_train        the data-parallel train step: the frontend on each
                  rank's clips, K5's gradient sums, one all-reduce
  discovery_scan  the discovery loop with ``STREAMZ_SHARD_DISCOVERY=1``
                  (the sharded route wherever there are two or more ranks)
  halo_frontend   the PCM-halo window-sharded frontend against the
                  unsharded one
  identify_psum   the window-sharded identify and embedding against the
                  unsharded ones
  serve_shard     the slot-sharded ``MultiStreamIdentifier`` over ``n``
                  devices of one process, its verdicts against the
                  unsharded identifier's (the speakers equal, the
                  confidences within 1e-5 relative)

The JAX package runs them in one process over an ``n``-device mesh.  Here
the first four run in ``n`` spawned ranks of a ``torch.distributed`` group
(``cuda:<rank % cards>``: NCCL when every rank has a card of its own, gloo
when ranks share one, gloo on the CPU), and ``serve_shard`` in the calling
process over a ``LocalMesh`` (the identifier refuses a process group).
Nothing falls back to the CPU: it runs there only when ``device="cpu"`` is
asked for.

    python -m streamz_tpu_torch.entry        # entry() and a dry run over every card
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# A rank still running then is killed and its programs fail.
RANK_DEADLINE_S = 900


def entry(device=None):
    """``(fn, args)``: ``fn(params, pcm, n_samples)`` is the frontend, the
    classifier's softmax and the per-clip vote sums ([B, capacity]), on
    four clips of a fresh 4-speaker model (seed 0), on ``device`` (the card
    unless ``'cpu'`` is asked for)."""
    from streamz_tpu_torch.device import resolve_device
    from streamz_tpu_torch.dsp.mfcc import mfcc_features, window_count
    from streamz_tpu_torch.nn.model import SpeakerNet, forward

    dev = resolve_device(device)
    net = SpeakerNet.new(output=4, seed=0, device=dev)
    num_speakers = net.num_speakers

    def fn(params, pcm, n_samples):
        feats = mfcc_features(pcm, n_samples)           # [B, W, 60]
        n_win = window_count(n_samples)                 # [B]
        probs = forward(params, feats, num_speakers)    # [B, W, capacity]
        valid = torch.arange(feats.shape[1], device=feats.device)[None, :] < n_win[:, None]
        return (probs * valid[..., None]).sum(dim=1)    # [B, capacity] vote sums

    B, T = 4, 8000
    rng = np.random.default_rng(0)
    pcm = torch.from_numpy(rng.normal(0, 0.1, size=(B, T)).astype(np.float32)).to(dev)
    n_samples = torch.tensor([8000, 4000, 1200, 8000], dtype=torch.int64, device=dev)
    return fn, (net.params, pcm, n_samples)


# ---------------------------------------------------------------------------
# The programs.  Each raises when its check fails.
# ---------------------------------------------------------------------------


def _frontend_core(dev: torch.device):
    """K1 on a card (the frontend's static default under a mesh), the plain
    formulation on the CPU."""
    from streamz_tpu_torch.dsp.features import frontend_core

    return frontend_core("pallas_v4" if dev.type == "cuda" else "plain")


def _same_on_every_rank(params, mesh, what: str) -> None:
    from streamz_tpu_torch.parallel import comm

    for k, v in params.items():
        every = comm.all_gather(v, mesh)
        if not all(torch.equal(every[0], e) for e in every[1:]):
            raise AssertionError(f"{what}: {k} differs between the ranks")


def _prog_dp_train(n: int, dev: torch.device) -> None:
    from streamz_tpu_torch.dsp.mfcc import window_count
    from streamz_tpu_torch.nn import train_kernels as tk
    from streamz_tpu_torch.nn.model import SpeakerNet
    from streamz_tpu_torch.parallel import comm, data_parallel as dp
    from streamz_tpu_torch.parallel.mesh import put_batch_sharded

    mesh = comm.make_mesh(n, axis=comm.DATA_AXIS)
    net = SpeakerNet.new(output=4, seed=0, device=dev)
    B, T = 2 * n, 2000  # 2 clips of 4 windows per rank
    rng = np.random.default_rng(1)
    pcm = rng.normal(0, 0.1, size=(B, T)).astype(np.float32)
    lens = np.full((B,), T, np.int64)
    labels = (np.arange(B) % 4).astype(np.int32)
    pcm_l, lens_l, lab_l = put_batch_sharded(mesh, pcm, lens, labels)
    with torch.no_grad():
        feats = _frontend_core(dev)(pcm_l, lens_l)      # [b, W, F]
    b, W, F = feats.shape
    valid = (torch.arange(W, device=dev)[None, :] < window_count(lens_l)[:, None])
    rows = tk.Batch(feats.reshape(b * W, F).contiguous(),
                    lab_l.repeat_interleave(W).contiguous(),
                    valid.reshape(b * W).to(torch.float32))
    params = net.working_params()
    loss = float(dp.dp_step(params, rows, net.num_speakers, 0.01, mesh))
    if not np.isfinite(loss):
        raise AssertionError(f"dp_train: loss {loss}")
    _same_on_every_rank(params, mesh, "dp_train")


def _prog_discovery_scan(n: int, dev: torch.device) -> None:
    from streamz_tpu_torch.app import device_loop as dl
    from streamz_tpu_torch.nn.model import SpeakerNet
    from streamz_tpu_torch.parallel import comm

    mesh = comm.make_mesh(n, axis=comm.DATA_AXIS)
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(2, 60)).astype(np.float32) * 3.0
    files, fm = [], {}
    for i in range(6):
        path = f"clip_{i}.wav"
        fm[path] = (centers[i % 2] + rng.normal(0, 0.1, size=(8, 60))).astype(np.float32)
        files.append((path, None))
    net = SpeakerNet.new(output=1, seed=0, device=dev)
    old = os.environ.get("STREAMZ_SHARD_DISCOVERY")
    os.environ["STREAMZ_SHARD_DISCOVERY"] = "1"
    try:
        res = dl.run_incremental_device(
            net, files, fm, burn_in_limit=2, conf_threshold=0.8, dropout=0.0,
            batch_size=8, epochs=1, max_speakers=None, show_progress=False, mesh=mesh)
    finally:
        if old is None:
            os.environ.pop("STREAMZ_SHARD_DISCOVERY", None)
        else:
            os.environ["STREAMZ_SHARD_DISCOVERY"] = old
    if res[1] != len(files) or net.output_size() < 1 or any(c is None for _, c in files):
        raise AssertionError(f"discovery_scan: {res[1]} of {len(files)} files, "
                             f"{net.output_size()} speakers, labels {files}")
    _same_on_every_rank(net.params, mesh, "discovery_scan")


def _tolerance(dev: torch.device) -> float:
    """The sharded frontend against the unsharded one: 1e-5 for the plain
    formulation (the JAX program's), K1's 1e-3 on a card."""
    return 1e-3 if dev.type == "cuda" else 1e-5


def _prog_halo_frontend(n: int, dev: torch.device) -> None:
    from streamz_tpu_torch.dsp.mfcc import extract_features_batch
    from streamz_tpu_torch.parallel import comm, window_parallel as wp

    mesh = comm.make_mesh(n, axis=comm.WINDOW_AXIS)
    clip = np.random.default_rng(2).normal(0, 3000, size=44100).astype(np.int16)
    ref = extract_features_batch([clip], core=_frontend_core(dev), device=dev)[0]
    got = wp.mfcc_features_pcm_sharded(clip, mesh)
    if got.shape != ref.shape:
        raise AssertionError(f"halo_frontend: shape {got.shape}, unsharded {ref.shape}")
    np.testing.assert_allclose(got, ref, atol=_tolerance(dev))


def _prog_identify_psum(n: int, dev: torch.device) -> None:
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.infer.embed import extract_embedding_from_features, normalize
    from streamz_tpu_torch.infer.identify import identify_speaker
    from streamz_tpu_torch.nn.model import SpeakerNet
    from streamz_tpu_torch.parallel import comm, window_parallel as wp

    mesh = comm.make_mesh(n, axis=comm.WINDOW_AXIS)
    clip = np.random.default_rng(3).normal(0, 3000, size=3 * 44100).astype(np.int16)
    net = SpeakerNet.new(output=5, seed=0, device=dev)
    ex = FeatureExtractor("pallas_v4" if dev.type == "cuda" else "plain", device=dev)
    sid_shd = wp.identify_speaker_pcm_sharded(net, clip, mesh)
    sid_ref = identify_speaker(net, clip, ex)
    if sid_shd != sid_ref:
        raise AssertionError(f"identify_psum: sharded {sid_shd}, unsharded {sid_ref}")
    e_ref = normalize(extract_embedding_from_features(net, ex.extract(clip)))
    e_shd = wp.extract_embedding_pcm_sharded(net, clip, mesh)
    np.testing.assert_allclose(e_shd, e_ref, atol=_tolerance(dev))


def _local_devices(n: int, device: str):
    if torch.device(device).type == "cuda":
        return [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]
    return [device] * n


def _prog_serve_shard(n: int, device: str) -> None:
    """In the calling process: two streams through the identifier sharded
    over ``n`` devices, every verdict the unsharded identifier's."""
    from streamz_tpu_torch.app.serve import MultiStreamIdentifier
    from streamz_tpu_torch.nn.model import SpeakerNet

    devices = _local_devices(n, device)
    net = SpeakerNet.new(output=3, seed=0, device=devices[0])
    n_streams = max(2, n)
    chunk = np.random.default_rng(4).normal(0, 3000, size=44100).astype(np.int16)
    verdicts = []
    for mesh in (devices, None):
        srv = MultiStreamIdentifier(net, n_streams=n_streams, threshold=0.0, mesh=mesh)
        sids = [srv.open(), srv.open()]
        srv.feed(sids[0], chunk)
        srv.feed(sids[1], chunk[::-1].copy())
        srv.tick()
        verdicts.append([srv.finalize(s) for s in sids])
    res = verdicts[0][0]
    if res is None or not 0 <= res[0] < net.output_size():
        raise AssertionError(f"serve_shard: verdict {res}")
    # The same speakers; confidences are vote sums that another slot count
    # per device groups in another order: relative 1e-5.
    for got, want in zip(*verdicts):
        if (got is None) != (want is None) or got is not None and (
                got[0] != want[0] or abs(got[1] - want[1]) > 1e-5 * abs(want[1])):
            raise AssertionError(f"serve_shard: sharded {verdicts[0]}, "
                                 f"unsharded {verdicts[1]}")


# The programs the ranks run, in order; serve_shard runs in the caller.
RANK_PROGRAMS: Dict[str, Callable[[int, torch.device], None]] = {
    "dp_train": _prog_dp_train,
    "discovery_scan": _prog_discovery_scan,
    "halo_frontend": _prog_halo_frontend,
    "identify_psum": _prog_identify_psum,
}
PROGRAMS = (*RANK_PROGRAMS, "serve_shard")


# ---------------------------------------------------------------------------
# The dry run.
# ---------------------------------------------------------------------------


def _failure(e: BaseException) -> str:
    return f"FAIL:{type(e).__name__}: {e}"


def _rank_main(rank: int, n: int, port: int, device: str, out: str) -> int:
    """One rank: every program of ``RANK_PROGRAMS`` in order, each one's
    result in ``<out>/rank_<rank>.json``."""
    from streamz_tpu_torch.parallel import comm

    dev = comm.initialize_distributed(f"127.0.0.1:{port}", n, rank, device=device)
    results = {}
    try:
        for name, prog in RANK_PROGRAMS.items():
            try:
                prog(n, dev)
                results[name] = "ok"
            except Exception as e:  # noqa: BLE001 - every program reports
                results[name] = _failure(e)
            Path(out, f"rank_{rank}.json").write_text(json.dumps(results))
    finally:
        comm.shutdown()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(n: int, device: str) -> Dict[str, str]:
    """Spawn the ``n`` ranks and merge their reports: a program is ok when
    every rank says so."""
    results = {name: "ok" for name in RANK_PROGRAMS}
    with tempfile.TemporaryDirectory(prefix="streamz_dryrun_") as out:
        port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "streamz_tpu_torch.entry", "--dryrun-rank", str(r),
             str(n), str(port), device, out],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n)]
        deadline = time.monotonic() + RANK_DEADLINE_S
        logs = []
        try:
            for r, p in enumerate(procs):
                try:
                    log, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                    status = f"rank {r} exited {p.returncode}"
                except subprocess.TimeoutExpired:
                    p.kill()
                    log, _ = p.communicate()
                    status = f"rank {r} missed the {RANK_DEADLINE_S} s deadline"
                logs.append((r, status, log))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, status, log in logs:
            path = Path(out, f"rank_{r}.json")
            got = json.loads(path.read_text()) if path.exists() else {}
            for name in RANK_PROGRAMS:
                mine = got.get(name, f"FAIL:{status}: {log[-2000:]}")
                if mine != "ok" and results[name] == "ok":
                    results[name] = f"{mine} (rank {r})"
    return results


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[str, str]:
    """Run the five programs over ``n_devices`` ranks and devices, print
    one ``multichip programs: name=ok|FAIL ...`` line, and return each
    program's result (``"ok"`` or its failure).  Raises ``RuntimeError``
    naming every failed program.  With fewer cards than ranks, ranks share
    cards over gloo; ``device="cpu"`` runs on the CPU."""
    from streamz_tpu_torch.device import resolve_device

    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = resolve_device(device)  # no card: raises, never falls back
    device = dev.type
    results = _run_ranks(n_devices, device)
    try:
        _prog_serve_shard(n_devices, device)
        results["serve_shard"] = "ok"
    except Exception as e:  # noqa: BLE001 - every program reports
        results["serve_shard"] = _failure(e)
    print("multichip programs: " + " ".join(
        f"{k}={'ok' if results[k] == 'ok' else 'FAIL'}" for k in PROGRAMS))
    failed = {k: v for k, v in results.items() if v != "ok"}
    if failed:
        detail = "\n".join(f"  {k}: {v}" for k, v in failed.items())
        raise RuntimeError(f"multichip dry run failed for {sorted(failed)}:\n{detail}")
    return results


if __name__ == "__main__":
    if len(sys.argv) >= 7 and sys.argv[1] == "--dryrun-rank":
        sys.exit(_rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                            sys.argv[5], sys.argv[6]))
    fn, args = entry()
    with torch.no_grad():
        print("entry forward:", tuple(fn(*args).shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok")
