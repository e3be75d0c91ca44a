"""The port's sharded discovery scan against the JAX package's mesh scan, on the CPU.

For each world size (2 and 3) one spawned job of gloo ranks
(``test_torch_dist.run_ranks``, its deadline) runs the port's discovery loop
under a mesh of every rank on ``tests/test_device_loop.py:248``'s corpus (30
files, 3 speakers, 20 windows each, 2 epochs, batch 8, dropout 0 and 0.2):
forced onto the sharded route (``STREAMZ_SHARD_DISCOVERY=1``) and onto the
replicated one (``=0``).  Rank 0's results are held to the JAX package's
``run_incremental_device`` under ``STREAMZ_SHARD_DISCOVERY=1`` on a
``comm.make_mesh(n)`` CPU mesh: labels equal, parameters and loss within
1e-4 (the sharded chunk gradients' f32 summation order); and to the port's
replicated route: labels equal, parameters within 1e-3 (the JAX test's own
tolerance, ``tests/test_device_loop.py:248-282``).  Every other rank's
results equal rank 0's bit for bit.  At world 3 every chunk of 8 windows
splits unevenly (3 rows a rank, one weight-0 padding row).

The same jobs check that ``=0`` never reaches the sharded trainer and
that, unset, the CPU takes the sharded default (probing off too); that
the window-sharded trainer alone, at batch 5 (uneven at both worlds),
matches the unsharded one; and that the measured scan choice is one
decision on every rank: probes that time differently on each rank, cached
decisions that disagree between the ranks, and ones that agree.  A
two-process CLI run forced onto the sharded route writes the labels of
one process.
"""

import json
import sys

import jax
import numpy as np
import pytest

from streamz_tpu.app import device_loop as jdl
from streamz_tpu.nn import drivers as jdrivers
from streamz_tpu.nn import model as jmodel
from streamz_tpu.parallel import comm as jcomm
from test_torch_dist import run_ranks
from test_torch_dist_cli import ARGS, SPEAKERS, _labels, _voice

DEADLINE_S = 120
DROPOUTS = (0.0, 0.2)

_WORKER = r'''
import json, os, sys
import numpy as np
import torch

rank, world, port, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
from streamz_tpu_torch.app import device_loop as dl
from streamz_tpu_torch.nn import drivers, prng, train
from streamz_tpu_torch.nn.model import SpeakerNet
from streamz_tpu_torch.parallel import comm
from streamz_tpu_torch.runtime import autotune

comm.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
mesh = comm.make_mesh(world)
d = np.load(inp)
paths = [str(p) for p in d["paths"]]
fm = {p: d["wins"][i] for i, p in enumerate(paths)}
res, info = {}, {}

sharded_calls = [0]
real = dl.train_on_windows_sharded_impl
def counting(*a, **kw):
    sharded_calls[0] += 1
    return real(*a, **kw)
dl.train_on_windows_sharded_impl = counting

for route, env in (("sharded", "1"), ("replicated", "0")):
    os.environ["STREAMZ_SHARD_DISCOVERY"] = env
    for dropout in (0.0, 0.2):
        drivers._key_counter[0] = 0
        files = [(p, 0 if i == 0 else None) for i, p in enumerate(paths)]
        net = SpeakerNet.new(output=1, seed=0, device="cpu")
        before = sharded_calls[0]
        loss, n, _, _, _ = dl.run_incremental_device(
            net, files, dict(fm), burn_in_limit=6, conf_threshold=0.8, dropout=dropout,
            batch_size=8, epochs=2, max_speakers=None, show_progress=False, mesh=mesh)
        tag = f"{route}_{dropout}"
        res[tag + "_labels"] = np.asarray([c for _, c in files])
        res[tag + "_loss"] = np.float64(loss)
        res.update({f"{tag}_{k}": v.numpy() for k, v in net.params.items()})
        info[tag + "_sharded_calls"] = sharded_calls[0] - before

# Unset, without a card: the default, the sharded route.
os.environ.pop("STREAMZ_SHARD_DISCOVERY")
before = sharded_calls[0]
dl.run_incremental_device(SpeakerNet.new(output=1, seed=0, device="cpu"),
                          [(p, None) for p in paths[:4]], dict(fm), burn_in_limit=1,
                          conf_threshold=0.8, dropout=0.0, batch_size=8, epochs=1,
                          max_speakers=None, show_progress=False, mesh=mesh)
info["default_sharded_calls"] = sharded_calls[0] - before

# The trainer alone at batch 5, against the unsharded one.
key = prng.PRNGKey(7)
for sharded in (True, False):
    net = SpeakerNet.new(output=3, seed=1, device="cpu")
    params = net.working_params()
    tvec = torch.zeros(params["b3"].shape[0]); tvec[1] = 1.0
    wins = torch.from_numpy(d["wins"][0][:20])
    padded = torch.zeros((40, 60)); padded[:20] = wins
    kw = dict(epochs=2, batch_size=5)
    if sharded:
        _, loss = train.train_on_windows_sharded_impl(params, padded, 20, tvec, 3, key, 0.05,
                                                      0.2, mesh=mesh, **kw)
    else:
        _, loss = train.train_on_windows_impl(params, padded, 20, tvec, 3, key, 0.05, 0.2, **kw)
    tag = "trainer_" + ("sharded" if sharded else "single")
    res[tag + "_loss"] = loss.numpy()
    res.update({f"{tag}_{k}": v.numpy() for k, v in params.items()})

# The measured choice: one decision on every rank.
autotune.on_cuda = lambda: True
autotune.device_kind = lambda: "FakeCard"
os.environ["STREAMZ_AUTOTUNE_CACHE"] = os.path.join(os.path.dirname(inp), f"cache_{rank}.json")
ran = []
def probe(name, t):
    def f():
        ran.append(name)
        return t
    return f
times = {0: (1.0, 2.0), 1: (3.0, 2.5), 2: (0.5, 2.0)}[rank]  # (single, sharded)
cands = lambda: {"single": probe("single", times[0]), "sharded": probe("sharded", times[1])}
info["fake_choice"] = autotune.measured_choice("fake_scan", cands(), default="sharded", mesh=mesh)
info["fake_probed"] = list(ran)
info["fake_times"] = autotune.probe_times["fake_scan:FakeCard"]
info["cache_written"] = os.path.exists(os.environ["STREAMZ_AUTOTUNE_CACHE"])
os.environ["STREAMZ_NO_AUTOTUNE"] = "1"
ran.clear()
info["no_probe_choice"] = autotune.measured_choice("fake_cold", cands(), default="sharded",
                                                   mesh=mesh)
info["no_probe_probed"] = list(ran)
os.environ.pop("STREAMZ_NO_AUTOTUNE")
for agree in (False, True):
    autotune.reset()
    ran.clear()
    choice = "single" if agree or rank == 0 else "sharded"
    autotune._disk_put("fake_scan:FakeCard", {"choice": choice, "candidates": ["sharded", "single"]})
    info[f"cached_agree_{agree}_choice"] = autotune.measured_choice(
        "fake_scan", cands(), default="sharded", mesh=mesh)
    info[f"cached_agree_{agree}_probed"] = list(ran)

np.savez(f"{out}_{rank}.npz", **res)
with open(f"{out}_{rank}.json", "w") as f:
    json.dump(info, f)
comm.shutdown()
'''


def _corpus():
    """``tests/test_device_loop.py:248``'s corpus: 30 files of 20 windows
    around 3 centres, from seed 0."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(3, 60)).astype(np.float32) * 3.0
    wins = np.stack([(centers[i % 3] + rng.normal(0, 0.1, size=(20, 60))).astype(np.float32)
                     for i in range(30)])
    return [f"clip_{i}.wav" for i in range(30)], wins


@pytest.fixture(scope="module", params=[2, 3])
def job(request, tmp_path_factory):
    """(world, rank 0's arrays, every rank's info), after holding every
    rank's arrays to rank 0's bit for bit."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"shardscan{world}")
    paths, wins = _corpus()
    np.savez(tmp / "in.npz", paths=np.asarray(paths), wins=wins)
    outs = run_ranks(world, lambda r, port: [
        sys.executable, "-c", _WORKER, str(r), str(world), str(port),
        str(tmp / "in.npz"), str(tmp / "out")], deadline=DEADLINE_S)
    for rc, out in outs:
        assert rc == 0, out[-3000:]
    res = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(world)]
    for other in res[1:]:
        assert other.keys() == res[0].keys()
        for k in res[0]:
            np.testing.assert_array_equal(other[k], res[0][k], err_msg=k)
    infos = [json.loads((tmp / f"out_{r}.json").read_text()) for r in range(world)]
    return world, res[0], infos, tmp


def _jax_sharded(world, dropout, monkeypatch):
    """The JAX package's mesh scan on the same corpus, forced on."""
    paths, wins = _corpus()
    monkeypatch.setenv("STREAMZ_SHARD_DISCOVERY", "1")
    monkeypatch.setattr(jdrivers, "_key_counter", [0])
    files = [(p, 0 if i == 0 else None) for i, p in enumerate(paths)]
    net = jmodel.SpeakerNet.new(output=1, seed=0)
    loss, _, _, _ = jdl.run_incremental_device(
        net, files, {p: wins[i] for i, p in enumerate(paths)}, burn_in_limit=6,
        conf_threshold=0.8, dropout=dropout, batch_size=8, epochs=2, max_speakers=None,
        show_progress=False, mesh=jcomm.make_mesh(world))
    params = jax.tree_util.tree_map(np.asarray, net.params)
    return [c for _, c in files], loss, params


@pytest.mark.parametrize("dropout", DROPOUTS)
def test_sharded_scan_matches_jax_mesh_scan(job, dropout, monkeypatch):
    world, res, _, _ = job
    labels, loss, params = _jax_sharded(world, dropout, monkeypatch)
    tag = f"sharded_{dropout}"
    assert res[tag + "_labels"].tolist() == labels
    assert len(set(labels)) > 1
    assert abs(float(res[tag + "_loss"]) - loss) <= 1e-4
    for k, v in params.items():
        np.testing.assert_allclose(res[f"{tag}_{k}"], v, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("dropout", DROPOUTS)
def test_sharded_scan_matches_the_replicated_route(job, dropout):
    world, res, _, _ = job
    s, r = f"sharded_{dropout}", f"replicated_{dropout}"
    np.testing.assert_array_equal(res[s + "_labels"], res[r + "_labels"])
    for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
        np.testing.assert_allclose(res[f"{s}_{k}"], res[f"{r}_{k}"], atol=1e-3, err_msg=k)


def test_escape_takes_the_replicated_route(job):
    """``STREAMZ_SHARD_DISCOVERY=0`` never reaches the sharded trainer;
    ``=1`` reaches it once per processed file."""
    _, _, infos, _ = job
    for info in infos:
        for dropout in DROPOUTS:
            assert info[f"replicated_{dropout}_sharded_calls"] == 0
            assert info[f"sharded_{dropout}_sharded_calls"] == 30


def test_default_route_is_sharded_without_a_card_or_probing(job):
    """As in JAX: unset without a card, the loop takes the sharded route;
    with probing off and no cached choice the default, unprobed."""
    _, _, infos, _ = job
    for info in infos:
        assert info["default_sharded_calls"] == 4
        assert info["no_probe_choice"] == "sharded" and info["no_probe_probed"] == []


def test_uneven_split_trainer_matches_unsharded(job):
    """Batch 5 over 2 or 3 ranks: a weight-0 row pads every chunk."""
    _, res, _, _ = job
    np.testing.assert_allclose(res["trainer_sharded_loss"], res["trainer_single_loss"],
                               atol=1e-5)
    for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
        np.testing.assert_allclose(res[f"trainer_sharded_{k}"], res[f"trainer_single_{k}"],
                                   atol=1e-5, err_msg=k)


def test_scan_choice_is_one_decision_on_every_rank(job):
    """Rank 0 alone would pick 'single' (1.0 s against 2.0 s); the times
    all-reduced to their maximum give 'sharded' on every rank, and rank 0
    alone writes the cache.  A cached choice that one rank does not share
    is probed again; one every rank shares is taken without a probe."""
    world, _, infos, _ = job
    for r, info in enumerate(infos):
        assert info["fake_choice"] == "sharded"
        assert info["fake_times"] == {"single": 3.0, "sharded": 2.5}
        assert info["fake_probed"] == ["single", "sharded"]
        assert info["cache_written"] == (r == 0)
        assert info["cached_agree_False_probed"] == ["single", "sharded"]
        assert info["cached_agree_False_choice"] == "sharded"
        assert info["cached_agree_True_probed"] == []
        assert info["cached_agree_True_choice"] == "single"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The default run as one process and, forced onto the sharded route,
    as two."""
    from streamz_tpu_torch.io import wav

    root = tmp_path_factory.mktemp("shardcli")
    rng = np.random.default_rng(5)
    clips = {f"c{i}_s{i % 4}.wav": _voice(rng, *SPEAKERS[i % 4], 0.6 + 0.05 * i)
             for i in range(8)}
    lines = [f"{n},{i % 4}" if i < 3 else n for i, n in enumerate(clips)]
    dirs = {1: [root / "single"], 2: [root / "p0", root / "p1"]}
    for d in dirs[1] + dirs[2]:
        d.mkdir()
        for name, pcm in clips.items():
            wav.write_wav(str(d / name), pcm)
        (d / "train_files.txt").write_text("\n".join(lines) + "\n")
    outs = {}
    for world, ds in dirs.items():
        flags = [] if world == 1 else ["--coordinator", "127.0.0.1:{port}",
                                       "--num-processes", str(world)]
        env = [] if world == 1 else ["env", "STREAMZ_SHARD_DISCOVERY=1"]
        outs[world] = run_ranks(world, lambda r, port: [
            *env, sys.executable, "-m", "streamz_tpu_torch", *ARGS,
            *(f.format(port=port) for f in flags),
            *([] if world == 1 else ["--process-id", str(r)])],
            cwd_of=lambda r: ds[r], deadline=DEADLINE_S)
        for rc, text in outs[world]:
            assert rc == 0, text[-3000:]
    return dirs, outs


def test_forced_sharded_cli_writes_the_single_process_labels(cli_runs):
    dirs, outs = cli_runs
    want = (dirs[1][0] / "train_files.txt").read_text()
    single = outs[1][0][1]
    for d, (_, text) in zip(dirs[2], outs[2]):
        assert "Running on 2 devices" in text
        assert (d / "train_files.txt").read_text() == want
        assert _labels(text) == _labels(single)
    assert len(_labels(single)) > 8
