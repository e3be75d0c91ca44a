"""The port's ``DeviceFeatureStore`` under a mesh of ranks, on the CPU.

The cases of the JAX package's ``tests/test_device_store.py`` on a mesh,
for each world size (2 and 3) in one spawned job of gloo ranks
(``test_torch_dist.run_ranks``, its deadline).  Every rank builds the store
from the clip-sharded frontend (``FeatureExtractor.extract_batch(mesh=,
store=)``, the plain frontend), holding its shard of every bucket.  Then:

- the replicated gather and each rank's row-sharded gather equal the host
  zero-pack of the frontend's own features bit for bit, a missing key's row
  zero and listed, and ``scatter_rows`` repairs it bit for bit;
- the discovery loop with and without the store gives identical labels and
  parameters on both routes (``STREAMZ_SHARD_DISCOVERY=1`` and ``0``), the
  store's ``host_pack_bytes`` 0; its labels equal the JAX package's mesh
  scan on the same features with its store, its parameters within 1e-4;
- ``evaluate`` with and without the store gives identical metrics, which
  equal the JAX package's on a ``comm.make_mesh(n)`` mesh with its store;
- a store built without a mesh, fed to the loop under one, is dropped with
  the JAX package's message, and the loop's results do not change.

Every rank's results equal rank 0's bit for bit.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from streamz_tpu.app import device_loop as jdl
from streamz_tpu.app.evaluate import evaluate as jevaluate
from streamz_tpu.dsp.mfcc import DeviceFeatureStore as JStore
from streamz_tpu.nn import drivers as jdrivers
from streamz_tpu.nn import model as jmodel
from streamz_tpu.parallel import comm as jcomm
from streamz_tpu.parallel.mesh import pad_rows_to_mesh
from test_torch_dist import run_ranks
from test_torch_dist_cli import SPEAKERS, _voice

DEADLINE_S = 120
MESSAGE = ("discovery loop: ingest feature store built under a different sharding; "
           "falling back to host-packed chunks")

_WORKER = r'''
import contextlib, io, json, os, sys
import numpy as np
import torch

rank, world, port, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
from streamz_tpu_torch.app import device_loop as dl
from streamz_tpu_torch.app.evaluate import evaluate
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.dsp.mfcc import DeviceFeatureStore
from streamz_tpu_torch.infer.embed import batch_clip_embeddings, normalize
from streamz_tpu_torch.nn import drivers
from streamz_tpu_torch.nn.model import SpeakerNet
from streamz_tpu_torch.parallel import comm

comm.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
mesh = comm.make_mesh(world)
d = np.load(inp)
n = int(d["n_clips"])
paths = [f"clip_{i}.wav" for i in range(n)]
clips = [d[f"clip_{i}"] for i in range(n)]
ex = FeatureExtractor("plain", device="cpu")

def build(with_mesh):
    store = DeviceFeatureStore(mesh=mesh if with_mesh else None)
    feats = ex.extract_batch(clips, mesh=mesh if with_mesh else None, store=store)
    store.rekey(dict(enumerate(paths)))
    return feats, store

feats, store = build(True)
fm = dict(zip(paths, feats))
res, info = {f"feats_{i}": f for i, f in enumerate(feats)}, {}
info["shard_rows"] = [int(store.bucket(b).shape[0]) for b in range(len(store._buckets))]

# Gathers against the host pack: a missing key, every clip, a pad row.
keys = [paths[i] for i in d["order"]] + ["missing.wav"]
w_pad = max(len(f) for f in feats) + 3
rows = -(-(len(keys) + 1) // world) * world
host = np.zeros((rows, w_pad, 60), np.float32)
for r, k in enumerate(keys[:-1]):
    host[r, : len(fm[k])] = fm[k]
rep, miss_rep = store.gather_partial(keys, w_pad, mesh=mesh, n_rows=rows)
shd, miss_shd = store.gather_partial(keys, w_pad, mesh=mesh, rows_sharded=True, n_rows=rows)
per = rows // world
info["replicated_equal"] = bool(np.array_equal(rep.numpy(), host))
info["sharded_equal"] = bool(np.array_equal(shd.numpy(), host[rank * per:(rank + 1) * per]))
info["missing"] = [miss_rep, miss_shd]
fix = np.full((1, w_pad, 60), 7.0, np.float32)
host[len(keys) - 1] = fix[0]
rep = store.scatter_rows(rep, fix, [len(keys) - 1], mesh=mesh)
shd = store.scatter_rows(shd, fix, [len(keys) - 1], mesh=mesh, rows_sharded=True)
info["scatter_equal"] = bool(np.array_equal(rep.numpy(), host)
                             and np.array_equal(shd.numpy(), host[rank * per:(rank + 1) * per]))
store.stats["host_pack_bytes"] = store.stats["host_pack_rows"] = 0

# The loop with and without the store, on both routes.
def loop(device_store, env, loop_mesh=mesh):
    os.environ["STREAMZ_SHARD_DISCOVERY"] = env
    drivers._key_counter[0] = 1000
    files = [(p, 0 if i == 0 else None) for i, p in enumerate(paths)]
    net = SpeakerNet.new(output=1, seed=0, device="cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        dl.run_incremental_device(net, files, dict(fm), burn_in_limit=3, conf_threshold=0.8,
                                  dropout=0.2, batch_size=8, epochs=2, max_speakers=None,
                                  show_progress=False, device_store=device_store,
                                  mesh=loop_mesh)
    return [c for _, c in files], {k: v.numpy() for k, v in net.params.items()}, err.getvalue()

for env in ("1", "0"):
    labels, params, _ = loop(None, env)
    labels_s, params_s, err = loop(store, env)
    info[f"loop_{env}_labels"] = labels
    info[f"loop_{env}_identical"] = labels == labels_s and all(
        np.array_equal(params[k], params_s[k]) for k in params)
    info[f"loop_{env}_stderr"] = err
    res.update({f"loop_{env}_{k}": v for k, v in params.items()})
info["host_pack_bytes"] = store.stats["host_pack_bytes"]

_, plain_store = build(False)
labels_m, params_m, err = loop(plain_store, "1")
info["mismatch_stderr"] = err
info["mismatch_identical"] = labels_m == info["loop_1_labels"] and all(
    np.array_equal(params_m[k], res[f"loop_1_{k}"]) for k in params_m)

# evaluate with and without the store.
net = SpeakerNet.new(output=3, seed=3, device="cpu")
embs = batch_clip_embeddings(net, feats, mesh=mesh)
net.set_embeddings([(normalize(np.mean(embs[i::3], axis=0)), 0.9, 0.05) for i in range(3)])
res.update({f"eval_{k}": v.numpy() for k, v in net.params.items()})
res["eval_cents"] = np.stack([m for m, _, _ in net.embeddings])
targets = [(p, i % 3) for i, p in enumerate(paths)]
info["metrics"] = evaluate(net, fm, targets, 0.2, verbose=False, mesh=mesh)
info["metrics_store"] = evaluate(net, fm, targets, 0.2, verbose=False, mesh=mesh, store=store)
info["eval_host_pack_bytes"] = store.stats["host_pack_bytes"]

np.savez(f"{out}_{rank}.npz", **res)
with open(f"{out}_{rank}.json", "w") as f:
    json.dump(info, f)
comm.shutdown()
'''


@pytest.fixture(scope="module", params=[2, 3])
def job(request, tmp_path_factory):
    """(world, rank 0's arrays, every rank's info)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"storemesh{world}")
    rng = np.random.default_rng(21)
    lens = [0.25, 0.5, 0.3, 0.45, 0.25, 0.6, 0.35, 0.5, 0.3, 0.55, 0.4, 0.25]
    d = {f"clip_{i}": _voice(rng, *SPEAKERS[i % 3], s) for i, s in enumerate(lens)}
    d["n_clips"] = np.int64(len(lens))
    d["order"] = rng.permutation(len(lens))
    np.savez(tmp / "in.npz", **d)
    outs = run_ranks(world, lambda r, port: [
        sys.executable, "-c", _WORKER, str(r), str(world), str(port),
        str(tmp / "in.npz"), str(tmp / "out")], deadline=DEADLINE_S)
    for rc, out in outs:
        assert rc == 0, out[-3000:]
    res = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(world)]
    for other in res[1:]:
        for k in res[0]:
            np.testing.assert_array_equal(other[k], res[0][k], err_msg=k)
    infos = [json.loads((tmp / f"out_{r}.json").read_text()) for r in range(world)]
    return world, res[0], infos


def _fm(res):
    n = len([k for k in res if k.startswith("feats_")])
    return {f"clip_{i}.wav": res[f"feats_{i}"] for i in range(n)}


def test_store_holds_shards_and_gathers_equal_the_host_pack(job):
    world, res, infos = job
    n_clips = len(_fm(res))
    for info in infos:
        assert info["replicated_equal"] and info["sharded_equal"] and info["scatter_equal"]
        missing_row = n_clips  # the last key
        assert info["missing"] == [[[missing_row, "missing.wav"]]] * 2
        # Every bucket split over the ranks, not replicated.
        assert sum(info["shard_rows"]) * world >= n_clips


@pytest.mark.parametrize("route", ["1", "0"])
def test_loop_with_the_mesh_store_is_identical(job, route):
    _, _, infos = job
    for info in infos:
        assert info[f"loop_{route}_identical"]
        assert info[f"loop_{route}_stderr"] == ""
        assert info["host_pack_bytes"] == 0


def test_loop_with_the_mesh_store_matches_the_jax_mesh_scan(job, monkeypatch):
    """The JAX package's scan, forced sharded, with a store holding the
    same features on its mesh."""
    world, res, infos = job
    fm = _fm(res)
    paths = list(fm)
    mesh = jcomm.make_mesh(world)
    store = JStore(mesh=mesh)
    by_w: dict = {}
    for i, p in enumerate(paths):
        by_w.setdefault(len(fm[p]), []).append(i)
    for w, idxs in by_w.items():
        _, (padded,) = pad_rows_to_mesh(mesh, np.stack([fm[paths[i]] for i in idxs]))
        store.add_bucket(jax.device_put(padded, NamedSharding(mesh, P(mesh.axis_names[0]))),
                         idxs, [w] * len(idxs))
    store.rekey(dict(enumerate(paths)))
    monkeypatch.setenv("STREAMZ_SHARD_DISCOVERY", "1")
    monkeypatch.setattr(jdrivers, "_key_counter", [1000])
    files = [(p, 0 if i == 0 else None) for i, p in enumerate(paths)]
    net = jmodel.SpeakerNet.new(output=1, seed=0)
    jdl.run_incremental_device(net, files, dict(fm), burn_in_limit=3, conf_threshold=0.8,
                               dropout=0.2, batch_size=8, epochs=2, max_speakers=None,
                               show_progress=False, mesh=mesh, device_store=store)
    assert [c for _, c in files] == infos[0]["loop_1_labels"]
    for k, v in net.params.items():
        np.testing.assert_allclose(res[f"loop_1_{k}"], np.asarray(v), atol=1e-4, err_msg=k)


def test_evaluate_with_the_mesh_store_identical_metrics(job):
    world, res, infos = job
    for info in infos:
        assert info["metrics_store"] == info["metrics"]
        assert info["eval_host_pack_bytes"] == 0
    assert infos[0]["metrics"]["correct"] > 0  # the comparison is not vacuous
    # The JAX package's evaluate on its mesh, with its store, on the same
    # features, model and centroids.
    fm = _fm(res)
    paths = list(fm)
    net = jmodel.SpeakerNet.new(output=3, seed=3)
    net.params = {k: jnp.asarray(res[f"eval_{k}"]) for k in net.params}
    net.set_embeddings([(c, 0.9, 0.05) for c in res["eval_cents"]])
    targets = [(p, i % 3) for i, p in enumerate(paths)]
    mesh = jcomm.make_mesh(world)
    want = jevaluate(net, fm, targets, 0.2, verbose=False, mesh=mesh)
    assert infos[0]["metrics"] == pytest.approx(want, rel=1e-5)


def test_store_built_without_the_mesh_is_dropped(job):
    _, _, infos = job
    for info in infos:
        assert info["mismatch_stderr"].strip() == MESSAGE
        assert info["mismatch_identical"]
