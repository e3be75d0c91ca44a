"""The port's multi-process run against the JAX package's device mesh, on the CPU.

For each world size (2 and 3) one spawned job of gloo ranks
(``comm.initialize_distributed`` on ``tcp://127.0.0.1``, ``--device cpu``)
computes everything once and every rank writes its results to an npz; the
test compares rank 0's with the JAX package on a ``comm.make_mesh(n)`` CPU
mesh (``tests/conftest.py`` forces 8 CPU devices), from the same numpy
seed, and holds every other rank to rank 0's bits (the gathers hand every
rank the same arrays):

- the data-parallel step, the DP epoch trainer and ``train_corpus`` with
  dropout over a ragged last step (3 ranks: a rank with no real rows):
  1e-5, the f32 summation-order tolerance of ``tests/test_torch_train.py``;
- ``vote_sums_sharded`` (sums of 1001 windows: relative 1e-5) and
  ``extract_embedding_sharded`` (1e-5);
- ``mfcc_features_pcm_sharded`` on a clip of 2500 windows and on clips
  shorter than one shard: 1e-4, the plain frontend's tolerance against the
  XLA formulation in ``tests/test_torch_mfcc.py``; the clip-sharded ingest
  and its embeddings at the same tolerance;
- equal verdicts from the batched identify, the PCM-halo long-clip
  identify and the sharded thresholded vote.

Each job has a hard deadline: a rank still running then is killed and the
test fails.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from streamz_tpu.app import corpus as jcorpus
from streamz_tpu.dsp import mfcc as jmfcc
from streamz_tpu.infer import embed as jembed
from streamz_tpu.infer import identify as jidentify
from streamz_tpu.nn import model as jmodel
from streamz_tpu.parallel import comm as jcomm
from streamz_tpu.parallel import data_parallel as jdp
from streamz_tpu.parallel import window_parallel as jwp

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 150

_WORKER = r'''
import json, sys
import numpy as np
import torch

rank, world, port, inp, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
from streamz_tpu_torch.app import corpus
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.infer import embed, identify
from streamz_tpu_torch.nn.convert import params_from_numpy
from streamz_tpu_torch.nn.model import SpeakerMLP, SpeakerNet
from streamz_tpu_torch.parallel import comm, data_parallel as dp, window_parallel as wp

dev = comm.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
mesh = comm.make_mesh(world)
d = dict(np.load(inp))


def net_from(prefix, ns):
    p = params_from_numpy({k: d[prefix + k] for k in ("w1", "b1", "w2", "b2", "w3", "b3")},
                          device="cpu")
    return SpeakerNet(mlp=SpeakerMLP({k: v.contiguous() for k, v in p.items()}),
                      num_speakers=ns, file_lists=[[] for _ in range(ns)])


res = {}
step_net = net_from("dp_", 3)
params = step_net.working_params()
_, loss = dp.make_dp_train_step(mesh)(params, d["x"], d["y"], d["w"], 3, 0.05)
res.update({"step_" + k: v.numpy() for k, v in params.items()}, step_loss=loss.numpy())

params = step_net.working_params()
_, losses = dp.make_dp_train_epoch(mesh, steps=2)(params, d["ex"], d["ey"], d["ew"], 3, 0.1)
res.update({"epoch_" + k: v.numpy() for k, v in params.items()}, epoch_losses=losses.numpy())

tnet = net_from("dp_", 3)
res["corpus_losses"] = np.asarray(corpus.train_corpus(
    tnet, d["px"], d["py"], epochs=2, batch_size=64, lr=0.05, dropout=0.2, mesh=mesh,
    seed=3))
res.update({"corpus_" + k: v.numpy() for k, v in tnet.params.items()})

net = net_from("id_", 5)
res["vote_sums"] = wp.vote_sums_sharded(net, d["wins"], mesh)
res["embedding"] = wp.extract_embedding_sharded(net, d["wins"], mesh)
res["id_sharded"] = np.int64(wp.identify_speaker_sharded(net, d["wins"], mesh))
res["pcm_feats"] = wp.mfcc_features_pcm_sharded(d["pcm"], mesh)
for i in range(3):
    res[f"short_{i}"] = wp.mfcc_features_pcm_sharded(d[f"short_{i}"], mesh)
res["pcm_embedding"] = wp.extract_embedding_pcm_sharded(net, d["pcm"], mesh)
res["pcm_id"] = np.int64(wp.identify_speaker_pcm_sharded(net, d["pcm"], mesh))

ex = FeatureExtractor(device="cpu")
clips = [d[f"clip_{i}"] for i in range(int(d["n_clips"]))]
ingest = ex.extract_batch(clips, mesh=mesh)
for i, f in enumerate(ingest):
    res[f"ingest_{i}"] = f
res["clip_embs"] = np.stack(embed.batch_clip_embeddings(net, ingest, mesh=mesh))
res["median_embs"] = np.stack(embed.batch_median_embeddings(net, ingest, mesh=mesh))
res["id_lists"] = np.asarray(json.dumps(
    identify.identify_speaker_list_batch(net, clips, 0.0, ex, mesh=mesh)))
res["id_long"] = np.int64(identify.identify_speaker(net, d["long"], ex, mesh=mesh))
res["id_thresh"] = np.int64(identify.identify_speaker_with_threshold_feats(
    net, d["long_wins"], 0.0, mesh=mesh))
np.savez(f"{out}_{rank}.npz", **res)
comm.shutdown()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, argv_of, cwd_of=lambda r: None, deadline=DEADLINE_S):
    """Start ``world`` ranks (``argv_of(rank, port)``, in ``cwd_of(rank)``),
    wait for all of them until ``deadline`` seconds, kill any still running
    then; returns their (rc, output) in rank order."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv_of(r, port), cwd=cwd_of(r), env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=deadline)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"a rank of {world} missed its {deadline} s deadline")
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _voice(rng, f0, seconds):
    t = np.arange(int(seconds * 44100)) / 44100
    x = sum(0.6 ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
            for h in range(10)) + rng.normal(0, 0.05, t.shape)
    return np.clip(x / np.abs(x).max() * 12000, -32768, 32767).astype(np.int16)


def _inputs(rng):
    d = {}
    for prefix, (out, seed) in (("dp_", (3, 1)), ("id_", (5, 2))):
        net = jmodel.SpeakerNet.new(60, 32, 16, out, seed=seed)
        for k, v in net.params.items():
            v = np.asarray(v)
            # A sharper softmax: the verdicts then do not hinge on f32 noise.
            d[prefix + k] = v * 8.0 if prefix == "id_" and k in ("w3", "b3") else v
    d["x"] = rng.normal(0, 1, (96, 60)).astype(np.float32)
    d["y"] = rng.integers(0, 3, 96).astype(np.int32)
    d["w"] = (rng.random(96) > 0.2).astype(np.float32)
    d["ex"] = rng.normal(0, 1, (2, 96, 60)).astype(np.float32)
    d["ey"] = rng.integers(0, 3, (2, 96)).astype(np.int32)
    d["ew"] = np.ones((2, 96), np.float32)
    d["px"] = rng.normal(0, 1, (300, 60)).astype(np.float32)
    d["px"][::40] = 0.0
    d["py"] = rng.integers(0, 3, 300).astype(np.int32)
    d["wins"] = rng.normal(0, 1, (1001, 60)).astype(np.float32)
    d["pcm"] = rng.normal(0, 0.1, 800 + 2499 * 400 + 123).astype(np.float32)
    for i, n in enumerate((500, 1000, 2100)):  # 0, 1 and 4 windows: under a shard
        d[f"short_{i}"] = rng.normal(0, 0.1, n).astype(np.float32)
    lens = (0.3, 0.5, 0.8, 1.0, 0.45)
    d["n_clips"] = np.int64(len(lens))
    for i, s in enumerate(lens):
        d[f"clip_{i}"] = _voice(rng, 100.0 + 60 * i, s)
    d["long"] = rng.normal(0, 0.1, 800 + 16400 * 400).astype(np.float32)
    d["long_wins"] = rng.normal(0, 1, (16500, 60)).astype(np.float32)
    return d


@pytest.fixture(scope="module", params=[2, 3])
def job(request, tmp_path_factory):
    """(world, inputs, rank 0's results), after holding every rank's
    results to rank 0's bit for bit."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"dist{world}")
    d = _inputs(np.random.default_rng(11))
    np.savez(tmp / "in.npz", **d)
    outs = run_ranks(world, lambda r, port: [
        sys.executable, "-c", _WORKER, str(r), str(world), str(port),
        str(tmp / "in.npz"), str(tmp / "out")])
    for rc, out in outs:
        assert rc == 0, out[-3000:]
    res = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(world)]
    for other in res[1:]:
        assert other.keys() == res[0].keys()
        for k in res[0]:
            np.testing.assert_array_equal(other[k], res[0][k], err_msg=k)
    return world, d, res[0]


def _jnet(d, prefix, ns):
    net = jmodel.SpeakerNet.new(60, 32, 16, ns, seed=0)
    net.params = {k: jnp.asarray(d[prefix + k]) for k in net.params}
    return net


def test_dp_step_matches_jax_mesh(job):
    world, d, res = job
    mesh = jcomm.make_mesh(world)
    params = _jnet(d, "dp_", 3).params
    xb, yb, wb = jdp.shard_arrays(mesh, d["x"], d["y"], d["w"])
    jp, jloss = jdp.make_dp_train_step(mesh, backend="xla")(
        params, xb, yb, wb, jnp.int32(3), jnp.float32(0.05))
    np.testing.assert_allclose(res["step_loss"], float(jloss), atol=1e-5)
    for k in jp:
        np.testing.assert_allclose(res["step_" + k], np.asarray(jp[k]), atol=1e-5,
                                   err_msg=k)


def test_dp_epoch_matches_jax_mesh(job):
    world, d, res = job
    mesh = jcomm.make_mesh(world)
    jp, jl = jdp.make_dp_train_epoch(mesh, steps=2, backend="xla")(
        _jnet(d, "dp_", 3).params, jnp.asarray(d["ex"]), jnp.asarray(d["ey"]),
        jnp.asarray(d["ew"]), jnp.int32(3), jnp.float32(0.1))
    np.testing.assert_allclose(res["epoch_losses"], np.asarray(jl), atol=1e-5)
    for k in jp:
        np.testing.assert_allclose(res["epoch_" + k], np.asarray(jp[k]), atol=1e-5,
                                   err_msg=k)


def test_train_corpus_with_dropout_matches_jax_mesh(job):
    """Batch 64 rounds up to 66 on 3 ranks; the last step's real rows do
    not reach the last rank, whose shard is all padding."""
    world, d, res = job
    jnet = _jnet(d, "dp_", 3)
    jl = jcorpus.train_corpus(jnet, d["px"], d["py"], epochs=2, batch_size=64, lr=0.05,
                              dropout=0.2, mesh=jcomm.make_mesh(world), seed=3)
    np.testing.assert_allclose(res["corpus_losses"], jl, atol=1e-5)
    for k, v in jnet.params.items():
        np.testing.assert_allclose(res["corpus_" + k], np.asarray(v), atol=1e-5, err_msg=k)


def test_sharded_votes_and_embedding_match_jax_mesh(job):
    world, d, res = job
    mesh = jcomm.make_mesh(world)
    net = _jnet(d, "id_", 5)
    np.testing.assert_allclose(res["vote_sums"], jwp.vote_sums_sharded(net, d["wins"], mesh),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["embedding"],
                               jwp.extract_embedding_sharded(net, d["wins"], mesh), atol=1e-5)
    assert int(res["id_sharded"]) == jwp.identify_speaker_sharded(net, d["wins"], mesh)


def test_pcm_sharded_frontend_matches_jax_mesh(job):
    world, d, res = job
    mesh = jcomm.make_mesh(world)
    want = jwp.mfcc_features_pcm_sharded(d["pcm"], mesh)
    assert res["pcm_feats"].shape == want.shape == (2500, 60)
    np.testing.assert_allclose(res["pcm_feats"], want, atol=1e-4)
    for i in range(3):
        want = jwp.mfcc_features_pcm_sharded(d[f"short_{i}"], mesh)
        assert res[f"short_{i}"].shape == want.shape
        np.testing.assert_allclose(res[f"short_{i}"], want, atol=1e-4)
    net = _jnet(d, "id_", 5)
    np.testing.assert_allclose(res["pcm_embedding"],
                               jwp.extract_embedding_pcm_sharded(net, d["pcm"], mesh),
                               atol=1e-5)
    assert int(res["pcm_id"]) == jwp.identify_speaker_pcm_sharded(net, d["pcm"], mesh)


def test_sharded_ingest_and_embeddings_match_jax_mesh(job):
    world, d, res = job
    mesh = jcomm.make_mesh(world)
    clips = [d[f"clip_{i}"] for i in range(int(d["n_clips"]))]
    want = jmfcc.extract_features_batch(clips, mesh=mesh)
    for i, w in enumerate(want):
        assert res[f"ingest_{i}"].shape == w.shape
        np.testing.assert_allclose(res[f"ingest_{i}"], w, atol=1e-4)
    net = _jnet(d, "id_", 5)
    np.testing.assert_allclose(res["clip_embs"],
                               np.stack(jembed.batch_clip_embeddings(net, want, mesh=mesh)),
                               atol=1e-4)
    np.testing.assert_allclose(res["median_embs"],
                               np.stack(jembed.batch_median_embeddings(net, want, mesh=mesh)),
                               atol=1e-4)


def test_sharded_identify_verdicts_match_jax_mesh(job):
    world, d, res = job
    mesh = jcomm.make_mesh(world)
    net = _jnet(d, "id_", 5)
    clips = [d[f"clip_{i}"] for i in range(int(d["n_clips"]))]
    want = jidentify.identify_speaker_list_batch(net, clips, 0.0, mesh=mesh)
    assert json.loads(str(res["id_lists"])) == want
    assert int(res["id_long"]) == jidentify.identify_speaker(net, d["long"], mesh=mesh)
    assert int(res["id_thresh"]) == jidentify.identify_speaker_with_threshold_feats(
        net, d["long_wins"], 0.0, mesh=mesh)
