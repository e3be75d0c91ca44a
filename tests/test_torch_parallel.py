"""The port's parallel layer in process, on the CPU.

- ``pad_rows_to_mesh`` and the rank slices of ``put_batch_sharded``;
- ``initialize_distributed``'s contract (``tests/test_multihost.py:210-226``):
  any partial set of the three flags raises ``ValueError`` naming "pass all
  three", none is a no-op, and ``STREAMZ_DIST_AUTO=1`` with none takes
  ``torchrun``'s ``env://`` rendezvous; the CLI accepts the flags and
  raises on a partial set;
- ``auto_mesh``: ``STREAMZ_TPU_MESH=0`` wins on every call, a pinned None
  stays pinned;
- a 1-rank gloo group: the collectives, the data-parallel step and
  ``train_corpus`` over a 1-rank mesh bit for bit equal to the
  single-device route;
- the multi-process guards: no frontend probe (nor any measured choice
  across hosts), no store built without the frontend's mesh, the
  ``MultiStreamIdentifier`` refuses; ``STREAMZ_SHARD_DISCOVERY`` under a
  mesh of two ranks takes the sharded discovery scan, ``0`` the
  replicated loop.
"""

import numpy as np
import pytest
import torch

from streamz_tpu_torch.app import corpus
from streamz_tpu_torch.nn import model as tmodel
from streamz_tpu_torch.nn import train_kernels as tk
from streamz_tpu_torch.parallel import comm
from streamz_tpu_torch.parallel import data_parallel as dp
from streamz_tpu_torch.parallel import mesh as meshmod
from streamz_tpu_torch.runtime import autotune


class _FakeMesh:
    """Stands for a mesh where only its size and this rank's place matter."""

    device_type = "cpu"

    def __init__(self, n, rank=0):
        self.n, self.rank = n, rank

    def size(self):
        return self.n

    def get_local_rank(self):
        return self.rank


@pytest.mark.parametrize("n_dev,rows,want", [(2, 5, 6), (3, 6, 6), (3, 0, 3), (4, 7, 8)])
def test_pad_rows_to_mesh(n_dev, rows, want):
    a = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    b = np.arange(rows, dtype=np.int32)
    n, (pa, pb) = meshmod.pad_rows_to_mesh(_FakeMesh(n_dev), a, b)
    assert n == rows and pa.shape == (want, 2) and pb.shape == (want,)
    np.testing.assert_array_equal(pa[:rows], a)
    assert not pa[rows:].any() and not pb[rows:].any()


def test_put_batch_sharded_takes_each_ranks_contiguous_slice():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    for rank in range(3):
        (got,) = meshmod.put_batch_sharded(_FakeMesh(3, rank), a)
        np.testing.assert_array_equal(got.numpy(), a[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="do not split"):
        meshmod.put_batch_sharded(_FakeMesh(4), a)


def test_partial_distributed_args_rejected():
    with pytest.raises(ValueError):
        comm.initialize_distributed(process_id=1)
    with pytest.raises(ValueError, match="pass all three"):
        comm.initialize_distributed(num_processes=4)
    with pytest.raises(ValueError, match="pass all three"):
        comm.initialize_distributed(coordinator_address="h:1", process_id=0)
    assert comm.initialize_distributed() is None  # all-None: the no-op
    assert not comm.initialized()


def test_cli_accepts_the_flags_and_rejects_a_partial_set(monkeypatch, tmp_path, capsys):
    from streamz_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="pass all three"):
        cli.main(["--device", "cpu", "--process-id", "1"])
    with pytest.raises(ValueError, match="pass all three"):
        cli.main(["--device", "cpu", "--coordinator", "127.0.0.1:1", "--num-processes", "2"])
    assert cli.main(["--device", "cpu"]) == 1  # unchanged without them: no list
    assert "not yet ported" not in capsys.readouterr().err


def test_local_layout(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert comm._local_layout("127.0.0.1:5", 4, 2) == (2, 4)
    assert comm._local_layout("localhost:5", 3, 1) == (1, 3)
    assert comm._local_layout("10.1.2.3:5", 4, 2) == (0, 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert comm._local_layout("10.1.2.3:5", 8, 5) == (1, 2)


@pytest.fixture
def fresh_mesh_state(monkeypatch):
    monkeypatch.setattr(meshmod, "_ACTIVE", [meshmod._UNSET])
    monkeypatch.delenv("STREAMZ_TPU_MESH", raising=False)
    return monkeypatch


def test_auto_mesh_kill_switch_and_pinned_none(fresh_mesh_state):
    mp = fresh_mesh_state
    assert meshmod.auto_mesh() is None  # no process group
    built = _FakeMesh(2)
    mp.setattr(comm, "world_size", lambda: 2)
    mp.setattr(comm, "make_mesh", lambda n_devices=None, axis=comm.DATA_AXIS: built)
    assert meshmod.auto_mesh() is built and meshmod.active_mesh() is built
    mp.setenv("STREAMZ_TPU_MESH", "0")
    assert meshmod.auto_mesh() is None  # consulted on every call
    mp.delenv("STREAMZ_TPU_MESH")
    assert meshmod.auto_mesh() is built
    meshmod.set_active_mesh(None)
    assert meshmod.auto_mesh() is None  # a pinned None is not rebuilt
    meshmod.reset_active_mesh()
    assert meshmod.auto_mesh() is built


@pytest.fixture
def one_rank(monkeypatch):
    """A 1-rank gloo group through ``STREAMZ_DIST_AUTO=1``'s env:// path."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("STREAMZ_DIST_AUTO", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(port)), ("WORLD_SIZE", "1"), ("RANK", "0"),
                 ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "1")):
        monkeypatch.setenv(k, v)
    dev = comm.initialize_distributed(device="cpu")
    try:
        yield dev
    finally:
        comm.shutdown()


def test_one_rank_group_collectives(one_rank):
    assert one_rank == torch.device("cpu")
    assert comm.initialized() and comm.backend() == "gloo" and comm.world_size() == 1
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        comm.make_mesh(2)
    mesh = comm.make_mesh(1)
    assert mesh.size() == 1 and comm.axis_index(mesh) == 0
    assert mesh.mesh_dim_names == (comm.DATA_AXIS,)
    assert comm.make_mesh(axis=comm.WINDOW_AXIS).mesh_dim_names == (comm.WINDOW_AXIS,)
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    np.testing.assert_array_equal(comm.psum(x, mesh), x)
    np.testing.assert_array_equal(comm.pmean(x, mesh), x)
    assert comm.all_gather(x, mesh).shape == (1, 3, 2)
    assert comm.all_gather(x, mesh, tiled=True).shape == (3, 2)
    np.testing.assert_array_equal(meshmod.fetch(x, mesh), x.numpy())


def test_one_rank_dp_step_equals_the_single_device_step(one_rank):
    mesh = comm.make_mesh(1)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(40, 60)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 40).astype(np.int32))
    w = torch.from_numpy((rng.random(40) > 0.3).astype(np.float32))
    net = tmodel.SpeakerNet.new(60, 32, 16, 3, seed=0, device="cpu")
    a, b = net.working_params(), net.working_params()
    la = dp.dp_step(a, tk.Batch(x, y, w), 3, 0.05, mesh)
    lb = tk.corpus_step_k5(b, tk.Batch(x, y, w), 3, 0.05)
    assert torch.equal(la, lb)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    _, losses = dp.make_dp_train_epoch(mesh, steps=1)(
        net.working_params(), x[None].numpy(), y[None].numpy(), w[None].numpy(), 3, 0.05)
    assert torch.equal(losses[0], lb)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_one_rank_train_corpus_equals_the_single_device_route(one_rank, dropout):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 60)).astype(np.float32)
    y = rng.integers(0, 4, 500).astype(np.int32)
    nets = [tmodel.SpeakerNet.new(60, 32, 16, 4, seed=2, device="cpu") for _ in range(2)]
    kw = dict(epochs=2, batch_size=128, lr=0.05, dropout=dropout, seed=1)
    la = corpus.train_corpus(nets[0], x, y, mesh=comm.make_mesh(1), **kw)
    lb = corpus.train_corpus(nets[1], x, y, **kw)
    assert la == lb
    for k in nets[0].params:
        assert torch.equal(nets[0].params[k], nets[1].params[k]), k


def test_probe_and_store_are_off_under_a_mesh(monkeypatch):
    from streamz_tpu_torch.dsp import mfcc

    monkeypatch.setattr(comm, "world_size", lambda: 2)
    monkeypatch.setattr(autotune, "on_cuda", lambda: True)

    def probe():
        raise AssertionError("a probe ran in a multi-process run")

    assert autotune.measured_choice("frontend_test", {"a": probe, "b": probe},
                                    default="b", force=True) == "b"
    assert autotune.cached_choice("frontend_test", "b", "plain") == "b"
    # A choice made under a mesh is measured by every rank together, but
    # only when every rank runs on this host.
    monkeypatch.setattr(comm, "single_host", lambda: False)
    assert autotune.measured_choice("frontend_test", {"a": probe, "b": probe},
                                    default="b", force=True, mesh=_FakeMesh(2)) == "b"
    with pytest.raises(ValueError, match="built under another mesh"):
        mfcc.extract_features_batch([np.zeros(2000, np.int16)], device="cpu",
                                    store=mfcc.DeviceFeatureStore(), mesh=_FakeMesh(2))


def test_multi_stream_identifier_refuses_in_a_multi_process_run(monkeypatch):
    from streamz_tpu_torch.app.serve import MultiStreamIdentifier

    net = tmodel.SpeakerNet.new(60, 32, 16, 2, seed=0, device="cpu")
    monkeypatch.setattr(comm, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        MultiStreamIdentifier(net, 2)


@pytest.mark.parametrize("value", ["1", "spmd"])
def test_sharded_discovery_scan_raises_not_yet_ported(monkeypatch, value):
    """Any value but "0" now takes the sharded scan (the sharded trainer is
    reached; ``tests/test_torch_shard_scan.py`` runs it over real ranks),
    "0" the replicated loop."""
    from streamz_tpu_torch.app import device_loop
    from streamz_tpu_torch.app.incremental import run_incremental

    def reached(*a, **kw):
        raise RuntimeError("the sharded trainer")

    monkeypatch.setattr(device_loop, "train_on_windows_sharded_impl", reached)
    monkeypatch.setattr(comm, "psum", lambda x, mesh: x)
    monkeypatch.setenv("STREAMZ_SHARD_DISCOVERY", value)
    net = tmodel.SpeakerNet.new(60, 32, 16, 1, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="the sharded trainer"):
        run_incremental(net, [("a.wav", None)], {"a.wav": np.zeros((8, 60), np.float32)},
                        burn_in_limit=1, mesh=_FakeMesh(2), show_progress=False)
    monkeypatch.setenv("STREAMZ_SHARD_DISCOVERY", "0")  # the replicated loop
    res = run_incremental(net, [("a.wav", None)],
                          {"a.wav": np.zeros((8, 60), np.float32)},
                          burn_in_limit=1, mesh=_FakeMesh(2), show_progress=False)
    assert res.processed == 1
