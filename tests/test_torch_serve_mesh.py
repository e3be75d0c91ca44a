"""The slot-sharded ``MultiStreamIdentifier`` over several devices, on the CPU.

The identifier over ``["cpu"] * n`` (n = 2 and 3; a ``LocalMesh`` of one
process) against the unsharded identifier and the JAX package's
``MultiStreamIdentifier(mesh=comm.make_mesh(n))`` on the same feeds, on the
f32, i16 and mu-law wires: every rolling verdict (from the merged snapshot
and from each slot's own readback) and every final verdict the same
speaker, the confidences within rtol 1e-5 (vote sums that another slot
count per device groups in another order).  ``n_streams`` stays the
admission bound: the padding slots of an uneven split are never handed
out, and a slot closed on one device is reused there.  ``--serve``'s mesh
is every card of its process.
"""

import numpy as np
import pytest

from streamz_tpu.app.serve import MultiStreamIdentifier as JMulti
from streamz_tpu.nn.model import SpeakerNet as JNet
from streamz_tpu.parallel import comm as jcomm
from streamz_tpu_torch.app.serve import MultiStreamIdentifier
from streamz_tpu_torch.dsp.mfcc import _to_f32
from streamz_tpu_torch.io import g711
from streamz_tpu_torch.nn.model import SpeakerNet
from streamz_tpu_torch.parallel.mesh import LocalMesh
from test_torch_serve import _assert_verdict_close, _clips, _feed_interleaved, _oracle

N_STREAMS = 5


@pytest.fixture(scope="module")
def net():
    return SpeakerNet.new(output=5, seed=0, device="cpu")


def _wire(clips, wire):
    if wire == "f32":
        return [_to_f32(c) for c in clips], None
    if wire == "i16":
        return clips, None
    return [g711.ulaw_encode(c) for c in clips], ["ulaw"] * len(clips)


def _serve(srv, clips, encodings):
    sids = [srv.open() for _ in clips]
    _feed_interleaved(srv, sids, clips, encodings=encodings)
    polled = [srv.current(s) for s in sids]
    srv.refresh_verdicts()
    snap = [srv.current(s) for s in sids]
    return polled, snap, [srv.finalize(s) for s in sids]


@pytest.mark.parametrize("wire", ["f32", "i16", "ulaw"])
@pytest.mark.parametrize("n", [2, 3])
def test_sharded_verdicts_equal_unsharded_and_jax(net, n, wire):
    clips, encodings = _wire(_clips(N_STREAMS, seed=n), wire)
    sharded = MultiStreamIdentifier(net, N_STREAMS, threshold=0.0, mesh=["cpu"] * n)
    assert sharded.n_slots == -(-N_STREAMS // n) * n
    got = _serve(sharded, clips, encodings)
    want = _serve(MultiStreamIdentifier(net, N_STREAMS, threshold=0.0), clips, encodings)
    jax_srv = JMulti(JNet.new(output=5, seed=0), n_streams=N_STREAMS, threshold=0.0,
                     mesh=jcomm.make_mesh(n))
    assert jax_srv.n_slots == sharded.n_slots
    jax_want = _serve(jax_srv, clips, encodings)
    assert sharded.stats()["wire_dispatches"][{"ulaw": "u8"}.get(wire, wire)] > 0
    for ref in (want, jax_want):
        for g_part, r_part in zip(got, ref):
            for g, r in zip(g_part, r_part):
                _assert_verdict_close(g, r)
    assert all(v is not None for v in got[2])


def test_padding_slots_are_never_handed_out(net):
    srv = MultiStreamIdentifier(net, N_STREAMS, threshold=0.0, mesh=LocalMesh(["cpu"] * 3))
    assert (srv.n_streams, srv.n_slots) == (5, 6)
    assert [srv.open() for _ in range(N_STREAMS)] == [0, 1, 2, 3, 4]
    with pytest.raises(RuntimeError, match="all 5 stream slots in use"):
        srv.open()
    with pytest.raises(KeyError):
        srv.feed(5, np.zeros(400, np.int16))
    # Slot 3 lives on the second device: close it there and use it again.
    clip = _clips(1, seed=9)[0]
    srv.feed(3, clip[:9000])
    srv.tick()
    srv.close(3)
    assert srv.open() == 3
    srv.feed(3, clip)
    _assert_verdict_close(srv.finalize(3), _oracle(net, clip))


def test_serve_shards_over_every_card_of_its_process(monkeypatch):
    """``--serve``'s mesh (``parallel.mesh.local_mesh``): every card the
    process sees when there are two or more, none on the CPU, one card or
    ``STREAMZ_TPU_MESH=0``."""
    from streamz_tpu_torch.parallel.mesh import local_mesh

    monkeypatch.setattr("torch.cuda.device_count", lambda: 3)
    assert [str(d) for d in local_mesh("cuda").devices] == ["cuda:0", "cuda:1", "cuda:2"]
    assert local_mesh("cpu") is None
    monkeypatch.setenv("STREAMZ_TPU_MESH", "0")
    assert local_mesh("cuda") is None
    monkeypatch.delenv("STREAMZ_TPU_MESH")
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    assert local_mesh("cuda") is None
