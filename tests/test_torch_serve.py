"""Multi-stream batched serving on the port (app/serve.py) and its G.711
codec (io/g711.py), against the JAX package.

Each slot of :class:`MultiStreamIdentifier` reproduces the single-stream
identifier, and so the offline pipeline, for any interleaving of feeds;
slots are independent and reusable.  The G.711 tables and codec equal the
JAX package's bit for bit; the u8 and i16 wires equal host decoding bit for
bit; vote sums lie within rtol 1e-5 of the JAX server's on the same feeds
and every verdict is the same.  (The JAX file's mesh cases are in
``tests/test_torch_serve_mesh.py``.)
"""

import numpy as np
import pytest
import torch

from streamz_tpu.app.serve import MultiStreamIdentifier as JMulti
from streamz_tpu.io import g711 as jg711
from streamz_tpu.nn.model import SpeakerNet as JNet
from streamz_tpu_torch import config
from streamz_tpu_torch.app import serve as tserve
from streamz_tpu_torch.app import stream as tstream
from streamz_tpu_torch.app.serve import MultiStreamIdentifier
from streamz_tpu_torch.app.stream import StreamingIdentifier
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.infer.identify import identify_speaker_with_threshold
from streamz_tpu_torch.io import g711
from streamz_tpu_torch.nn.model import SpeakerNet

ALL_CODES = np.arange(256, dtype=np.uint8)


@pytest.fixture(scope="module")
def net():
    return SpeakerNet.new(output=5, seed=0, device="cpu")


def _assert_verdict_close(got, ref):
    """Speaker ids exactly; confidences are vote sums whose grouping differs
    across dispatch patterns, so rtol 1e-5."""
    if ref is None:
        assert got is None
        return
    assert got is not None and got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)


def _clips(n, seed=0, seconds=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 3000, size=int(44100 * seconds) + 37 * i).astype(np.int16)
            for i in range(n)]


def _feed_interleaved(srv, sids, clips, seed=1, encodings=None):
    """Feed every clip through its stream in random-size interleaved chunks,
    ticking between rounds."""
    rng = np.random.default_rng(seed)
    pos = [0] * len(sids)
    encodings = encodings or [None] * len(sids)
    while any(p < len(c) for p, c in zip(pos, clips)):
        for i, (sid, clip) in enumerate(zip(sids, clips)):
            if pos[i] < len(clip):
                n = int(rng.integers(1, 7000))
                srv.feed(sid, clip[pos[i]:pos[i] + n], encoding=encodings[i])
                pos[i] += n
        srv.tick()


def _oracle(net, *pieces):
    ref = StreamingIdentifier(net, threshold=0.0)
    for p in pieces:
        ref.feed(p)
    return ref.finalize()


def _spy_wires(srv):
    """Record which wire each dispatch used ('f32' | 'i16' | 'u8')."""
    wires = []
    f32, i16, u8 = srv._step, srv._step_i16, srv._step_u8
    srv._step = lambda *a: (wires.append("f32"), f32(*a))[1]
    srv._step_i16 = lambda *a: (wires.append("i16"), i16(*a))[1]
    srv._step_u8 = lambda *a: (wires.append("u8"), u8(*a))[1]
    return wires


# -- G.711 against the JAX package ----------------------------------------------


def test_g711_tables_are_the_jax_packages_bit_for_bit():
    for name in ("ULAW_TABLE", "ALAW_TABLE", "ULAW_TABLE_I16", "ALAW_TABLE_I16"):
        a, b = getattr(g711, name), getattr(jg711, name)
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert set(g711.TABLES) == set(jg711.TABLES) == {"ulaw", "alaw"}
    for enc in g711.TABLES:
        for mine, ref in zip(g711.TABLES[enc], jg711.TABLES[enc]):
            assert np.array_equal(mine, ref)
        assert np.array_equal(g711.decode(ALL_CODES, enc), jg711.decode(ALL_CODES, enc))


@pytest.mark.parametrize("law", ["ulaw", "alaw"])
def test_g711_codec_is_the_jax_packages_bit_for_bit(law):
    """Encode over the whole i16 range and decode of every code."""
    x = np.arange(-32768, 32768, dtype=np.int16)
    enc, jenc = getattr(g711, f"{law}_encode"), getattr(jg711, f"{law}_encode")
    dec, jdec = getattr(g711, f"{law}_decode"), getattr(jg711, f"{law}_decode")
    assert np.array_equal(enc(x), jenc(x))
    assert np.array_equal(dec(ALL_CODES), jdec(ALL_CODES))
    # encode(decode(c)) == c but for mu-law's -0 (0x7F), which re-encodes as +0.
    back = enc(dec(ALL_CODES))
    keep = ALL_CODES != 0x7F if law == "ulaw" else np.ones(256, bool)
    assert np.array_equal(back[keep], ALL_CODES[keep])


def test_g711_spot_values_and_dispatch():
    assert g711.ulaw_decode(np.uint8(0x00)) == -32124
    assert g711.ulaw_decode(np.uint8(0xFF)) == 0
    assert g711.alaw_decode(np.uint8(0xD5)) == 8
    assert g711.alaw_decode(np.uint8(0xAA)) == 32256
    with pytest.raises(ValueError):
        g711.decode(ALL_CODES, "pcm")


# -- the wires on the device side, bit for bit -----------------------------------


def _step_inputs(seed, S=3, k=16):
    rng = np.random.default_rng(seed)
    pcm = rng.normal(0, 6000, (S, k, 400)).clip(-32768, 32767).astype(np.int16)
    n_new = torch.tensor(rng.integers(0, k + 1, S), dtype=torch.int32)
    return pcm, n_new


@pytest.mark.parametrize("law", ["ulaw", "alaw"])
def test_u8_wire_equals_host_decode_bit_for_bit(net, law):
    """The table gather and /32767 on the device give the very bits of the
    f32 step on host-decoded, host-converted PCM: carry, features, mask."""
    pcm, n_new = _step_inputs(1)
    codes = g711.ulaw_encode(pcm) if law == "ulaw" else g711.alaw_encode(pcm)
    carry = tstream.zero_carry(3, net.capacity, "cpu")
    table = torch.as_tensor(g711.TABLES[law][0])
    with torch.no_grad():
        got = tserve.step_u8(net.params, carry, torch.from_numpy(codes), n_new, 5, table)
        host = (g711.decode(codes, law).astype(np.float32) / 32767.0).astype(np.float32)
        want = tstream.stream_step(net.params, carry, torch.from_numpy(host), n_new, 5)
    for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(a, b)


def test_i16_wire_equals_host_conversion_bit_for_bit(net):
    pcm, n_new = _step_inputs(2)
    carry = tstream.zero_carry(3, net.capacity, "cpu")
    from streamz_tpu_torch.dsp.mfcc import _to_f32

    with torch.no_grad():
        got = tserve.step_i16(net.params, carry, torch.from_numpy(pcm), n_new, 5)
        want = tstream.stream_step(net.params, carry, torch.from_numpy(_to_f32(pcm)), n_new, 5)
    for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(a, b)


# -- against the JAX server --------------------------------------------------------


def test_multi_stream_matches_jax_and_single_stream(net):
    """Interleaved feeds on every wire (i16, f32, mu-law, A-law): vote sums
    within rtol 1e-5 of the JAX server's on the same feeds, verdicts the
    same, and each the single-stream identifier's."""
    clips = _clips(4, seed=3, seconds=0.7)
    feeds = [clips[0], clips[1].astype(np.float32) / 32767.0,
             g711.ulaw_encode(clips[2]), g711.alaw_encode(clips[3])]
    encs = [None, None, "ulaw", "alaw"]
    t = MultiStreamIdentifier(net, n_streams=5, threshold=0.0)
    j = JMulti(JNet.new(output=5, seed=0), n_streams=5, threshold=0.0)
    for srv in (t, j):
        sids = [srv.open() for _ in feeds]
        _feed_interleaved(srv, sids, feeds, seed=4, encodings=encs)
    np.testing.assert_allclose(t._carry[4].numpy(), np.asarray(j._carry[4]),
                               rtol=1e-5, atol=1e-6)
    assert np.array_equal(t._carry[6].numpy(), np.asarray(j._carry[6]))
    decoded = [clips[0], clips[1], g711.ulaw_decode(feeds[2]), g711.alaw_decode(feeds[3])]
    for sid, pcm in zip(sids, decoded):
        got = t.finalize(sid)
        ref = j.finalize(sid)
        assert got is not None and got[0] == ref[0]
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)
        _assert_verdict_close(got, _oracle(net, pcm))
    ext = FeatureExtractor("plain", device="cpu")
    assert t.finalize(sids[0])[0] == identify_speaker_with_threshold(net, clips[0], 0.0, ext)


def test_refresh_verdicts_matches_jax_and_readback(net):
    """The one-readback snapshot equals the per-slot readback and the JAX
    server's; it goes stale on a dispatch, and close() zeroes its row so a
    recycled slot never serves the previous stream's verdict."""
    t = MultiStreamIdentifier(net, n_streams=3, threshold=0.0)
    j = JMulti(JNet.new(output=5, seed=0), n_streams=3, threshold=0.0)
    rng = np.random.default_rng(11)
    pcm = [rng.normal(0, 3000, size=44100).astype(np.int16),
           rng.normal(0, 1500, size=22050).astype(np.int16)]
    for srv in (t, j):
        a, b = srv.open(), srv.open()
        srv.feed(a, pcm[0])
        srv.feed(b, pcm[1])
        srv.tick()
    assert t._vcache is None
    exact = {sid: t.current(sid) for sid in (a, b)}
    t.refresh_verdicts()
    j.refresh_verdicts()
    assert t._vcache.shape == (3, net.capacity + 1)
    np.testing.assert_allclose(t._vcache, j._vcache, rtol=1e-5, atol=1e-6)
    for sid in (a, b):
        assert t.current(sid) == exact[sid]
        _assert_verdict_close(t.current(sid), j.current(sid))
    t.feed(a, pcm[1][:4410])
    t.tick()
    assert t._vcache is None
    t.refresh_verdicts()
    assert t.current(a) is not None
    t.close(a)
    assert t.open() == a
    assert t.current(a) is None


# -- the JAX file's cases -----------------------------------------------------------


def test_streams_are_independent(net):
    clip = _clips(1, seed=5)[0]
    alone = MultiStreamIdentifier(net, n_streams=2, threshold=0.0)
    s0 = alone.open()
    alone.feed(s0, clip)
    alone.tick()
    ref = alone.finalize(s0)
    noisy = MultiStreamIdentifier(net, n_streams=2, threshold=0.0)
    a, b = noisy.open(), noisy.open()
    _feed_interleaved(noisy, [a, b], [clip, _clips(1, seed=6, seconds=2.0)[0]])
    _assert_verdict_close(noisy.finalize(a), ref)


def test_slot_reuse_after_close(net):
    clip = _clips(1, seed=7)[0]
    srv = MultiStreamIdentifier(net, n_streams=1, threshold=0.0)
    s0 = srv.open()
    srv.feed(s0, _clips(1, seed=8, seconds=0.5)[0])
    srv.tick()
    srv.finalize(s0)
    srv.close(s0)
    s1 = srv.open()
    assert s1 == s0
    srv.feed(s1, clip)
    srv.tick()
    _assert_verdict_close(srv.finalize(s1), _oracle(net, clip))


def test_rolling_current_empty_tick_and_exhaustion(net):
    srv = MultiStreamIdentifier(net, n_streams=2, threshold=0.0)
    sid = srv.open()
    assert srv.tick() == 0  # nothing buffered: no dispatch
    srv.feed(sid, _clips(1, seed=9)[0])
    assert srv.tick() >= 1
    cur = srv.current(sid)
    assert cur is not None and 0.0 < cur[1] <= 1.0
    with pytest.raises(KeyError):
        srv.current(99)
    srv.open()
    with pytest.raises(RuntimeError, match="all 2 stream slots"):
        srv.open()
    with pytest.raises(ValueError):
        MultiStreamIdentifier(net, n_streams=0)


def test_bounded_tick_and_pending_blocks(net):
    srv = MultiStreamIdentifier(net, n_streams=2, threshold=0.0, block_batch=4)
    sid = srv.open()
    srv.feed(sid, np.zeros(10 * config.HOP_SIZE, np.int16))
    assert srv.pending_blocks() == 10
    assert srv.tick(drain=False) == 1
    assert srv.pending_blocks() == 6
    assert srv.tick() == 2
    assert srv.pending_blocks() == 0


def test_mixed_fleet_wire_policy(net):
    """A mixed fleet ships ONE f32 dispatch, and the downgrade is transient:
    after close/reopen the fleet is back on i16."""
    clips = _clips(3, seed=31, seconds=0.5)
    srv = MultiStreamIdentifier(net, n_streams=3, threshold=0.0)
    sids = [srv.open() for _ in clips]
    wires = _spy_wires(srv)
    srv.feed(sids[0], clips[0].astype(np.float32) / 32767.0)
    srv.feed(sids[1], clips[1])
    srv.feed(sids[2], clips[2])
    srv.tick()
    assert set(wires) == {"f32"}
    for sid, clip in zip(sids, clips):
        _assert_verdict_close(srv.finalize(sid), _oracle(net, clip))
    for sid in sids:
        srv.close(sid)
    wires.clear()
    s = srv.open()
    srv.feed(s, clips[1])
    srv.tick()
    assert wires and set(wires) == {"i16"}


def test_g711_mixed_fleet_downgrades_exactly(net):
    """mu-law + i16 share an i16 dispatch; an f32 slot downgrades to f32;
    mu-law + A-law cannot share a table and ship i16."""
    clips = _clips(3, seed=53, seconds=0.5)

    def fresh(feeds):
        srv = MultiStreamIdentifier(net, n_streams=3, threshold=0.0)
        wires = _spy_wires(srv)
        sids = [srv.open() for _ in feeds]
        for sid, (pcm, enc) in zip(sids, feeds):
            srv.feed(sid, pcm, encoding=enc)
        srv.tick()
        return srv, sids, wires

    srv, sids, wires = fresh([(g711.ulaw_encode(clips[0]), "ulaw"),
                              (clips[1], None), (clips[2], None)])
    assert set(wires) == {"i16"}
    _assert_verdict_close(srv.finalize(sids[0]),
                          _oracle(net, g711.ulaw_decode(g711.ulaw_encode(clips[0]))))
    _, _, wires = fresh([(g711.ulaw_encode(clips[0]), "ulaw"),
                         (clips[1].astype(np.float32) / 32767.0, None), (clips[2], None)])
    assert set(wires) == {"f32"}
    _, _, wires = fresh([(g711.ulaw_encode(clips[0]), "ulaw"),
                         (g711.alaw_encode(clips[1]), "alaw"), (clips[2][:0], None)])
    assert set(wires) == {"i16"}


def test_ulaw_wire_bit_parity_in_the_server(net):
    """mu-law bytes through the server give the very vote bits of feeding
    the host-decoded i16."""
    clips = _clips(2, seed=51, seconds=0.7)
    codes = [g711.ulaw_encode(c) for c in clips]
    u8 = MultiStreamIdentifier(net, n_streams=2, threshold=0.0)
    i16 = MultiStreamIdentifier(net, n_streams=2, threshold=0.0)
    wires = _spy_wires(u8)
    u_sids = [u8.open() for _ in clips]
    d_sids = [i16.open() for _ in clips]
    for i in range(0, max(len(c) for c in codes), 5000):
        for sid, c in zip(u_sids, codes):
            u8.feed(sid, c[i:i + 5000], encoding="ulaw")
        for sid, c in zip(d_sids, codes):
            i16.feed(sid, g711.ulaw_decode(c[i:i + 5000]))
        u8.tick()
        i16.tick()
    assert wires and set(wires) == {"u8"}
    assert torch.equal(u8._carry[4], i16._carry[4])
    for us, ds in zip(u_sids, d_sids):
        assert u8.finalize(us) == i16.finalize(ds)


def test_alaw_bytes_and_midstream_wire_switch(net):
    clip = _clips(1, seed=54, seconds=0.8)[0]
    srv = MultiStreamIdentifier(net, n_streams=1, threshold=0.0)
    wires = _spy_wires(srv)
    sid = srv.open()
    codes = g711.alaw_encode(clip)
    srv.feed(sid, codes.tobytes(), encoding="alaw")  # raw bytes accepted
    srv.tick()
    assert wires and set(wires) == {"u8"}
    _assert_verdict_close(srv.finalize(sid), _oracle(net, g711.alaw_decode(codes)))
    # mu-law bytes, then linear i16 while bytes are still buffered.
    srv.close(sid)
    sid = srv.open()
    half = len(clip) // 2
    u = g711.ulaw_encode(clip[:half])
    srv.feed(sid, u[: half // 2], encoding="ulaw")
    srv.feed(sid, g711.ulaw_decode(u[half // 2:]))
    srv.feed(sid, clip[half:])
    srv.tick()
    _assert_verdict_close(srv.finalize(sid),
                          _oracle(net, np.concatenate([g711.ulaw_decode(u), clip[half:]])))


def test_g711_feed_validation(net):
    srv = MultiStreamIdentifier(net, n_streams=1, threshold=0.0)
    sid = srv.open()
    with pytest.raises(TypeError):  # ambiguous u8 without an encoding
        srv.feed(sid, np.zeros(10, np.uint8))
    with pytest.raises(ValueError):
        srv.feed(sid, np.zeros(10, np.uint8), encoding="g722")
    with pytest.raises(TypeError):  # G.711 chunks must be bytes
        srv.feed(sid, np.zeros(10, np.int16), encoding="ulaw")
    srv.feed(sid, np.zeros(800, np.int16))
    srv.finalize(sid)
    with pytest.raises(RuntimeError, match="already finalized"):
        srv.feed(sid, np.zeros(10, np.int16))


def test_serve_lifecycle_fuzz(net):
    """Random open/feed/tick/finalize/close interleavings: every finalized
    stream matches the single-stream oracle on exactly the audio it was
    fed, across slot reuse, wire mixes and partial ticks."""
    rng = np.random.default_rng(99)
    srv = MultiStreamIdentifier(net, n_streams=3, threshold=0.0)
    live = {}
    checked = 0
    for _ in range(120):
        op = rng.choice(["open", "feed", "tick", "finish"])
        if op == "open" and len(live) < srv.n_slots:
            live[srv.open()] = []
        elif op == "feed" and live:
            sid = int(rng.choice(list(live)))
            pcm = rng.normal(0, 3000, size=int(rng.integers(1, 4000))).astype(np.int16)
            kind = rng.choice(["i16", "f32", "ulaw", "alaw"])
            if kind == "i16":
                srv.feed(sid, pcm)
                live[sid].append(pcm)
            elif kind == "f32":
                srv.feed(sid, pcm.astype(np.float32) / 32767.0)
                live[sid].append(pcm)
            else:
                codes = (g711.ulaw_encode if kind == "ulaw" else g711.alaw_encode)(pcm)
                srv.feed(sid, codes, encoding=kind)
                live[sid].append(g711.decode(codes, kind))
        elif op == "tick":
            srv.tick(drain=bool(rng.integers(0, 2)))
        elif op == "finish" and live:
            sid = int(rng.choice(list(live)))
            _assert_verdict_close(srv.finalize(sid), _oracle(net, *live.pop(sid)))
            srv.close(sid)
            checked += 1
    for sid in list(live):
        _assert_verdict_close(srv.finalize(sid), _oracle(net, *live[sid]))
        checked += 1
    assert checked >= 5


def test_serve_stats_accounting(net):
    """stats() counts exactly what tick() shipped, under the JAX keys."""
    srv = MultiStreamIdentifier(net, n_streams=2, threshold=0.0, block_batch=4)
    j = JMulti(JNet.new(output=5, seed=0), n_streams=2, threshold=0.0, block_batch=4)
    assert srv.stats() == j.stats()
    for s in (srv, j):
        sid = s.open()
        s.feed(sid, np.zeros(6 * config.HOP_SIZE, np.int16))
        assert s.tick() == 2
    st = srv.stats()
    assert st == j.stats()
    assert st["dispatches"] == 2
    assert st["wire_dispatches"] == {"u8": 0, "i16": 2, "f32": 0}
    assert st["bytes_shipped"] == 2 * (2 * 4 * config.HOP_SIZE * 2 + 2 * 4)
    assert st["open_slots"] == 1 and st["n_slots"] == 2
    assert st["pending_blocks"] == 0 and st["buffered_samples"] == 0


def test_update_model_same_capacity_and_growth(net):
    """Mid-stream swaps (same capacity, then a doubling) match the oracle
    doing the same swaps; an untouched slot keeps its meaning; a shrink is
    refused."""
    clip = _clips(1, seed=61, seconds=1.0)[0]
    third = len(clip) // 3
    net2 = SpeakerNet.new(output=5, seed=7, device="cpu")
    grown = SpeakerNet.new(output=5, seed=0, device="cpu")
    grown.ensure_capacity(net.capacity + 1)
    other = _clips(1, seed=63, seconds=0.6)[0]
    srv = MultiStreamIdentifier(net, n_streams=2, threshold=0.0)
    a, b = srv.open(), srv.open()
    srv.feed(a, clip[:third])
    srv.feed(b, other)
    srv.tick()
    srv.update_model(net2)
    srv.feed(a, clip[third:2 * third])
    srv.tick()
    srv.update_model(grown)
    assert srv._carry[4].shape == (2, grown.capacity)
    srv.feed(a, clip[2 * third:])
    srv.tick()
    ref = StreamingIdentifier(net, threshold=0.0)
    ref.feed(clip[:third])
    ref.update_model(net2)
    ref.feed(clip[third:2 * third])
    ref.update_model(grown)
    ref.feed(clip[2 * third:])
    _assert_verdict_close(srv.finalize(a), ref.finalize())
    ref_b = StreamingIdentifier(net, threshold=0.0)
    ref_b.feed(other)
    ref_b.update_model(net2)
    ref_b.update_model(grown)
    _assert_verdict_close(srv.finalize(b), ref_b.finalize())
    with pytest.raises(ValueError):
        MultiStreamIdentifier(grown, n_streams=1).update_model(net)


def test_warm_up_touches_no_live_state(net):
    """warm_up() runs every wire on scratch state: the live carry, the
    counters and the verdicts are those of a server that never ran it."""
    clip = _clips(1, seed=71, seconds=0.5)[0]
    warm, cold = (MultiStreamIdentifier(net, n_streams=2, threshold=0.0) for _ in range(2))
    sid = warm.open()
    warm.feed(sid, clip[:5000])
    warm.tick()
    warm.warm_up()
    assert warm.stats()["dispatches"] == 1
    assert warm._stage._i == 0 and cold._stage._i == 0
    cold.open()
    cold.feed(sid, clip[:5000])
    cold.tick()
    for a, b in zip(warm._carry, cold._carry):
        assert torch.equal(a, b)
    for srv in (warm, cold):
        srv.feed(sid, clip[5000:])
    assert warm.finalize(sid) == cold.finalize(sid)
