"""Streaming identification on the port (app/stream.py) against the JAX
package's ``StreamingIdentifier`` and against the offline frontend.

Streaming is a latency mode, not an approximation: after ``finalize()``
the streamed features equal the offline pipeline's on the same PCM for any
chunking, and the verdicts equal the JAX package's.  Features are held to
1e-5 (the CPU's f32 products in another blocking), vote sums to rtol 1e-5,
verdicts exactly.  Both packages start from the same seeded weights.
"""

import numpy as np
import pytest
import torch

from streamz_tpu.app.stream import StreamingIdentifier as JStream
from streamz_tpu.dsp.mfcc import extract_features as jextract
from streamz_tpu.nn.model import SpeakerNet as JNet
from streamz_tpu_torch.app import stream as tstream
from streamz_tpu_torch.app.stream import StreamingIdentifier
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.dsp.mfcc import extract_features
from streamz_tpu_torch.infer.identify import (
    identify_speaker,
    identify_speaker_with_threshold,
)
from streamz_tpu_torch.io import g711
from streamz_tpu_torch.nn.model import SpeakerNet

TOL = 1e-5


@pytest.fixture(scope="module")
def nets():
    return SpeakerNet.new(output=5, seed=0, device="cpu"), JNet.new(output=5, seed=0)


def _clip(seed, n):
    return np.random.default_rng(seed).normal(0, 3000, size=n).astype(np.int16)


def _stream(cls, net, clip, chunks, **kw):
    sid = cls(net, collect_features=True, **kw)
    i = 0
    for n in chunks:
        sid.feed(clip[i:i + n])
        i += n
    if i < len(clip):
        sid.feed(clip[i:])
    return sid


def _assert_verdict_close(got, ref):
    if ref is None:
        assert got is None
        return
    assert got is not None and got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=TOL)


def test_streamed_features_match_jax_and_offline(nets):
    tnet, jnet = nets
    rng = np.random.default_rng(0)
    clip = rng.normal(0, 3000, size=5 * 44100 + 123).astype(np.int16)
    chunks = rng.integers(1, 5000, size=200).tolist()
    t = _stream(StreamingIdentifier, tnet, clip, chunks, threshold=0.0)
    j = _stream(JStream, jnet, clip, chunks, threshold=0.0)
    _assert_verdict_close(t.finalize(), j.finalize())
    out = t.streamed_features()
    ref = extract_features(clip, device="cpu")
    assert out.shape == ref.shape == j.streamed_features().shape
    np.testing.assert_allclose(out, ref, atol=TOL)
    np.testing.assert_allclose(out, j.streamed_features(), atol=TOL)
    np.testing.assert_allclose(out, jextract(clip), atol=TOL)
    # The carried vote sums and count, not only the verdict.
    np.testing.assert_allclose(t._carry[4][0].numpy(), np.asarray(j._carry[4]), rtol=TOL)
    assert int(t._carry[6][0]) == int(j._carry[6]) == len(ref)


def test_final_verdict_matches_offline_voting(nets):
    tnet, jnet = nets
    clip = _clip(1, 2 * 44100)
    speaker, conf = _stream(StreamingIdentifier, tnet, clip, [len(clip)],
                            threshold=0.0).finalize()
    ext = FeatureExtractor("plain", device="cpu")
    assert speaker == identify_speaker(tnet, clip, ext)
    assert speaker == identify_speaker_with_threshold(tnet, clip, 0.0, ext)
    assert 0.0 < conf <= 1.0
    _assert_verdict_close((speaker, conf),
                          _stream(JStream, jnet, clip, [len(clip)], threshold=0.0).finalize())


def test_chunking_invariance(nets):
    """Same PCM through wildly different chunkings: the same results."""
    tnet, _ = nets
    clip = _clip(2, 44100)
    a = _stream(StreamingIdentifier, tnet, clip, [len(clip)], threshold=0.0)
    b = _stream(StreamingIdentifier, tnet, clip, [7] * 1000, threshold=0.0)
    _assert_verdict_close(a.finalize(), b.finalize())
    np.testing.assert_allclose(a.streamed_features(), b.streamed_features(), atol=TOL)


@pytest.mark.parametrize("n", [0, 100, 800, 1200, 1600, 4000])
def test_tiny_streams_match_offline(nets, n):
    tnet, jnet = nets
    clip = _clip(n, n)
    chunks = [max(n // 3, 1)] * 3
    t = _stream(StreamingIdentifier, tnet, clip, chunks, threshold=0.0)
    j = _stream(JStream, jnet, clip, chunks, threshold=0.0)
    _assert_verdict_close(t.finalize(), j.finalize())
    out, ref = t.streamed_features(), extract_features(clip, device="cpu")
    assert out.shape == ref.shape == j.streamed_features().shape
    if ref.size:
        np.testing.assert_allclose(out, ref, atol=TOL)
        np.testing.assert_allclose(out, j.streamed_features(), atol=TOL)


def test_rolling_verdict_available_mid_stream(nets):
    tnet, jnet = nets
    clip = _clip(3, 44100)
    t = StreamingIdentifier(tnet, threshold=0.0)
    j = JStream(jnet, threshold=0.0)
    for s in (t, j):
        s.feed(clip[:22050])
    mid = t.current()
    assert mid is not None  # enough finalized frames for a verdict
    _assert_verdict_close(mid, j.current())
    for s in (t, j):
        s.feed(clip[22050:])
    _assert_verdict_close(t.finalize(), j.finalize())


def test_single_speaker_net_returns_none():
    # output_size <= 1 -> None (src/lib.rs:1311-1315)
    sid = StreamingIdentifier(SpeakerNet.new(output=1, seed=0, device="cpu"), threshold=0.0)
    sid.feed(_clip(4, 8000))
    assert sid.finalize() is None


def test_threshold_gates_verdict(nets):
    sid = StreamingIdentifier(nets[0], threshold=1.01)  # impossible confidence
    sid.feed(_clip(5, 8000))
    assert sid.finalize() is None


def test_feed_after_finalize_raises(nets):
    """A post-finalize feed or model swap raises, also under python -O."""
    s = StreamingIdentifier(nets[0], threshold=0.0)
    s.feed(_clip(0, 12000))
    s.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        s.feed(np.zeros(400, np.int16))
    with pytest.raises(RuntimeError, match="finalized"):
        s.update_model(nets[0])


def test_update_model_growth_matches_jax_and_refuses_shrink():
    """A mid-stream swap to a grown model pads the vote carries; the votes
    and the verdict equal the JAX package's doing the same swap.  A shrink
    is refused."""
    clip = _clip(62, 44100)
    half = len(clip) // 2
    out = []
    for cls, net_cls, kw in ((StreamingIdentifier, SpeakerNet, {"device": "cpu"}),
                             (JStream, JNet, {})):
        net = net_cls.new(output=5, seed=0, **kw)
        grown = net_cls.new(output=5, seed=0, **kw)
        grown.ensure_capacity(net.capacity + 1)  # a capacity doubling
        assert grown.capacity > net.capacity
        s = cls(net, threshold=0.0)
        s.feed(clip[:half])
        s.update_model(grown)
        s.feed(clip[half:])
        out.append((s.finalize(), np.asarray(s._carry[4]).reshape(-1), s))
        with pytest.raises(ValueError, match="shrank"):
            cls(grown, threshold=0.0).update_model(net)
    (tv, tvotes, t), (jv, jvotes, _) = out
    assert tvotes.shape == jvotes.shape == (t.net.capacity,)
    np.testing.assert_allclose(tvotes, jvotes, rtol=TOL, atol=1e-6)
    _assert_verdict_close(tv, jv)


def test_g711_feed_equals_host_decoded(nets):
    clip = _clip(55, 22050)
    for enc, encode in (("ulaw", g711.ulaw_encode), ("alaw", g711.alaw_encode)):
        codes = encode(clip)
        a = StreamingIdentifier(nets[0], threshold=0.0)
        a.feed(codes.tobytes(), encoding=enc)
        b = StreamingIdentifier(nets[0], threshold=0.0)
        b.feed(g711.decode(codes, enc))
        assert a.finalize() == b.finalize()


def test_feed_reads_nothing_back(nets, monkeypatch):
    """``feed`` enqueues its dispatches and reads no tensor back to the host
    (the CPU stand-in for the card's sync check): every host read a tensor
    offers raises while it runs."""
    s = StreamingIdentifier(nets[0], threshold=0.0)
    s.feed(_clip(6, 4000))  # first use builds the constants

    def no_read(*_a, **_k):
        raise AssertionError("host read inside feed")

    for name in ("cpu", "item", "tolist", "__bool__", "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    s.feed(_clip(7, 30000))
    monkeypatch.undo()
    assert s.current() is not None


def test_step_is_one_function_of_the_slot_axis(nets):
    """Two streams through one S = 2 step equal each through its own S = 1
    step: the batched step does not mix slots."""
    tnet = nets[0]
    rng = np.random.default_rng(8)
    blocks = torch.from_numpy(rng.normal(0, 0.1, (2, 16, 400)).astype(np.float32))
    n_new = torch.tensor([16, 5], dtype=torch.int32)
    carry = tstream.zero_carry(2, tnet.capacity, "cpu")
    with torch.no_grad():
        both, feats, vmask = tstream.stream_step(tnet.params, carry, blocks, n_new, 5)
        for s in range(2):
            one, f1, m1 = tstream.stream_step(
                tnet.params, tuple(c[s:s + 1] for c in carry), blocks[s:s + 1],
                n_new[s:s + 1], 5)
            for a, b in zip(both, one):
                torch.testing.assert_close(a[s:s + 1], b, rtol=0, atol=1e-6)
            torch.testing.assert_close(vmask[s:s + 1], m1, rtol=0, atol=0)
