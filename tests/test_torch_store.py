"""The port's DeviceFeatureStore and its consumers, against the JAX package.

The store keeps the frontend's outputs on the device; the discovery loop,
the pooled embeddings, ``--eval`` and finalize gather their rows there.
A gathered row must equal the host zero-packed row bit for bit (the
frontend zeroes every frame past a clip's window count), so every consumer
gives the same bits with the store as without it; the JAX package's
``tests/test_device_store.py`` holds its store to the same contract, and
these tests mirror it on one device (the mesh cases are not ported).
Across the two packages the labels are identical and the centroids agree
within rtol 1e-3 / atol 1e-5, as ``tests/test_torch_discovery.py`` holds
the discovery loop.
"""

import numpy as np
import pytest
import torch

from streamz_tpu.app import incremental as jinc
from streamz_tpu.dsp import mfcc as jmfcc
from streamz_tpu.nn import drivers as jdrivers
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch import config
from streamz_tpu_torch.app import incremental as tinc
from streamz_tpu_torch.dsp import mfcc as tmfcc
from streamz_tpu_torch.dsp.mfcc import DeviceFeatureStore, extract_features_batch
from streamz_tpu_torch.infer.embed import batch_clip_embeddings
from streamz_tpu_torch.nn import drivers as tdrivers
from streamz_tpu_torch.nn import model as tmodel


def _clips(rng, n=6):
    # Mixed lengths across several frontend buckets, one shorter than a window.
    lens = [4000, 9000, 4000, 22000, 700, 9000][:n]
    return [rng.normal(0, 0.2, size=(n_,)).astype(np.float32) for n_ in lens]


def _feature_corpus(rng, n_files, n_clusters, windows_per_file=8, dim=60):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 2.0
    files, fm = [], {}
    for i in range(n_files):
        wins = (centers[i % n_clusters]
                + rng.normal(0, 0.3, size=(windows_per_file, dim))).astype(np.float32)
        files.append((f"clip_{i}.wav", None))
        fm[f"clip_{i}.wav"] = wins
    return files, fm


def _synthetic_store(fm, paths, bucket_w=None, store=None):
    """A store whose buckets hold the feature map's windows directly, one
    bucket per window count, zero-padded to ``bucket_w`` frames when given
    (as a frontend bucket is wider than its clips)."""
    store = DeviceFeatureStore() if store is None else store
    by_w: dict = {}
    for i, p in enumerate(paths):
        by_w.setdefault(fm[p].shape[0], []).append(i)
    for w, idxs in by_w.items():
        batch = np.zeros((len(idxs), bucket_w or w, fm[paths[idxs[0]]].shape[1]), np.float32)
        for r, i in enumerate(idxs):
            batch[r, :w] = fm[paths[i]]
        store.add_bucket(torch.from_numpy(batch), idxs, [w] * len(idxs))
    store.rekey({i: p for i, p in enumerate(paths)})
    return store


def test_store_rows_match_host_outputs():
    """Each clip's rows in its bucket are its host features, bit for bit,
    and its frames past the window count are exact zeros."""
    clips = _clips(np.random.default_rng(0))
    store = DeviceFeatureStore()
    feats = extract_features_batch(clips, device="cpu", store=store)
    for i, clip in enumerate(clips):
        bid, row, n_win = store.lookup(i)
        assert n_win == tmfcc.window_count_host(len(clip)) == len(feats[i])
        got = store.bucket(bid)[row].numpy()
        assert np.array_equal(got[:n_win], feats[i])
        assert not got[n_win:].any()
    # The same features as the JAX frontend's host copies (1e-4, the plain
    # formulation against XLA's).
    for t, j in zip(feats, jmfcc.extract_features_batch(clips)):
        np.testing.assert_allclose(t, j, atol=1e-4)


def test_store_rekey_and_release():
    store = DeviceFeatureStore()
    extract_features_batch(_clips(np.random.default_rng(1), n=3), device="cpu", store=store)
    store.rekey({0: "a.wav", 1: "b.wav", 2: "c.wav"})
    assert store.lookup("b.wav") is not None
    assert store.lookup(1) is None
    store.release()
    assert store.lookup("a.wav") is None and store._bytes == 0


@pytest.mark.parametrize("missing", [[], [1], [0, 2, 3]])
def test_gather_partial_equals_host_packing(missing):
    """Hits gathered on the device, misses listed and repaired by
    ``scatter_rows``: bit for bit the host zero-packed batch, rows past the
    keys zero; ``stats`` meters the misses only."""
    rng = np.random.default_rng(2)
    files, fm = _feature_corpus(rng, 5, 2)
    for i, (p, _) in enumerate(files):
        fm[p] = fm[p][: 3 + i]
    paths = [p for p, _ in files]
    store = _synthetic_store(fm, [p for i, p in enumerate(paths) if i not in missing],
                             bucket_w=16)
    w_pad, n_rows = 8, 8
    want = np.zeros((n_rows, w_pad, 60), np.float32)
    for r, p in enumerate(paths):
        want[r, : len(fm[p])] = fm[p]
    wins, misses = store.gather_partial(paths, w_pad, n_rows=n_rows)
    assert [r for r, _ in misses] == missing
    pack = np.zeros((len(misses), w_pad, 60), np.float32)
    for j, (r, key) in enumerate(misses):
        pack[j, : len(fm[key])] = fm[key]
    wins = store.scatter_rows(wins, pack, [r for r, _ in misses])
    assert np.array_equal(wins.numpy(), want)
    assert store.stats["host_pack_rows"] == len(missing)
    assert store.stats["host_pack_bytes"] == len(missing) * w_pad * 60 * 4


def test_gather_all_or_nothing():
    clips = _clips(np.random.default_rng(42), n=3)
    store = DeviceFeatureStore()
    feats = extract_features_batch(clips, device="cpu", store=store)
    w_pad = config.next_pow2(max(len(f) for f in feats))
    wins = store.gather([0, 1, 2], w_pad)
    assert wins.shape == (3, w_pad, 60)
    for i, f in enumerate(feats):
        assert np.array_equal(wins[i, : len(f)].numpy(), f)
        assert not wins[i, len(f):].any()
    assert store.gather([0, 1, 99], w_pad) is None
    assert store.gather_partial([98, 99], w_pad) == (None, [(0, 98), (1, 99)])


def test_store_max_bytes_cap():
    """A bucket past the cap is dropped and metered; its clips miss."""
    a = torch.zeros((2, 4, 60))
    store = DeviceFeatureStore(max_bytes=a.numel() * 4)
    store.add_bucket(a, [0, 1], [4, 4])
    store.add_bucket(torch.zeros((2, 4, 60)), [2, 3], [4, 4])
    assert store.lookup(0) is not None and store.lookup(2) is None
    assert store.stats["dropped_buckets"] == 1
    assert store.stats["dropped_bytes"] == a.numel() * 4


# ---------------------------------------------------------------------------
# The discovery loop with and without the store.
# ---------------------------------------------------------------------------


def _run_loop(files, fm, device_store=None, **kw):
    tdrivers._key_counter[0] = 1000  # the same keys in every run
    net = tmodel.SpeakerNet.new(output=1, seed=0, device="cpu")
    fs = list(files)
    res = tinc.run_incremental(net, fs, dict(fm), show_progress=False,
                               device_store=device_store, **kw)
    return net, [c for _, c in fs], res


def _assert_bit_identical(a, b):
    (net_a, labels_a, res_a), (net_b, labels_b, res_b) = a, b
    assert labels_a == labels_b
    assert res_a.decision_margins == res_b.decision_margins
    for k in net_a.params:
        assert torch.equal(net_a.params[k], net_b.params[k]), k
    for sid, c in res_a.speaker_embeddings.items():
        assert np.array_equal(res_b.speaker_embeddings[sid], c)


@pytest.mark.parametrize("missing", [set(), {5}, {2, 5, 9}, "all"])
def test_loop_with_store_bit_identical(missing):
    """Labels, parameters, centroids and margins equal the loop without a
    store bit for bit, with the misses packed on the host and metered
    (one row of w_pad = 8 windows each)."""
    rng = np.random.default_rng(41)
    files, fm = _feature_corpus(rng, 12, 3)
    files[0] = (files[0][0], 0)
    paths = [p for p, _ in files]
    if missing == "all":
        # The cap refuses every bucket.
        store = _synthetic_store(fm, paths, store=DeviceFeatureStore(max_bytes=1))
        missing = set(range(len(paths)))
    else:
        store = _synthetic_store(fm, [p for i, p in enumerate(paths) if i not in missing],
                                 bucket_w=64)
    kw = dict(burn_in_limit=3, conf_threshold=0.8, epochs=1)
    _assert_bit_identical(_run_loop(files, fm, **kw),
                          _run_loop(files, fm, device_store=store, **kw))
    assert store.stats["host_pack_rows"] == len(missing)
    assert store.stats["host_pack_bytes"] == len(missing) * 8 * 60 * 4


def test_loop_store_labels_match_jax(monkeypatch):
    """Through the real frontend on the same clips: the port's loop fed
    from its store against the JAX loop fed from the JAX store.  Labels
    identical, centroids rtol 1e-3 / atol 1e-5, and the port's run with the
    store bit-identical to its run without one."""
    rng = np.random.default_rng(7)
    voices = rng.normal(size=(3, 40)).astype(np.float32)
    t = np.arange(9000) / config.DEFAULT_SAMPLE_RATE
    clips = []
    for i in range(9):
        f0 = 120.0 + 60.0 * (i % 3)
        x = sum(np.exp(-0.3 * h) * np.sin(2 * np.pi * f0 * (h + 1) * t + voices[i % 3, h])
                for h in range(12))
        clips.append((x / np.abs(x).max() * 0.5 + rng.normal(0, 0.01, t.shape))
                     .astype(np.float32))
    paths = [f"v{i}.wav" for i in range(9)]
    tstore, jstore = DeviceFeatureStore(), jmfcc.DeviceFeatureStore()
    tfeats = extract_features_batch(clips, device="cpu", store=tstore)
    jfeats = jmfcc.extract_features_batch(clips, store=jstore)
    for s in (tstore, jstore):
        s.rekey(dict(enumerate(paths)))
    files = [(p, 0 if i == 0 else None) for i, p in enumerate(paths)]
    kw = dict(burn_in_limit=2, conf_threshold=0.8, dropout=0.2)
    t_ref = _run_loop(files, dict(zip(paths, tfeats)), **kw)
    t_run = _run_loop(files, dict(zip(paths, tfeats)), device_store=tstore, **kw)
    _assert_bit_identical(t_ref, t_run)
    monkeypatch.setattr(jdrivers, "_key_counter", [1000])
    jnet = jmodel.SpeakerNet.new(output=1, seed=0)
    jf = list(files)
    jres = jinc.run_incremental(jnet, jf, dict(zip(paths, jfeats)), show_progress=False,
                                device_store=jstore, **kw)
    _, t_labels, t_res = t_run
    assert t_labels == [c for _, c in jf]
    assert len(set(t_labels)) > 1
    assert tstore.stats["host_pack_rows"] == 0 == jstore.stats["host_pack_rows"]
    finite = [m for m in t_res.decision_margins if np.isfinite(m)]
    print(f"smallest decision margin: {min(finite) if finite else 'none decided'}")
    for sid, c in jres.speaker_embeddings.items():
        np.testing.assert_allclose(t_res.speaker_embeddings[sid], c, rtol=1e-3, atol=1e-5)


def test_batch_embeddings_with_store_bit_identical():
    """The pooled-embedding buckets: every hit gathered, the misses
    scattered in, a bucket without a hit packed whole; the embeddings equal
    those without a store bit for bit."""
    rng = np.random.default_rng(42)
    files, fm = _feature_corpus(rng, 10, 3, windows_per_file=6)
    for i, (p, _) in enumerate(files[:4]):
        fm[p] = fm[p][: 2 + i]
    paths = [p for p, _ in files]
    net = tmodel.SpeakerNet.new(output=3, seed=1, device="cpu")
    store = _synthetic_store(fm, [p for p in paths if p not in paths[5:7] + paths[:1]],
                             bucket_w=32)
    ref = batch_clip_embeddings(net, [fm[p] for p in paths])
    got = batch_clip_embeddings(net, [fm[p] for p in paths], store=store, keys=paths)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    # paths[0] is alone in its window bucket (2 windows): packed whole,
    # unmetered; paths[5] and paths[6] share the 6-window bucket with hits.
    assert store.stats["host_pack_rows"] == 2


def test_compute_speaker_embeddings_with_store(tmp_path, monkeypatch):
    """Finalize's centroid recompute gathers the map-sourced clips from the
    store: the same stats bit for bit; a clip from the feature cache misses."""
    from streamz_tpu_torch.dsp.features import save_cached_features
    from streamz_tpu_torch.infer.cosine import compute_speaker_embeddings

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(11)
    files, fm = _feature_corpus(rng, 9, 3, windows_per_file=6)
    paths = [p for p, _ in files]
    net = tmodel.SpeakerNet.new(output=3, seed=4, device="cpu")
    for i, p in enumerate(paths):
        net.record_training_file(i % 3, p)
    ref = compute_speaker_embeddings(net, feature_map=fm)
    import shutil

    shutil.rmtree("feature_cache")
    save_cached_features(paths[4], fm[paths[4]])
    store = _synthetic_store(fm, paths)
    got = compute_speaker_embeddings(net, feature_map=fm, store=store)
    for (m1, a1, s1), (m2, a2, s2) in zip(ref, got):
        assert np.array_equal(m1, m2) and a1 == a2 and s1 == s2
    assert store.stats["host_pack_rows"] == 1  # the cache-sourced clip


# ---------------------------------------------------------------------------
# The host oracle.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(burn_in_limit=4, conf_threshold=0.8),
    dict(burn_in_limit=12, conf_threshold=0.99, max_speakers=4),
])
def test_run_incremental_host_matches_jax(monkeypatch, kw):
    """The host-stepped loop of both packages on the same corpus and keys:
    labels identical, centroids rtol 1e-3 / atol 1e-5, parameters 1e-4."""
    rng = np.random.default_rng(0)
    files, fm = _feature_corpus(rng, 16, 3, windows_per_file=12)
    files[0] = (files[0][0], 0)
    seeds = [(np.ones(256, np.float32) / 16.0, 0.9, 0.05)]
    jnet = jmodel.SpeakerNet.new(output=1, seed=0)
    tnet = tmodel.SpeakerNet.new(output=1, seed=0, device="cpu")
    jnet.set_embeddings(seeds)
    tnet.set_embeddings(seeds)
    monkeypatch.setattr(jdrivers, "_key_counter", [0])
    monkeypatch.setattr(tdrivers, "_key_counter", [0])
    jf, tf = list(files), list(files)
    jr = jinc.run_incremental_host(jnet, jf, dict(fm), show_progress=False, dropout=0.2, **kw)
    tr = tinc.run_incremental_host(tnet, tf, dict(fm), show_progress=False, dropout=0.2, **kw)
    assert [c for _, c in tf] == [c for _, c in jf]
    assert tnet.output_size() == jnet.output_size() > 1
    assert tnet.file_lists == jnet.file_lists
    assert tr.processed == jr.processed == len(files)
    assert set(tr.speaker_embeddings) == set(jr.speaker_embeddings)
    for sid, c in jr.speaker_embeddings.items():
        np.testing.assert_allclose(tr.speaker_embeddings[sid], c, rtol=1e-3, atol=1e-5)
    assert abs(tr.total_loss - jr.total_loss) <= 1e-3 * max(1.0, abs(jr.total_loss))
    ns = tnet.num_speakers
    for k, v in jnet.params.items():
        t, j = tnet.params[k].numpy(), np.asarray(v)
        if k in ("w3", "b3"):
            t, j = t[..., :ns], j[..., :ns]
        np.testing.assert_allclose(t, j, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# The CLI's build_feature_map: the store it returns, its cap and its pins.
# ---------------------------------------------------------------------------


def _wav_paths(tmp_path, n=4, seed=14):
    from streamz_tpu.io import wav

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        pcm = (rng.normal(0, 0.1, size=(4000 + 1500 * i,)) * 20000).astype(np.int16)
        paths.append(str(tmp_path / f"f{i}.wav"))
        wav.write_wav(paths[-1], pcm, config.DEFAULT_SAMPLE_RATE)
    return paths


@pytest.mark.parametrize("cap", ["0", "-1", "64", "not a number", None])
def test_build_feature_map_store_and_its_cap(tmp_path, monkeypatch, cap):
    """A path-keyed store whose rows are the feature map's, unless
    STREAMZ_STORE_MAX_MB is 0 or less; the feature map is the JAX CLI's
    (1e-4, the plain frontend against XLA's)."""
    from streamz_tpu.cli import build_feature_map as jbuild
    from streamz_tpu.dsp.features import FeatureExtractor as JExtractor
    from streamz_tpu_torch.cli import build_feature_map
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.runtime.profiler import PhaseTimer

    paths = _wav_paths(tmp_path)
    if cap is None:
        monkeypatch.delenv("STREAMZ_STORE_MAX_MB", raising=False)
    else:
        monkeypatch.setenv("STREAMZ_STORE_MAX_MB", cap)
    timer = PhaseTimer()
    fmap, store = build_feature_map(paths, FeatureExtractor(device="cpu"), timer)
    assert set(timer.phases) == {"ingest", "features"}
    jmap, jstore = jbuild(paths, JExtractor("jax"), keep_device=True)
    assert (store is None) == (jstore is None) == (cap in ("0", "-1"))
    for p in paths:
        np.testing.assert_allclose(fmap[p], jmap[p], atol=1e-4)
        if store is not None:
            bid, row, n_win = store.lookup(p)
            assert n_win == len(fmap[p])
            assert np.array_equal(store.bucket(bid)[row, :n_win].numpy(), fmap[p])
    numpy_store = build_feature_map(paths, FeatureExtractor("numpy", device="cpu"),
                                    PhaseTimer())[1]
    assert numpy_store is None


def test_build_feature_map_pins_only_store_paths(tmp_path):
    """--eval's pins: only the kept clips' buckets are resident, and every
    clip is in the feature map."""
    from streamz_tpu_torch.cli import build_feature_map
    from streamz_tpu_torch.dsp.features import FeatureExtractor
    from streamz_tpu_torch.runtime.profiler import PhaseTimer

    paths = _wav_paths(tmp_path)
    keep = set(paths[2:])
    fmap, store = build_feature_map(paths, FeatureExtractor(device="cpu"), PhaseTimer(),
                                    store_paths=keep)
    for p in paths:
        hit = store.lookup(p)
        assert (hit is not None) == (p in keep)
        if hit is not None:
            bid, row, n_win = hit
            assert np.array_equal(store.bucket(bid)[row, :n_win].numpy(), fmap[p])
    assert sum(int(b.shape[0]) for b in store._buckets) == len(keep)
    store.release()
    assert store.lookup(paths[3]) is None
