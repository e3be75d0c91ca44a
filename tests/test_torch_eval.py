"""The evaluation and inspection modules of the port against the JAX package.

``evaluate`` (``--eval``), the threefry twins of ``jax.random.permutation``
and ``jax.random.randint``, the cosine k-means of ``--cluster-embeddings``,
and the ``identify_speaker`` variants.  The same inputs, made from a seed
with numpy, go through both packages on the CPU.  Counts, ids and labels
must be equal; the PRNG draws bit for bit; vote sums within 1e-5 (f32 sums
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamz_tpu.app import evaluate as jeval
from streamz_tpu.infer import cluster as jcluster
from streamz_tpu.infer import cosine as jcos
from streamz_tpu.infer import embed as jembed
from streamz_tpu.infer import identify as jidentify
from streamz_tpu.nn import checkpoint as jckpt
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch.app import evaluate as teval
from streamz_tpu_torch.dsp.features import FeatureExtractor
from streamz_tpu_torch.infer import cluster as tcluster
from streamz_tpu_torch.infer import cosine as tcos
from streamz_tpu_torch.infer import embed as tembed
from streamz_tpu_torch.infer import identify as tidentify
from streamz_tpu_torch.nn import checkpoint as tckpt
from streamz_tpu_torch.nn import prng
from test_torch_store import _feature_corpus, _synthetic_store


def _both_nets(tmp_path, output, seed, hidden=(32, 16), class_feats=None):
    """A JAX net and the port's load of its checkpoint.  With
    ``class_feats`` (one window set per class) each class's ``w3`` column
    is set to its windows' mean tanh-h2, so that the classes' clips vote
    for their own class."""
    jnet = jmodel.SpeakerNet.new(60, *hidden, output, seed=seed)
    if class_feats is not None:
        w3 = np.array(jnet.params["w3"])
        for c, f in enumerate(class_feats):
            h2 = np.asarray(jmodel.embed(jnet.params, jnp.asarray(f))).mean(axis=0)
            w3[:, c] = 4.0 * h2 / np.linalg.norm(h2)
        jnet.params = dict(jnet.params, w3=jnp.asarray(w3))
    jckpt.save(jnet, str(tmp_path / "m.npz"))
    return jnet, tckpt.load(str(tmp_path / "m.npz"), device="cpu")


@pytest.mark.parametrize("with_store", [False, True])
@pytest.mark.parametrize("threshold", [0.2, 0.997])
def test_evaluate_matches_jax(tmp_path, with_store, threshold):
    """The metrics dict equals JAX's on the same model and features, with
    the port's store on and off; the counts cover hits, misses and
    unclassified files."""
    rng = np.random.default_rng(10)
    files, fm = _feature_corpus(rng, 12, 3, windows_per_file=7)
    paths = [p for p, _ in files]
    jnet, tnet = _both_nets(tmp_path, 3, 3)
    embs = jembed.batch_clip_embeddings(jnet, [fm[p] for p in paths])
    cents = [(jembed.normalize(np.mean(embs[i::3], axis=0)), 0.9, 0.05) for i in range(3)]
    jnet.set_embeddings(cents)
    tnet.set_embeddings(cents)
    # One target whose features are missing: logged and counted in the total.
    targets = [(p, (i + (i == 4)) % 3) for i, p in enumerate(paths)] + [("gone.wav", 1)]
    want = jeval.evaluate(jnet, fm, targets, threshold, verbose=False)
    store = _synthetic_store(fm, paths) if with_store else None
    got = teval.evaluate(tnet, fm, targets, threshold, verbose=False, store=store)
    assert got == want
    assert want["correct"] > 0
    if threshold == 0.2:
        assert want["false_positive"] > 0
    else:
        assert want["false_negative"] > 0
    if with_store:
        assert store.stats["host_pack_bytes"] == 0


@pytest.mark.parametrize("split", [0.0, 0.25, 0.5, 1.0, 3.0])
def test_eval_targets_match_jax(tmp_path, monkeypatch, split):
    """--eval-split: the tail of the labelled training entries when there
    is no target list, the list itself when there is; both from the
    in-memory lists and from the files."""
    from streamz_tpu.io import filelists as jfl

    monkeypatch.chdir(tmp_path)
    train = [(f"t{i}.wav", None if i % 3 == 2 else i % 2) for i in range(9)]
    assert (teval.resolve_eval_targets(train, [], split)
            == jeval.resolve_eval_targets(train, [], split))
    assert teval.resolve_eval_targets(train, [("x.wav", 1)], split) == [("x.wav", 1)]
    jfl.write_train_files("train_files.txt", train)
    assert (teval.build_eval_targets("train_files.txt", "none.txt", split)
            == jeval.build_eval_targets("train_files.txt", "none.txt", split))


# ---------------------------------------------------------------------------
# The threefry twins and the k-means.
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 42, 2**31 + 5, 2**32 - 1]


@pytest.mark.parametrize("n", [1, 2, 7, 64, 128, 1000, 1700])
def test_permutation_matches_jax(n):
    """Bit for bit for several keys (n = 1700 takes two sort rounds)."""
    for seed in SEEDS:
        for key_j, key_t in ((jax.random.PRNGKey(seed), prng.PRNGKey(seed)),
                             (jax.random.fold_in(jax.random.PRNGKey(seed), 9),
                              prng.fold_in(prng.PRNGKey(seed), 9))):
            want = np.asarray(jax.random.permutation(key_j, n))
            assert np.array_equal(prng.permutation(key_t, n).numpy(), want)


def test_permutation_keeps_order_on_tied_keys(monkeypatch):
    """Two elements that draw the same 32-bit sort key keep their order, as
    JAX's stable ``sort_key_val`` keeps it."""
    monkeypatch.setattr(prng, "random_bits",
                        lambda key, shape: torch.tensor([5, 3, 5, 3, 1], dtype=torch.int64))
    assert prng.permutation(prng.PRNGKey(0), 5).tolist() == [4, 1, 3, 0, 2]


@pytest.mark.parametrize("n", [1, 2, 7, 64, 128, 1000])
def test_randint_matches_jax(n):
    """int32 draws bit for bit, spans small, past 2**16 (the wrapping
    multiplier) and empty."""
    for seed in SEEDS:
        key_j, key_t = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for lo, hi in ((0, n), (-5, n), (3, 3), (10, 2), (0, 70_000),
                       (0, 2**31 - 1), (-2**31, 2**31 - 1)):
            want = np.asarray(jax.random.randint(key_j, (n,), lo, hi))
            got = prng.randint(key_t, (n,), lo, hi)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), (seed, lo, hi)
        want = np.asarray(jax.random.randint(key_j, (2, 3), 0, n))
        assert np.array_equal(prng.randint(key_t, (2, 3), 0, n).numpy(), want)


def _embeddings(rng, n, k, dim=64, noise=0.1):
    centers = rng.normal(size=(k, dim)).astype(np.float32)
    return np.stack([centers[i % k] + noise * rng.normal(size=dim)
                     for i in range(n)]).astype(np.float32)


@pytest.mark.parametrize("k", [0, 1, 3, 8])
@pytest.mark.parametrize("iterations", [1, 20])
def test_cluster_embeddings_match_jax(k, iterations):
    """The labels of JAX's k-means for several seeds, on well-separated
    embeddings, on a set whose duplicates leave a cluster empty (reseeded
    by a randint draw), and with a zero-norm embedding."""
    rng = np.random.default_rng(k * 31 + iterations)
    sets = {
        "separated": _embeddings(rng, 24, 4),
        "duplicates": np.tile(_embeddings(rng, 3, 3), (4, 1)),
        "zero row": np.concatenate([_embeddings(rng, 9, 3), np.zeros((1, 64), np.float32)]),
    }
    for name, embeds in sets.items():
        for seed in (0, 1, 7):
            want = jcluster.cluster_embeddings(embeds, k, iterations, seed=seed)
            got = tcluster.cluster_embeddings(embeds, k, iterations, seed=seed, device="cpu")
            assert got == want, (name, seed)


def test_cluster_reseeds_an_empty_cluster():
    """The duplicates set really empties a cluster: with k = 8 over three
    distinct vectors at most three clusters hold members in any round."""
    embeds = np.tile(_embeddings(np.random.default_rng(5), 3, 3), (4, 1))
    labels = tcluster.cluster_embeddings(embeds, 8, 1, device="cpu")
    assert len(set(labels)) <= 3 < 8
    with pytest.raises(ValueError):
        tcluster.cluster_embeddings(embeds, -1, 1, device="cpu")
    assert tcluster.cluster_embeddings(embeds[:0], 3, 1, device="cpu") == []


# ---------------------------------------------------------------------------
# The identify_speaker variants and the cosine helpers.
# ---------------------------------------------------------------------------


def _pcm(rng, seconds, f0):
    t = np.arange(int(seconds * 44100)) / 44100
    x = sum(0.6 ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
            for h in range(10))
    return (x / np.abs(x).max() * 12000 + rng.normal(0, 300, t.shape)).astype(np.int16)


def test_identify_speaker_variants_match_jax(tmp_path):
    """identify_speaker, identify_speaker_with_threshold(_feats) and
    identify_speaker_list give JAX's ids on the same clips; the window
    softmax sums agree within 1e-5."""
    rng = np.random.default_rng(3)
    ex = FeatureExtractor(device="cpu")
    clips = [_pcm(rng, s, f) for s, f in ((0.5, 110), (1.0, 190), (0.3, 300), (0.01, 200))]
    jnet, tnet = _both_nets(tmp_path, 4, 11, class_feats=[ex.extract(c) for c in clips[:3]])
    seen = set()
    for clip in clips:
        feats = ex.extract(clip)
        assert (tidentify.identify_speaker(tnet, clip, ex)
                == jidentify.identify_speaker(jnet, clip))
        if len(feats):
            sums, _ = jidentify._prob_sums(jnet.params, jnp.asarray(feats), 4)
            np.testing.assert_allclose(
                tidentify._probs(tnet, feats).sum(dim=0).numpy(), np.asarray(sums),
                atol=1e-5)
            seen.add(tidentify.identify_speaker(tnet, clip, ex))
        for thr in (0.0, 0.3, 0.6, 1.1):
            assert (tidentify.identify_speaker_with_threshold(tnet, clip, thr, ex)
                    == jidentify.identify_speaker_with_threshold(jnet, clip, thr))
            assert (tidentify.identify_speaker_with_threshold_feats(tnet, feats, thr)
                    == jidentify.identify_speaker_with_threshold_feats(jnet, feats, thr))
            assert (tidentify.identify_speaker_list(tnet, clip, thr, ex)
                    == jidentify.identify_speaker_list(jnet, clip, thr))
    assert len(seen) > 1
    one = np.zeros(60, np.float32)  # a bare [F] vector is one window
    assert (tidentify.identify_speaker_with_threshold_feats(tnet, one, 0.0)
            == jidentify.identify_speaker_with_threshold_feats(jnet, one, 0.0))
    # A single-speaker net answers None, a net without speakers 0 / [].
    jn1, tn1 = _both_nets(tmp_path, 1, 2)
    assert tidentify.identify_speaker_with_threshold(tn1, clips[1], 0.0, ex) is None
    tn1.num_speakers = 0
    assert tidentify.identify_speaker(tn1, clips[1], ex) == 0
    assert tidentify.identify_speaker_list(tn1, clips[1], 0.0, ex) == []


def test_cosine_identifiers_match_jax(tmp_path):
    """cosine_similarity, identify_embedding_cosine and
    identify_speaker_cosine(_feats), and the three single-clip embeddings,
    against JAX's (1e-5)."""
    rng = np.random.default_rng(8)
    jnet, tnet = _both_nets(tmp_path, 3, 5)
    ex = FeatureExtractor(device="cpu")
    clips = [_pcm(rng, 0.4, f) for f in (110, 190, 300)]
    feats = [ex.extract(c) for c in clips]
    for f in feats + [np.zeros((0, 60), np.float32), feats[0][:4]]:
        for name in ("extract_embedding_from_features", "median_embedding_from_features"):
            np.testing.assert_allclose(getattr(tembed, name)(tnet, f),
                                       getattr(jembed, name)(jnet, f), atol=1e-5)
    for c in clips:
        np.testing.assert_allclose(tembed.extract_embedding(tnet, c, ex),
                                   jembed.extract_embedding(jnet, c), atol=1e-5)
    stats = [(jembed.median_embedding_from_features(jnet, f), 0.95, 0.02) for f in feats]
    hits = 0
    for c, f in zip(clips, feats):
        for thr in (0.1, 0.5, 0.99):
            want = jcos.identify_speaker_cosine_feats(jnet, stats, f, thr)
            assert tcos.identify_speaker_cosine_feats(tnet, stats, f, thr) == want
            hits += want is not None
            assert (tcos.identify_speaker_cosine(tnet, stats, c, thr, ex)
                    == jcos.identify_speaker_cosine(jnet, stats, c, thr))
            emb = jembed.extract_embedding_from_features(jnet, f)
            assert (tcos.identify_embedding_cosine(emb * 3.0, stats, thr)
                    == jcos.identify_embedding_cosine(emb * 3.0, stats, thr))
    assert hits > 0
    assert tcos.identify_speaker_cosine_feats(tnet, [], feats[0], 0.1) is None
    a, b = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    assert abs(tcos.cosine_similarity(a, b) - jcos.cosine_similarity(a, b)) <= 1e-6
    assert tcos.cosine_similarity(a, np.zeros(16)) == 0.0
