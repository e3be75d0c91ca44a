"""The port's training core against the JAX package, on the CPU.

- ``nn/prng.py`` against ``jax.random`` (partitionable threefry): bit for
  bit, keys and uniforms, for several seeds and shapes, including the
  discovery loop's own ((n_pad,) and (n_pad, 60) with n_pad up to 4096,
  split(key, 5)).
- The corpus step (K5's wrapper, which runs its plain version on the
  CPU) against JAX's ``corpus_step(backend='xla')`` and
  ``corpus_step_pallas`` in interpret mode: 1e-5 on parameters and loss
  (f32, summation order only).
- The per-file trainer (K6's plain version) against JAX's
  ``train_on_windows_impl`` with the XLA scan and the Pallas kernel in
  interpret mode, same key: 1e-4 (a few dozen sequential SGD steps).
- ``train_corpus`` against JAX's on a one-device mesh, same seed: losses
  and parameters within 1e-5.
- Class growth: bit-identical new columns.

Kernel-level cases use small widths (60 -> 32 -> 16) where Pallas
interpret mode is slow; inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamz_tpu.nn import model as jmodel
from streamz_tpu.nn import train as jtrain
from streamz_tpu.nn.pallas_train import corpus_step_pallas
from streamz_tpu_torch.nn import model as tmodel
from streamz_tpu_torch.nn import prng
from streamz_tpu_torch.nn import train as ttrain
from streamz_tpu_torch.nn import train_kernels as tk
from streamz_tpu_torch.nn.convert import params_from_numpy


def _torch_params(jparams):
    return {k: v.contiguous() for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu").items()}


def _max_err(jparams, tparams):
    return max(float(np.abs(np.asarray(jparams[k]) - tparams[k].numpy()).max())
               for k in jparams)


def _key_words(jkey):
    return np.asarray(jkey).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 7])
def test_prng_keys_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk_ = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk_.numpy(), _key_words(jk))
    np.testing.assert_array_equal(prng.split(tk_, 5).numpy(),
                                  _key_words(jax.random.split(jk, 5)))
    np.testing.assert_array_equal(prng.split(tk_).numpy(), _key_words(jax.random.split(jk)))
    for data in (0, 3, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk_, data).numpy(),
                                      _key_words(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("shape", [(7,), (4096,), (4096, 60), (100, 60), (3, 4, 5)])
@pytest.mark.parametrize("seed", [1, 42])
def test_prng_uniform_matches_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    want = np.asarray(jax.random.uniform(key, shape), np.float32)
    got = prng.uniform(torch.from_numpy(_key_words(key)), shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_prng_batched_keys_match_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9, 3)))(keys))
    got = prng.uniform(torch.from_numpy(_key_words(keys)), (9, 3)).numpy()
    np.testing.assert_array_equal(got, want)
    want = _key_words(jax.vmap(lambda d: jax.random.fold_in(jax.random.PRNGKey(1), d))(
        jnp.arange(6)))
    np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(1), torch.arange(6)).numpy(), want)


@pytest.mark.parametrize("n_pad,n_valid,dropout", [(64, 50, 0.0), (448, 300, 0.2),
                                                   (2048, 1101, 0.2)])
def test_file_epoch_views_bit_identical(n_pad, n_valid, dropout):
    rng = np.random.default_rng(n_pad)
    windows = rng.normal(0, 1, (n_pad, 60)).astype(np.float32)
    jd, jv = jtrain.file_epoch_views(jnp.asarray(windows), jnp.int32(n_valid),
                                     jax.random.PRNGKey(7), jnp.float32(dropout), 5)
    td, tv = ttrain.file_epoch_views(torch.from_numpy(windows), n_valid,
                                     prng.PRNGKey(7), dropout, 5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _corpus_case(case):
    """(net, x, labels, weights, ns) mirroring tests/test_pallas_train.py."""
    classes, B, label_hi, seed = {"mixed": (5, 700, 7, 1), "tile": (5, 1024, 7, 2),
                                  "stretch": (1000, 300, 1100, 3)}[case[0]]
    net = jmodel.SpeakerNet.new(60, 32, 16, classes, seed=0)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 60)).astype(np.float32)
    labels = rng.integers(0, label_hi, B).astype(np.int32)
    w = (rng.uniform(size=B) > 0.1).astype(np.float32)
    if case[1] == "zero_weights":
        w = np.zeros_like(w)
    ns = 0 if case[1] == "no_class" else classes
    return net, x, labels, w, ns


@pytest.mark.parametrize("case", [("mixed", ""), ("tile", ""), ("stretch", ""),
                                  ("mixed", "zero_weights"), ("mixed", "no_class")],
                         ids=lambda c: "-".join(filter(None, c)))
def test_corpus_step_matches_jax_xla_and_pallas(case):
    """Out-of-range labels (zero target), a ragged last tile (B = 700 and 300
    against 512- and 128-row TPU tiles), an exact tile multiple, all-zero
    weights (no update) and ns = 0 (no update): 1e-5."""
    net, x, labels, w, ns = _corpus_case(case)
    args = (jnp.asarray(x), jnp.asarray(labels), jnp.asarray(w))
    p_xla, l_xla = jtrain.corpus_step(net.params, *args, ns, 0.05, backend="xla")
    p_pal, l_pal = corpus_step_pallas(net.params, *args, ns, 0.05)
    targs = (torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(w))
    tparams = _torch_params(net.params)
    _, loss = ttrain.corpus_step(tparams, *targs, ns, 0.05)
    for jp, jl in ((p_xla, l_xla), (p_pal, l_pal)):
        assert _max_err(jp, tparams) <= 1e-5
        if ns:
            assert abs(float(loss) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    if case[1]:
        for k in tparams:  # no update at all
            np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(net.params[k]))


@pytest.mark.parametrize("n_pad,n_valid,dropout,tgt_cls,epochs",
                         [(64, 50, 0.0, 2, 3), (128, 90, 0.2, 1, 3), (64, 64, 0.2, 99, 2),
                          (64, 50, 0.2, 2, 0)])
def test_train_on_windows_matches_jax(n_pad, n_valid, dropout, tgt_cls, epochs):
    """The per-file trainer (K6's plain twin on the CPU) against the JAX
    XLA scan and the Pallas file kernel in interpret mode, same key,
    dropout on, a partial last chunk, an out-of-range target (zero
    target vector) and zero epochs (S = 0, a no-op): 1e-4."""
    net = jmodel.SpeakerNet.new(60, 32, 16, 5, seed=0)
    cap = net.capacity
    rng = np.random.default_rng(n_pad + tgt_cls)
    windows = rng.normal(0, 1, (n_pad, 60)).astype(np.float32)
    tvec = np.zeros(cap, np.float32)
    if tgt_cls < 5:
        tvec[tgt_cls] = 1.0
    key = jax.random.PRNGKey(42)
    outs = {}
    for backend in ("xla", "pallas"):
        outs[backend] = jtrain.train_on_windows_impl(
            net.params, jnp.asarray(windows), jnp.int32(n_valid), jnp.asarray(tvec),
            jnp.int32(5), key, jnp.float32(0.05), jnp.float32(dropout),
            epochs=epochs, batch_size=8, backend=backend)
    tparams = _torch_params(net.params)
    _, loss = ttrain.train_on_windows_impl(
        tparams, torch.from_numpy(windows), n_valid, torch.from_numpy(tvec), 5,
        prng.PRNGKey(42), 0.05, dropout, epochs=epochs, batch_size=8)
    for jp, jl in outs.values():
        assert _max_err(jp, tparams) <= 1e-4
        assert abs(float(loss) - float(jl)) <= 1e-4
    if epochs == 0:
        assert float(loss) == 0.0
        assert _max_err(net.params, tparams) == 0.0


def test_train_windows_plain_skips_empty_chunks_and_dead_classes():
    """A chunk with no surviving window and ns = 0 both apply no update."""
    params = tmodel.init_params(60, 32, 16, 5, seed=1, device="cpu")
    ref = {k: v.clone() for k, v in params.items()}
    rng = np.random.default_rng(0)
    chunks = torch.from_numpy(rng.normal(0, 1, (4, 8, 60)).astype(np.float32))
    tvec = torch.zeros(128)
    tvec[1] = 1.0
    loss, cnt = tk.train_windows_plain(params, chunks, torch.zeros(4, 8), tvec, 5, 0.05)
    assert float(loss) == 0.0 and float(cnt) == 0.0
    tk.train_windows_plain(params, chunks, torch.ones(4, 8), tvec, 0, 0.05)
    for k in ref:
        assert torch.equal(params[k], ref[k]), k
    before = tk.train_windows_k6.launches
    tk.train_windows_k6(params, chunks, torch.ones(4, 8), tvec, 5, 0.05)
    assert tk.train_windows_k6.launches == before  # CPU tensors: no kernel
    assert not torch.equal(params["w3"], ref["w3"])


def test_train_corpus_matches_jax_on_one_device():
    """The initial corpus training, same seed and numpy-drawn shuffles and
    dropout: per-epoch losses and parameters within 1e-5."""
    from streamz_tpu.app import corpus as jcorpus
    from streamz_tpu.parallel import comm
    from streamz_tpu_torch.app import corpus as tcorpus

    rng = np.random.default_rng(4)
    fm = {f"f{i}.wav": rng.normal(i % 3, 1, (90 + 7 * i, 60)).astype(np.float32)
          for i in range(6)}
    files = [(p, i % 3) for i, p in enumerate(fm)]
    jx, jy = jcorpus.build_window_pool(fm, files)
    tx, ty = tcorpus.build_window_pool(fm, files)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    jnet = jmodel.SpeakerNet.new(60, 32, 16, 3, seed=0)
    tnet = tmodel.SpeakerNet.new(60, 32, 16, 3, seed=0, device="cpu")
    kw = dict(epochs=3, batch_size=256, lr=0.01, dropout=0.2, seed=0)
    jl = jcorpus.train_corpus(jnet, jx, jy, mesh=comm.make_mesh(1), **kw)
    tl = tcorpus.train_corpus(tnet, tx, ty, **kw)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert _max_err(jnet.params, tnet.params) <= 1e-5


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_train_corpus_pool_route_matches_jax(dropout):
    """The pool route (the step's rows gathered by the uploaded order and
    keep mask) over several steps per epoch, a ragged last one, with and
    without dropout, against the JAX package's host-gathered batches:
    per-epoch losses and parameters within 1e-5."""
    from streamz_tpu.app import corpus as jcorpus
    from streamz_tpu.parallel import comm
    from streamz_tpu_torch.app import corpus as tcorpus

    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (700, 60)).astype(np.float32)
    x[::50] = 0.0  # all-zero windows: skipped only under dropout
    y = rng.integers(0, 4, 700).astype(np.int32)
    jnet = jmodel.SpeakerNet.new(60, 32, 16, 4, seed=1)
    tnet = tmodel.SpeakerNet.new(60, 32, 16, 4, seed=1, device="cpu")
    kw = dict(epochs=2, batch_size=256, lr=0.05, dropout=dropout, seed=3)
    jl = jcorpus.train_corpus(jnet, x, y, mesh=comm.make_mesh(1), **kw)
    tl = tcorpus.train_corpus(tnet, x, y, **kw)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert _max_err(jnet.params, tnet.params) <= 1e-5


def _host_gathered(windows, labels, order, n, keep):
    """One step's batch as the JAX package gathers it on the host
    (streamz_tpu/app/corpus.py:95-113): padding rows past n are window 0
    with weight 0; dropout zeroes features and skips all-zero rows."""
    x = windows[order]
    w = (np.arange(len(order)) < n).astype(np.float32)
    if keep is not None:
        x[:n] = x[:n] * keep
        w = w * np.any(x != 0.0, axis=-1)
    return (torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(labels[order]),
            torch.from_numpy(w.astype(np.float32)))


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("n", [64, 37])
def test_pool_rows_plain_match_host_gather_bit_for_bit(dropout, n):
    """K5's pool route on the CPU (the plain gather in torch, then the plain
    gradients and step) against the host-gathered batch through
    corpus_grads_plain and _apply_step: the same bits, at a full step and a
    ragged one (37 real rows of 64), with and without dropout."""
    rng = np.random.default_rng(n + int(dropout * 10))
    windows = rng.normal(0, 1, (150, 60)).astype(np.float32)
    windows[:5] = 0.0
    labels = rng.integers(0, 6, 150).astype(np.int32)
    order = np.zeros(64, np.int32)
    order[:n] = rng.permutation(150)[:n]
    keep = rng.random((n, 60), dtype=np.float32) >= dropout if dropout else None
    rows = tk.PoolRows(torch.from_numpy(windows), torch.from_numpy(labels),
                       torch.from_numpy(order),
                       None if keep is None else torch.from_numpy(keep.view(np.uint8)), n)
    host = _host_gathered(windows, labels, order, n, keep)
    for got, want in zip(tk.rows_plain(rows), host):
        assert torch.equal(got, want)
    params = tmodel.init_params(60, 32, 16, 8, seed=4, device="cpu")
    g, loss, cnt = tk.corpus_rows_grads_k5(params, rows, 5)
    wg, wloss, wcnt = tk.corpus_grads_plain(params, *host, 5)
    for k in wg:
        assert torch.equal(g[k], wg[k]), k
    assert torch.equal(loss, wloss) and torch.equal(cnt, wcnt)
    stepped = {k: v.clone() for k, v in params.items()}
    mean = tk.corpus_step_k5(stepped, rows, 5, 0.05)
    wmean = tk._apply_step(params, wg, wloss, wcnt, 0.05)
    assert torch.equal(mean, wmean)
    for k in params:
        assert torch.equal(stepped[k], params[k]), k


@pytest.mark.parametrize("batch_size,n_pad", [(64, 128), (48, 144)])
def test_train_on_windows_wide_chunks_match_jax(batch_size, n_pad):
    """Chunks of 64 and 48 windows (K6 runs them as row tiles on the card;
    its plain twin here) against the JAX XLA scan and the Pallas file kernel
    in interpret mode: 1e-4."""
    net = jmodel.SpeakerNet.new(60, 32, 16, 5, seed=0)
    rng = np.random.default_rng(batch_size)
    windows = rng.normal(0, 1, (n_pad, 60)).astype(np.float32)
    tvec = np.zeros(net.capacity, np.float32)
    tvec[2] = 1.0
    key = jax.random.PRNGKey(5)
    outs = {}
    for backend in ("xla", "pallas"):
        outs[backend] = jtrain.train_on_windows_impl(
            net.params, jnp.asarray(windows), jnp.int32(n_pad - 20), jnp.asarray(tvec),
            jnp.int32(5), key, jnp.float32(0.05), jnp.float32(0.2),
            epochs=2, batch_size=batch_size, backend=backend)
    tparams = _torch_params(net.params)
    _, loss = ttrain.train_on_windows_impl(
        tparams, torch.from_numpy(windows), n_pad - 20, torch.from_numpy(tvec), 5,
        prng.PRNGKey(5), 0.05, 0.2, epochs=2, batch_size=batch_size)
    for jp, jl in outs.values():
        assert _max_err(jp, tparams) <= 1e-4
        assert abs(float(loss) - float(jl)) <= 1e-4


def test_class_growth_bit_identical():
    jnet = jmodel.SpeakerNet.new(60, 32, 16, 127, seed=0)
    tnet = tmodel.SpeakerNet.new(60, 32, 16, 127, seed=0, device="cpu")
    for net in (jnet, tnet):
        net.add_output_class()   # 128: fills the capacity
        net.add_output_class()   # 129: doubles it to 256
        net.ensure_capacity(300)  # 384
        net.record_training_file(130, "a.wav")
        net.record_training_file(130, "a.wav")
    assert tnet.capacity == jnet.capacity == 384
    assert tnet.num_speakers == jnet.num_speakers == 129
    assert tnet.file_lists == jnet.file_lists
    assert _max_err(jnet.params, tnet.params) == 0.0
    w3, b3 = jnet.output_layer()
    jnet.set_output_layer(w3[:, :50], b3[:50])
    tnet.set_output_layer(w3[:, :50], b3[:50])
    assert tnet.num_speakers == jnet.num_speakers == 50
    assert tnet.capacity == jnet.capacity
    assert _max_err(jnet.params, tnet.params) == 0.0


def test_corpus_step_takes_num_speakers_as_a_device_scalar():
    """The live class count as an int32 tensor (as the discovery loop keeps
    it) and as an int give bit-identical steps."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (40, 60)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, 40).astype(np.int32))
    w = torch.ones(40)
    a = tmodel.init_params(60, 32, 16, 4, seed=2, device="cpu")
    b = {k: v.clone() for k, v in a.items()}
    _, la = ttrain.corpus_step(a, x, labels, w, 3, 0.1)
    _, lb = ttrain.corpus_step(b, x, labels, w, torch.tensor(3, dtype=torch.int32), 0.1)
    assert float(la) == float(lb)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("masked", [False, True])
def test_train_batch_matches_jax(masked):
    """The reference's mean-gradient batch step with per-row targets, with
    and without a row mask (a fully masked batch applies nothing): 1e-5."""
    net = jmodel.SpeakerNet.new(60, 32, 16, 4, seed=2)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (24, 60)).astype(np.float32)
    target = np.zeros((24, net.capacity), np.float32)
    target[np.arange(24), rng.integers(0, 4, 24)] = 1.0
    w = (np.arange(24) % 3 > 0).astype(np.float32) if masked else None
    want = jtrain.train_batch(net.params, jnp.asarray(x), jnp.asarray(target),
                              jnp.float32(0.05), jnp.int32(4),
                              None if w is None else jnp.asarray(w))
    tparams = _torch_params(net.params)
    ttrain.train_batch(tparams, torch.from_numpy(x), torch.from_numpy(target), 0.05, 4,
                       None if w is None else torch.from_numpy(w))
    assert _max_err(want, tparams) <= 1e-5


def test_pretrain_drivers_match_jax(monkeypatch):
    """``pretrain_from_features`` and ``train_from_feature_map`` with both
    packages' key counters at 0: same keys, parameters within 1e-4; an
    out-of-range class trains a zero target; a masked class raises."""
    from streamz_tpu.nn import drivers as jdrivers
    from streamz_tpu_torch.nn import drivers as tdrivers

    monkeypatch.setattr(jdrivers, "_key_counter", [0])
    monkeypatch.setattr(tdrivers, "_key_counter", [0])
    rng = np.random.default_rng(8)
    fm = {f"f{i}.wav": rng.normal(i, 1, (20 + 9 * i, 60)).astype(np.float32)
          for i in range(3)}
    files = [("f0.wav", 0), ("f1.wav", 1), ("f2.wav", 5), ("missing.wav", 0)]
    jnet = jmodel.SpeakerNet.new(60, 32, 16, 2, seed=3)
    tnet = tmodel.SpeakerNet.new(60, 32, 16, 2, seed=3, device="cpu")
    jl = jdrivers.pretrain_from_features(jnet, fm["f0.wav"], 1, 2, 2, 0.05, 0.2, 8)
    tl = tdrivers.pretrain_from_features(tnet, fm["f0.wav"], 1, 2, 2, 0.05, 0.2, 8)
    assert abs(tl - jl) <= 1e-4
    jl = jdrivers.train_from_feature_map(jnet, fm, files, 2, 0.05, 0.2, 8)
    tl = tdrivers.train_from_feature_map(tnet, fm, files, 2, 0.05, 0.2, 8)
    assert abs(tl - jl) <= 1e-4
    assert _max_err(jnet.params, tnet.params) <= 1e-4
    assert tnet.file_lists == jnet.file_lists
    with pytest.raises(ValueError):
        tdrivers.pretrain_from_features(tnet, fm["f0.wav"], 3, 4, 1, 0.05, 0.0, 8)
