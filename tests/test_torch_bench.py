"""The bench twin (streamz_tpu_torch.bench) held against the JAX package's
``bench.py`` pipeline, on the CPU at a small size.

What the twin times on the card (frontend → forward → vote sums, consumed
by a max over classes) is computed here with the plain versions and held
to the same pipeline built from the JAX package's functions; the timing
itself needs a card, and without one the twin exits non-zero and prints
no result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamz_tpu.dsp import mfcc as jmfcc
from streamz_tpu.nn import model as jmodel
from streamz_tpu_torch import bench
from streamz_tpu_torch.dsp import features
from streamz_tpu_torch.nn.forward_kernel import forward_probs_k7
from streamz_tpu_torch.nn.model import forward
from streamz_tpu_torch.runtime import measure


def test_bench_pipeline_matches_jax_bench_pipeline():
    """bench.py's net (64 classes, seed 0, capacity 128) and pipeline on two
    short seeded clips: f32 frontend and MLP, vote sums over about 20
    windows, 1e-4.  K7's plain version runs the TPU kernel's bf16 products:
    against the same pipeline with them written in JAX, 2e-4 a window and
    1e-2 for one window whose bf16 rounding of h1 or h2 flips with the
    summation order (``test_torch_forward.py``); against f32, 0.1 a window."""
    net = bench.make_net("cpu")
    jnet = jmodel.SpeakerNet.new(output=bench.CLASSES, seed=0)
    for k, v in net.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), np.asarray(jnet.params[k]))
    pcm, n_samples, n_win = bench._clip_batch(2, 0.2, "cpu")
    got = bench._pipeline(net, features.frontend_core("plain"), forward)(pcm, n_samples)
    fused = bench._pipeline(net, features.frontend_core("plain"), forward_probs_k7)(
        pcm, n_samples)

    jpcm, jns = jnp.asarray(pcm.numpy()), jnp.asarray(n_samples.numpy())
    feats = jmfcc.mfcc_features(jpcm, jns)
    probs = jmodel.forward(jnet.params, feats, bench.CLASSES)
    valid = jnp.arange(feats.shape[1])[None, :] < jmfcc.window_count(jns)[:, None]
    want = np.asarray(jnp.max((probs * valid[..., None]).sum(axis=1), axis=-1))
    assert feats.shape[1] == n_win
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    bf = lambda a: a.astype(jnp.bfloat16)  # noqa: E731
    dot = lambda a, b: jnp.dot(bf(a), bf(b), preferred_element_type=jnp.float32)  # noqa: E731
    p = jnet.params
    h1 = jnp.maximum(dot(feats, p["w1"]) + p["b1"], 0.0)
    h2 = jnp.tanh(dot(h1, p["w2"]) + p["b2"])
    logits = jnp.where(jnp.arange(128) < bench.CLASSES, dot(h2, p["w3"]) + p["b3"],
                       jmodel.MASK_LOGIT)
    bf16_probs = jnp.where(jnp.arange(128) < bench.CLASSES, jax.nn.softmax(logits, axis=-1), 0.0)
    bf16_want = np.asarray(jnp.max((bf16_probs * valid[..., None]).sum(axis=1), axis=-1))
    np.testing.assert_allclose(fused.numpy(), bf16_want, atol=n_win * 2e-4 + 1e-2)
    np.testing.assert_allclose(fused.numpy(), got.numpy(), atol=n_win * 0.1)


def test_cpu_baseline_counts_windows():
    rate = bench.bench_cpu_baseline(bench.make_net("cpu"), clip_seconds=0.1, iters=1)
    assert rate > 0


def test_bench_and_timer_need_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure.chain_timer(lambda: None)
