"""K7, the fused classifier forward, held against the JAX package.

``forward_probs_k7`` runs its plain version, ``nn/model.forward``, on CPU
tensors, which is what these tests run; it is held to the TPU kernel
``forward_probs_pallas`` in interpret mode and to the JAX ``model.forward``
on the same seeded windows and parameters.  The CUDA kernel is held to the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamz_tpu.nn import model as jmodel
from streamz_tpu.nn.pallas_forward import forward_probs_pallas
from streamz_tpu_torch.nn.convert import params_from_numpy
from streamz_tpu_torch.nn.forward_kernel import forward_probs_k7


def _pair(output, seed):
    jnet = jmodel.SpeakerNet.new(output=output, seed=seed)
    params = params_from_numpy({k: np.asarray(v) for k, v in jnet.params.items()},
                               device="cpu")
    return jnet, params


@pytest.mark.parametrize("ns", [0, 2, 3, 128])
@pytest.mark.parametrize("rows", [1, 512, 700])
def test_k7_matches_pallas_interpret_and_jax_forward(ns, rows):
    """Full width 60->512->256->128, both f32 on the CPU (the TPU kernel's
    DEFAULT precision is f32 in interpret mode): 1e-5 on the
    probabilities; the columns at or past ns exactly 0.0, also at ns = 0,
    where the masked softmax would be a uniform row."""
    jnet, params = _pair(5, 3)
    x = np.random.default_rng(rows + ns).normal(size=(rows, 60)).astype(np.float32)
    got = forward_probs_k7(params, torch.from_numpy(x), ns).numpy()
    pallas = np.asarray(forward_probs_pallas(jnet.params, jnp.asarray(x), ns))
    xla = np.asarray(jmodel.forward(jnet.params, jnp.asarray(x), ns))
    assert got.shape == pallas.shape == (rows, 128)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, xla, atol=1e-5)
    assert np.all(got[:, ns:] == 0.0)
    if ns:
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def test_k7_grown_class_count_matches_jax():
    """After a class is added both packages expose the new column alike."""
    jnet, _ = _pair(2, 4)
    jnet.add_output_class()
    params = params_from_numpy({k: np.asarray(v) for k, v in jnet.params.items()},
                               device="cpu")
    x = np.random.default_rng(1).normal(size=(64, 60)).astype(np.float32)
    got = forward_probs_k7(params, torch.from_numpy(x), 3).numpy()
    want = np.asarray(forward_probs_pallas(jnet.params, jnp.asarray(x), 3))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.any(got[:, 2] > 0.0) and np.all(got[:, 3:] == 0.0)


def test_k7_on_cpu_counts_no_launch_and_rejects_other_devices():
    _, params = _pair(3, 0)
    before = forward_probs_k7.launches
    forward_probs_k7(params, torch.zeros((4, 60)), 3)
    assert forward_probs_k7.launches == before
    with pytest.raises(ValueError):
        forward_probs_k7(params, torch.zeros((4, 60), device="meta"), 3)
