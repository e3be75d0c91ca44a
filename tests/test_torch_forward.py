"""K7, the fused classifier forward, held against the JAX package.

``forward_probs_k7`` runs its plain version, ``forward_probs_plain``, on
CPU tensors, which is what these tests run.  Its function is the TPU
kernel's, ``_fwd_kernel`` at DEFAULT precision: each product's operands
rounded to bf16 (nearest even), f32 sums, f32 bias, activations, mask and
softmax.  It is held to that arithmetic written in JAX (``jnp.dot`` of
bf16 operands with f32 results) and, loosely, to the TPU kernel
``forward_probs_pallas`` in interpret mode and the JAX ``model.forward``,
which run the products in f32 on the CPU.  The CUDA kernel is held to the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances.  Two f32 summation orders can round an h1 or h2 value to
different bf16 neighbours when it lies next to a rounding midpoint; such a
flip moves that window's probabilities by up to a few 1e-3.  So on inputs
whose layer-1 and layer-2 sums are exact in f32 in any order, where no
flip can happen, every window is held within ``K7_TOL`` of the bf16
arithmetic; on real inputs every window within ``FLIP_TOL`` and all but
``FLIP_SHARE`` of them within ``K7_TOL``.  Against the f32 forms:
``F32_TOL`` on the probabilities, and a window's label may differ only
where the f32 top-two gap is under ``F32_TOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import k7_exact_inputs
from streamz_tpu.nn import model as jmodel
from streamz_tpu.nn.pallas_forward import forward_probs_pallas
from streamz_tpu_torch.nn.convert import params_from_numpy
from streamz_tpu_torch.nn.forward_kernel import (
    forward_probs_k7, forward_probs_plain, packed_weights_plain, padded_widths)

K7_TOL = 2e-4      # windows whose bf16 roundings agree
FLIP_TOL = 1e-2    # every window: a flipped bf16 rounding of h1 or h2
FLIP_SHARE = 0.01  # the windows allowed past K7_TOL
F32_TOL = 0.1      # against f32 products: probabilities, top-two gap of a changed label


def _pair(output, seed):
    jnet = jmodel.SpeakerNet.new(output=output, seed=seed)
    params = params_from_numpy({k: np.asarray(v) for k, v in jnet.params.items()},
                               device="cpu")
    return jnet, params


def jax_default(params, x, ns):
    """``_fwd_kernel``'s DEFAULT arithmetic in JAX: bf16 operands, f32
    results, the same bias, activations, mask and softmax."""
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    dot = lambda a, b: jnp.dot(bf(a), bf(b), preferred_element_type=jnp.float32)  # noqa: E731
    h1 = jnp.maximum(dot(x, params["w1"]) + params["b1"], 0.0)
    h2 = jnp.tanh(dot(h1, params["w2"]) + params["b2"])
    logits = dot(h2, params["w3"]) + params["b3"]
    col = jnp.arange(logits.shape[-1])[None, :]
    logits = jnp.where(col < ns, logits, jmodel.MASK_LOGIT)
    e = jnp.exp(logits - jnp.max(logits, axis=-1, keepdims=True))
    return np.asarray(jnp.where(col < ns, e / jnp.sum(e, axis=-1, keepdims=True), 0.0))


def assert_bf16_close(got, want):
    err = np.abs(got - want).max(axis=1)
    assert err.max() <= FLIP_TOL, err.max()
    assert (err > K7_TOL).sum() <= max(1, int(FLIP_SHARE * len(err))), np.sort(err)[-8:]


def assert_f32_close(got, f32, ns):
    assert np.abs(got - f32).max() <= F32_TOL
    if ns > 1:
        top = np.sort(f32[:, :ns], axis=1)[:, -2:]
        changed = got[:, :ns].argmax(axis=1) != f32[:, :ns].argmax(axis=1)
        assert np.all(top[changed, 1] - top[changed, 0] < F32_TOL)


@pytest.mark.parametrize("ns", [0, 2, 3, 128])
@pytest.mark.parametrize("rows", [1, 512, 700])
def test_k7_matches_pallas_interpret_and_jax_forward(ns, rows):
    """Full width 60->512->256->128: the bf16 arithmetic of the TPU kernel
    within K7_TOL (FLIP_TOL for flipped roundings), the f32 kernel in
    interpret mode and the f32 forward within F32_TOL; rows sum to 1; the
    columns at or past ns exactly 0.0, also at ns = 0, where the masked
    softmax would be a uniform row."""
    jnet, params = _pair(5, 3)
    x = np.random.default_rng(rows + ns).normal(size=(rows, 60)).astype(np.float32)
    got = forward_probs_k7(params, torch.from_numpy(x), ns).numpy()
    pallas = np.asarray(forward_probs_pallas(jnet.params, jnp.asarray(x), ns))
    xla = np.asarray(jmodel.forward(jnet.params, jnp.asarray(x), ns))
    assert got.shape == pallas.shape == (rows, 128)
    assert_bf16_close(got, jax_default(jnet.params, x, ns))
    assert_f32_close(got, pallas, ns)
    assert_f32_close(got, xla, ns)
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
    assert_bf16_close(got, jax_default(jnet.params, x, 3))
    assert_f32_close(got, np.asarray(forward_probs_pallas(jnet.params, jnp.asarray(x), 3)), 3)
    assert np.any(got[:, 2] > 0.0) and np.all(got[:, 3:] == 0.0)


def _numpy_params(F, H1, H2, cap, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (F, H1), "b1": (H1,), "w2": (H1, H2), "b2": (H2,),
              "w3": (H2, cap), "b3": (cap,)}
    return {k: rng.uniform(-0.5, 0.5, s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("F,H1,H2,cap", [(60, 512, 256, 128), (60, 100, 52, 256),
                                         (12, 20, 8, 128)])
@pytest.mark.parametrize("ns", [1, 7])
def test_k7_plain_matches_the_tpu_kernels_arithmetic(F, H1, H2, cap, ns):
    """At full width and at small ones (whose padding the kernel fills with
    zeros): the plain version against the bf16 arithmetic in JAX and the
    f32 TPU kernel in interpret mode, on 1024 seeded windows with nonzero
    biases."""
    np_params = _numpy_params(F, H1, H2, cap, seed=F + H1 + ns)
    params = {k: torch.from_numpy(v) for k, v in np_params.items()}
    x = np.random.default_rng(ns).normal(size=(1024, F)).astype(np.float32)
    got = forward_probs_plain(params, torch.from_numpy(x), ns).numpy()
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    assert_bf16_close(got, jax_default(jparams, x, ns))
    assert_f32_close(got, np.asarray(forward_probs_pallas(jparams, jnp.asarray(x), ns)), ns)
    assert np.all(got[:, ns:] == 0.0)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("F,H1,H2,cap", [(60, 512, 256, 128), (60, 100, 52, 256),
                                         (60, 512, 256, 4096)])
@pytest.mark.parametrize("ns", [0, 8])
def test_k7_plain_matches_the_jax_arithmetic_on_exact_sums(F, H1, H2, cap, ns):
    """Where no summation order can flip a bf16 rounding of h1 or h2 (the
    inputs of chip_smoke.py's exact-sum check), the plain version and the
    TPU kernel's bf16 arithmetic in JAX agree within K7_TOL on every window
    (exp, tanh and the softmax's sums aside, they compute the same bits)."""
    params, x = k7_exact_inputs(F, H1, H2, cap, 2048, "cpu", seed=cap + ns)
    got = forward_probs_plain(params, x, ns).numpy()
    want = jax_default({k: jnp.asarray(v.numpy()) for k, v in params.items()}, x.numpy(), ns)
    assert np.abs(got - want).max() <= K7_TOL
    assert np.all(got[:, ns:] == 0.0)


def _unpack(packed, K, N):
    """The inverse of one layer's packing: [K, N] bf16 from [N / 128, K / 16,
    128, 2, 8] with each odd row group's halves swapped back."""
    b = packed.reshape(N // 128, K // 16, 128, 2, 8).clone()
    odd = (torch.arange(128) >> 2) & 1 == 1
    b[:, :, odd] = b[:, :, odd].flip(3)
    return b.permute(1, 3, 4, 0, 2).reshape(K, N)


@pytest.mark.parametrize("F,H1,H2,cap", [(60, 512, 256, 128), (60, 100, 52, 256),
                                         (8, 4, 132, 4096), (60, 384, 260, 384)])
def test_packed_weights_unpack_to_bf16_weights(F, H1, H2, cap):
    """The kernel's weight layout in its torch form: each layer unpacks to
    bf16(w) bit for bit, zero in its padding."""
    params = {k: torch.from_numpy(v) for k, v in _numpy_params(F, H1, H2, cap, seed=5).items()}
    K1, N1, N2, N3 = padded_widths(F, H1, H2, cap)
    packed = packed_weights_plain(params)
    assert packed.dtype == torch.bfloat16 and packed.numel() == K1 * N1 + N1 * N2 + N2 * N3
    at = 0
    for name, K, N in (("w1", K1, N1), ("w2", N1, N2), ("w3", N2, N3)):
        w = params[name]
        got = _unpack(packed[at:at + K * N], K, N)
        at += K * N
        want = torch.zeros((K, N), dtype=torch.bfloat16)
        want[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), name


def test_k7_on_cpu_counts_no_launch_and_rejects_other_devices():
    _, params = _pair(3, 0)
    before = forward_probs_k7.launches
    forward_probs_k7(params, torch.zeros((4, 60)), 3)
    assert forward_probs_k7.launches == before
    with pytest.raises(ValueError):
        forward_probs_k7(params, torch.zeros((4, 60), device="meta"), 3)
