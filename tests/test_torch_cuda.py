"""Kernel K1 on the card: the CUDA kernel against its plain PyTorch version.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither jax nor the JAX package, so it also runs on a machine
with PyTorch for CUDA and no jax, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from streamz_tpu_torch.dsp import mfcc, mfcc_kernel
from streamz_tpu_torch.dsp.features import FeatureExtractor

# The launcher's edge shapes: (129, 1600) and (513, 800) give rows = 516
# and 1026, a full tile plus a short tail; (2, 399) has no whole window;
# (64, 819200) is the main path's bucket of 64 ten-second clips.
SHAPES = [(1, 800), (1, 2000), (2, 4000), (1, 208000), (3, 208000),
          (129, 1600), (513, 800), (2, 399), (64, 819200)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", SHAPES)
def test_k1_kernel_matches_plain_on_card(cuda_device, B, T):
    """FP32 FMA in another summation order than cuBLAS: 1e-3 on the base
    MFCCs (the frontend's golden gate).  One launch when there is a
    window, none otherwise."""
    rng = np.random.default_rng(B * 1000003 + T)
    pcm = torch.from_numpy(rng.normal(0, 0.1, (B, T)).astype(np.float32)).to(cuda_device)
    before = mfcc_kernel.mfcc_base_v4.launches
    got = mfcc_kernel.mfcc_base_v4(pcm)
    torch.cuda.synchronize()
    want = mfcc.mfcc_base(pcm)
    assert got.shape == want.shape
    assert mfcc_kernel.mfcc_base_v4.launches == before + int(T // 400 >= 2)
    if got.numel():
        assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_k1_rejects_what_it_cannot_take(cuda_device):
    pcm = torch.zeros((2, 4000), device=cuda_device)
    with pytest.raises(ValueError):
        mfcc_kernel.mfcc_base_v4(pcm.double())
    with pytest.raises(ValueError):
        mfcc_kernel.mfcc_base_v4(pcm[:, ::2])
    with pytest.raises(ValueError):
        mfcc_kernel.mfcc_base_v4(pcm[0])


@pytest.mark.cuda
def test_auto_frontend_on_card_matches_cpu(cuda_device):
    """Ragged clips through FeatureExtractor('auto'): K1 on the card vs the
    plain formulation on the CPU, within the 1e-3 feature gate."""
    rng = np.random.default_rng(1)
    clips = [rng.normal(0, 3000, n).astype(np.int16) for n in (700, 9000, 44100, 441000)]
    before = mfcc_kernel.mfcc_base_v4.launches
    got = FeatureExtractor("auto", device=cuda_device).extract_batch(clips)
    assert mfcc_kernel.mfcc_base_v4.launches > before
    want = FeatureExtractor("auto", device="cpu").extract_batch(clips)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-3)
