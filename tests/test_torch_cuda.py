"""The port's CUDA kernels (K1-K7) on the card, each against its plain
PyTorch version.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports neither jax nor the JAX package, so it also runs on a machine
with PyTorch for CUDA and no jax, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from streamz_tpu_torch.dsp import mfcc_kernel
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
    """bf16x3 with v4's tail fold, in another summation order than the plain
    version's f32 matmuls: 1e-3 on the base MFCCs (the frontend's golden
    gate).  One launch when there is a window, none otherwise."""
    rng = np.random.default_rng(B * 1000003 + T)
    pcm = torch.from_numpy(rng.normal(0, 0.1, (B, T)).astype(np.float32)).to(cuda_device)
    before = mfcc_kernel.mfcc_base_v4.launches
    got = mfcc_kernel.mfcc_base_v4(pcm)
    torch.cuda.synchronize()
    want = mfcc_kernel.mfcc_base_bf16x3_plain(pcm, True, tail_fold=True)
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
    """Ragged clips through FeatureExtractor('auto'): the measured winner
    (K1 or K2) on the card vs the f32 plain formulation on the CPU, within
    the 1e-3 feature gate."""
    rng = np.random.default_rng(1)
    clips = [rng.normal(0, 3000, n).astype(np.int16) for n in (700, 9000, 44100, 441000)]
    extractor = FeatureExtractor("auto", device=cuda_device)
    winner = {"pallas_v4": mfcc_kernel.mfcc_base_v4,
              "pallas_v3": mfcc_kernel.mfcc_base_v3}[extractor.resolved()]
    before = winner.launches
    got = extractor.extract_batch(clips)
    assert winner.launches > before
    want = FeatureExtractor("auto", device="cpu").extract_batch(clips)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-3)


# ---------------------------------------------------------------------------
# K5 (corpus_grads.cu) and K6 (file_train.cu) against their plain versions.
# ---------------------------------------------------------------------------

from streamz_tpu_torch.nn import prng, train_kernels as tk  # noqa: E402
from streamz_tpu_torch.nn.model import init_params  # noqa: E402
from streamz_tpu_torch.nn.train import corpus_step, file_epoch_views  # noqa: E402


def _params(capacity, device, seed=0):
    return {k: v.contiguous() for k, v in
            init_params(60, 512, 256, capacity, seed=seed, device=device).items()}


def _max_rel_err(got, want):
    """Largest |got - want| over max(1, max |want|): FP32 sums taken in
    another order than cuBLAS's."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _k5_batch(B, capacity, device, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (B, 60)).astype(np.float32)).to(device)
    # labels up to capacity + 50: some past the live classes, some past capacity
    labels = torch.from_numpy(rng.integers(0, capacity + 50, B).astype(np.int32)).to(device)
    w = torch.from_numpy((rng.uniform(size=B) > 0.1).astype(np.float32)).to(device)
    return x, labels, w


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [128, 1024, 4096])
@pytest.mark.parametrize("B", [4096, 777])
def test_k5_matches_plain_on_card(cuda_device, capacity, B):
    """Gradient sums within 1e-4 of the largest |grad| (FP32 in another
    summation order), one launch per call, bit-identical on a rerun."""
    params = _params(capacity, cuda_device)
    ns = capacity - 28
    x, labels, w = _k5_batch(B, capacity, cuda_device, seed=capacity + B)
    before = tk.corpus_grads_k5.launches
    g1, loss1, cnt1 = tk.corpus_grads_k5(params, x, labels, w, ns)
    g2, loss2, _ = tk.corpus_grads_k5(params, x, labels, w, ns)
    torch.cuda.synchronize()
    assert tk.corpus_grads_k5.launches == before + 2
    want, wloss, wcnt = tk.corpus_grads_plain(params, x, labels, w, ns)
    for k in want:
        assert _max_rel_err(g1[k], want[k]) <= 1e-4, k
        assert torch.equal(g1[k], g2[k]), f"{k} differs between two runs"
    assert abs(float(loss1) - float(wloss)) <= 1e-4 * abs(float(wloss))
    assert float(loss1) == float(loss2)
    assert float(cnt1) == float(wcnt)


@pytest.mark.cuda
def test_k5_zero_weights_and_no_live_class_apply_nothing(cuda_device):
    params = _params(128, cuda_device)
    x, labels, w = _k5_batch(1000, 128, cuda_device, seed=3)
    for weights, ns in ((torch.zeros_like(w), 7), (w, 0)):
        g, _, cnt = tk.corpus_grads_k5(params, x, labels, weights, ns)
        torch.cuda.synchronize()
        for k in g:
            assert float(g[k].abs().max()) == 0.0, k
    assert float(cnt) == float(w.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [128, 1024, 4096])
def test_k5_step_updates_in_place(cuda_device, capacity):
    """K5's step form against _apply_step over the plain gradients: every
    parameter within 1e-5, one launch, the mean loss within 1e-4 relative."""
    params = _params(capacity, cuda_device)
    ref = {k: v.clone() for k, v in params.items()}
    x, labels, w = _k5_batch(4096, capacity, cuda_device, seed=5 + capacity)
    ns = min(100, capacity - 28)
    before = tk.corpus_grads_k5.launches
    _, loss = corpus_step(params, x, labels, w, ns, 0.01)
    assert tk.corpus_grads_k5.launches == before + 1
    want = tk._apply_step(ref, *tk.corpus_grads_plain(ref, x, labels, w, ns), 0.01)
    for k in ref:
        assert float((params[k] - ref[k]).abs().max()) <= 1e-5, k
    assert abs(float(loss) - float(want)) <= 1e-4 * max(1.0, abs(float(want)))


def _pool_rows(capacity, device, n_pool, B, n, dropout, seed):
    """A step's PoolRows: a permutation of a seeded pool, the first n
    positions real, and (dropout > 0) a 0/1 keep mask of theirs."""
    rng = np.random.default_rng(seed)
    pool_x = torch.from_numpy(rng.normal(0, 1, (n_pool, 60)).astype(np.float32)).to(device)
    pool_x[:7] = 0.0  # all-zero windows: weight 0 under dropout, 1 without
    pool_y = torch.from_numpy(rng.integers(0, capacity + 50, n_pool).astype(np.int32))
    order = np.zeros(B, np.int32)
    order[:n] = rng.permutation(n_pool)[:n]
    keep = None
    if dropout > 0:
        keep = torch.from_numpy((rng.random((n, 60)) >= dropout).astype(np.uint8)).to(device)
    return tk.PoolRows(pool_x, pool_y.to(device), torch.from_numpy(order).to(device), keep, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("n", [4096, 1232])
def test_k5_pool_route_matches_gathered_batch_on_card(cuda_device, dropout, n):
    """The on-card gather (pool, order, keep mask) against the plain gather
    of the same step through the plain gradients, at a full step and at a
    ragged last step (1232 real rows of 4096): sums within 1e-4 of the
    largest |grad|, the loss sum within 1e-4 relative, the count exact, two
    launches bit-identical; the step form within 1e-5 of _apply_step."""
    rows = _pool_rows(128, cuda_device, 17616, 4096, n, dropout, seed=n + int(dropout * 10))
    params = _params(128, cuda_device)
    g1, loss1, cnt1 = tk.corpus_rows_grads_k5(params, rows, 100)
    g2, loss2, cnt2 = tk.corpus_rows_grads_k5(params, rows, 100)
    torch.cuda.synchronize()
    want, wloss, wcnt = tk.corpus_grads_plain(params, *tk.rows_plain(rows), 100)
    for k in want:
        assert _max_rel_err(g1[k], want[k]) <= 1e-4, k
        assert torch.equal(g1[k], g2[k]), k
    assert abs(float(loss1) - float(wloss)) <= 1e-4 * abs(float(wloss))
    assert float(loss1) == float(loss2) and float(cnt1) == float(cnt2)
    assert float(cnt1) == float(wcnt)
    if dropout == 0.0:
        assert float(cnt1) == n
    ref = {k: v.clone() for k, v in params.items()}
    before = tk.corpus_grads_k5.launches
    loss = tk.corpus_step_k5(params, rows, 100, 0.01)
    assert tk.corpus_grads_k5.launches == before + 1
    wmean = tk._apply_step(ref, want, wloss, wcnt, 0.01)
    for k in ref:
        assert float((params[k] - ref[k]).abs().max()) <= 1e-5, k
    assert abs(float(loss) - float(wmean)) <= 1e-4 * max(1.0, abs(float(wmean)))


def _k6_inputs(capacity, device, n_pad=256, n_valid=200, epochs=5, seed=0, B=8):
    rng = np.random.default_rng(seed)
    windows = torch.from_numpy(rng.normal(0, 1, (n_pad, 60)).astype(np.float32)).to(device)
    dropped, valid = file_epoch_views(windows, n_valid, prng.PRNGKey(seed + 1, device),
                                      0.2, epochs)
    chunks = dropped.reshape(-1, B, 60).contiguous()
    masks = valid.reshape(-1, B).contiguous()
    tvec = torch.zeros(capacity, device=device)
    tvec[3] = 1.0
    return chunks, masks, tvec


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [128, 1024, 2048, 4096])
def test_k6_matches_plain_on_card(cuda_device, capacity):
    """160 sequential chunk steps (5 epochs of 256 padded windows, 200 real,
    dropout 0.2): parameters within 1e-4 and the loss within 1e-4 relative
    of the plain loop (FP32 in another summation order, compounding over
    the steps); one launch per file.  Capacity 4096 keeps w3 in device
    memory, the others in the cluster's shared memory."""
    chunks, masks, tvec = _k6_inputs(capacity, cuda_device, seed=capacity)
    got = _params(capacity, cuda_device)
    want = {k: v.clone() for k, v in got.items()}
    before = tk.train_windows_k6.launches
    loss, cnt = tk.train_windows_k6(got, chunks, masks, tvec, 9, 0.05)
    torch.cuda.synchronize()
    assert tk.train_windows_k6.launches == before + 1
    wloss, wcnt = tk.train_windows_plain(want, chunks, masks, tvec, 9, 0.05)
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 1e-4, k
    assert abs(float(loss) - float(wloss)) <= 1e-4 * max(1.0, abs(float(wloss)))
    assert float(cnt) == float(wcnt)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [128, 4096])
@pytest.mark.parametrize("B", [12, 16, 32])
def test_k6_wider_chunks_match_plain_on_card(cuda_device, capacity, B):
    """Chunks of 12, 16 and 32 windows run the 16- and 32-row instances
    (5 epochs of 384 padded windows, 300 real: 160, 120 and 60 steps): the
    plain loop's parameters within 1e-4, its loss within 1e-4 relative, two
    launches bit-identical.  At 32 rows w3 stays in device memory at every
    capacity."""
    chunks, masks, tvec = _k6_inputs(capacity, cuda_device, n_pad=384, n_valid=300,
                                     seed=capacity + B, B=B)
    got = _params(capacity, cuda_device)
    again = {k: v.clone() for k, v in got.items()}
    want = {k: v.clone() for k, v in got.items()}
    before = tk.train_windows_k6.launches
    loss, cnt = tk.train_windows_k6(got, chunks, masks, tvec, 9, 0.05)
    aloss, acnt = tk.train_windows_k6(again, chunks, masks, tvec, 9, 0.05)
    torch.cuda.synchronize()
    assert tk.train_windows_k6.launches == before + 2
    wloss, wcnt = tk.train_windows_plain(want, chunks, masks, tvec, 9, 0.05)
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 1e-4, k
        assert torch.equal(got[k], again[k]), k
    assert abs(float(loss) - float(wloss)) <= 1e-4 * max(1.0, abs(float(wloss)))
    assert float(loss) == float(aloss) and float(cnt) == float(acnt)
    assert float(cnt) == float(wcnt)
    _, route = tk.k6_plan(60, 512, 256, capacity, B)
    assert route == ("shared memory" if capacity == 128 and B <= 16 else "w3 in device memory")


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [128, 4096])
def test_k6_two_launches_give_the_same_bits(cuda_device, capacity):
    """Every sum runs in a fixed order, across warps and across the
    cluster's CTAs, on both w3 routes."""
    chunks, masks, tvec = _k6_inputs(capacity, cuda_device, seed=7)
    first = _params(capacity, cuda_device)
    second = {k: v.clone() for k, v in first.items()}
    l1, c1 = tk.train_windows_k6(first, chunks, masks, tvec, 9, 0.05)
    l2, c2 = tk.train_windows_k6(second, chunks, masks, tvec, 9, 0.05)
    torch.cuda.synchronize()
    for k in first:
        assert torch.equal(first[k], second[k]), k
    assert float(l1) == float(l2) and float(c1) == float(c2)
    _, route = tk.k6_plan(60, 512, 256, capacity, 8)
    assert route == ("shared memory" if capacity == 128 else "w3 in device memory")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [5, 32])
def test_k6_ragged_slices_at_narrow_widths(cuda_device, B):
    """60 -> 20 -> 12 -> 8 with chunks of 5 and 32 windows (the 8- and
    32-row instances, w3 in shared memory): most CTAs own no h1 unit, no h2
    unit and no class column, the rest slices of 4."""
    rng = np.random.default_rng(11)
    shapes = {"w1": (60, 20), "b1": (20,), "w2": (20, 12), "b2": (12,),
              "w3": (12, 8), "b3": (8,)}
    params = {k: torch.from_numpy(rng.uniform(-0.3, 0.3, shp).astype(np.float32))
              .to(cuda_device) for k, shp in shapes.items()}
    want = {k: v.clone() for k, v in params.items()}
    chunks = torch.from_numpy(rng.normal(0, 1, (40, B, 60)).astype(np.float32)).to(cuda_device)
    masks = torch.from_numpy((rng.uniform(size=(40, B)) > 0.3).astype(np.float32))
    masks[::7] = 0.0
    masks = masks.to(cuda_device)
    tvec = torch.zeros(8, device=cuda_device)
    tvec[2] = 1.0
    before = tk.train_windows_k6.launches
    loss, cnt = tk.train_windows_k6(params, chunks, masks, tvec, 6, 0.05)
    torch.cuda.synchronize()
    assert tk.train_windows_k6.launches == before + 1
    wloss, wcnt = tk.train_windows_plain(want, chunks, masks, tvec, 6, 0.05)
    for k in want:
        assert float((params[k] - want[k]).abs().max()) <= 1e-4, k
    assert abs(float(loss) - float(wloss)) <= 1e-4 * max(1.0, abs(float(wloss)))
    assert float(cnt) == float(wcnt)
    assert tk.k6_plan(60, 20, 12, 8, B)[1] == "shared memory"


def _k6_against_plain(params, chunks, masks, tvec, ns):
    """K6 twice and the plain loop once from the same parameters: (max abs
    parameter error, relative loss error); asserts one launch each, two
    launches bit-identical and the count exact."""
    again = {k: v.clone() for k, v in params.items()}
    want = {k: v.clone() for k, v in params.items()}
    before = tk.train_windows_k6.launches
    loss, cnt = tk.train_windows_k6(params, chunks, masks, tvec, ns, 0.05)
    aloss, acnt = tk.train_windows_k6(again, chunks, masks, tvec, ns, 0.05)
    torch.cuda.synchronize()
    assert tk.train_windows_k6.launches == before + 2
    wloss, wcnt = tk.train_windows_plain(want, chunks, masks, tvec, ns, 0.05)
    for k in want:
        assert torch.equal(params[k], again[k]), k
    assert float(loss) == float(aloss) and float(cnt) == float(acnt)
    assert float(cnt) == float(wcnt)
    err = max(float((params[k] - want[k]).abs().max()) for k in want)
    return err, abs(float(loss) - float(wloss)) / max(1.0, abs(float(wloss)))


@pytest.mark.cuda
@pytest.mark.parametrize("H1,H2,B", [(4096, 256, 8), (4096, 256, 64), (512, 2048, 8)])
def test_k6_wide_layers_match_plain_on_card(cuda_device, H1, H2, B):
    """H1 = 4096 (chunks of 8, and of 64 in row tiles) and H2 = 2048: the
    slices of w1 and w2 do not fit the cluster's shared memory, so the
    weights and activations stay in device memory; 160 (or 20) steps
    within 1e-4 of the plain loop, two launches bit-identical."""
    params = {k: v.contiguous() for k, v in
              init_params(60, H1, H2, 128, seed=0, device=cuda_device).items()}
    chunks, masks, tvec = _k6_inputs(128, cuda_device, seed=H1 + H2 + B, B=B)
    err, loss_err = _k6_against_plain(params, chunks, masks, tvec, 9)
    assert err <= 1e-4 and loss_err <= 1e-4, (err, loss_err)
    assert tk.k6_plan(60, H1, H2, 128, B)[1] == "device memory"


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [128, 4096])
@pytest.mark.parametrize("B", [64, 48])
def test_k6_chunks_past_32_windows_match_plain_on_card(cuda_device, capacity, B):
    """Chunks of 64 and 48 windows run as row tiles of 32 (48: a ragged
    second tile of 16) whose gradients add up before the chunk's one
    update: 5 epochs of 384 padded windows, 300 real (30 and 40 steps),
    within 1e-4 of the plain loop, two launches bit-identical."""
    chunks, masks, tvec = _k6_inputs(capacity, cuda_device, n_pad=384, n_valid=300,
                                     seed=capacity + B, B=B)
    err, loss_err = _k6_against_plain(_params(capacity, cuda_device), chunks, masks, tvec, 9)
    assert err <= 1e-4 and loss_err <= 1e-4, (err, loss_err)
    assert tk.k6_plan(60, 512, 256, capacity, B)[1] == "w3 in device memory"


@pytest.mark.cuda
def test_k6_no_update_without_windows_or_classes(cuda_device):
    """S == 0 launches nothing; chunks with no valid window, and ns == 0,
    leave every parameter bit-identical."""
    chunks, masks, tvec = _k6_inputs(128, cuda_device, seed=1)
    params = _params(128, cuda_device)
    ref = {k: v.clone() for k, v in params.items()}
    before = tk.train_windows_k6.launches
    loss, cnt = tk.train_windows_k6(params, chunks[:0], masks[:0], tvec, 9, 0.05)
    assert tk.train_windows_k6.launches == before
    assert float(loss) == 0.0 and float(cnt) == 0.0
    loss, cnt = tk.train_windows_k6(params, chunks, torch.zeros_like(masks), tvec, 9, 0.05)
    loss0, _ = tk.train_windows_k6(params, chunks, masks, tvec, 0, 0.05)
    torch.cuda.synchronize()
    assert tk.train_windows_k6.launches == before + 2
    assert float(cnt) == 0.0 and float(loss) == 0.0
    for k in ref:
        assert torch.equal(params[k], ref[k]), k
    assert torch.isfinite(loss0)


@pytest.mark.cuda
def test_training_kernels_reject_what_they_cannot_take(cuda_device):
    params = _params(128, cuda_device)
    x, labels, w = _k5_batch(64, 128, cuda_device, seed=2)
    with pytest.raises(ValueError):
        tk.corpus_grads_k5(params, x.double(), labels, w, 4)
    with pytest.raises(ValueError):
        tk.corpus_grads_k5(params, x, labels.long(), w, 4)
    with pytest.raises(ValueError):
        tk.corpus_grads_k5(params, x[:, :30], labels, w, 4)
    chunks, masks, tvec = _k6_inputs(128, cuda_device)
    with pytest.raises(ValueError):
        tk.train_windows_k6(params, chunks[:, :, ::2], masks, tvec, 4, 0.05)
    with pytest.raises(ValueError):
        tk.train_windows_k6(params, chunks, masks, tvec[:64], 4, 0.05)


@pytest.mark.cuda
def test_discovery_step_never_waits_on_the_host(cuda_device):
    """One file of the discovery loop (embed, match, decision, threefry
    views, K6, centroid update) enqueues without a host synchronisation."""
    from streamz_tpu_torch.app.device_loop import _file_step

    params = _params(128, cuda_device)
    state = (params, torch.tensor(3, dtype=torch.int32, device=cuda_device),
             torch.zeros((128, 256), device=cuda_device),
             torch.zeros(128, device=cuda_device))
    seed_cent = torch.zeros((128, 256), device=cuda_device)
    seed_mask = torch.zeros(128, dtype=torch.bool, device=cuda_device)
    max_sp = torch.tensor(10, dtype=torch.int32, device=cuda_device)
    windows = torch.zeros((256, 60), device=cuda_device)
    windows[:200] = torch.randn((200, 60), device=cuda_device)
    key = prng.PRNGKey(3, cuda_device)
    torch.cuda.synchronize()
    before = tk.train_windows_k6.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _file_step(state, windows, 200, -1, False, 0.8, 0.05, key, seed_cent,
                         seed_mask, max_sp, 0.2, 5, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tk.train_windows_k6.launches == before + 1
    assert int(out[0]) == 3 and int(state[1]) == 4  # no centroid yet: a new class


# ---------------------------------------------------------------------------
# K2 (mfcc_v3.cu), K3 (mfcc_v2.cu) and K4 (mfcc_frames.cu) against their
# plain versions, K1-K4 at their tile's edges, the backends through
# FeatureExtractor, the 'auto' probe, and K7 (forward_probs.cu) against
# its plain version and model.forward.
# ---------------------------------------------------------------------------

from chip_smoke import k7_exact_inputs  # noqa: E402
from streamz_tpu_torch.dsp import features  # noqa: E402
from streamz_tpu_torch.nn import model  # noqa: E402
from streamz_tpu_torch.nn.forward_kernel import (  # noqa: E402
    forward_probs_k7, forward_probs_plain, packed_weights_k7, packed_weights_plain)

_MFCC_PLAIN = {
    "K1": lambda pcm: mfcc_kernel.mfcc_base_bf16x3_plain(pcm, True, tail_fold=True),
    "K2": lambda pcm: mfcc_kernel.mfcc_base_bf16x3_plain(pcm, True),
    "K3": lambda pcm: mfcc_kernel.mfcc_base_bf16x3_plain(pcm, False),
    "K4": mfcc_kernel.mfcc_base_frames_plain,
}


@pytest.mark.cuda
@pytest.mark.parametrize("kid", ["K2", "K3", "K4"])
@pytest.mark.parametrize("B,T", SHAPES)
def test_mfcc_kernels_match_plain_on_card(cuda_device, kid, B, T):
    """bf16x3 in another summation order than the plain version's f32
    matmuls: 1e-3 on the base MFCCs.  One launch when there is a window,
    none otherwise."""
    wrapper = mfcc_kernel.WRAPPERS[kid]
    rng = np.random.default_rng(B * 1000003 + T + 7)
    pcm = torch.from_numpy(rng.normal(0, 0.1, (B, T)).astype(np.float32)).to(cuda_device)
    before = wrapper.launches
    got = wrapper(pcm)
    torch.cuda.synchronize()
    want = _MFCC_PLAIN[kid](pcm)
    assert got.shape == want.shape == (B, max(T // 400 - 1, 0), 20)
    assert wrapper.launches == before + int(T // 400 >= 2)
    if got.numel():
        assert float((got - want).abs().max()) <= 1e-3


# The edges of the tile of K1-K4 (mfcc_tc.cuh): 64 block rows, 63 windows a
# tile, tiles walked in pairs by clusters of two CTAs (K4: row 64 of its
# planes, the zero row its shifted descriptor reads).  (B, T, offset):
# fewer rows than one tile; B * nb = 127 (two whole tiles), 126 and 128
# around it, 129 (one past two tiles of 64 rows); 190 and 191 (three tiles:
# a cluster with one CTA idle, and four); clip boundaries inside a tile
# (nb = 3 and 520); T % 400 != 0; T % 4 != 0; a base one float past a
# 16-byte boundary (a view at offset 1), with T % 4 == 0 and != 0.
TC_EDGES = [(1, 2000, 0), (1, 50800, 0), (1, 50400, 0), (1, 51200, 0), (43, 1200, 0),
            (1, 76000, 0), (1, 76400, 0), (3, 208000, 0), (2, 4123, 0), (5, 12345, 0),
            (7, 41600, 1), (4, 9999, 1)]


def _offset_pcm(B, T, offset, seed, device):
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.normal(0, 0.1, B * T + offset).astype(np.float32))
    return flat.to(device)[offset:].view(B, T)


@pytest.mark.cuda
@pytest.mark.parametrize("kid", ["K1", "K2", "K3", "K4"])
@pytest.mark.parametrize("B,T,offset", TC_EDGES)
def test_tc_tile_edges_match_plain_on_card(cuda_device, kid, B, T, offset):
    """K1-K4 at shapes that cross the tile's edges: 1e-3 on the base MFCCs
    against the plain bf16x3 version, one launch, finite."""
    wrapper = mfcc_kernel.WRAPPERS[kid]
    pcm = _offset_pcm(B, T, offset, B * 7919 + T, cuda_device)
    assert pcm.is_contiguous() and (pcm.data_ptr() % 16 != 0) == bool(offset)
    before = wrapper.launches
    got = wrapper(pcm)
    torch.cuda.synchronize()
    want = _MFCC_PLAIN[kid](pcm)
    assert got.shape == want.shape == (B, T // 400 - 1, 20)
    assert wrapper.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kid", ["K1", "K2", "K3", "K4"])
def test_tc_tile_two_launches_give_the_same_bits(cuda_device, kid):
    """No atomics and a fixed summation order: the same bits twice, over
    many tile pairs and an unaligned base."""
    wrapper = mfcc_kernel.WRAPPERS[kid]
    for B, T, offset in ((9, 208000, 0), (5, 12345, 1)):
        pcm = _offset_pcm(B, T, offset, 5, cuda_device)
        a = wrapper(pcm)
        b = wrapper(pcm)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kid", ["K1", "K2", "K3", "K4"])
def test_mfcc_kernels_on_silence_and_odd_lengths(cuda_device, kid):
    """A zero clip hits the log floor everywhere; a length that is not a
    multiple of 4 takes the tile's unaligned copy path."""
    wrapper = mfcc_kernel.WRAPPERS[kid]
    plain = _MFCC_PLAIN[kid]
    pcm = torch.zeros((3, 8001), device=cuda_device)
    pcm[1] = torch.from_numpy(
        np.random.default_rng(11).normal(0, 0.1, 8001).astype(np.float32))
    got = wrapper(pcm)
    torch.cuda.synchronize()
    want = plain(pcm)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "pallas_v2", "pallas_v3", "pallas_v4"])
def test_kernel_backends_on_card_match_cpu(cuda_device, backend):
    """Ragged clips through each kernel backend on the card vs the same
    backend's plain version on the CPU: the 1e-3 feature gate."""
    rng = np.random.default_rng(1)
    clips = [rng.normal(0, 3000, n).astype(np.int16) for n in (700, 9000, 44100, 441000)]
    got = features.FeatureExtractor(backend, device=cuda_device).extract_batch(clips)
    want = features.FeatureExtractor(backend, device="cpu").extract_batch(clips)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-3)


@pytest.mark.cuda
def test_auto_probe_on_card(cuda_device, tmp_path, monkeypatch):
    """'auto' measures K2 against K1, launches both, and caches the winner."""
    from streamz_tpu_torch.runtime import autotune

    monkeypatch.setenv("STREAMZ_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    autotune.reset("frontend")
    before = (mfcc_kernel.mfcc_base_v4.launches, mfcc_kernel.mfcc_base_v3.launches)
    winner = features.autotune_frontend(force=True)
    assert winner in ("pallas_v3", "pallas_v4")
    assert mfcc_kernel.mfcc_base_v4.launches > before[0]
    assert mfcc_kernel.mfcc_base_v3.launches > before[1]
    assert features.FeatureExtractor(device=cuda_device).resolved() == winner
    assert winner in (tmp_path / "tune.json").read_text()
    autotune.reset("frontend")


# K7 runs the TPU kernel's bf16 products.  Against its plain version
# (forward_probs_plain) on inputs whose layer-1 and layer-2 sums are exact
# in f32 in any order: K7_TOL on every window.  On real inputs: K7_TOL a
# window, K7_FLIP_TOL for the few windows (at most K7_FLIP_SHARE) where an
# h1 or h2 value next to a bf16 rounding midpoint rounds the other way in
# the other f32 summation order (tests/test_torch_forward.py).  Against the
# FP32 forward: K7_F32_TOL, and a label may change only where the FP32
# top-two gap is under it.
K7_TOL, K7_FLIP_TOL, K7_FLIP_SHARE, K7_F32_TOL = 2e-4, 1e-2, 0.01, 0.1
# (F, H1, H2, capacity, rows): capacities past one chunk, the tile's edges,
# and widths whose padding the kernel fills (60, 100, 52), (12, 36, 20) or
# whose activations live in device memory (60, 4096, 2048).
K7_SHAPES = [(60, 512, 256, 128, 1), (60, 512, 256, 128, 63), (60, 512, 256, 128, 64),
             (60, 512, 256, 128, 65), (60, 512, 256, 128, 70464), (60, 512, 256, 256, 4096),
             (60, 512, 256, 4096, 700), (60, 100, 52, 128, 1000), (60, 4096, 2048, 128, 300),
             (12, 36, 20, 384, 129)]


def _k7_params(F, H1, H2, capacity, device, seed=0):
    """Uniform(-0.5, 0.5) weights and biases (nonzero, unlike init_params')."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (F, H1), "b1": (H1,), "w2": (H1, H2), "b2": (H2,),
              "w3": (H2, capacity), "b3": (capacity,)}
    return {k: torch.from_numpy(rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(device)
            for k, s in shapes.items()}


def _k7_inputs(rows, capacity, device, seed=0, widths=(60, 512, 256)):
    params = _k7_params(*widths, capacity, device, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.normal(0, 1, (rows, widths[0])).astype(np.float32)).to(device)
    return params, x


def _k7_check(params, x, ns):
    """One K7 launch against its plain version and the FP32 forward."""
    before = forward_probs_k7.launches
    got = forward_probs_k7(params, x, ns)
    torch.cuda.synchronize()
    assert forward_probs_k7.launches == before + 1
    want = forward_probs_plain(params, x, ns)
    assert got.shape == want.shape == (x.shape[0], params["b3"].shape[0])
    err = (got - want).abs().amax(dim=1)
    assert float(err.max()) <= K7_FLIP_TOL
    assert int((err > K7_TOL).sum()) <= max(1, int(K7_FLIP_SHARE * x.shape[0]))
    assert bool((got[:, ns:] == 0.0).all())
    f32 = model.forward(params, x, ns)
    assert float((got - f32).abs().max()) <= K7_F32_TOL
    if ns > 1:
        top = f32[:, :ns].topk(2, dim=1).values
        changed = got[:, :ns].argmax(dim=1) != f32[:, :ns].argmax(dim=1)
        assert bool((top[changed, 0] - top[changed, 1] < K7_F32_TOL).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [0, 1, 8, 128])
@pytest.mark.parametrize("rows", [1, 700, 70464])
def test_k7_matches_forward_on_card(cuda_device, ns, rows):
    """bf16 products on wgmma against the plain version's FP32 sums of the
    same bf16 products, and against the FP32 forward; the columns at or
    past ns exactly 0.0, also at ns = 0; one launch."""
    params, x = _k7_inputs(rows, 128, cuda_device, seed=rows)
    _k7_check(params, x, ns)


@pytest.mark.cuda
@pytest.mark.parametrize("F,H1,H2,capacity,rows", K7_SHAPES)
def test_k7_shapes_on_card(cuda_device, F, H1, H2, capacity, rows):
    """Sums exact in any order (chip_smoke.py's k7_exact_inputs): every
    window within K7_TOL of the plain version, the inactive columns exactly
    0.0, one launch a call."""
    params, x = k7_exact_inputs(F, H1, H2, capacity, rows, cuda_device, seed=rows + capacity)
    for ns in (0, 1, 5, capacity):
        before = forward_probs_k7.launches
        got = forward_probs_k7(params, x, ns)
        torch.cuda.synchronize()
        assert forward_probs_k7.launches == before + 1
        want = forward_probs_plain(params, x, ns)
        assert got.shape == want.shape == (rows, capacity)
        assert float((got - want).abs().max()) <= K7_TOL
        assert bool((got[:, ns:] == 0.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("F,H1,H2,capacity", [(60, 512, 256, 128), (60, 100, 52, 4096),
                                              (60, 4096, 2048, 256), (12, 36, 20, 384)])
def test_k7_packs_the_weights_as_its_torch_form(cuda_device, F, H1, H2, capacity):
    """The pack kernel's bf16 layout equals packed_weights_plain bit for bit."""
    params = _k7_params(F, H1, H2, capacity, cuda_device, seed=F + H1)
    got = packed_weights_k7(params)
    torch.cuda.synchronize()
    want = packed_weights_plain(params)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(60, 512, 256), (60, 4096, 2048)])
def test_k7_two_launches_give_the_same_bits(cuda_device, widths):
    params, x = _k7_inputs(3000, 256, cuda_device, seed=9, widths=widths)
    first = forward_probs_k7(params, x, 200)
    again = forward_probs_k7(params, x, 200)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_k7_sees_an_in_place_update(cuda_device):
    """K5 and K6 update the parameters in place: the next call packs the
    updated w2, so it agrees with the plain version of the new weights."""
    params, x = _k7_inputs(2000, 128, cuda_device, seed=11)
    before = forward_probs_k7(params, x, 8)
    params["w2"].mul_(-1.5)
    after = _k7_check(params, x, 8)
    assert float((after - before).abs().max()) > 0.1


@pytest.mark.cuda
def test_k7_rejects_what_it_cannot_take(cuda_device):
    params, x = _k7_inputs(64, 128, cuda_device)
    with pytest.raises(ValueError):
        forward_probs_k7(params, x.double(), 3)
    with pytest.raises(ValueError):
        forward_probs_k7(params, x[:, :30], 3)
    with pytest.raises(ValueError):
        forward_probs_k7(params, x[:, ::2], 3)
    assert forward_probs_k7(params, x[:0], 3).shape == (0, 128)


# ---------------------------------------------------------------------------
# The DeviceFeatureStore on the card: the discovery loop and --eval fed
# from it give the bits they give without it.
# ---------------------------------------------------------------------------

from streamz_tpu_torch.app.evaluate import evaluate  # noqa: E402
from streamz_tpu_torch.app.incremental import run_incremental  # noqa: E402
from streamz_tpu_torch.dsp.mfcc import DeviceFeatureStore  # noqa: E402
from streamz_tpu_torch.infer.embed import batch_clip_embeddings, normalize  # noqa: E402
from streamz_tpu_torch.nn import drivers  # noqa: E402
from streamz_tpu_torch.nn.model import SpeakerNet  # noqa: E402


def _store_corpus(device, n=12, seed=4):
    """Seeded clips of three voices (2 to 3 s, two frontend buckets) through
    the 'auto' frontend on ``device``, kept in a path-keyed store."""
    rng = np.random.default_rng(seed)
    clips = []
    for i in range(n):
        t = np.arange(int((2.0 + 0.1 * i) * 44100)) / 44100
        f0 = 110.0 + 80.0 * (i % 3)
        x = sum(0.6 ** h * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 6.3))
                for h in range(10))
        clips.append((x / np.abs(x).max() * 12000 + rng.normal(0, 200, t.shape))
                     .astype(np.int16))
    paths = [f"c{i}.wav" for i in range(n)]
    store = DeviceFeatureStore()
    feats = FeatureExtractor(device=device).extract_batch(clips, store=store)
    store.rekey(dict(enumerate(paths)))
    return paths, dict(zip(paths, feats)), store


@pytest.mark.cuda
def test_store_discovery_equals_host_packing_on_card(cuda_device):
    """The discovery loop on the card fed from the store against the same
    loop fed by the host upload: labels, parameters and margins bit for
    bit, no host packing; and a store gather enqueues without waiting."""
    paths, fm, store = _store_corpus(cuda_device)
    files = [(p, 0 if i == 0 else None) for i, p in enumerate(paths)]
    runs = []
    for st in (None, store):
        drivers._key_counter[0] = 0
        net = SpeakerNet.new(output=1, seed=0, device=cuda_device)
        fs = list(files)
        res = run_incremental(net, fs, fm, burn_in_limit=2, conf_threshold=0.8,
                              show_progress=False, device_store=st)
        runs.append((fs, net.params, res.decision_margins))
    (l0, p0, m0), (l1, p1, m1) = runs
    assert l0 == l1 and m0 == m1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert store.stats["host_pack_bytes"] == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wins, missing = store.gather_partial(paths[:3] + ["absent.wav"], 512)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [r for r, _ in missing] == [3]
    for r, p in enumerate(paths[:3]):
        assert torch.equal(wins[r, : len(fm[p])].cpu(), torch.from_numpy(fm[p]))


@pytest.mark.cuda
def test_eval_metrics_with_and_without_store_on_card(cuda_device):
    paths, fm, store = _store_corpus(cuda_device, seed=6)
    net = SpeakerNet.new(60, 64, 32, output=3, seed=2, device=cuda_device)
    embs = batch_clip_embeddings(net, [fm[p] for p in paths])
    net.set_embeddings([(normalize(np.mean(embs[i::3], axis=0)), 0.9, 0.05)
                        for i in range(3)])
    targets = [(p, i % 3) for i, p in enumerate(paths)]
    want = evaluate(net, fm, targets, 0.5, verbose=False)
    got = evaluate(net, fm, targets, 0.5, verbose=False, store=store)
    assert got == want and want["correct"] > 0
    assert store.stats["host_pack_bytes"] == 0


# ---------------------------------------------------------------------------
# Steganography and the raw-PCM drivers on the card.
# ---------------------------------------------------------------------------

from streamz_tpu_torch.dsp.augment import augment  # noqa: E402
from streamz_tpu_torch.nn import prng  # noqa: E402
from streamz_tpu_torch.nn import train_kernels as tk  # noqa: E402
from streamz_tpu_torch.stego import codec  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples", [None, [44100, 500, 0]])
def test_augment_on_card_equals_cpu(cuda_device, n_samples):
    pcm = np.random.default_rng(1).integers(-32768, 32768, (3, 44100)).astype(np.float32)
    key = prng.PRNGKey(7)
    got = augment(key.to(cuda_device), torch.from_numpy(pcm).to(cuda_device), n_samples)
    want = augment(key, torch.from_numpy(pcm), n_samples)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("max_epochs", [10_000, 11])
def test_stego_block_loop_on_card_equals_one_step_blocks(cuda_device, max_epochs):
    """The doubling blocks on the card stop where blocks of one step stop:
    the same weights, bit for bit, and the same count."""
    rng = np.random.default_rng(0)
    h2 = torch.from_numpy(np.tanh(rng.normal(0, 1, 64)).astype(np.float32)).to(cuda_device)
    w3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (64, 256)).astype(np.float32))
    target = np.zeros(256, np.float32)
    target[:200] = rng.integers(0, 2, 200)
    target = torch.from_numpy(target).to(cuda_device)
    runs = []
    for max_block in (1, 256):
        a, b = w3.clone().to(cuda_device), torch.zeros(256, device=cuda_device)
        got = codec._train_bits_loop(a, b, h2, target, 200, 0.002,
                                     max_epochs=max_epochs, max_block=max_block)
        runs.append((got, a, b))
    (g1, a1, b1), (g2, a2, b2) = runs
    assert g1 == g2
    assert g1 == (11, False) if max_epochs == 11 else (g1[1] and g1[0] > 20)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)


@pytest.mark.cuda
def test_stego_encode_on_card_returns_a_host_net(cuda_device, tmp_path):
    """The encode trains on the card, and what it returns holds no device
    memory: the decoder and the w4/b4 stash read it on the host."""
    payload = np.random.default_rng(3).bytes(512)
    src = tmp_path / "secret.bin"
    src.write_bytes(payload)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    net = codec.encode_file(str(src), device=cuda_device)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base
    assert net.device.type == "cpu"
    assert codec.extract_file_from_classifier(net)[:len(payload)] == payload


@pytest.mark.cuda
def test_pretrain_network_launches_the_frontend_and_k6_per_epoch(cuda_device):
    t = np.arange(44100) / 44100.0
    pcm = (np.sin(2 * np.pi * 150.0 * t) * 9000).astype(np.int16)
    net = SpeakerNet.new(60, 64, 32, output=2, seed=1, device=cuda_device)
    ex = FeatureExtractor("pallas_v4", device=cuda_device)
    k1 = mfcc_kernel.WRAPPERS["K1"]
    k1.launches = tk.train_windows_k6.launches = 0
    loss = drivers.pretrain_network(net, pcm, 1, 2, 3, 0.05, 0.2, 8, ex,
                                    key=prng.PRNGKey(0))
    assert k1.launches == 3 and tk.train_windows_k6.launches == 3
    assert np.isfinite(loss) and loss > 0


# ---------------------------------------------------------------------------
# Streaming and serving (app/stream.py, app/serve.py): no kernel of the
# port runs there; the step's torch ops on the card against the CPU.
# ---------------------------------------------------------------------------

from streamz_tpu_torch.app import serve as tserve  # noqa: E402
from streamz_tpu_torch.app import stream as tstream  # noqa: E402
from streamz_tpu_torch.io import g711  # noqa: E402


def _stream_inputs(S, k, seed, capacity):
    rng = np.random.default_rng(seed)
    pcm = rng.normal(0, 6000, (3, S, k, 400)).clip(-32768, 32767).astype(np.int16)
    n_new = rng.integers(0, k + 1, (3, S)).astype(np.int32)
    return pcm, n_new


@pytest.mark.cuda
def test_batched_stream_step_on_card_matches_cpu(cuda_device):
    """Three steps and the flush of 64 slots at full width on the card
    against the CPU: the FP32 products in another order, so features 1e-4
    and the vote sums 1e-4 relative; the counts and masks exact."""
    from streamz_tpu_torch.device import resolve_device

    resolve_device(cuda_device)  # TF32 off, as every entry point sets it
    S, k = 64, 16
    params = init_params(60, 512, 256, 8, seed=3, device="cpu")
    pcm, n_new = _stream_inputs(S, k, 5, 128)
    out = {}
    for dev in ("cpu", cuda_device):
        p = {name: v.to(dev) for name, v in params.items()}
        carry = tstream.zero_carry(S, 128, dev)
        feats = []
        with torch.no_grad():
            for t in range(3):
                blocks = torch.from_numpy(pcm[t].astype(np.float32) / 32767.0).to(dev)
                carry, f, m = tstream.stream_step(p, carry, blocks,
                                                  torch.from_numpy(n_new[t]).to(dev), 8)
                feats.append((f.cpu(), m.cpu()))
            votes, count, f, m = tstream.finalize_step(p, carry, 8)
        out[str(dev)] = ([c.cpu() for c in carry], feats, votes.cpu(), count.cpu())
    (cc, cf, cv, cn), (gc, gf, gv, gn) = out["cpu"], out[str(cuda_device)]
    for (a, am), (b, bm) in zip(cf, gf):
        assert torch.equal(am, bm)
        assert float((a - b).abs().max()) <= 1e-4
    assert torch.equal(cn, gn) and torch.equal(cc[3], gc[3]) and torch.equal(cc[6], gc[6])
    assert float(((cv - gv).abs() / cv.abs().clamp(min=1e-3)).max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["i16", "ulaw", "alaw"])
def test_narrow_wires_on_card_equal_host_decode_bit_for_bit(cuda_device, law):
    """The i16 and u8 wires converted on the card give the very bits of the
    f32 step on PCM decoded and converted on the host."""
    S, k = 64, 16
    params = init_params(60, 512, 256, 8, seed=4, device=cuda_device)
    pcm, n_new = _stream_inputs(S, k, 6, 128)
    pcm, n_new = pcm[0], torch.from_numpy(n_new[0]).to(cuda_device)
    carry = tstream.zero_carry(S, 128, cuda_device)
    with torch.no_grad():
        if law == "i16":
            host = pcm
            got = tserve.step_i16(params, carry, torch.from_numpy(pcm).to(cuda_device), n_new, 8)
        else:
            codes = g711.ulaw_encode(pcm) if law == "ulaw" else g711.alaw_encode(pcm)
            host = g711.decode(codes, law)
            table = torch.as_tensor(g711.TABLES[law][0], device=cuda_device)
            got = tserve.step_u8(params, carry, torch.from_numpy(codes).to(cuda_device),
                                 n_new, 8, table)
        f32 = torch.from_numpy(host.astype(np.float32) / 32767.0).to(cuda_device)
        want = tstream.stream_step(params, carry, f32, n_new, 8)
    for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_streaming_feed_on_card_reads_nothing_back(cuda_device):
    """``StreamingIdentifier.feed`` enqueues its dispatches without a host
    synchronisation: no sync under ``set_sync_debug_mode('error')``."""
    net = SpeakerNet.new(output=5, seed=0, device=cuda_device)
    clip = np.random.default_rng(7).normal(0, 3000, 44100).astype(np.int16)
    sid = tstream.StreamingIdentifier(net, threshold=0.0)
    sid.feed(clip[:8000])  # first use builds the constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(8000, len(clip), 4410):
            sid.feed(clip[i:i + 4410])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = tstream.StreamingIdentifier(SpeakerNet.new(output=5, seed=0, device="cpu"),
                                      threshold=0.0)
    ref.feed(clip)
    got, want = sid.finalize(), ref.finalize()
    assert got[0] == want[0] and abs(got[1] - want[1]) <= 1e-4


@pytest.mark.cuda
def test_staging_buffer_not_reused_before_its_copy_completes(cuda_device):
    """64 slots fed on every wire in back-to-back ticks, one dispatch each
    and no synchronisation between them, against the same feeds with the
    card synchronised after every tick: the same bits."""
    net = SpeakerNet.new(output=8, seed=0, device=cuda_device)
    rng = np.random.default_rng(8)
    clips = [rng.normal(0, 3000, 3 * 44100).astype(np.int16) for _ in range(64)]
    runs = []
    for sync in (False, True):
        srv = tserve.MultiStreamIdentifier(net, n_streams=64, threshold=0.0)
        sids = [srv.open() for _ in clips]
        for a in range(0, len(clips[0]), 6400):
            for sid, c in zip(sids, clips):
                piece = c[a:a + 6400]
                if sid % 3 == 1:
                    srv.feed(sid, g711.ulaw_encode(piece), encoding="ulaw")
                elif sid % 3 == 2 and a % 12800 == 0:
                    srv.feed(sid, piece.astype(np.float32) / 32767.0)
                else:
                    srv.feed(sid, piece)
            srv.tick(drain=False)
            if sync:
                torch.cuda.synchronize()
        while srv.tick(drain=False):
            if sync:
                torch.cuda.synchronize()
        runs.append(([c.clone() for c in srv._carry], srv.stats()["wire_dispatches"]))
    (a, wa), (b, wb) = runs
    assert wa == wb and sum(wa.values()) > 10
    for x, y in zip(a, b):
        assert torch.equal(x, y)
