"""The operation and byte counts against hand counts at small shapes."""

import numpy as np
import pytest

from portbench import roofline
from portbench.reference import mel


def test_filterbank_nonzeros_match_the_reference():
    assert int((mel.mel_filterbank() != 0).sum()) == roofline.MEL_NONZERO


def test_mlp_row_ops_by_hand():
    # F=2, H1=3, H2=4, cap=5: forward 6+12+20=38, data backward 20+12=32,
    # weight gradients 38 again; two operations a multiply-add.
    assert roofline.mlp_row_ops((2, 3, 4, 5)) == 2 * (38 + 32 + 38)
    assert roofline.n_params((2, 3, 4, 5)) == 6 + 3 + 12 + 4 + 20 + 5


def test_frontend_by_hand():
    # One clip of 1,200 samples: 2 windows.  An 800-point real FFT at 2.5 N
    # log2 N is 2.5 * 800 * 9.6439 = 19,288 operations; the power 3 a bin;
    # the log one a mel; the filterbank (741 nonzeros) and the DCT (26 x 20)
    # two a multiply-add.
    w = roofline.frontend([2], 1200)
    assert w.fp32 == pytest.approx(2 * 19287.712 + 2 * 401 * 3 + 2 * 26, abs=0.01)
    assert w.fp32_tc == 2 * 2 * (741 + 26 * 20)
    assert w.nbytes == 4 * (1200 + 2 * 20 + 741 + 26 * 20)
    none = roofline.frontend([0], 300)
    assert none.fp32 == none.fp32_tc == 0


def test_frontend_of_a_batch_is_bound_by_its_bytes():
    # 64 clips of 10 s at 44.1 kHz: 1,101 windows each.  The FFTs take
    # 64 * 1101 * 19,288 / 67e12 = 20.3 us, the power and logs 1.3 us, the
    # products 64 * 1101 * 2 * 1261 / 165e12 = 1.1 us; reading the 28.2 M
    # samples and writing 1.4 M coefficients take 35.4 us.
    w = roofline.frontend([1101] * 64, 64 * 441000)
    t_ops = w.fp32 / roofline.PEAK_FP32 + w.fp32_tc / roofline.PEAK_FP32_TC
    assert t_ops == pytest.approx(22.65e-6, rel=0.01)
    assert w.seconds() == pytest.approx(4 * 64 * (441000 + 1101 * 20) / 3.35e12, rel=0.01)


def test_corpus_and_file_by_hand():
    dims = (2, 3, 4, 5)
    w = roofline.corpus_steps([7, 3], batch=8, dims=dims)
    assert w.fp32_tc == 10 * roofline.mlp_row_ops(dims)
    assert w.fp32 == 2 * 2 * roofline.n_params(dims)
    assert w.nbytes == 4 * 2 * (8 * 4 + 2 * roofline.n_params(dims))
    masks = np.array([[1, 1, 0], [0, 0, 0], [1, 0, 0]])
    f = roofline.file_train(masks, dims)
    assert f.fp32_tc == 3 * roofline.mlp_row_ops(dims)
    assert f.fp32 == 2 * 2 * roofline.n_params(dims)
    assert f.nbytes == 4 * (3 * 3 * 3 + 5 + 2 * roofline.n_params(dims))
    e = roofline.embed_windows(10, dims)
    assert e.fp32_tc == 2 * 10 * (2 * 3 + 3 * 4)


def test_least_time_takes_the_larger_bound():
    ops = roofline.Work(fp32=67e12, fp32_tc=165e12)
    assert ops.seconds() == pytest.approx(2.0)
    assert roofline.Work(nbytes=3.35e12).seconds() == pytest.approx(1.0)
    assert (ops + roofline.Work(nbytes=3.35e13)).seconds() == pytest.approx(10.0)
    assert roofline.total([ops, ops]).fp32 == 2 * 67e12


def test_the_recount_keeps_the_old_least_time_for_3xtf32():
    # Three TF32 products at the TF32 peak take as long as one at a third
    # of it.
    one = 1e12
    assert roofline.Work(fp32_tc=one).seconds() == pytest.approx(3 * one / roofline.PEAK_TF32)
