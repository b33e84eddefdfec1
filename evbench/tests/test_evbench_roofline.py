"""The kernels' operations and bytes at small shapes, counted by hand."""

import pytest

from evbench.roofline import k1, k2, k4, k5, peaks, step
from evbench.inputs import model_dims


def test_interaction_counts():
    # B=2, T=3, D=4: P = 6 pairs of the 4 features
    assert k1.pairs(3) == 6
    assert k1.cost(2, 3, 4) == (4 * (2 * 4 + 2 * 3 * 4 + 2 * (4 + 6)),
                                2 * 2 * 6 * 4)
    assert k4.cost(2, 3, 4) == (4 * (2 * (8 + 24) + 2 * 10), 4 * 2 * 6 * 4)
    # phase 2's bound at the Kaggle shape, B=65536: 0.1063 ms
    assert k1.bound(65536, 26, 36) == pytest.approx(0.1063e-3, rel=1e-3)
    assert k4.bound(65536, 26, 36) == pytest.approx(0.1824e-3, rel=1e-3)


def test_gather_and_update_counts_read_each_row_once():
    assert k2.cost(10, 3, 4) == (40 + 16 * 3 + 16 * 10, 0)
    assert k5.cost(10, 3, 4) == (40 + 160 + 2 * 16 * 3, 4 * 13)
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)


def test_step_flops_at_the_kaggle_widths():
    dims = model_dims({"arch_sparse_feature_size": 36,
                       "arch_embedding_size": [5] * 26,
                       "arch_mlp_bot": [13, 512, 256, 64, 36],
                       "arch_mlp_top": [512, 256, 1]})
    macs = 13 * 512 + 512 * 256 + 256 * 64 + 64 * 36 \
        + 387 * 512 + 512 * 256 + 256
    assert macs == 485888
    inter = 2 * 351 * 36
    assert step.forward_flops(dims, 1) == 2 * macs + inter
    assert step.train_flops(dims, 1) == \
        2 * macs + inter + 2 * macs + 2 * (macs - 13 * 512) + 2 * inter
    # 190.2 GFLOP of MLPs and 5.0 of interaction a step at B = 65536
    assert step.train_flops(dims, 65536) == pytest.approx(195.16e9, rel=1e-3)
