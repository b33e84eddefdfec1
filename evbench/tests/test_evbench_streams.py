"""The traffic generator repeats exactly from its seed, and keeps each
table's ids in range with the mix's skew."""

import numpy as np
import pytest
import torch

from evbench import harness, inputs
from evbench.traffic import streams

SIZES = [3, 1460, 2_202_608, 10_131_227]


GROUPED = {"kind": "train", "batch_size": 512,
           "ids": {"distribution": "grouped_zipf", "zipf_alpha": 1.05,
                   "group_noise": 0.1}}


@pytest.mark.parametrize("mix_name", ["grouped_zipf", "train.sgd-b65536"])
def test_each_mix_repeats_exactly_from_its_seed(mix_name):
    mix = GROUPED if mix_name == "grouped_zipf" else dict(
        harness._json("traffic", f"{mix_name}.json"), batch_size=512)
    seed = 2 ** 31 + 99
    a = streams.make_batches(mix, SIZES, 13, seed, 5, "cpu")
    b = streams.make_batches(mix, SIZES, 13, seed, 5, "cpu")
    c = streams.make_batches(mix, SIZES, 13, seed + 1, 5, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[1], c[1])
    dense, idx, labels = a
    assert dense.shape == (5, 512, 13) and idx.shape == (5, 512, 4)
    assert ((idx >= 0) & (idx < np.asarray(SIZES))).all()
    assert set(np.unique(labels)) <= {0.0, 1.0}
    assert ((dense >= 0) & (dense < 1)).all()


def test_zipf_ranks_are_skewed_and_bounded():
    g = torch.Generator().manual_seed(3)
    r = streams.zipf_ranks(g, 200_000, 1_000_000, 1.05, "cpu")
    assert int(r.min()) >= 0 and int(r.max()) < 1_000_000
    # rank 0 is the most drawn, far above a uniform draw's share
    assert float((r == 0).float().mean()) > 0.05


def test_grouped_zipf_shares_one_rank_across_tables():
    mix = {"batch_size": 4096, "ids": {"distribution": "grouped_zipf",
                                       "zipf_alpha": 1.05,
                                       "group_noise": 0.0}}
    g = torch.Generator().manual_seed(5)
    scat = streams.scatters([5000, 5000], torch.Generator().manual_seed(6),
                            "cpu")
    ids = streams.draw_ids(mix["ids"], [5000, 5000], 4096, g, scat, "cpu")
    # with no noise the two tables' ids are one rank through two scatters
    back0 = torch.argsort(scat[0][1])[ids[:, 0].long()]
    back1 = torch.argsort(scat[1][1])[ids[:, 1].long()]
    assert torch.equal(back0, back1)


def test_inputs_repeat_and_differ_by_part():
    a = inputs.table(2 ** 33 + 1, 4, 100, 8, "cpu")
    assert torch.equal(a, inputs.table(2 ** 33 + 1, 4, 100, 8, "cpu"))
    assert not torch.equal(a, inputs.table(2 ** 33 + 1, 5, 100, 8, "cpu"))
    assert float(a.abs().max()) <= 0.1
    assert inputs.sub_seed(1, "x") != inputs.sub_seed(1, "y")
