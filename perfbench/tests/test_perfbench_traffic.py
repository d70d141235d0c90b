"""The traffic generator: the same seed gives the same inputs, another seed
another dataset with rungs of the same sizes, and the rungs are those of the
program's Successive Halving race."""
import math

import numpy as np
import pytest
import torch

from perfbench.traffic import draw_normals, make_traffic, sh_masks

CONFIG = {"n": 40, "m": 52, "d": 7}
MIX = {"min_epochs": 1, "eta": 3, "races": 3}
BIG_SEED = 2**31 + 977


def test_same_seed_same_inputs():
    a, b = make_traffic(CONFIG, MIX, BIG_SEED), make_traffic(CONFIG, MIX,
                                                             BIG_SEED)
    assert np.array_equal(a.t, b.t) and len(a.races) == len(b.races) == 3
    for ra, rb in zip(a.races, b.races):
        assert np.array_equal(ra.X, rb.X)
        assert np.array_equal(ra.Y_full, rb.Y_full)
        for (ya, ma), (yb, mb) in zip(ra.rungs, rb.rungs):
            assert np.array_equal(ya, yb) and np.array_equal(ma, mb)
    za, ea = draw_normals(BIG_SEED, 3, 4, 40, 52, "cpu")
    zb, eb = draw_normals(BIG_SEED, 3, 4, 40, 52, "cpu")
    assert torch.equal(za, zb) and torch.equal(ea, eb)


def test_other_seed_or_race_other_dataset_same_sizes():
    a, b = make_traffic(CONFIG, MIX, 1), make_traffic(CONFIG, MIX, 2)
    races = a.races + b.races
    for i, ri in enumerate(races):
        for rj in races[i + 1:]:
            assert not np.array_equal(ri.Y_full, rj.Y_full)
            assert not np.array_equal(ri.X, rj.X)
            assert len(ri.rungs) == len(rj.rungs)
            for (_, mi), (_, mj) in zip(ri.rungs, rj.rungs):
                assert np.array_equal(np.sort(mi.sum(1)), np.sort(mj.sum(1)))
    za, _ = draw_normals(1, 0, 2, 40, 52, "cpu")
    zb, _ = draw_normals(2, 0, 2, 40, 52, "cpu")
    assert not torch.equal(za, zb)


@pytest.mark.parametrize("n,m,eta,counts", [
    # n configurations at 1, 3, 9 epochs, then the survivors at all m:
    # ceil(n / 3) go on at each rung (by hand: 4096 -> 1366 -> 456 -> 152)
    (4096, 52, 3, [(4096, 1), (1366, 3), (456, 9), (152, 52)]),
    (40, 52, 3, [(40, 1), (14, 3), (5, 9), (2, 52)]),
    (40, 27, 3, [(40, 1), (14, 3), (5, 9), (2, 27)]),
    (30, 20, 2, [(30, 1), (15, 2), (8, 4), (4, 8), (2, 20)]),
])
def test_rungs_follow_successive_halving(n, m, eta, counts):
    Y = np.random.default_rng(n + m).uniform(size=(n, m))
    masks = sh_masks(Y, 1, eta)
    assert len(masks) == len(counts) == int(
        math.floor(math.log(m) / math.log(eta))) + 1
    for mask, (active, target) in zip(masks, counts):
        lens = mask.sum(1)
        assert int((lens >= target).sum()) == active
        assert np.all(np.diff(mask, axis=1) <= 0)       # prefixes
    for before, after in zip(masks, masks[1:]):
        assert np.all(after >= before)                  # rungs only add


def test_promotion_ranks_by_the_observed_value():
    Y = np.zeros((6, 9))
    Y[:, 0] = [0.1, 0.9, 0.5, 0.8, 0.2, 0.3]     # best two at epoch 1: 1, 3
    Y[:, 2] = [0.0, 0.1, 0.0, 0.7, 0.0, 0.0]     # best of 1, 3 at epoch 3: 3
    masks = sh_masks(Y, 1, 3)
    assert [int(v) for v in masks[1].sum(1)] == [1, 3, 1, 3, 1, 1]
    assert [int(v) for v in masks[2].sum(1)] == [1, 3, 1, 9, 1, 1]


def test_each_race_starts_from_one_epoch_and_shows_its_curves():
    for race in make_traffic(CONFIG, MIX, BIG_SEED).races:
        first = race.rungs[0][1]
        assert np.all(first.sum(1) == 1)
        for Y, mask in race.rungs:
            assert np.all(mask >= first)
            assert np.array_equal(Y, race.Y_full * mask)
