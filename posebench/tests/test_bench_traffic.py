"""The traffic generator: a seed gives its traffic, another seed other
traffic."""

import numpy as np

from posebench import harness
from posebench.traffic import generator

MIX = dict(pool=4, points=128, ring=3, batch=2, noise=0.005)


def test_same_seed_same_batches():
    a = generator.batches(2 ** 31 + 9, MIX)
    b = generator.batches(2 ** 31 + 9, MIX)
    c = generator.batches(2 ** 31 + 10, MIX)
    assert len(a) == 3 and a[0].shape == (2, 128, 3)
    assert a[0].dtype == np.float32
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))


def test_clouds_are_distinct_and_unit_scale():
    ring = np.concatenate(generator.batches(1, dict(MIX, ring=4)))
    flat = ring.reshape(len(ring), -1)
    assert len(np.unique(flat, axis=0)) == len(ring)
    diag = np.linalg.norm(ring.max(1) - ring.min(1), axis=1)
    assert np.all((diag > 0.5) & (diag < 1.5))


def test_sub_seeds_fit_their_streams():
    for seed in (0, 1, 2 ** 31 + 5, 2 ** 40):
        for tag in ("weights", "data", "dropout"):
            s = harness.sub_seed(seed, tag)
            assert 0 <= s < 2 ** 31
        assert harness.sub_seed(seed, "draws", 63) < 2 ** 63
    assert harness.sub_seed(1, "weights") != harness.sub_seed(2, "weights")
    assert harness.sub_seed(1, "weights") != harness.sub_seed(1, "data")
