"""The FPS wrappers' launch plan and tie rule, on the CPU.

`fps.fps_plan` decides, from the shape alone, which variant of
`csrc/fps.cu` a launch takes and how many CTAs of a thread-block cluster
share a cloud.  It needs no library, so it is held here to its choices
at the port's path shapes (the sweep on the card that set them is in
PERF.md section 6).  The cluster merge has to keep the lowest-index tie
rule across warps and CTAs; a tie-heavy grid cloud pins that rule: the
plain versions against the Pallas kernels in interpret mode, exact.
The kernels themselves are held against the plain versions on the card
by tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from articulated_pose_tpu.ops.pallas.fps import (farthest_point_sample2_pallas,
                                                 farthest_point_sample_pallas)
from articulated_pose_tpu_torch.ops.kernels import fps


# (B, N, np1) of each path that launches FPS, and the plan it must get
@pytest.mark.parametrize("B,N,np1,plan", [
    (16, 2048, 512, ("w4p16", 1)),      # serving forward (fps2)
    (64, 2048, 512, ("w4p16", 1)),      # packed / bucket forward, fps1
    (4, 32768, 512, ("w4p16", 16)),     # large-cloud forward
    (1, 32768, 512, ("w4p16", 16)),
    (8, 8192, 1024, ("w1p16", 16)),     # N-level SA1: 128 one-warp CTAs
    (8, 4097, 1024, ("w1p16", 16)),
    (8, 1024, 256, ("w4p8", 1)),        # N-level SA2
    (8, 256, 64, ("w1p16", 1)),         # N-level SA3
    (8, 64, 16, ("w1p4", 1)),           # N-level SA4
    (64, 512, 128, ("w1p16", 1)),       # profiler fps2
    (2, 100003, 512, ("stream", 16)),   # past every register variant
    (1, 32769, 512, ("stream", 16)),
])
def test_plan_at_path_shapes(B, N, np1, plan):
    assert fps.fps_plan(B, N, np1) == plan
    # decided without building or loading the library
    assert fps.KERNEL._lib is None and fps.SINGLE_KERNEL._lib is None


@pytest.mark.parametrize("N", [1, 2, 127, 128, 129, 511, 512, 513, 1024,
                               1025, 2047, 2048, 2049, 8192, 8193, 32768,
                               32769, 131072, 131073])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_plan_holds_the_cloud(B, N):
    variant, cluster = fps.fps_plan(B, N, 1)
    assert cluster in fps.CLUSTERS
    assert fps.fits(variant, N, cluster)
    # a cluster only where one CTA cannot hold the cloud
    assert cluster == 1 or N > fps.CTA_POINTS


@pytest.mark.parametrize("B,N,np1", [(0, 2048, 512), (2, 2048, 0),
                                     (2, 0, 1)])
def test_plan_rejects_bad_shapes(B, N, np1):
    with pytest.raises(ValueError):
        fps.fps_plan(B, N, np1)


# more picks than points, as the TPU kernels take them (the joint
# baseline's SA1 picks 512): the plan is the cloud's, whatever np1 is
@pytest.mark.parametrize("N", [1, 100, 511])
@pytest.mark.parametrize("B", [1, 16])
def test_plan_takes_more_picks_than_points(B, N):
    assert fps.fps_plan(B, N, 512) == fps.fps_plan(B, N, 1)


# picks past the cloud's points: every running minimum is 0, so each is
# index 0; the plain versions against the Pallas kernels in interpret
# mode, exact (fps2's level 2 also picks more than level 1 holds)
@pytest.mark.parametrize("N", [1, 100])
def test_more_picks_than_points_match_pallas(N):
    xyz = np.random.RandomState(50 + N).rand(2, N, 3).astype(np.float32)
    idx, new_xyz = (v.numpy() for v in fps.fps_plain(torch.from_numpy(xyz),
                                                     128))
    want = np.asarray(farthest_point_sample_pallas(128, jnp.asarray(xyz),
                                                   interpret=True))
    np.testing.assert_array_equal(idx, want)
    assert (idx[:, N:] == 0).all()
    np.testing.assert_array_equal(
        new_xyz, np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1))
    for np1, np2 in ((128, 32), (64, 96)):
        got = [v.numpy() for v in fps.fps2_plain(torch.from_numpy(xyz), np1,
                                                 np2)]
        want = [np.asarray(v) for v in farthest_point_sample2_pallas(
            np1, np2, jnp.asarray(xyz), interpret=True)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the sweep runs on a card that is present")
def test_sweep_needs_a_card():
    from articulated_pose_tpu_torch import fps_sweep

    assert fps_sweep.main([]) == 2
    # every shape the sweep times is one the plan holds
    for _, B, N, np1, _, _ in fps_sweep.SHAPES:
        variant, cluster = fps.fps_plan(B, N, np1)
        assert fps.fits(variant, N, cluster)


def _grid_cloud(seed, B, N, side):
    """Points on a coarse integer grid scaled by 1/8: exact duplicates and
    exactly equal distances, with every product and sum exact."""
    g = np.random.RandomState(seed).randint(0, side, (B, N, 3))
    return (g * 0.125).astype(np.float32)


# side 4 leaves 64 positions for 1024 points: past the 64th pick every
# running minimum is 0 and each pick is a tie broken by the lowest index
@pytest.mark.parametrize("side", [4, 16])
def test_tie_heavy_grid_matches_pallas(side):
    xyz = _grid_cloud(40 + side, 2, 1024, side)
    np1, np2 = 256, 64
    i1, x1, i2, x2 = (v.numpy() for v in fps.fps2_plain(
        torch.from_numpy(xyz), np1, np2))
    p1, px1, p2, px2 = (np.asarray(v) for v in farthest_point_sample2_pallas(
        np1, np2, jnp.asarray(xyz), interpret=True))
    np.testing.assert_array_equal(i1, p1)
    np.testing.assert_array_equal(i2, p2)
    np.testing.assert_array_equal(x1, px1)
    np.testing.assert_array_equal(x2, px2)

    idx, new_xyz = (v.numpy() for v in fps.fps_plain(torch.from_numpy(xyz),
                                                     np1))
    single = np.asarray(farthest_point_sample_pallas(np1, jnp.asarray(xyz),
                                                     interpret=True))
    np.testing.assert_array_equal(idx, single)
    np.testing.assert_array_equal(idx, i1)
    np.testing.assert_array_equal(
        new_xyz, np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1))
