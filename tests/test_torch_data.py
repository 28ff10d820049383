"""The port's host data feed against the JAX package's, on the CPU.

The NumPy copies must give the JAX package's arrays bit for bit for the
same seeds: synthetic frames (both on the NumPy labeling path,
`use_native=False`) and batches (both on their default path),
`labeling.build_sample`, the transforms and the training jitter; the
iterators the same order.
`device_prefetch` on the CPU yields the same batches in the same order
(its card path is driven by chip_smoke.py phase 10).
"""

import numpy as np
import pytest
import torch

from articulated_pose_tpu.data import augment as jaugment
from articulated_pose_tpu.data import batcher as jbatcher
from articulated_pose_tpu.data import labeling as jlabeling
from articulated_pose_tpu.data import synthetic as jsynthetic
from articulated_pose_tpu.utils import transforms as jtr
from articulated_pose_tpu_torch.data import augment, batcher, labeling
from articulated_pose_tpu_torch.data import synthetic
from articulated_pose_tpu_torch.utils import transforms as tr


def assert_same_sample(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("nocs_type,n_max_parts", [("AC", None), ("A", 4),
                                                   ("C", None)])
def test_frames_equal_jax(seed, nocs_type, n_max_parts):
    kw = dict(n_parts=3, points_per_part=120, seed=seed,
              joint_types=["revolute", "prismatic"])
    got_gen = synthetic.SyntheticArticulated(**kw)
    want_gen = jsynthetic.SyntheticArticulated(**kw)
    r1, r2 = np.random.RandomState(seed + 10), np.random.RandomState(seed + 10)
    for _ in range(2):
        got, got_gt = got_gen.frame(r1, num_points=256, nocs_type=nocs_type,
                                    n_max_parts=n_max_parts, noise=0.01,
                                    use_native=False)
        want, want_gt = want_gen.frame(r2, num_points=256,
                                       nocs_type=nocs_type,
                                       n_max_parts=n_max_parts, noise=0.01,
                                       use_native=False)
        assert_same_sample(got, want)
        for field in ("rt_nocs2cam", "scales", "joint_axes_cam",
                      "joint_points_cam", "states", "rt_naocs2cam"):
            np.testing.assert_array_equal(getattr(got_gt, field),
                                          getattr(want_gt, field))


@pytest.mark.parametrize("seed", [0, 3])
def test_batch_equals_jax_frames(seed):
    gen = synthetic.SyntheticArticulated(n_parts=3, points_per_part=100,
                                         seed=seed, full_rotation=False)
    jgen = jsynthetic.SyntheticArticulated(n_parts=3, points_per_part=100,
                                           seed=seed, full_rotation=False)
    # both on their default labeling path: the C++ one where it builds
    got, _ = gen.batch(np.random.RandomState(seed), 3, num_points=128)
    r = np.random.RandomState(seed)
    frames = [jgen.frame(r, num_points=128)[0] for _ in range(3)]
    assert_same_sample(got, {k: np.stack([f[k] for f in frames])
                             for k in frames[0]})


def test_native_labeling_is_not_ported():
    """Once raised NotImplementedError; the C++ labeling is ported now,
    so use_native=True gives the native labels (tests/test_torch_native.py
    holds them to JAX's) and never quietly the NumPy ones."""
    gen = synthetic.SyntheticArticulated(n_parts=2, points_per_part=50)
    got, _ = gen.frame(np.random.RandomState(0), num_points=64,
                       use_native=True)
    want, _ = jsynthetic.SyntheticArticulated(
        n_parts=2, points_per_part=50).frame(np.random.RandomState(0),
                                             num_points=64, use_native=True)
    assert_same_sample(got, want)


def test_build_sample_equals_jax():
    rng = np.random.RandomState(5)
    parts = [rng.rand(40 + 10 * j, 3) for j in range(3)]
    canon = [rng.rand(40 + 10 * j, 3) for j in range(3)]

    def joints(mod):
        return [mod.JointSpec(position=rng.rand(3), axis=rng.rand(3),
                              parent=0, child=j, jtype=t)
                for j, t in ((1, "revolute"), (2, "prismatic"))]

    state = rng.get_state()
    got_j = joints(labeling)
    rng.set_state(state)
    want_j = joints(jlabeling)
    for nocs_type in ("AC", "A", "C"):
        got = labeling.build_sample(
            parts, canon, got_j, labeling.NormInfo.from_parts(canon),
            num_points=256, nocs_type=nocs_type, n_max_parts=4,
            rng=np.random.RandomState(1))
        want = jlabeling.build_sample(
            parts, canon, want_j, jlabeling.NormInfo.from_parts(canon),
            num_points=256, nocs_type=nocs_type, n_max_parts=4,
            rng=np.random.RandomState(1))
        assert_same_sample(got, want)
    with pytest.raises(ValueError, match="nocs_type"):
        labeling.build_sample(parts, canon, got_j,
                              labeling.NormInfo.from_parts(canon),
                              nocs_type="B")


def test_transforms_equal_jax():
    rng1, rng2 = np.random.RandomState(2), np.random.RandomState(2)
    for _ in range(5):
        np.testing.assert_array_equal(tr.random_rotation(rng1),
                                      jtr.random_rotation(rng2))
    axis, point, pts = np.array([0.3, -1.0, 0.5]), np.ones(3), rng1.rand(9, 3)
    for name, args in (("rotvec_to_matrix", (axis,)),
                       ("rotvec_to_matrix", (np.zeros(3),)),
                       ("axis_angle_matrix", (axis, 0.7)),
                       ("rotation_about_line", (axis, point, -1.1)),
                       ("translation_along", (axis, 0.25))):
        np.testing.assert_array_equal(getattr(tr, name)(*args),
                                      getattr(jtr, name)(*args), err_msg=name)
    T = tr.similarity(1.3, tr.axis_angle_matrix(axis, 0.4), point)
    np.testing.assert_array_equal(
        T, jtr.similarity(1.3, jtr.axis_angle_matrix(axis, 0.4), point))
    np.testing.assert_array_equal(tr.apply_similarity(T, pts),
                                  jtr.apply_similarity(T, pts))
    s, R, t = tr.decompose_similarity(T)
    js, jR, jt = jtr.decompose_similarity(T)
    assert s == js
    np.testing.assert_array_equal(R, jR)
    np.testing.assert_array_equal(t, jt)


def test_train_noise_equals_jax():
    batch = {"P": np.random.RandomState(3).rand(4, 64, 3).astype(np.float32),
             "cls_gt": np.zeros((4, 64), np.float32)}
    got = augment.train_noise_batch(batch, np.random.RandomState(9))
    want = jaugment.train_noise_batch(batch, np.random.RandomState(9))
    assert_same_sample(got, want)
    assert got["cls_gt"] is batch["cls_gt"]


def _samples(n):
    rng = np.random.RandomState(4)
    return [{"P": rng.rand(8, 3).astype(np.float32),
             "cls_gt": np.full((8,), i, np.float32)} for i in range(n)]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_order_equals_jax(drop_last, shuffle):
    samples = _samples(11)
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, drop_last=drop_last)
    got = batcher.BatchIterator(11, lambda i: samples[i], **kw)
    want = jbatcher.BatchIterator(11, lambda i: samples[i], **kw)
    assert len(got) == len(want)
    for _ in range(3):                            # three epochs
        a, b = list(got), list(want)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_sample(x, y)


def test_batch_iterator_transform_equals_jax():
    samples = _samples(8)
    kw = dict(batch_size=4, seed=1, transform=augment.train_noise_batch)
    got = batcher.BatchIterator(8, lambda i: samples[i], **kw)
    want = jbatcher.BatchIterator(8, lambda i: samples[i], **{
        **kw, "transform": jaugment.train_noise_batch})
    for x, y in zip(list(got) + list(got), list(want) + list(want)):
        assert_same_sample(x, y)


def test_streaming_iterator_equals_jax():
    def make(rng):
        return {"P": rng.rand(8, 3).astype(np.float32)}

    got = batcher.StreamingIterator(make, batch_size=3, batches_per_epoch=4,
                                    seed=2)
    want = jbatcher.StreamingIterator(make, batch_size=3, batches_per_epoch=4,
                                      seed=2)
    assert len(got) == len(want) == 4
    for x, y in zip(list(got) + list(got), list(want) + list(want)):
        assert_same_sample(x, y)


@pytest.mark.parametrize("size", [1, 2, 5])
def test_device_prefetch_on_the_cpu(size):
    samples = _samples(10)
    it = batcher.BatchIterator(10, lambda i: samples[i], batch_size=3, seed=0,
                               drop_last=False)
    want = list(batcher.BatchIterator(10, lambda i: samples[i], batch_size=3,
                                      seed=0, drop_last=False))
    got = list(batcher.device_prefetch(it, size=size, device="cpu"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
