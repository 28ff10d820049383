"""The pose fit's four A/B knobs in the port against the JAX package's,
on the CPU: `use_gt_association` (with `joint_cls_gt`), `axis_agg="mean"`,
`batch_joints=True` and `hypo_estimator="lm"`.

Each runs JAX's `fit_frame_batch` and the port's on the same frames and
on JAX's own draws (`test_torch_pose.jax_draws`), held to
`test_torch_pose.py`'s full-fit tolerances; `batch_joints=True` must
also give exactly the loop's fits on the same draws.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulated_pose_tpu.data.synthetic import SyntheticArticulated
from articulated_pose_tpu.pose import pipeline as jpipe
from articulated_pose_tpu_torch.pose import pipeline
from test_torch_pose import _t, jax_draws, perfect_pred, port_cfg

B = 2

# (name, parts, joint types, knobs)
CASES = [
    ("gt_association", 2, ("revolute",), dict(use_gt_association=True)),
    ("axis_mean", 2, ("revolute",), dict(axis_agg="mean")),
    ("batch_joints", 3, ("revolute", "revolute"), dict(batch_joints=True)),
    ("hypo_lm", 2, ("revolute",), dict(hypo_estimator="lm")),
]


def frames(n_parts, joint_types, seed):
    """B frames of the synthetic generator with oracle predictions,
    except for the joint head's association, which is scrambled on a
    third of the points."""
    gen = SyntheticArticulated(n_parts=n_parts, points_per_part=150,
                               joint_types=list(joint_types), seed=seed)
    batch, _ = gen.batch(np.random.RandomState(seed), B, num_points=128)
    preds = [perfect_pred({k: batch[k][i] for k in batch}, n_parts)
             for i in range(B)]
    pred = {k: np.stack([p[k] for p in preds]) for k in preds[0]}
    rng = np.random.RandomState(seed + 100)
    wrong = rng.rand(B, 128) < 0.33
    scrambled = np.eye(n_parts, dtype=np.float32)[
        rng.randint(0, n_parts, (B, 128))]
    pred["index_per_point"] = np.where(wrong[..., None], scrambled,
                                       pred["index_per_point"])
    return pred, batch


def jax_and_port(pred, batch, jcfg, key, joint_cls_gt=None):
    want = jax.device_get(jpipe.fit_frame_batch(
        {k: jnp.asarray(v) for k, v in pred.items()},
        jnp.asarray(batch["P"]), key, jcfg,
        joint_cls_gt=None if joint_cls_gt is None
        else jnp.asarray(joint_cls_gt)))
    cfg = port_cfg(jcfg)
    got = pipeline.fit_frame_batch(
        {k: _t(v) for k, v in pred.items()},
        _t(batch["P"].astype(np.float32)), jax_draws(key, B, cfg), cfg,
        joint_cls_gt=None if joint_cls_gt is None else _t(joint_cls_gt))
    return {k: v.numpy() for k, v in got.items()}, want


def assert_fits_close(got, want):
    """test_torch_pose.py's tolerances for the whole fit."""
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["part_counts"], want["part_counts"])
    for prefix in ("baseline", "nonlinear"):
        np.testing.assert_allclose(got[f"{prefix}_R"], want[f"{prefix}_R"],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[f"{prefix}_s"], want[f"{prefix}_s"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got[f"{prefix}_t"], want[f"{prefix}_t"],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,n_parts,joint_types,knobs", CASES,
                         ids=[c[0] for c in CASES])
def test_knob_matches_jax(name, n_parts, joint_types, knobs):
    pred, batch = frames(n_parts, joint_types, seed=len(name))
    jcfg = jpipe.PoseFitConfig(
        n_parts=n_parts, niter_part=32, niter_joint=16,
        joint_types=joint_types, lm_iters_hypo=5, lm_iters_refit=10,
        ransac_chunk=None, **knobs)
    key = jax.random.PRNGKey(7)
    jc = None
    if knobs.get("use_gt_association"):
        # the joint head associates every point with joint 1, and every
        # point but joint 1's predicts the x axis: the head's vote for
        # joint 1 is x, the GT labels' is joint 1's own axis
        jc = batch["joint_cls_gt"]
        pred["index_per_point"] = np.eye(n_parts, dtype=np.float32)[
            np.ones((B, 128), int)]
        pred["joint_axis_per_point"][jc != 1] = [1.0, 0.0, 0.0]
    got, want = jax_and_port(pred, batch, jcfg, key, jc)
    assert_fits_close(got, want)
    if jc is not None:
        # the GT labels moved the fit: without them it is another one
        cfg = port_cfg(jcfg)
        plain = pipeline.fit_frame_batch(
            {k: _t(v) for k, v in pred.items()},
            _t(batch["P"].astype(np.float32)), jax_draws(key, B, cfg), cfg)
        assert not np.array_equal(plain["nonlinear_R"].numpy(),
                                  got["nonlinear_R"])


@pytest.mark.parametrize("joint_types", [("revolute", "revolute"),
                                         ("prismatic",) * 3,
                                         ("revolute", "prismatic", "revolute")],
                         ids=["K3", "K4_drawer", "K4_mixed"])
def test_batch_joints_equals_the_loop(joint_types):
    """Same draws: batch_joints=True gives exactly the loop's fits."""
    K = len(joint_types) + 1
    pred, batch = frames(K, joint_types, seed=K)
    cfg = pipeline.PoseFitConfig(n_parts=K, niter_part=32, niter_joint=16,
                                 joint_types=joint_types, ransac_chunk=None)
    draws = pipeline.PoseDraws.sample(B, cfg, torch.Generator().manual_seed(0))
    args = ({k: _t(v) for k, v in pred.items()},
            _t(batch["P"].astype(np.float32)), draws)
    loop = pipeline.fit_frame_batch(*args, cfg)
    batched = pipeline.fit_frame_batch(
        *args, dataclasses.replace(cfg, batch_joints=True))
    assert set(loop) == set(batched)
    for k in loop:
        assert torch.equal(loop[k], batched[k]), k


def test_mean_vote_falls_back_to_z():
    """A joint with no associated point, or whose axes cancel, votes +z
    (pipeline.py:240-253); otherwise the normalised mean, as JAX's."""
    axis = np.zeros((1, 6, 3), np.float32)
    axis[0, :2] = [[1, 0, 0], [-1, 0, 0]]              # cancel
    axis[0, 2:4] = [[0.6, 0.8, 0], [0.6, 0.8, 0.2]]
    assocs = np.zeros((1, 3, 6), np.float32)
    assocs[0, 0, :2] = 1                               # cancelling
    assocs[0, 1, 2:4] = 1                              # a real vote
    got = pipeline.vote_joint_axes(_t(axis), _t(assocs), "mean").numpy()
    want = np.asarray(jpipe.vote_joint_axes(jnp.asarray(axis[0]),
                                            jnp.asarray(assocs[0]), "mean"))
    np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[0, [0, 2]], [[0, 0, 1], [0, 0, 1]])
    np.testing.assert_allclose(np.linalg.norm(got[0, 1]), 1.0, rtol=1e-6)
