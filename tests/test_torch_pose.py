"""The port's pose stage against the JAX package's, on the CPU.

Inputs come from numpy seeds.  Where the JAX code draws random numbers,
the port is handed the very same uniforms (`jax_draws` rebuilds the JAX
key tree of pipeline.py:362/457 and :267-270), so the fits must agree to
float rounding, not just statistically.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulated_pose_tpu.data.synthetic import SyntheticArticulated
from articulated_pose_tpu.pose import lm as jlm
from articulated_pose_tpu.pose import pipeline as jpipe
from articulated_pose_tpu.pose import ransac as jransac
from articulated_pose_tpu.pose import umeyama as jum
from articulated_pose_tpu.utils import transforms as tr
from articulated_pose_tpu_torch.pose import lm, pipeline, ransac, umeyama


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return np.asarray(x)


def port_cfg(jcfg: jpipe.PoseFitConfig) -> pipeline.PoseFitConfig:
    names = [f.name for f in dataclasses.fields(pipeline.PoseFitConfig)]
    return pipeline.PoseFitConfig(**{n: getattr(jcfg, n) for n in names})


def jax_draws(key, B: int, cfg) -> pipeline.PoseDraws:
    """The uniforms JAX's fit_frame_batch draws from `key`, as PoseDraws:
    split(key, B); per frame split(k, 2K-1); part j: uniform(ks[j]);
    joint j: k0, k1 = split(ks[K+j-1])."""
    K = cfg.n_parts
    part, joint = [], []
    for kb in jax.random.split(key, B):
        ks = jax.random.split(kb, 2 * K - 1)
        part.append([jax.random.uniform(ks[j], (cfg.niter_part, 3))
                     for j in range(K)])
        joint.append([[jax.random.uniform(k, (cfg.niter_joint, 3))
                       for k in jax.random.split(ks[K + j - 1])]
                      for j in range(1, K)])
    part = np.asarray(part, np.float32)
    joint = np.asarray(joint, np.float32).reshape(
        B, K - 1, 2, cfg.niter_joint, 3)
    return pipeline.PoseDraws(part=_t(part), joint=_t(joint))


def perfect_pred(sample, n_parts):
    """Oracle predictions from GT labels (as tests/test_pose.py builds them)."""
    N = sample["P"].shape[0]
    cls = sample["cls_gt"].astype(int)
    nocs = np.zeros((N, 3 * n_parts), np.float32)
    for j in range(n_parts):
        nocs[cls == j, 3 * j:3 * (j + 1)] = sample["nocs_gt"][cls == j]
    return {
        "W": np.eye(n_parts, dtype=np.float32)[cls],
        "nocs_per_point": nocs,
        "joint_axis_per_point": sample["orient_gt"].astype(np.float32),
        "index_per_point": np.eye(n_parts, dtype=np.float32)[
            sample["joint_cls_gt"].astype(int) % n_parts],
    }


def random_similarity_pairs(rng, shape, n):
    """src (shape, n, 3) and tgt = s·R·src + t + noise."""
    src = rng.rand(*shape, n, 3).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    R = q * np.sign(np.linalg.det(q))
    tgt = 1.3 * src @ R.T + np.array([0.1, -0.2, 0.3])
    tgt = tgt + 0.01 * rng.randn(*tgt.shape)
    return src, tgt.astype(np.float32)


class TestUmeyama:
    def test_fit_3pt_similarity(self):
        rng = np.random.RandomState(0)
        src, tgt = random_similarity_pairs(rng, (64,), 3)
        src[0, 1] = src[0, 0]                     # a degenerate sample
        tgt[0, 1] = tgt[0, 0]
        R, s, t = umeyama.fit_3pt_similarity(_t(src), _t(tgt))
        jR, js, jt = jax.vmap(jum.fit_3pt_similarity)(jnp.asarray(src),
                                                      jnp.asarray(tgt))
        # the 12 renormalised squarings amplify f32 rounding that the two
        # backends place differently (eigenvector error ~ eps / eigengap)
        np.testing.assert_allclose(R.numpy(), _np(jR), atol=1e-4)
        np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.numpy(), _np(jt), atol=1e-4)

    @pytest.mark.parametrize("n", [40, 300])      # exact / strided pair sums
    def test_transform_pts_weighted(self, n):
        rng = np.random.RandomState(1)
        src, tgt = random_similarity_pairs(rng, (3,), n)
        w = (rng.rand(3, n) > 0.3).astype(np.float32)
        R, s, t = umeyama.transform_pts(_t(src), _t(tgt), _t(w))
        jR, js, jt = jax.vmap(jum.transform_pts)(
            jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
        np.testing.assert_allclose(R.numpy(), _np(jR), atol=1e-5)
        np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-5)
        np.testing.assert_allclose(t.numpy(), _np(jt), atol=1e-5)


class TestRansac:
    def test_hypothesis_inlier_counts(self):
        rng = np.random.RandomState(2)
        src, tgt = random_similarity_pairs(rng, (), 200)
        idx = rng.randint(0, 200, (48, 3))
        Rs, ss, ts = jax.vmap(jum.fit_3pt_similarity)(
            jnp.asarray(src[idx]), jnp.asarray(tgt[idx]))
        mask = rng.rand(200) > 0.2
        th = 0.05
        got = ransac.hypothesis_inlier_counts(
            _t(_np(Rs)), _t(_np(ss)), _t(_np(ts)), _t(src), _t(tgt),
            _t(mask), th).numpy()
        want = _np(jransac.hypothesis_inlier_counts(
            Rs, ss, ts, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
            th))
        # residuals within 1e-5 of the threshold may fall either way
        pred = (_np(ss)[:, None, None] * src[None] @ np.transpose(
            _np(Rs), (0, 2, 1)) + _np(ts)[:, None])
        r2 = ((tgt[None].astype(np.float64) - pred) ** 2).sum(-1)
        near = (np.abs(r2 - th * th) < 1e-5 * th * th) & mask
        assert np.all(np.abs(got - want) <= near.sum(-1))
        assert (got == want).mean() > 0.9

    def test_sample_indices_match_jax(self):
        key = jax.random.PRNGKey(4)
        mask = np.zeros(50, np.float32)
        mask[:37] = 1.0
        want = _np(jransac.masked_sample_indices(key, jnp.asarray(mask),
                                                 (64, 3), compact=True))
        u = _t(_np(jax.random.uniform(key, (64, 3))))
        got = ransac.masked_sample_indices(u, _t(mask))
        np.testing.assert_array_equal(got.numpy(), want)


class TestJointLM:
    @pytest.mark.parametrize("prismatic", [False, True])
    def test_lm_refine_joint(self, prismatic):
        rng = np.random.RandomState(5)
        x0, y0 = random_similarity_pairs(rng, (), 60)
        x1, y1 = random_similarity_pairs(rng, (), 60)
        m0 = (rng.rand(60) > 0.2).astype(np.float32)
        m1 = (rng.rand(60) > 0.2).astype(np.float32)
        a = np.array([0.0, 0.6, 0.8], np.float32)
        v0 = np.array([0.1, -0.2, 0.3], np.float32)
        v1 = np.array([0.2, 0.1, -0.1], np.float32)
        args = (v0, v1, x0, y0, m0, x1, y1, m1, a, np.float32(40.0))
        g0, g1 = lm.lm_refine_joint(*map(_t, args), iters=8,
                                    prismatic=prismatic)
        w0, w1 = jlm.lm_refine_joint(*map(jnp.asarray, args), iters=8,
                                     prismatic=prismatic)
        np.testing.assert_allclose(g0.numpy(), _np(w0), atol=1e-4)
        np.testing.assert_allclose(g1.numpy(), _np(w1), atol=1e-4)

    @pytest.mark.parametrize("prismatic", [False, True])
    def test_joint_transformation_estimate_alt(self, prismatic):
        rng = np.random.RandomState(6)
        s0, t0 = random_similarity_pairs(rng, (32,), 3)
        s1, t1 = random_similarity_pairs(rng, (32,), 3)
        ones = np.ones((32, 3), np.float32)
        axis = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (32, 1))
        got = lm.joint_transformation_estimate_alt(
            *map(_t, (s0, t0, ones, s1, t1, ones, axis)), sweeps=3,
            prismatic=prismatic)
        want = jax.vmap(lambda *a: jlm.joint_transformation_estimate_alt(
            *a, sweeps=3, prismatic=prismatic))(
            *map(jnp.asarray, (s0, t0, ones, s1, t1, ones, axis)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4,
                                       rtol=1e-4)

    def test_rotvec_round_trip(self):
        rng = np.random.RandomState(7)
        v = rng.uniform(-2.0, 2.0, (20, 3)).astype(np.float32)
        R = lm.rotvec_to_matrix(_t(v))
        np.testing.assert_allclose(
            R.numpy(), _np(jax.vmap(jlm.rotvec_to_matrix)(jnp.asarray(v))),
            atol=1e-6)
        np.testing.assert_allclose(lm.matrix_to_rotvec(R).numpy(), v,
                                   atol=1e-4)


class TestPipeline:
    def test_build_part_buffers_sorted_exact(self):
        K, cap, N, B = 3, 64, 128, 4
        rng = np.random.RandomState(9)
        cls = rng.randint(0, K, (B, N))
        P = rng.rand(B, N, 3).astype(np.float32)
        nocs = rng.rand(B, N, 3 * K).astype(np.float32)
        got = pipeline.build_part_buffers_sorted(_t(nocs), _t(P), _t(cls), K,
                                                 cap)
        want = jax.vmap(lambda n, p, c: jpipe.build_part_buffers_sorted(
            n, p, c, K, cap))(jnp.asarray(nocs), jnp.asarray(P),
                              jnp.asarray(cls))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w))

    def test_masked_median(self):
        rng = np.random.RandomState(10)
        x = rng.rand(3, 31, 3).astype(np.float32)
        mask = (rng.rand(3, 31) > 0.5).astype(np.float32)
        mask[2] = 0.0                              # no row: inf
        got = pipeline.masked_median(_t(x), _t(mask)).numpy()
        want = _np(jax.vmap(jpipe.masked_median)(jnp.asarray(x),
                                                 jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want)
        assert np.isinf(got[2]).all()

    def test_fit_frame_batch_matches_jax(self):
        n_parts = 2
        gen = SyntheticArticulated(n_parts=n_parts, points_per_part=150,
                                   seed=3)
        batch, gts = gen.batch(np.random.RandomState(1), 2, num_points=128)
        preds = [perfect_pred({k: batch[k][i] for k in batch}, n_parts)
                 for i in range(2)]
        pred = {k: np.stack([p[k] for p in preds]) for k in preds[0]}
        jcfg = jpipe.PoseFitConfig(
            n_parts=n_parts, niter_part=64, niter_joint=16,
            joint_types=("revolute",), lm_iters_hypo=5, lm_iters_refit=10,
            ransac_chunk=None)
        key = jax.random.PRNGKey(0)
        want = jax.device_get(jpipe.fit_frame_batch(
            {k: jnp.asarray(v) for k, v in pred.items()},
            jnp.asarray(batch["P"]), key, jcfg))
        cfg = port_cfg(jcfg)
        got = pipeline.fit_frame_batch({k: _t(v) for k, v in pred.items()},
                                       _t(batch["P"].astype(np.float32)),
                                       jax_draws(key, 2, cfg), cfg)
        got = {k: v.numpy() for k, v in got.items()}
        assert set(got) == set(want)
        # the single-frame entry point is the batch's row
        d = jax_draws(key, 2, cfg)
        one = pipeline.fit_frame({k: _t(v[1]) for k, v in pred.items()},
                                 _t(batch["P"][1].astype(np.float32)),
                                 pipeline.PoseDraws(d.part[1], d.joint[1]),
                                 cfg)
        for k, v in one.items():
            np.testing.assert_array_equal(v.numpy(), got[k][1], err_msg=k)
        np.testing.assert_array_equal(got["part_counts"], want["part_counts"])
        for prefix in ("baseline", "nonlinear"):
            np.testing.assert_allclose(got[f"{prefix}_R"], want[f"{prefix}_R"],
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(got[f"{prefix}_s"], want[f"{prefix}_s"],
                                       rtol=1e-4)
            np.testing.assert_allclose(got[f"{prefix}_t"], want[f"{prefix}_t"],
                                       rtol=0, atol=1e-4)
            for i in range(2):
                for j in range(n_parts):
                    s_gt, R_gt, t_gt = tr.decompose_similarity(
                        gts[i].rt_nocs2cam[j])
                    assert tr.rot_diff_degree(got[f"{prefix}_R"][i, j],
                                              R_gt) < 3.0
                    np.testing.assert_allclose(got[f"{prefix}_s"][i, j], s_gt,
                                               rtol=0.05)
                    np.testing.assert_allclose(got[f"{prefix}_t"][i, j], t_gt,
                                               atol=0.05)
