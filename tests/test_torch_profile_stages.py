"""The stage profiler's path on the CPU: `partition_by_class`, the
part-buffer build it serves, the joint-hypothesis half of the joint RANSAC, and
`profile_stages` itself at tiny widths.

The pose pieces are held against the JAX package on the same numpy
inputs (and, where JAX draws random numbers, the same uniforms).  The
profiler's device columns need the card; here it runs every stage
through the plain versions and prints host-clock times only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulated_pose_tpu.data.synthetic import SyntheticArticulated
from articulated_pose_tpu.pose import pipeline as jpipe
from articulated_pose_tpu_torch import profile_stages
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec)
from articulated_pose_tpu_torch.pose import pipeline
from test_torch_pose import jax_draws, perfect_pred, port_cfg

TINY = BackboneSpec(**TINY_WIDTHS)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _labels(seed, B, N, K):
    """Labels in [-1, K]: the out-of-range ones are clamped, as in JAX."""
    return np.random.RandomState(seed).randint(-1, K + 1, (B, N))


class TestPartitionByClass:
    @pytest.mark.parametrize("cap", [None, 40, 150, 500])
    def test_matches_jax(self, cap):
        K, B, N = 3, 3, 200
        cls = _labels(50, B, N, K)
        order, cnt = pipeline.partition_by_class(_t(cls), K, cap)
        jorder, jcnt = jax.vmap(lambda c: jpipe.partition_by_class(
            c, K, cap=cap))(jnp.asarray(cls))
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        assert order.dtype == torch.int32 and cnt.dtype == torch.int32
        assert order.shape == (B, K, min(cap or N, N))

    def test_overflow_branch_gives_the_same_rows(self, monkeypatch):
        """Where the composite key (cls << ceil_log2(N)) | index would
        overflow int32 (K·N >= 2^30 points, too large for a test), a
        stable argsort of the labels takes its place; with the key limit
        lowered, that branch must give JAX's rows exactly."""
        K, B, N = 4, 2, 300
        cls = _labels(51, B, N, K)
        jorder, jcnt = jax.vmap(lambda c: jpipe.partition_by_class(
            c, K, cap=100))(jnp.asarray(cls))
        monkeypatch.setattr(pipeline, "KEY_LIMIT", 1)
        order, cnt = pipeline.partition_by_class(_t(cls), K, 100)
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def _jax_gather_build(nocs, P, cls, K, cap):
    """The reference's buffer_build="gather" branch of fit_frame
    (pipeline.py:348-355), over a batch."""
    def one(n, p, c):
        orders, cnts = jpipe.partition_by_class(c, K, cap=cap)
        mask = (jnp.arange(cap)[None, :] < cnts[:, None]).astype(p.dtype)
        parts = jnp.transpose(n.reshape(-1, K, 3), (1, 0, 2))
        src = jnp.take_along_axis(parts, orders[:, :, None], axis=1)
        return (src * mask[:, :, None], p[orders] * mask[:, :, None], mask,
                cnts)
    return jax.device_get(jax.vmap(one)(*map(jnp.asarray, (nocs, P, cls))))


class TestGatherBuild:
    """The port has one part-buffer build; it must give the buffers of
    both of the reference's builds, for any N."""

    @pytest.mark.parametrize("cap", [64, 128])
    def test_equals_the_sorted_build(self, cap):
        K, B, N = 3, 4, 128
        rng = np.random.RandomState(52)
        cls = rng.randint(0, K, (B, N))
        P = rng.rand(B, N, 3).astype(np.float32)
        nocs = rng.rand(B, N, 3 * K).astype(np.float32)
        got = pipeline.build_part_buffers_sorted(_t(nocs), _t(P), _t(cls), K,
                                                 cap)
        sort = jax.device_get(jax.vmap(
            lambda n, p, c: jpipe.build_part_buffers_sorted(n, p, c, K, cap))(
                *map(jnp.asarray, (nocs, P, cls))))
        gather = _jax_gather_build(nocs, P, cls, K, cap)
        for g, s, w in zip(got, sort, gather):
            np.testing.assert_array_equal(g.numpy(), np.asarray(s))
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_takes_over_where_the_sorted_key_overflows(self, monkeypatch):
        """Where the reference's sorted build raises (a composite key past
        int32), partition_by_class's argsort branch gives the same
        buffers, with no option to set."""
        K, B, N = 3, 2, 100
        rng = np.random.RandomState(53)
        nocs = rng.rand(B, N, 3 * K).astype(np.float32)
        P = rng.rand(B, N, 3).astype(np.float32)
        cls = rng.randint(0, K, (B, N))
        args = (_t(nocs), _t(P), _t(cls), K, 64)
        want = pipeline.build_part_buffers_sorted(*args)
        monkeypatch.setattr(pipeline, "KEY_LIMIT", 1)
        got = pipeline.build_part_buffers_sorted(*args)
        for g, w, j in zip(got, want, _jax_gather_build(nocs, P, cls, K, 64)):
            assert torch.equal(g, w)
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))

    def test_fit_frame_batch_gather_matches_sort_and_jax(self):
        n_parts = 2
        gen = SyntheticArticulated(n_parts=n_parts, points_per_part=150,
                                   seed=4)
        batch, _ = gen.batch(np.random.RandomState(2), 2, num_points=128)
        preds = [perfect_pred({k: batch[k][i] for k in batch}, n_parts)
                 for i in range(2)]
        pred = {k: np.stack([p[k] for p in preds]) for k in preds[0]}
        jcfg = jpipe.PoseFitConfig(
            n_parts=n_parts, niter_part=64, niter_joint=16,
            joint_types=("revolute",), lm_iters_hypo=5, lm_iters_refit=10,
            ransac_chunk=None, part_points=100, buffer_build="gather")
        key = jax.random.PRNGKey(1)
        want = jax.device_get(jpipe.fit_frame_batch(
            {k: jnp.asarray(v) for k, v in pred.items()},
            jnp.asarray(batch["P"]), key, jcfg))
        cfg = port_cfg(jcfg)
        assert cfg.buffer_build == "gather"
        args = ({k: _t(v) for k, v in pred.items()},
                _t(batch["P"].astype(np.float32)), jax_draws(key, 2, cfg))
        got = pipeline.fit_frame_batch(*args, cfg)
        sort = pipeline.fit_frame_batch(
            *args, dataclasses.replace(cfg, buffer_build="sort"))
        # both names select the one build, so the same fits
        for k in got:
            assert torch.equal(got[k], sort[k]), k
        got = {k: v.numpy() for k, v in got.items()}
        np.testing.assert_array_equal(got["part_counts"], want["part_counts"])
        # tests/test_torch_pose.py's tolerances for the whole fit
        for prefix in ("baseline", "nonlinear"):
            np.testing.assert_allclose(got[f"{prefix}_R"], want[f"{prefix}_R"],
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(got[f"{prefix}_s"], want[f"{prefix}_s"],
                                       rtol=1e-4)
            np.testing.assert_allclose(got[f"{prefix}_t"], want[f"{prefix}_t"],
                                       rtol=0, atol=1e-4)

    # every knob of JAX's PoseFitConfig is ported (batch_joints, "mean"
    # and "lm" are tests/test_torch_pose_knobs.py's); a value that names
    # none of its choices raises
    @pytest.mark.parametrize("knob", [dict(buffer_build="scatter"),
                                      dict(hypo_estimator="gauss_newton"),
                                      dict(axis_agg="trimmed_mean"),
                                      dict(hypo_estimator="LM")])
    def test_knobs_not_taken_raise(self, knob):
        with pytest.raises(ValueError):
            pipeline.PoseFitConfig(**knob)


class TestJointHypotheses:
    def test_best_score_matches_jax(self):
        """The `jhypo` stage: the best hypothesis's mean inlier ratio
        equals the score JAX's _joint_ransac returns, on the same draws;
        a residual within float rounding of the threshold may move one
        point, hence 0.02 (a few points of ~100)."""
        rng = np.random.RandomState(54)
        P = 100
        src = rng.rand(2, P, 3).astype(np.float32)
        tgt = (src @ np.eye(3, dtype=np.float32) * 1.2 + 0.1).astype(
            np.float32)
        tgt[:, ::5] += 0.5                              # outliers
        m = np.ones((2, P), np.float32)
        axis = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (2, 1))
        jcfg = jpipe.PoseFitConfig(n_parts=2, niter_joint=16,
                                   joint_types=("revolute",))
        cfg = port_cfg(jcfg)
        keys = jax.random.split(jax.random.PRNGKey(2), 2)
        want = np.asarray([jpipe._joint_ransac(
            k, *map(jnp.asarray, (src[b], tgt[b], m[b], tgt[b], src[b],
                                  m[b], axis[b])), jcfg, False)[1]
            for b, k in enumerate(keys)])
        u = np.asarray([[jax.random.uniform(kk, (16, 3))
                         for kk in jax.random.split(k)] for k in keys],
                       np.float32)
        _, scores = pipeline.joint_hypotheses(
            _t(u[:, 0]), _t(u[:, 1]), _t(src), _t(tgt), _t(m), _t(tgt),
            _t(src), _t(m), _t(axis), cfg, False)
        assert scores.shape == (2, 16)
        np.testing.assert_allclose(scores.max(-1).values.numpy(), want,
                                   atol=0.02)


class TestProfileStages:
    def test_cpu_run_prints_every_stage(self, capsys):
        rows = profile_stages.run(batch=2, points=128, iters=1, device="cpu",
                                  spec=TINY)
        out = capsys.readouterr().out
        assert [r["stage"] for r in rows] == list(profile_stages.STAGES)
        for r in rows:
            assert r["label"] in out and r["wall_ms"] > 0
            # the device columns need the card
            assert r["device_ms"] is None and r["idle_share"] is None
            assert r["launches"] == {}
        assert out.count("not measured") == len(profile_stages.STAGES)

    def test_without_a_card_exits_non_zero_and_prints_no_table(
            self, capsys, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert profile_stages.main(["--stages", "fps1"]) != 0
        captured = capsys.readouterr()
        assert captured.out == "" and "not available" in captured.err

    def test_stage_subset_and_unknown_stage(self, capsys):
        rows = profile_stages.run(batch=1, points=128, iters=1, device="cpu",
                                  spec=TINY, stages=["bq1", "median"])
        assert [r["stage"] for r in rows] == ["bq1", "median"]
        with pytest.raises(ValueError, match="unknown stages"):
            profile_stages.run(stages=["nope"], device="cpu")

    def test_device_events_leave_out_annotations(self):
        """`timing.device_events` keeps the card's kernels, copies and
        memsets in start order, and drops the ranges that user
        annotations (a kernel entry's "kernel:<entry>" scope) place on
        the card's timeline, so a one-kernel stage reads one op."""
        from types import SimpleNamespace

        from torch.autograd import DeviceType

        from articulated_pose_tpu_torch import timing

        def ev(name, start, device=DeviceType.CUDA, annotation=False):
            return SimpleNamespace(name=name, device_type=device,
                                   is_user_annotation=annotation,
                                   time_range=SimpleNamespace(start=start))

        events = [ev("fps_kernel", 5), ev("kernel:fps", 4),
                  ev("user range", 3, annotation=True),
                  ev("Memset (Device)", 1), ev("aten::add_", 0, DeviceType.CPU),
                  ev("spin", 9)]
        assert [e.name for e in timing.device_events(events)] == [
            "Memset (Device)", "fps_kernel", "spin"]
