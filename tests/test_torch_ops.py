"""Parity of the port's point-cloud ops and kernel wrappers with the JAX package.

Inputs come from numpy seeds and go through both packages.  On the CPU
each kernel wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel it replaces (in interpret mode),
against `articulated_pose_tpu.ops.core` and against the NumPy oracles.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from articulated_pose_tpu.ops import core as jcore
from articulated_pose_tpu.ops import numpy_ref
from articulated_pose_tpu.ops.pallas.ball_query_butterfly import \
    query_ball_group_pallas
from articulated_pose_tpu.ops.pallas.fps import farthest_point_sample2_pallas
from articulated_pose_tpu.ops.pallas.three_nn import three_nn_pallas
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels import (ball_query, fps, knn,
                                                    launch_counts,
                                                    reset_launch_counts,
                                                    three_nn, vector_attention)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cloud(seed, B, N):
    return np.random.RandomState(seed).rand(B, N, 3).astype(np.float32)


def _boundary_mask(xyz, q, radius, rel=1e-5):
    """(B, M, N) True where |d² − r²| < rel·r² (float64): points whose
    radius decision may legitimately flip between summation orders."""
    d2 = ((q[:, :, None, :].astype(np.float64)
           - xyz[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    return np.abs(d2 - radius * radius) < rel * radius * radius


class TestFPS:
    @pytest.mark.parametrize("B,N,np1,np2", [(3, 256, 64, 16), (2, 200, 50, 7)])
    def test_two_levels_match_pallas_and_xla(self, B, N, np1, np2):
        xyz = _cloud(0, B, N)
        i1, x1, i2, x2 = (v.numpy() for v in fps.fps2_plain(_t(xyz), np1, np2))
        p1, px1, p2, px2 = (np.asarray(v) for v in farthest_point_sample2_pallas(
            np1, np2, jnp.asarray(xyz), interpret=True))
        np.testing.assert_array_equal(i1, p1)
        np.testing.assert_array_equal(i2, p2)
        np.testing.assert_array_equal(x1, px1)
        np.testing.assert_array_equal(x2, px2)
        # and the XLA tier applied twice, with its gather in between
        j1 = np.asarray(jcore.farthest_point_sample(np1, jnp.asarray(xyz)))
        j2 = np.asarray(jcore.farthest_point_sample(
            np2, jcore.gather_point(jnp.asarray(xyz), jnp.asarray(j1))))
        np.testing.assert_array_equal(i1, j1)
        np.testing.assert_array_equal(i2, j2)
        assert i1.dtype == np.int32 and i2.dtype == np.int32

    def test_matches_numpy_oracle(self):
        xyz = _cloud(1, 2, 128)
        got = core.farthest_point_sample(32, _t(xyz)).numpy()
        np.testing.assert_array_equal(got,
                                      numpy_ref.farthest_point_sample(32, xyz))


class TestBallQuery:
    @pytest.mark.parametrize("emit_idx", [True, False])
    def test_matches_pallas_transposed(self, emit_idx):
        B, N, M, S, r = 2, 256, 64, 16, 0.2
        xyz = _cloud(2, B, N)
        q = xyz[:, ::4].copy()
        g, cnt, idx = ball_query.ball_query_group_plain(r, S, _t(xyz), _t(q),
                                                        emit_idx)
        pg, pcnt, pidx = query_ball_group_pallas(
            r, S, jnp.asarray(xyz), jnp.asarray(q), emit_idx=emit_idx,
            interpret=True, transposed=True)
        near = _boundary_mask(xyz, q, r).any(-1)              # (B, M)
        assert near.mean() < 0.05
        keep = ~near
        np.testing.assert_array_equal(cnt.numpy()[keep], np.asarray(pcnt)[keep])
        # coordinates are copies minus the same query: exact
        np.testing.assert_allclose(g.numpy()[keep], np.asarray(pg)[keep],
                                   rtol=0, atol=1e-6)
        if emit_idx:
            np.testing.assert_array_equal(idx.numpy()[keep],
                                          np.asarray(pidx)[keep])
        else:
            assert idx is None and pidx is None

    def test_matches_xla_and_numpy_oracle(self):
        B, N, M, S, r = 2, 300, 40, 8, 0.25
        xyz = _cloud(3, B, N)
        q = _cloud(4, B, M)
        idx, cnt = core.query_ball_point(r, S, _t(xyz), _t(q))
        jidx, jcnt = jcore.query_ball_point(r, S, jnp.asarray(xyz),
                                            jnp.asarray(q))
        nidx, ncnt = numpy_ref.query_ball_point(r, S, xyz, q)
        keep = ~_boundary_mask(xyz, q, r).any(-1)
        for want_idx, want_cnt in ((np.asarray(jidx), np.asarray(jcnt)),
                                   (nidx, ncnt)):
            np.testing.assert_array_equal(idx.numpy()[keep], want_idx[keep])
            np.testing.assert_array_equal(cnt.numpy()[keep], want_cnt[keep])

    def test_zero_hits_take_point_zero_centred(self):
        xyz = _cloud(5, 1, 64)
        q = np.full((1, 4, 3), 10.0, np.float32)
        g, cnt, idx = ball_query.ball_query_group_plain(0.1, 8, _t(xyz), _t(q))
        assert (cnt.numpy() == 0).all() and (idx.numpy() == 0).all()
        np.testing.assert_array_equal(
            g.numpy(), np.broadcast_to(xyz[0, 0] - q[0, :, None], g.shape))

    def test_saturated_neighbourhood_caps_count(self):
        xyz = _cloud(6, 1, 128)
        q = np.full((1, 2, 3), 0.5, np.float32)
        _, cnt, idx = ball_query.ball_query_group_plain(5.0, 16, _t(xyz), _t(q))
        assert (cnt.numpy() == 16).all()
        np.testing.assert_array_equal(idx.numpy()[0, 0], np.arange(16))


class TestThreeNN:
    @pytest.mark.parametrize("N,M", [(256, 64), (130, 3)])
    def test_matches_pallas(self, N, M):
        xyz1, xyz2 = _cloud(7, 2, N), _cloud(8, 2, M)
        d, i = three_nn.three_nn_plain(_t(xyz1), _t(xyz2))
        pd, pi = (np.asarray(v) for v in three_nn_pallas(
            jnp.asarray(xyz1), jnp.asarray(xyz2), interpret=True))
        np.testing.assert_allclose(d.numpy(), pd, rtol=1e-5, atol=1e-6)
        # ranks may swap only between near-tied candidates
        near_tie = np.zeros_like(pi, bool)
        near_tie[..., 1:] |= np.abs(np.diff(pd, axis=-1)) < 1e-5
        near_tie[..., :-1] |= np.abs(np.diff(pd, axis=-1)) < 1e-5
        np.testing.assert_array_equal(i.numpy()[~near_tie], pi[~near_tie])

    def test_matches_numpy_oracle_and_ties(self):
        xyz1, xyz2 = _cloud(9, 2, 64), _cloud(10, 2, 32)
        xyz2[:, 5] = xyz2[:, 9]          # an exact duplicate: lowest index wins
        xyz1[:, 0] = xyz2[:, 9]
        d, i = core.three_nn(_t(xyz1), _t(xyz2))
        nd, ni = numpy_ref.three_nn(xyz1, xyz2)
        np.testing.assert_allclose(d.numpy(), nd, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(i.numpy(), ni)
        np.testing.assert_array_equal(i.numpy()[:, 0, :2], [[5, 9], [5, 9]])


class TestInterpolateAndGroup:
    def test_group_point_matches_oracle(self):
        rng = np.random.RandomState(11)
        pts = rng.rand(2, 50, 7).astype(np.float32)
        idx = rng.randint(0, 50, (2, 10, 4)).astype(np.int32)
        np.testing.assert_array_equal(core.group_point(_t(pts), _t(idx)).numpy(),
                                      numpy_ref.group_point(pts, idx))

    def test_three_interpolate_matches_oracle_and_xla(self):
        rng = np.random.RandomState(12)
        pts = rng.rand(2, 40, 6).astype(np.float32)
        dist, idx = numpy_ref.three_nn(rng.rand(2, 30, 3), rng.rand(2, 40, 3))
        w = core.interp_weights(_t(dist))
        np.testing.assert_allclose(
            w.numpy(), np.asarray(jcore.interp_weights(jnp.asarray(dist))),
            rtol=1e-6)
        got = core.three_interpolate(_t(pts), _t(idx), w).numpy()
        np.testing.assert_allclose(
            got, numpy_ref.three_interpolate(pts, idx, w.numpy()), rtol=1e-6,
            atol=1e-6)


def _attention_inputs(device):
    """A Point Transformer attention layer (C=16, eval) on `device` with
    its inputs: points, q, key, v and 8 neighbours of 32 points."""
    from articulated_pose_tpu_torch.models import point_transformer as pt

    layer = pt.PointTransformerLayer(16, 8, torch.float32).eval()
    p = _t(_cloud(5, 2, 32))
    nbr = core.knn_point(8, p, p)[1]
    q, key, v = (_t(np.random.RandomState(s).randn(2, 32, 16).astype(
        np.float32)) for s in (1, 2, 3))
    return [t.to(device) for t in (layer, p, q, key, v, nbr)]


class TestDispatch:
    def test_cpu_tensors_take_the_plain_versions(self):
        reset_launch_counts()
        xyz = _t(_cloud(13, 2, 128))
        i1, x1, i2, x2 = fps.fps2(xyz, 32, 8)
        ref = fps.fps2_plain(xyz, 32, 8)
        for a, b in zip((i1, x1, i2, x2), ref):
            assert torch.equal(a, b)
        g, c, i = ball_query.ball_query_group(0.3, 8, xyz, x1, emit_idx=True)
        gp, cp, ip = ball_query.ball_query_group_plain(0.3, 8, xyz, x1)
        assert torch.equal(g, gp) and torch.equal(c, cp) and torch.equal(i, ip)
        g, c, i = ball_query.ball_query_group_packed(0.3, 8, xyz, x1)
        gp, cp, ip = ball_query.ball_query_group_packed_plain(0.3, 8, xyz, x1)
        assert torch.equal(g, gp) and torch.equal(c, cp) and torch.equal(i, ip)
        i, c = ball_query.ball_query_idx(0.3, 8, xyz, x1)
        ip, cp = ball_query.ball_query_idx_plain(0.3, 8, xyz, x1)
        assert torch.equal(c, cp) and torch.equal(i, ip)
        d, j = three_nn.three_nn(xyz, x1)
        dp, jp = three_nn.three_nn_plain(xyz, x1)
        assert torch.equal(d, dp) and torch.equal(j, jp)
        i, x = fps.fps(xyz, 32)
        ip, xp = fps.fps_plain(xyz, 32)
        assert torch.equal(i, ip) and torch.equal(x, xp)
        g, c, i = ball_query.ball_query_group_bucket(0.3, 8, xyz, x1)
        gp, cp, ip = ball_query.ball_query_group_bucket_plain(0.3, 8, xyz, x1)
        assert torch.equal(g, gp) and torch.equal(c, cp) and torch.equal(i, ip)
        i, c = ball_query.ball_query_point(0.3, 8, xyz, x1)
        ip, cp = ball_query.ball_query_point_plain(0.3, 8, xyz, x1)
        assert torch.equal(c, cp) and torch.equal(i, ip)
        i, c, g = ball_query.ball_query_point_grouped(0.3, 8, xyz, x1)
        ip, cp, gp = ball_query.ball_query_point_grouped_plain(0.3, 8, xyz,
                                                               x1)
        assert torch.equal(g, gp) and torch.equal(c, cp) and torch.equal(i, ip)
        d, j = three_nn.three_nn_stream(xyz, x1)
        dp, jp = three_nn.three_nn_stream_plain(xyz, x1)
        assert torch.equal(d, dp) and torch.equal(j, jp)
        d, j = three_nn.three_nn_packed(xyz, x1)
        dp, jp = three_nn.three_nn_packed_plain(xyz, x1)
        assert torch.equal(d, dp) and torch.equal(j, jp)
        d, j = knn.knn(8, xyz, x1)
        dp, jp = knn.knn_plain(8, xyz, x1)
        assert torch.equal(d, dp) and torch.equal(j, jp)
        layer, *args = _attention_inputs("cpu")
        with torch.no_grad():
            assert torch.equal(vector_attention.vector_attention(layer, *args),
                               vector_attention.vector_attention_plain(layer,
                                                                       *args))
        assert launch_counts() == {"fps2": 0, "fps": 0, "ball_query_group": 0,
                                   "ball_query_group_packed": 0,
                                   "ball_query_idx": 0,
                                   "ball_query_point": 0,
                                   "ball_query_point_grouped": 0,
                                   "ball_query_group_bucket": 0,
                                   "three_nn": 0, "three_nn_stream": 0,
                                   "three_nn_packed": 0, "knn": 0,
                                   "joint_fit": 0, "vector_attention": 0}

    def test_other_devices_are_refused(self):
        xyz = torch.zeros((1, 8, 3), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fps.fps2(xyz, 4, 2)
        with pytest.raises(ValueError, match="CUDA"):
            ball_query.ball_query_group(0.1, 4, xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            ball_query.ball_query_group_packed(0.1, 4, xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            ball_query.ball_query_idx(0.1, 4, xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            three_nn.three_nn(xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            fps.fps(xyz, 4)
        with pytest.raises(ValueError, match="CUDA"):
            ball_query.ball_query_group_bucket(0.1, 4, xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            ball_query.ball_query_point(0.1, 4, xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            ball_query.ball_query_point_grouped(0.1, 4, xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            three_nn.three_nn_stream(xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            three_nn.three_nn_packed(xyz, xyz)
        with pytest.raises(ValueError, match="CUDA"):
            knn.knn(4, xyz, xyz)
        layer, *args = _attention_inputs("meta")
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            vector_attention.vector_attention(layer, *args)
