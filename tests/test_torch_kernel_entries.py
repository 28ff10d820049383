"""The last four kernel entries against the interpreted Pallas kernels.

B5 (`ball_query_point`), B5g (`ball_query_point_grouped`), B7
(`three_nn_stream`) and B9 (`three_nn_packed`) on the CPU, where each
wrapper runs its plain version, held against the JAX kernel it replaces
in interpret mode, as tests/test_pallas.py runs them.  The CUDA kernels
are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py.

Tolerances: the Pallas kernels compute d² with a HIGHEST-precision
matmul, which may sum in another order than the port's elementwise
expansion, so a radius decision within 1e-5·r² of the boundary may flip
(ROADMAP C1: those queries are excluded), 3-NN distances agree within
1e-5 relative, and a near-tie may swap ranks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from articulated_pose_tpu.ops.pallas.ball_query import (
    query_ball_point_grouped_pallas, query_ball_point_pallas)
from articulated_pose_tpu.ops.pallas.three_nn import three_nn_pallas
from articulated_pose_tpu.ops.pallas.three_nn_stream import three_nn_stream
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels import ball_query, three_nn
from test_torch_ops import _boundary_mask

# one key quantum: the packed key keeps 7 mantissa bits of d²
KEY_QUANTUM = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cloud(seed, B, N):
    return np.random.RandomState(seed).rand(B, N, 3).astype(np.float32)


def _d2_of(q, p, idx):
    """float64 d² of each query to its chosen candidates: (B, N, 3)."""
    q, p = q.astype(np.float64), p.astype(np.float64)
    return np.stack([((q[b][:, None] - p[b][idx[b]]) ** 2).sum(-1)
                     for b in range(len(q))])


def _far_queries(seed, B, M, n_far):
    """Random queries, the first n_far of each cloud far outside it."""
    q = _cloud(seed, B, M)
    q[:, :n_far] += 50.0
    return q


class TestBallQueryPoint:
    # N=300 pads to 384 inside the Pallas wrapper (1e9-far points)
    @pytest.mark.parametrize("N,M,S,r", [(300, 140, 16, 0.25),
                                         (256, 64, 32, 0.4)])
    def test_matches_rank_select_kernel(self, N, M, S, r):
        xyz = _cloud(30, 2, N)
        q = _far_queries(31, 2, M, 3)
        idx, cnt = ball_query.ball_query_point(r, S, _t(xyz), _t(q))
        pidx, pcnt = (np.asarray(v) for v in query_ball_point_pallas(
            r, S, jnp.asarray(xyz), jnp.asarray(q), interpret=True))
        keep = ~_boundary_mask(xyz, q, r).any(-1)
        assert keep.mean() > 0.95
        np.testing.assert_array_equal(cnt.numpy()[keep], pcnt[keep])
        np.testing.assert_array_equal(idx.numpy()[keep], pidx[keep])
        # zero hits: cnt 0 and point 0 in every slot, in both
        assert (cnt.numpy()[:, :3] == 0).all() and (pcnt[:, :3] == 0).all()
        assert (idx.numpy()[:, :3] == 0).all() and (pidx[:, :3] == 0).all()
        assert (cnt.numpy()[:, 3:] > 0).all()

    def test_is_the_plain_query(self):
        xyz, q = _cloud(32, 2, 200), _cloud(33, 2, 50)
        got = ball_query.ball_query_point(0.3, 8, _t(xyz), _t(q))
        want = core.query_ball_point(0.3, 8, _t(xyz), _t(q))
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_takes_clouds_past_the_stream_tier_range(self):
        # ball_query_idx stops at 2^24 (f32 index carry); B5 does not
        xyz = torch.empty((1, 1 << 24, 3), device="meta")
        with pytest.raises(ValueError, match="2\\^24"):
            ball_query.ball_query_idx(0.1, 4, xyz, xyz[:, :2])
        with pytest.raises(ValueError, match="CUDA"):
            ball_query.ball_query_point(0.1, 4, xyz, xyz[:, :2])


class TestBallQueryPointGrouped:
    @pytest.mark.parametrize("N,M,S,r", [(300, 140, 16, 0.25),
                                         (256, 64, 32, 0.4)])
    def test_matches_grouped_kernel(self, N, M, S, r):
        xyz = _cloud(34, 2, N)
        q = _far_queries(35, 2, M, 2)
        idx, cnt, g = ball_query.ball_query_point_grouped(r, S, _t(xyz),
                                                          _t(q))
        pidx, pcnt, pg = (np.asarray(v) for v in
                          query_ball_point_grouped_pallas(
                              r, S, jnp.asarray(xyz), jnp.asarray(q),
                              interpret=True))
        assert idx.shape == (2, M, S) and g.shape == (2, M, S, 3)
        keep = ~_boundary_mask(xyz, q, r).any(-1)
        assert keep.mean() > 0.95
        np.testing.assert_array_equal(idx.numpy()[keep], pidx[keep])
        np.testing.assert_array_equal(cnt.numpy()[keep], pcnt[keep])
        # a copied coordinate minus the same query, in both: equal
        np.testing.assert_array_equal(g.numpy()[keep], pg[keep])

    def test_zero_hit_queries_use_point_zero(self):
        # tests/test_pallas.py:242-252's case
        xyz = np.random.RandomState(0).rand(1, 64, 3).astype(np.float32)
        q = np.full((1, 1, 3), 50.0, np.float32)
        idx, cnt, g = ball_query.ball_query_point_grouped(0.1, 8, _t(xyz),
                                                          _t(q))
        pidx, pcnt, pg = (np.asarray(v) for v in
                          query_ball_point_grouped_pallas(
                              0.1, 8, jnp.asarray(xyz), jnp.asarray(q),
                              interpret=True))
        assert cnt.item() == 0 and pcnt.item() == 0
        assert (idx.numpy() == 0).all() and (pidx == 0).all()
        np.testing.assert_array_equal(g.numpy(), pg)
        np.testing.assert_array_equal(
            g.numpy()[0, 0], np.broadcast_to(xyz[0, 0] - q[0, 0], (8, 3)))


class TestThreeNNStream:
    def _near_tie(self, pd):
        tie = np.zeros(pd.shape, bool)
        close = np.abs(np.diff(pd, axis=-1)) < 1e-5
        tie[..., 1:] |= close
        tie[..., :-1] |= close
        return tie

    def test_multitile_matches_stream_kernel(self):
        # block_m=128 -> 3 candidate tiles; a duplicate in a later tile
        q, p = _cloud(36, 2, 100), _cloud(37, 2, 300)
        p[:, 260] = p[:, 10]
        q[:, 0] = p[:, 10]
        d, i = three_nn.three_nn_stream(_t(q), _t(p))
        pd, pi = (np.asarray(v) for v in three_nn_stream(
            jnp.asarray(q), jnp.asarray(p), block_m=128, interpret=True))
        np.testing.assert_allclose(d.numpy(), pd, rtol=1e-5, atol=1e-6)
        tie = self._near_tie(pd)
        assert tie.mean() < 0.05
        np.testing.assert_array_equal(i.numpy()[~tie], pi[~tie])
        # the cross-tile tie goes to the lower index in both
        np.testing.assert_array_equal(i.numpy()[:, 0, :2], [[10, 260]] * 2)
        np.testing.assert_array_equal(pi[:, 0, :2], [[10, 260]] * 2)

    @pytest.mark.parametrize("M", [1, 2])
    def test_spare_slots_match(self, M):
        q, p = _cloud(38, 2, 20), _cloud(39, 2, M)
        d, i = three_nn.three_nn_stream(_t(q), _t(p))
        pd, pi = (np.asarray(v) for v in three_nn_stream(
            jnp.asarray(q), jnp.asarray(p), block_m=128, interpret=True))
        np.testing.assert_array_equal(i.numpy(), pi)
        assert np.isinf(d.numpy()[..., M:]).all() and np.isinf(pd[..., M:]).all()
        np.testing.assert_allclose(d.numpy()[..., :M], pd[..., :M],
                                   rtol=1e-5, atol=1e-6)

    def test_takes_no_tile_size(self):
        # block_m sized the TPU's VMEM tile; the result never depended on it
        q, p = _cloud(40, 1, 50), _cloud(41, 1, 700)
        a = [np.asarray(v)[1] for v in (
            three_nn_stream(jnp.asarray(q), jnp.asarray(p), block_m=bm,
                            interpret=True) for bm in (128, 512))]
        np.testing.assert_array_equal(a[0], a[1])
        got = three_nn.three_nn_stream(_t(q), _t(p))
        want = three_nn.three_nn(_t(q), _t(p))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


class TestThreeNNPacked:
    def test_matches_key_kernel(self):
        """idx equals the interpreted key kernel's except where two
        candidates' d² lie within one key quantum (2^-7 relative): the
        keys keep 7 mantissa bits of d², so a last-bit difference of d²
        between the two packages' summation orders may reorder such a
        pair.  Where idx agrees the dist bits agree, but for entries one
        key quantum off, which such a last-bit difference can also cause
        when d² sits on a quantum boundary."""
        q, p = _cloud(42, 2, 140), _cloud(43, 2, 70)
        d, i = three_nn.three_nn_packed(_t(q), _t(p))
        pd, pi = (np.asarray(v) for v in three_nn_pallas(
            jnp.asarray(q), jnp.asarray(p), True, True))
        i, d = i.numpy(), d.numpy()
        differ = i != pi
        assert differ.mean() < 0.02
        got, want = _d2_of(q, p, i), _d2_of(q, p, pi)
        assert (np.abs(got - want)[differ]
                <= KEY_QUANTUM * want[differ] + 1e-7).all()
        bits = np.abs(d.view(np.int32).astype(np.int64)
                      - pd.view(np.int32))[~differ]
        assert ((bits == 0) | (bits == 1 << 16)).all()
        assert (bits == 0).mean() > 0.99

    def test_duplicate_point_ties_to_lowest_index(self):
        p = _cloud(44, 1, 40)
        p[0, 17] = p[0, 3]
        q = p[:, 3:4].copy()
        _, i = three_nn.three_nn_packed(_t(q), _t(p))
        _, pi = three_nn_pallas(jnp.asarray(q), jnp.asarray(p), True, True)
        np.testing.assert_array_equal(i.numpy()[0, 0, :2], [3, 17])
        np.testing.assert_array_equal(np.asarray(pi)[0, 0, :2], [3, 17])

    @pytest.mark.parametrize("M", [1, 2])
    def test_spare_slots_bit_for_bit(self, M):
        # spare slots hold the key 0x7FFFFFFF: idx 65535, dist NaN
        # (0x7FFF0000), as the TPU kernel emits them
        q, p = _cloud(45, 2, 20), _cloud(46, 2, M)
        d, i = three_nn.three_nn_packed(_t(q), _t(p))
        pd, pi = (np.asarray(v) for v in three_nn_pallas(
            jnp.asarray(q), jnp.asarray(p), True, True))
        np.testing.assert_array_equal(i.numpy(), pi)
        np.testing.assert_array_equal(d.numpy().view(np.int32)[..., M:],
                                      pd.view(np.int32)[..., M:])
        assert (i.numpy()[..., M:] == 65535).all()
        assert (d.numpy().view(np.int32)[..., M:] == 0x7FFF0000).all()

    def test_refuses_more_than_65536_candidates(self):
        xyz = torch.empty((1, 4, 3), device="meta")
        big = torch.empty((1, 65537, 3), device="meta")
        with pytest.raises(ValueError, match="65536"):
            three_nn.three_nn_packed(xyz, big)
        with pytest.raises(ValueError, match="65536"):
            core.three_nn_packed(xyz, big)
        with pytest.raises(AssertionError, match="16 bits"):
            three_nn_pallas(jnp.zeros((1, 4, 3)), jnp.zeros((1, 65537, 3)),
                            True, True)
        # 65536 candidates still fit the key's index
        with pytest.raises(ValueError, match="CUDA"):
            three_nn.three_nn_packed(xyz, big[:, :65536])
