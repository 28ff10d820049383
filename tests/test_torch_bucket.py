"""The bucket ball-query tier of the port against the JAX package, on the CPU.

`ball_query_group_bucket` (plain version here) against the Pallas bucket
kernel run in interpret mode and `query_ball_point_bucket` against
JAX's pure-XLA twin; the port's tiny model with `ball_query_impl`
"bucket" and "bucket_xla" against the JAX tiny model.  On the CPU the
JAX package would resolve both tiers to its exact ball query
(pointnet2.py:27-37), so `resolve_impl` is made the identity there, as
in tests/test_torch_packed.py.  The CUDA kernel is held against the
plain version on the card by tests/test_torch_kernels_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import articulated_pose_tpu.ops.pallas as jpallas
from articulated_pose_tpu.ops import core as jcore
from articulated_pose_tpu.models import pointnet2 as jpointnet2
from articulated_pose_tpu.models.ancsh import ANCSHModel as JaxANCSHModel
from articulated_pose_tpu.models.pointnet2 import BackboneSpec as JaxSpec
from articulated_pose_tpu_torch.convert import state_dict_from_flax
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec)
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels import (ball_query,
                                                    launch_counts,
                                                    reset_launch_counts)
from test_torch_models import N_POINTS, flax_variables, unflatten
from test_torch_ops import _boundary_mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cloud_and_queries(seed, B, N, M):
    """A cloud, M of its points as queries, and query 0 moved out of
    the cloud so that it has no hit."""
    rng = np.random.RandomState(seed)
    xyz = rng.rand(B, N, 3).astype(np.float32)
    qi = rng.choice(N, size=(B, M))
    q = np.stack([xyz[b, qi[b]] for b in range(B)])
    q[:, 0] = 10.0
    return xyz, q


def query_bucket(r, S, xyz, q, emit_idx):
    """The JAX package's bucket kernel, interpreted."""
    out = jpallas.query_ball_group_bucket(
        r, S, jnp.asarray(xyz), jnp.asarray(q), emit_idx=emit_idx,
        interpret=True)
    return tuple(None if v is None else np.asarray(v) for v in out)


class TestBucketBallQuery:
    # W = 16; N=200 pads to 256 (W = 32), its last 56 lanes never hit;
    # N=64 pads to 128 (W = 8), so half the slots are always empty
    @pytest.mark.parametrize("B,N,M,S,r", [(2, 256, 32, 16, 0.2),
                                           (2, 200, 24, 8, 0.3),
                                           (1, 64, 16, 16, 0.35)])
    @pytest.mark.parametrize("emit_idx", [True, False])
    def test_matches_pallas_bucket(self, B, N, M, S, r, emit_idx):
        xyz, q = _cloud_and_queries(N + S, B, N, M)
        g, cnt, idx = ball_query.ball_query_group_bucket_plain(
            r, S, _t(xyz), _t(q), emit_idx)
        pg, pcnt, pidx = query_bucket(r, S, xyz, q, emit_idx)
        # a point within rounding of the radius may be decided apart by
        # the two summation orders (ROADMAP C1): leave those queries out
        near = _boundary_mask(xyz, q, r).any(-1)              # (B, M)
        assert near.mean() < 0.1
        keep = ~near
        np.testing.assert_array_equal(cnt.numpy()[keep], pcnt[keep])
        # bf16-rounded offsets, and p[0] − q for the zero-hit query:
        # equal bit for bit
        np.testing.assert_array_equal(g.numpy()[keep], pg[keep])
        if emit_idx:
            np.testing.assert_array_equal(idx.numpy()[keep], pidx[keep])
        else:
            assert idx is None and pidx is None
        assert (cnt.numpy()[:, 0] == 0).all()

    def test_zero_hits_take_point_zero_unrounded(self):
        xyz, q = _cloud_and_queries(1, 1, 128, 4)
        q[:] = 10.0
        g, cnt, idx = ball_query.ball_query_group_bucket_plain(
            0.1, 16, _t(xyz), _t(q))
        assert (cnt.numpy() == 0).all() and (idx.numpy() == 0).all()
        np.testing.assert_array_equal(
            g.numpy(), np.broadcast_to(xyz[0, 0] - q[0, :, None], g.shape))

    def test_slots_are_first_hits_of_their_buckets(self):
        xyz, q = _cloud_and_queries(2, 1, 512, 16)
        S, r = 32, 0.25
        g, cnt, idx = ball_query.ball_query_group_bucket_plain(
            r, S, _t(xyz), _t(q))
        d2 = ((xyz[0][None] - q[0][:, None]) ** 2).sum(-1)     # (M, N)
        W = 512 // S
        for m in range(1, 16):
            hits = np.flatnonzero(d2[m] < r * r)
            firsts = [h[0] for h in (hits[(hits >= j * W) & (hits < (j + 1) * W)]
                                     for j in range(S)) if len(h)]
            got = idx.numpy()[0, m]
            assert cnt.numpy()[0, m] == min(len(hits), S)
            # filled slots in bucket order, the rest repeat the first hit
            filled = [got[j] for j in range(S) if j * W <= got[j] < (j + 1) * W]
            assert filled == firsts
            assert set(got) == set(firsts)
            np.testing.assert_array_equal(
                g.numpy()[0, m],
                _t(xyz[0, got] - q[0, m]).to(torch.bfloat16).float().numpy())

    @pytest.mark.parametrize("N,S", [(256, 16), (200, 8), (1000, 64)])
    def test_idx_matches_xla_twin(self, N, S):
        xyz, q = _cloud_and_queries(3 + N, 2, N, 40)
        r = 0.25
        idx, cnt = core.query_ball_point_bucket(r, S, _t(xyz), _t(q))
        jidx, jcnt = jcore.query_ball_point_bucket(r, S, jnp.asarray(xyz),
                                                   jnp.asarray(q))
        keep = ~_boundary_mask(xyz, q, r).any(-1)
        np.testing.assert_array_equal(idx.numpy()[keep], np.asarray(jidx)[keep])
        np.testing.assert_array_equal(cnt.numpy()[keep], np.asarray(jcnt)[keep])
        assert idx.dtype == cnt.dtype == torch.int32

    @pytest.mark.parametrize("N,S", [(384, 16), (256, 24), (100, 256)])
    def test_bucket_width_not_a_power_of_two_raises(self, N, S):
        xyz, q = _cloud_and_queries(4, 1, N, 8)
        with pytest.raises(ValueError, match="power-of-two bucket"):
            ball_query.ball_query_group_bucket(0.3, S, _t(xyz), _t(q))
        with pytest.raises(ValueError, match="power-of-two bucket"):
            core.query_ball_point_bucket(0.3, S, _t(xyz), _t(q))
        with pytest.raises(ValueError, match="bucket"):
            jcore.query_ball_point_bucket(0.3, S, jnp.asarray(xyz),
                                          jnp.asarray(q))


class TestBucketModel:
    @pytest.mark.parametrize("impl", ["bucket", "bucket_xla"])
    def test_matches_jax_bucket_model(self, impl, monkeypatch):
        """The tiny model (SA1 256 -> 64 points, W = 16; SA2 64 -> 32
        points padded to 128, W = 8) against the JAX tiny model with the
        same tier: the interpreted Pallas kernel for "bucket", the XLA
        twin for "bucket_xla"."""
        monkeypatch.setattr(jpointnet2, "resolve_impl", lambda impl: impl)
        monkeypatch.setattr(jpallas, "query_ball_group_bucket",
                            functools.partial(jpallas.query_ball_group_bucket,
                                              interpret=True))
        flat = flax_variables({})
        jmodel = JaxANCSHModel(backbone_spec=JaxSpec(ball_query_impl=impl,
                                                     **TINY_WIDTHS))
        P = np.random.RandomState(11).rand(2, N_POINTS, 3).astype(np.float32)
        want = jax.device_get(jmodel.apply(unflatten(flat), jnp.asarray(P),
                                           train=False))
        exact = jax.device_get(JaxANCSHModel(backbone_spec=JaxSpec(
            **TINY_WIDTHS)).apply(unflatten(flat), jnp.asarray(P),
                                  train=False))

        model = ANCSHModel(backbone_spec=BackboneSpec(ball_query_impl=impl,
                                                      **TINY_WIDTHS)).eval()
        model.load_state_dict(state_dict_from_flax(flat))
        reset_launch_counts()
        with torch.no_grad():
            got = {k: v.numpy() for k, v in model(_t(P)).items()}
        assert sum(launch_counts().values()) == 0
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            # same neighbourhoods and coordinates (TestBucketBallQuery):
            # only the matmul summation order differs
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        # the bucket tier is a different function from the exact one
        assert max(np.abs(want[k] - exact[k]).max() for k in want) > 1e-3
