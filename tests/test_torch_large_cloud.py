"""The port's large-cloud tier against the JAX package, on the CPU.

`ball_query_idx` (plain version here) against the streaming Pallas ball
query run in interpret mode; two-level FPS at N=32768 against the JAX
XLA tier; and the tiny model with `ball_query_impl="stream"` against the
JAX tiny model with the same spec.  The CUDA kernels are held against
their plain versions on the card by tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulated_pose_tpu.models.ancsh import ANCSHModel as JaxANCSHModel
from articulated_pose_tpu.models.pointnet2 import BackboneSpec as JaxSpec
from articulated_pose_tpu.ops import core as jcore
from articulated_pose_tpu.ops.pallas.ball_query_stream import \
    query_ball_point_stream
from articulated_pose_tpu_torch.convert import state_dict_from_flax
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec)
from articulated_pose_tpu_torch.ops.kernels import ball_query, fps
from test_torch_models import flax_variables, unflatten
from test_torch_ops import _boundary_mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cloud(seed, B, N):
    return np.random.RandomState(seed).rand(B, N, 3).astype(np.float32)


class TestStreamBallQuery:
    # N=700 spans six 128-point tiles of the streaming kernel, the last
    # one ragged; r=0.3 saturates most neighbourhoods, r=0.12 few
    @pytest.mark.parametrize("r", [0.12, 0.3])
    def test_matches_pallas_stream(self, r):
        B, N, M, S = 2, 700, 64, 16
        xyz = _cloud(20, B, N)
        q = _cloud(21, B, M)
        idx, cnt = ball_query.ball_query_idx_plain(r, S, _t(xyz), _t(q))
        pidx, pcnt = (np.asarray(v) for v in query_ball_point_stream(
            r, S, jnp.asarray(xyz), jnp.asarray(q), block_n=128,
            interpret=True))
        # the streaming kernel sums the inner product on the MXU, in
        # another order: exclude queries with a point within 1e-5·r² of
        # the radius (ROADMAP C1), and require exact idx, cnt elsewhere
        near = _boundary_mask(xyz, q, r).any(-1)               # (B, M)
        assert near.mean() < 0.05
        keep = ~near
        np.testing.assert_array_equal(cnt.numpy()[keep], pcnt[keep])
        np.testing.assert_array_equal(idx.numpy()[keep], pidx[keep])
        assert 0 < cnt.numpy().min() or r < 0.2

    def test_zero_hits_and_fill(self):
        xyz = _cloud(22, 1, 300)
        q = np.concatenate([np.full((1, 1, 3), 10.0, np.float32),
                            xyz[:, :3]], axis=1)
        idx, cnt = ball_query.ball_query_idx(0.1, 24, _t(xyz), _t(q))
        idx, cnt = idx.numpy(), cnt.numpy()
        assert cnt[0, 0] == 0 and (idx[0, 0] == 0).all()
        for m in range(1, 4):
            c = cnt[0, m]
            assert 0 < c < 24
            assert (idx[0, m, c:] == idx[0, m, 0]).all()
            assert (np.diff(idx[0, m, :c]) > 0).all()   # index order

    def test_refuses_clouds_past_the_index_range(self):
        xyz = torch.empty((1, 1 << 24, 3), device="meta")
        with pytest.raises(ValueError, match="2\\^24"):
            ball_query.ball_query_idx(0.1, 4, xyz, xyz[:, :2])


class TestLargeCloudFPS:
    def test_fps2_at_32k_matches_xla(self):
        xyz = _cloud(23, 1, 32768)
        i1, x1, i2, x2 = (v.numpy() for v in fps.fps2_plain(_t(xyz), 512, 128))
        j1 = np.asarray(jcore.farthest_point_sample(512, jnp.asarray(xyz)))
        jx1 = jcore.gather_point(jnp.asarray(xyz), jnp.asarray(j1))
        j2 = np.asarray(jcore.farthest_point_sample(128, jx1))
        np.testing.assert_array_equal(i1, j1)
        np.testing.assert_array_equal(i2, j2)
        np.testing.assert_array_equal(x1, np.asarray(jx1))
        np.testing.assert_array_equal(x2, x1[0][i2[0]][None])


def _stream_models(flat):
    jmodel = JaxANCSHModel(backbone_spec=JaxSpec(ball_query_impl="stream",
                                                 **TINY_WIDTHS))
    model = ANCSHModel(backbone_spec=BackboneSpec(ball_query_impl="stream",
                                                  **TINY_WIDTHS))
    model.load_state_dict(state_dict_from_flax(flat))
    return jmodel, model.eval()


class TestStreamModel:
    def test_matches_jax_stream_model(self):
        """N=1024 through both tiny models with ball_query_impl="stream"
        (on the CPU the JAX package resolves the stream tier to its XLA
        ball query, the same function)."""
        flat = flax_variables({})
        jmodel, model = _stream_models(flat)
        P = np.random.RandomState(24).rand(2, 1024, 3).astype(np.float32)
        want = jax.device_get(jmodel.apply(unflatten(flat), jnp.asarray(P),
                                           train=False))
        with torch.no_grad():
            got = {k: v.numpy() for k, v in model(_t(P)).items()}
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            # same neighbourhoods, so only the matmul summation order
            # differs: the f32 bound of tests/test_torch_models.py
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)

    def test_stream_equals_exact_tier(self):
        # idx-then-gather gives the same neighbourhoods as the fused
        # exact tier, so the two models agree to the bit
        flat = flax_variables({})
        _, stream = _stream_models(flat)
        exact = ANCSHModel(backbone_spec=BackboneSpec(**TINY_WIDTHS))
        exact.load_state_dict(state_dict_from_flax(flat))
        P = _t(_cloud(25, 2, 512))
        with torch.no_grad():
            a, b = stream(P), exact.eval()(P)
        for k in a:
            assert torch.equal(a[k], b[k]), k

    def test_jax_weights_load_into_the_stream_model(self):
        flat = flax_variables({})
        sd = state_dict_from_flax(flat)
        _, model = _stream_models(flat)
        assert set(sd) == set(model.state_dict())
