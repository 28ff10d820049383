"""The packed ball-query tier of the port against the JAX package, on the CPU.

`ball_query_group_packed` (plain version here) against the Pallas
packed butterfly kernel run in interpret mode; the port's tiny model
with `ball_query_packed=True` against the JAX tiny model whose ball
query takes that interpreted kernel; and the config switches that
select the tier (`use_pallas`, `ball_query_packed`, `ball_query_impl`).
The CUDA kernel is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import articulated_pose_tpu.ops.pallas as jpallas
from articulated_pose_tpu.config import load_config as jax_load_config
from articulated_pose_tpu.models import pointnet2 as jpointnet2
from articulated_pose_tpu.models.ancsh import ANCSHModel as JaxANCSHModel
from articulated_pose_tpu.models.pointnet2 import BackboneSpec as JaxSpec
from articulated_pose_tpu_torch.config import NetworkConfig, load_config
from articulated_pose_tpu_torch.convert import state_dict_from_flax
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel, build_model
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec, group)
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels import ball_query
from test_torch_models import N_POINTS, flax_variables, unflatten


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cloud_and_queries(seed, B, N, M):
    """A cloud with a different extent per axis, and M of its points as
    queries (test_pallas.py:315-317)."""
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(B, N, 3) * [1.0, 2.0, 0.5] - [0.3, 1.0, 0.0]).astype(
        np.float32)
    qi = rng.choice(N, size=(B, M))
    q = np.stack([xyz[b, qi[b]] for b in range(B)])
    return xyz, q


class TestPackedBallQuery:
    # the shapes of tests/test_pallas.py:307-309; N=300 is not a multiple
    # of the kernel's 128-lane tile, so its bounding box is masked
    @pytest.mark.parametrize("B,N,M,S,r", [(2, 256, 128, 32, 0.2),
                                           (2, 300, 100, 16, 0.35),
                                           (1, 512, 128, 64, 0.4)])
    @pytest.mark.parametrize("emit_idx", [True, False])
    def test_matches_pallas_packed(self, B, N, M, S, r, emit_idx):
        xyz, q = _cloud_and_queries(B * N + S, B, N, M)
        g, cnt, idx = ball_query.ball_query_group_packed_plain(
            r, S, _t(xyz), _t(q), emit_idx)
        pg, pcnt, pidx = query_packed(r, S, xyz, q, emit_idx)
        np.testing.assert_array_equal(cnt.numpy(), pcnt)
        if emit_idx:
            np.testing.assert_array_equal(idx.numpy(), pidx)
        else:
            assert idx is None and pidx is None
        # Coordinates: equal, except where a point sits within rounding
        # of a half-quantum boundary and the two grids round it apart;
        # such a flip moves a coordinate by one quantum ext/1023.  Allow
        # it on at most 0.1 % of entries (none occur at these seeds).
        ext = xyz.max(1) - xyz.min(1)                          # (B, 3)
        quantum = ext[:, None, None, :] / 1023.0
        diff = np.abs(g.numpy() - pg)
        flips = diff > 0
        assert flips.mean() <= 1e-3
        assert (diff <= quantum * (1 + 1e-3)).all()
        # every coordinate within half a quantum of exact grouping
        # (test_pallas.py:325-327)
        ridx, _ = core.query_ball_point(r, S, _t(xyz), _t(q))
        exact = core.group_point(_t(xyz), ridx).numpy() - q[:, :, None]
        assert (np.abs(g.numpy() - exact)
                <= ext[:, None, None, :] / 2046.0 + 1e-5).all()

    def test_zero_hits_take_quantised_point_zero(self):
        xyz, _ = _cloud_and_queries(1, 1, 64, 1)
        q = np.full((1, 3, 3), 10.0, np.float32)
        g, cnt, idx = ball_query.ball_query_group_packed_plain(
            0.1, 8, _t(xyz), _t(q))
        assert (cnt.numpy() == 0).all() and (idx.numpy() == 0).all()
        deq0 = core.quantize_coords(_t(xyz))[0, 0].numpy()
        np.testing.assert_array_equal(
            g.numpy(), np.broadcast_to(deq0 - q[0, :, None], g.shape))
        pg, _, _ = query_packed(0.1, 8, xyz, q, True)
        np.testing.assert_array_equal(g.numpy(), pg)

    def test_unfilled_slots_repeat_the_first_hit(self):
        xyz, q = _cloud_and_queries(2, 1, 200, 16)
        g, cnt, _ = ball_query.ball_query_group_packed_plain(
            0.15, 32, _t(xyz), _t(q))
        g, cnt = g.numpy(), cnt.numpy()
        assert 0 < cnt.min() and cnt.max() < 32
        for m in range(16):
            tail = g[0, m, cnt[0, m]:]
            np.testing.assert_array_equal(
                tail, np.broadcast_to(g[0, m, 0], tail.shape))

    def test_quantised_coordinates_lie_on_the_grid(self):
        xyz, _ = _cloud_and_queries(3, 2, 500, 1)
        deq = core.quantize_coords(_t(xyz)).numpy()
        mn, ext = xyz.min(1, keepdims=True), np.ptp(xyz, 1, keepdims=True)
        # the bounding box's low corner is a grid point, so it is exact
        np.testing.assert_array_equal(deq.min(1, keepdims=True), mn)
        level = (deq.astype(np.float64) - mn) / (ext / 1023.0)
        np.testing.assert_allclose(level, np.round(level), atol=1e-3)
        assert (np.abs(deq - xyz) <= ext / 2046.0 + 1e-6).all()

    def test_degenerate_axis_keeps_its_value(self):
        # a flat cloud: ext clamps to 1e-6 and the axis stays put
        xyz, _ = _cloud_and_queries(4, 1, 100, 1)
        xyz[..., 2] = 0.25
        deq = core.quantize_coords(_t(xyz)).numpy()
        np.testing.assert_array_equal(deq[..., 2], xyz[..., 2])


def query_packed(r, S, xyz, q, emit_idx):
    """The JAX package's packed transposed butterfly, interpreted."""
    out = jpallas.query_ball_group_pallas(
        r, S, jnp.asarray(xyz), jnp.asarray(q), emit_idx=emit_idx,
        packed=True, transposed=True, interpret=True)
    return tuple(None if v is None else np.asarray(v) for v in out)


class TestPackedModel:
    def test_matches_jax_packed_model(self, monkeypatch):
        """The tiny model with ball_query_packed=True against the JAX tiny
        model whose ball query takes the interpreted packed kernel: on the
        CPU the JAX package would resolve "pallas" back to its exact XLA
        ops (pointnet2.py:27-37), so resolve_impl is made the identity and
        the kernel is given interpret=True."""
        monkeypatch.setattr(jpointnet2, "resolve_impl", lambda impl: impl)
        monkeypatch.setattr(jpallas, "query_ball_group_pallas",
                            functools.partial(jpallas.query_ball_group_pallas,
                                              interpret=True))
        flat = flax_variables({})
        jmodel = JaxANCSHModel(backbone_spec=JaxSpec(
            ball_query_impl="pallas", ball_query_packed=True, **TINY_WIDTHS))
        P = np.random.RandomState(7).rand(2, N_POINTS, 3).astype(np.float32)
        want = jax.device_get(jmodel.apply(unflatten(flat), jnp.asarray(P),
                                           train=False))
        exact = jax.device_get(JaxANCSHModel(backbone_spec=JaxSpec(
            ball_query_impl="xla", **TINY_WIDTHS)).apply(
                unflatten(flat), jnp.asarray(P), train=False))

        model = build_model(NetworkConfig(backbone_preset="tiny",
                                          ball_query_packed=True))
        model.load_state_dict(state_dict_from_flax(flat))
        with torch.no_grad():
            got = {k: v.numpy() for k, v in model(_t(P)).items()}
        assert set(got) == set(want)
        for k in want:
            # The grouped coordinates are equal (TestPackedBallQuery), so
            # only the matmul summation order differs, ~2e-7 at these
            # widths.  5e-6 leaves a 25x margin and stays far below the
            # distance between the packed and the exact tier (below).
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-6,
                                       err_msg=k)
        # the packed tier is a different function from the exact one
        assert max(np.abs(want[k] - exact[k]).max() for k in want) > 2e-5


def _grouping(model, xyz, q):
    """SA1's centred neighbourhood coordinates through a model's backbone."""
    spec = model.backbone.spec
    g, _ = group(spec.sa_radii[0], spec.sa_nsamples[0], xyz, q, False,
                 spec.ball_query_impl, spec.ball_query_packed)
    return g


class TestConfig:
    def _inputs(self):
        xyz, q = _cloud_and_queries(5, 2, 256, 64)
        return _t(xyz), _t(q)

    def test_load_config_gives_a_packed_backbone(self):
        cfg = load_config(backbone_preset="tiny", ball_query_packed=True)
        assert cfg.ball_query_packed and cfg.use_pallas
        model = build_model(cfg)
        spec = model.backbone.spec
        assert spec.ball_query_impl == "pallas" and spec.ball_query_packed
        xyz, q = self._inputs()
        want, _, _ = ball_query.ball_query_group_packed_plain(
            spec.sa_radii[0], spec.sa_nsamples[0], xyz, q)
        assert torch.equal(_grouping(model, xyz, q), want)

    def test_yaml_ball_query_packed_is_read(self, tmp_path):
        path = tmp_path / "cfg.yml"
        path.write_text("backbone_preset: tiny\nball_query_packed: true\n")
        cfg = load_config(str(path))
        want = jax_load_config(str(path))
        assert cfg.ball_query_packed is want.ball_query_packed is True
        assert cfg.use_pallas == want.use_pallas
        assert build_model(cfg).backbone.spec.ball_query_packed

    def test_packed_without_pallas_is_exact(self):
        # JAX's "xla" route ignores ball_query_packed (pointnet2.py:109-110)
        cfg = load_config(backbone_preset="tiny", ball_query_packed=True,
                          use_pallas=False)
        model = build_model(cfg)
        assert model.backbone.spec.ball_query_impl == "xla"
        xyz, q = self._inputs()
        spec = model.backbone.spec
        want, _, _ = ball_query.ball_query_group_plain(
            spec.sa_radii[0], spec.sa_nsamples[0], xyz, q)
        packed, _, _ = ball_query.ball_query_group_packed_plain(
            spec.sa_radii[0], spec.sa_nsamples[0], xyz, q)
        got = _grouping(model, xyz, q)
        assert torch.equal(got, want) and not torch.equal(got, packed)

    @pytest.mark.parametrize("impl", ["bucket", "bucket_xla"])
    def test_bucket_raises(self, impl):
        # the bucket tier needs ceil(N/128)·128 / nsample to be a power
        # of two, on every device (ball_query_bucket.py:160-167): SA1 of
        # a 256-point cloud with nsample 24 is refused
        spec = BackboneSpec(ball_query_impl=impl,
                            **dict(TINY_WIDTHS, sa_nsamples=(24, 16)))
        model = ANCSHModel(backbone_spec=spec).eval()
        xyz, _ = self._inputs()
        with pytest.raises(ValueError, match="power-of-two bucket"):
            model(xyz)

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="unknown ball_query_impl"):
            BackboneSpec(ball_query_impl="fast")

    def test_jax_weights_load_into_the_packed_model(self):
        flat = flax_variables({})
        model = build_model(NetworkConfig(backbone_preset="tiny",
                                          ball_query_packed=True))
        sd = state_dict_from_flax(flat)
        assert set(sd) == set(model.state_dict())
        model.load_state_dict(sd)              # strict: every tensor used
