"""The port's backbone in every configuration the JAX backbone takes, on the CPU.

Single-level FPS (B2's plain version) against the Pallas kernel in
interpret mode; SA pyramids of one and three levels, whose FPS is the
single-level kernel per stage (JAX `fps_impl="pallas"`, interpreted,
with `resolve_impl` made the identity as in tests/test_torch_packed.py);
clouds with input features; the mixed-precision policy knobs; and the
weight bridge on an N-level tree.  The CUDA kernel is held against the
plain version on the card by tests/test_torch_kernels_cuda.py.
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
from articulated_pose_tpu.ops import core as jcore
from articulated_pose_tpu_torch.config import NetworkConfig, load_config
from articulated_pose_tpu_torch.convert import state_dict_from_flax
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel, build_model
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec,
                                                         PointNet2Backbone)
from articulated_pose_tpu_torch.ops.kernels import (fps, launch_counts,
                                                    reset_launch_counts)
from test_torch_models import N_POINTS, flax_variables, run_both, unflatten

ONE_LEVEL = dict(sa_npoints=(64,), sa_radii=(0.3,), sa_nsamples=(16,),
                 sa_mlps=((16, 32),), global_mlp=(32, 64),
                 fp_mlps=((32,), (16, 16)), head_width=16)
THREE_LEVEL = dict(sa_npoints=(64, 32, 16), sa_radii=(0.2, 0.4, 0.6),
                   sa_nsamples=(16, 16, 8),
                   sa_mlps=((16, 16), (16, 32), (32, 32)),
                   global_mlp=(32, 64), fp_mlps=((32,), (32,), (32,), (16, 16)),
                   head_width=16)
SPECS = {"one_level": ONE_LEVEL, "two_level": TINY_WIDTHS,
         "three_level": THREE_LEVEL}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cloud(seed, B, N):
    return np.random.RandomState(seed).rand(B, N, 3).astype(np.float32)


def _pallas_fps(monkeypatch):
    """Let the JAX model run its Pallas FPS tier on the CPU, interpreted:
    the two-level kernel for a two-level pyramid, else the single-level
    kernel per stage (pointnet2.py:290-302)."""
    monkeypatch.setattr(jpointnet2, "resolve_impl", lambda impl: impl)
    for name in ("farthest_point_sample_pallas",
                 "farthest_point_sample2_pallas"):
        monkeypatch.setattr(jpallas, name, functools.partial(
            getattr(jpallas, name), interpret=True))


def run_spec(spec_kw, in_features=0, seed=0):
    """The JAX model (Pallas FPS tier) and the port on the same random
    weights and the same (2, N_POINTS, 3 + in_features) clouds."""
    jmodel = JaxANCSHModel(backbone_spec=JaxSpec(fps_impl="pallas",
                                                 **spec_kw))
    flat = flax_variables({}, seed, model=jmodel, channels=3 + in_features)
    rng = np.random.RandomState(seed + 1)
    P = rng.rand(2, N_POINTS, 3 + in_features).astype(np.float32)
    want = jax.device_get(jmodel.apply(unflatten(flat), jnp.asarray(P),
                                       train=False))
    model = ANCSHModel(backbone_spec=BackboneSpec(**spec_kw),
                       in_features=in_features).eval()
    model.load_state_dict(state_dict_from_flax(flat))
    reset_launch_counts()
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(_t(P)).items()}
    assert sum(launch_counts().values()) == 0
    return got, want


def _assert_close(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == np.float32 and np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


class TestSingleLevelFPS:
    @pytest.mark.parametrize("B,N,npoint", [(3, 256, 64), (2, 200, 37)])
    def test_matches_pallas_and_xla(self, B, N, npoint):
        xyz = _cloud(N, B, N)
        idx, new_xyz = (v.numpy() for v in fps.fps_plain(_t(xyz), npoint))
        pidx = np.asarray(jpallas.farthest_point_sample_pallas(
            npoint, jnp.asarray(xyz), interpret=True))
        np.testing.assert_array_equal(idx, pidx)
        np.testing.assert_array_equal(
            idx, np.asarray(jcore.farthest_point_sample(npoint,
                                                        jnp.asarray(xyz))))
        np.testing.assert_array_equal(
            new_xyz, np.take_along_axis(xyz, pidx[..., None], axis=1))
        assert idx.dtype == np.int32

    def test_is_the_first_level_of_fps2(self):
        xyz = _t(_cloud(1, 2, 128))
        i1, x1, _, _ = fps.fps2_plain(xyz, 16, 4)
        idx, new_xyz = fps.fps(xyz, 16)
        assert torch.equal(idx, i1) and torch.equal(new_xyz, x1)


class TestPyramids:
    @pytest.mark.parametrize("name", ["one_level", "three_level"])
    def test_matches_jax_pallas_fps(self, name, monkeypatch):
        _pallas_fps(monkeypatch)
        got, want = run_spec(SPECS[name])
        # same weights, same neighbourhoods: only matmul summation order
        # differs between the two CPU backends
        _assert_close(got, want, 1e-4)

    @pytest.mark.parametrize("name", ["two_level", "three_level"])
    def test_input_features(self, name, monkeypatch):
        """(B, N, 3 + 2) clouds: SA1 groups the features with the
        coordinates, the last FP's skip is [xyz, features]."""
        _pallas_fps(monkeypatch)
        got, want = run_spec(SPECS[name], in_features=2, seed=3)
        _assert_close(got, want, 1e-4)

    def test_feature_width_is_checked(self):
        model = ANCSHModel(backbone_spec=BackboneSpec(**TINY_WIDTHS),
                           in_features=2).eval()
        with pytest.raises(ValueError, match="in_features=2"):
            model(_t(_cloud(0, 1, 64)))

    def test_fp_stages_must_be_one_more_than_sa_stages(self):
        with pytest.raises(ValueError, match=r"len\(fp_mlps\)"):
            BackboneSpec(**dict(THREE_LEVEL, fp_mlps=((32,), (16, 16))))
        with pytest.raises(ValueError, match="one entry per SA stage"):
            BackboneSpec(**dict(THREE_LEVEL, sa_radii=(0.2, 0.4)))

    def test_unknown_f32_stage_raises_as_jax(self):
        jmodel = JaxANCSHModel(backbone_spec=JaxSpec(**THREE_LEVEL),
                               f32_stages=("sa4",))
        x = jax.ShapeDtypeStruct((1, N_POINTS, 3), jnp.float32)
        with pytest.raises(ValueError) as jerr:
            jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p,
                                                 train=False), x)
        with pytest.raises(ValueError) as err:
            PointNet2Backbone(BackboneSpec(**THREE_LEVEL), f32_stages=("sa4",))
        assert str(err.value) == str(jerr.value)
        # sa3 and fp4 exist in a three-level pyramid
        PointNet2Backbone(BackboneSpec(**THREE_LEVEL),
                          f32_stages=("sa3", "fp4"))


class TestMixedPrecision:
    @pytest.mark.parametrize("knobs", [
        {"head_compute_dtype": "float32"},
        {"pool_compute_dtype": "float32"},
        {"act_compute_dtype": "float32"},
        {"f32_stages": ("sa1",)},
        {"head_compute_dtype": "float32", "pool_compute_dtype": "float32",
         "f32_stages": ("sa1", "fc1")},
    ], ids=["head", "pool", "act", "f32_sa1", "combined"])
    def test_policy_under_bf16_trunk(self, knobs):
        got, want = run_both(knobs, dtype="bfloat16")
        # bf16 keeps 8 mantissa bits and the two frameworks round at
        # different places: the bound of test_torch_models.test_bf16_trunk
        _assert_close(got, want, 2e-2)

    def test_knobs_set_the_stage_dtypes(self):
        f32, bf16 = torch.float32, torch.bfloat16
        m = build_model(NetworkConfig(backbone_preset="tiny",
                                      compute_dtype="bfloat16",
                                      head_compute_dtype="float32",
                                      pool_compute_dtype="float32",
                                      f32_stages=("sa1",)))
        bb = m.backbone
        assert bb.sa1.mlp.conv0.dtype == f32 and bb.sa2.mlp.conv0.dtype == bf16
        # pool_dtype: the last layer of each SA emits f32, the pooled
        # output goes back to the stage dtype
        assert bb.sa2.mlp.conv1.out_dtype == f32
        assert bb.sa2.mlp.conv0.out_dtype == bf16 and bb.sa2.out_dtype == bf16
        assert m.fc2_0.dtype == f32 and m.joint_net.fc3_0.dtype == f32
        assert bb.fc1.dtype == bf16
        act = build_model(NetworkConfig(backbone_preset="tiny",
                                        compute_dtype="bfloat16",
                                        act_compute_dtype="float32"))
        convs = [mod for name, mod in act.backbone.named_modules()
                 if name.split(".")[-1].startswith("conv") or name == "fc1"]
        assert convs and all(c.dtype == bf16 and c.out_dtype == f32
                             for c in convs)

    def test_load_config_normalises_f32_stages(self, tmp_path):
        path = tmp_path / "cfg.yml"
        path.write_text("compute_dtype: bfloat16\n"
                        "f32_stages: [' sa1 ', fc1]\n")
        cfg = load_config(str(path))
        assert cfg.f32_stages == ("sa1", "fc1")
        assert cfg.f32_stages == jax_load_config(str(path)).f32_stages
        path.write_text("f32_stages: [sa1, sa_1]\n")
        with pytest.raises(ValueError, match="unknown f32_stages"):
            load_config(str(path))
        with pytest.raises(ValueError, match="unknown f32_stages"):
            jax_load_config(str(path))


class TestWeightBridge:
    def test_round_trip_on_a_three_level_tree(self):
        jmodel = JaxANCSHModel(backbone_spec=JaxSpec(**THREE_LEVEL))
        flat = flax_variables({}, model=jmodel, channels=5)
        sd = state_dict_from_flax(flat)
        model = ANCSHModel(backbone_spec=BackboneSpec(**THREE_LEVEL),
                           in_features=2)
        # sa3 and fp4 are mapped by name, SA1's first layer is 5 + 3 wide
        assert set(sd) == set(model.state_dict())
        assert any(k.startswith("backbone.sa3.") for k in sd)
        assert any(k.startswith("backbone.fp4.") for k in sd)
        assert sd["backbone.sa1.mlp.conv0.dense.weight"].shape == (16, 5)
        model.load_state_dict(sd)                  # strict: every tensor
        for name, t in model.state_dict().items():
            path, leaf = name.rsplit(".", 2)[0], ".".join(name.rsplit(".", 2)[1:])
            col, fl = {"dense.weight": ("params", "dense/kernel"),
                       "dense.bias": ("params", "dense/bias"),
                       "bn.weight": ("params", "bn/scale"),
                       "bn.bias": ("params", "bn/bias"),
                       "bn.running_mean": ("batch_stats", "bn/mean"),
                       "bn.running_var": ("batch_stats", "bn/var")}[leaf]
            arr = t.numpy().T if leaf == "dense.weight" else t.numpy()
            np.testing.assert_array_equal(
                arr, flat[f"{col}/{path.replace('.', '/')}/{fl}"])
