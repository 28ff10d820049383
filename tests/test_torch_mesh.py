"""The port's device mesh and data-parallel serving against the JAX
package's, on the CPU.

JAX builds its meshes over the suite's eight virtual CPU devices
(tests/conftest.py); the port over eight copies of the CPU device, the
counterpart a caller passes as `devices`.  Held equal: the mesh's axes,
shape and ValueError text (`make_mesh`), the batch-divisibility message
(`batch_sharding`), and which leaves `state_shardings` puts on 'model'
(JAX's kernel paths mapped through `convert`'s names).  Sharded serving
on data=4,model=2: the forward (NOCS and segmentation) against JAX's
sharded forward with the fit stubbed, as JAX's fast test runs it
(tests/test_serving.py), within the port's cross-package forward
tolerance (atol 1e-4, tests/test_torch_serving.py); the fits exact
against the unsharded predictor on each shard's rows with that shard's
draws, and a mesh of one shard bit for bit the unsharded predictor.
"""

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

import articulated_pose_tpu.serving as jserving
from articulated_pose_tpu import config as jconfig
from articulated_pose_tpu.models.ancsh import ANCSHModel as JaxANCSHModel
from articulated_pose_tpu.models.pointnet2 import \
    BackboneSpec as JaxBackboneSpec
from articulated_pose_tpu.parallel import mesh as jmesh
from articulated_pose_tpu.train.state import create_train_state
from articulated_pose_tpu_torch import config
from articulated_pose_tpu_torch.convert import state_dict_from_flax
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.parallel import mesh
from articulated_pose_tpu_torch.serving import PosePredictor
from articulated_pose_tpu_torch.train.state import TrainState
from test_serving import _stub_fits
from test_torch_models import unflatten
from test_torch_pose import port_cfg
from test_torch_serving import clouds, tiny_setup

CPUS = [torch.device("cpu")] * 8
B = 8

# the wide backbone of JAX's TestTPSharding (tests/test_train.py): its
# global SA's conv1 crosses the 256-feature threshold
WIDE = dict(sa_npoints=(16, 8), sa_radii=(0.25, 0.5), sa_nsamples=(8, 8),
            sa_mlps=((16,), (32,)), global_mlp=(64, 256),
            fp_mlps=((32,), (16,), (16,)), head_width=16)
# and one whose first FP stage crosses it too (fp1 conv0)
WIDE_FP = dict(WIDE, fp_mlps=((256,), (16,), (16,)))


@pytest.mark.parametrize("spec", [None, "data=8", "data=4,model=2",
                                  "data=2,model=4", "model=2,data=4",
                                  "data=1,model=8"])
def test_make_mesh_matches_jax(spec):
    want = jmesh.make_mesh(spec)
    got = mesh.make_mesh(spec, devices=CPUS)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


@pytest.mark.parametrize("spec", ["data=2", "data=4,model=4", "data=3"])
def test_make_mesh_size_error_matches_jax(spec):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(spec)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(spec, devices=CPUS)
    assert str(got.value) == str(want.value)
    assert str(got.value) == f"mesh spec {spec!r} needs " \
        f"{np.prod([int(p.split('=')[1]) for p in spec.split(',')])} " \
        "devices, have 8"


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh("data=1")


def test_mesh_coords_and_lines():
    m = mesh.make_mesh("data=2,model=4", devices=CPUS)
    assert m.coords(6) == {"data": 1, "model": 2}
    assert m.lines("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.lines("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.batch_sharding(m).shards == 2
    assert mesh.batch_sharding(m).rows(8, 1) == slice(4, 8)


def _jax_state(widths, n_parts=2):
    model = JaxANCSHModel(n_max_parts=n_parts, mixed=False, pred_joint=False,
                          backbone_spec=JaxBackboneSpec(**widths))
    cfg = jconfig.NetworkConfig(n_max_parts=n_parts, num_points=64,
                                batch_size=4, nocs_type="npcs",
                                pred_joint=False)
    return create_train_state(model, cfg, jax.random.PRNGKey(0),
                              np.zeros((1, 64, 3), np.float32))


def _jax_model_leaves(tree):
    """{port parameter name: PartitionSpec} of a params-shaped tree."""
    flat = traverse_util.flatten_dict(tree, sep="/")
    names = state_dict_from_flax({"params/" + k: np.zeros((1, 1))
                                  for k in flat})
    return {n: flat[k].spec for n, k in zip(names, flat)}


@pytest.mark.parametrize("widths", [WIDE, WIDE_FP, {}],
                         ids=["wide", "wide_fp", "reference"])
@pytest.mark.parametrize("spec", ["data=4,model=2", "data=2,model=4"])
def test_state_shardings_match_jax(widths, spec):
    jstate = _jax_state(widths)
    jsh = jmesh.state_shardings(jstate, jmesh.make_mesh(spec))
    adam = jsh.opt_state.inner_state[0]
    model = ANCSHModel(n_max_parts=2, mixed=False, pred_joint=False,
                       backbone_spec=BackboneSpec(**widths))
    st = TrainState(model, config.NetworkConfig(n_max_parts=2))
    got = mesh.state_shardings(st, mesh.make_mesh(spec, devices=CPUS))
    assert got["count"] == got["step"] == ()
    for key, tree in (("model", jsh.params), ("mu", adam.mu),
                      ("nu", adam.nu)):
        want = _jax_model_leaves(tree)
        split = {n for n, s in got[key].items() if s}
        assert split == {n for n, s in want.items()
                         if s != jax.sharding.PartitionSpec()}, key
        for n in split:
            # JAX splits the kernel's (Cin, Cout) last axis, the port the
            # weight's (Cout, Cin) first
            assert got[key][n] == ("model", None)
            assert tuple(want[n]) == (None, "model")
        # the batch norm's statistics are replicated in both
        assert all(not s for n, s in got[key].items() if "running" in n)
    if widths:
        assert "backbone.sa_global.mlp.conv1.dense.weight" in {
            n for n, s in got["model"].items() if s}


@pytest.fixture(scope="module")
def served():
    """The JAX sharded predictor (fit stubbed) on data=4,model=2 and the
    port's sharded and unsharded predictors, on the same weights."""
    kw, jcfg, flat = tiny_setup(batch_size=B)
    variables = unflatten(flat)
    patch = pytest.MonkeyPatch()
    patch.setattr(jserving, "fit_frame_batch", _stub_fits)
    jpred = jserving.PosePredictor(
        jconfig.NetworkConfig(**kw), params=variables["params"],
        batch_stats=variables["batch_stats"], pose_cfg=jcfg,
        use_nonlinear=False, mesh=jmesh.make_mesh("data=4,model=2"))
    cfg = config.NetworkConfig(**kw)
    sd = state_dict_from_flax(flat)
    port = PosePredictor(cfg, state_dict=sd, pose_cfg=port_cfg(jcfg),
                         mesh=mesh.make_mesh("data=4,model=2", devices=CPUS))
    plain = PosePredictor(cfg, state_dict=sd, pose_cfg=port_cfg(jcfg),
                          device="cpu")
    yield dict(jax=jpred, port=port, plain=plain, cfg=cfg, sd=sd, jcfg=jcfg)
    patch.undo()


def test_sharded_forward_matches_jax_sharded_forward(served):
    P = clouds(B)
    want = served["jax"](P)
    got = served["port"](P)
    np.testing.assert_allclose(got.raw["nocs_per_point"],
                               want.raw["nocs_per_point"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    assert got.R.shape == want.R.shape == (B, 2, 3, 3)


def test_sharded_fits_equal_per_shard_unsharded_calls(served):
    P = clouds(B, seed=2)
    got = served["port"](P)
    fields = ("R", "scale", "t", "segmentation", "part_counts")
    for shard in range(4):
        rows = slice(2 * shard, 2 * shard + 2)
        want = served["plain"](P[rows],
                               draws=served["port"].draws(2, shard))
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f)[rows],
                                          getattr(want, f), err_msg=f)
        for k in want.raw:
            np.testing.assert_array_equal(got.raw[k][rows], want.raw[k],
                                          err_msg=k)
    # the shards draw apart; shard 0 draws the unsharded predictor's
    d0, d1 = (served["port"].draws(2, i) for i in (0, 1))
    assert not torch.equal(d0.part, d1.part)
    assert torch.equal(d0.part, served["plain"].draws(2).part)


def test_sharded_call_takes_one_draws_per_shard(served):
    P = clouds(B, seed=4)
    port = served["port"]
    own = port(P)
    given = port(P, draws=[port.draws(2, shard) for shard in range(4)])
    for f in ("R", "scale", "t", "segmentation", "part_counts"):
        np.testing.assert_array_equal(getattr(given, f), getattr(own, f))
    swapped = port(P, draws=[port.draws(2, 1 - shard % 2)
                             for shard in range(4)])
    assert not np.array_equal(swapped.R, own.R)


def test_one_shard_mesh_is_the_unsharded_predictor(served):
    one = PosePredictor(served["cfg"], state_dict=served["sd"],
                        pose_cfg=port_cfg(served["jcfg"]),
                        mesh=mesh.make_mesh("data=1", devices=CPUS[:1]))
    P = clouds(B, seed=3)
    got, want = one(P), served["plain"](P)
    for f in ("R", "scale", "t", "segmentation", "part_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_two_shard_result_equals_the_unsharded_predictors(served):
    """A data=2 mesh given the unsharded predictor's draws, split by
    rows, returns its PoseResult field by field: each shard's arrays
    land in their rows of one host array a field."""
    from articulated_pose_tpu_torch.pose.pipeline import PoseDraws

    two = PosePredictor(served["cfg"], state_dict=served["sd"],
                        pose_cfg=port_cfg(served["jcfg"]),
                        mesh=mesh.make_mesh("data=2", devices=CPUS[:2]))
    plain = served["plain"]
    P = clouds(B, seed=5)
    d = plain.draws(B)
    half = B // 2
    got = two(P, draws=[PoseDraws(part=d.part[r], joint=d.joint[r])
                        for r in (slice(0, half), slice(half, B))])
    want = plain(P)
    for f in ("R", "scale", "t", "segmentation", "part_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.raw.keys() == want.raw.keys()
    for k in want.raw:
        np.testing.assert_array_equal(got.raw[k], want.raw[k], err_msg=k)
    assert two.d2h_bytes == sum(
        a.nbytes for a in (got.R, got.scale, got.t, got.segmentation,
                           got.part_counts, *got.raw.values()))
    assert two.pinned_fields == two.pinned_allocs == 0


def test_batch_divisibility_error_matches_jax(served):
    P = clouds(6)
    with pytest.raises(ValueError) as want:
        served["jax"](P)
    with pytest.raises(ValueError) as got:
        served["port"](P)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="draws each shard's own"):
        served["port"](clouds(B), draws=served["plain"].draws(B))
