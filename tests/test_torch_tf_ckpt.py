"""The reference's TF1 checkpoints in the port, against the JAX package.

- `utils/tf_ckpt.map_var_name` equal to JAX's, and every name of the
  reference graph reaching a port state_dict entry;
- TF1 bundles written by either package's `write_bundle` read back
  equal by both `read_bundle`s (multi-block, prefix compression, a
  sharded header), with the same errors;
- the port's forward with TF weights (`load_reference_weights`) within
  atol 1e-4 of JAX's ANCSHModel with JAX's `load_reference_weights`
  (tests/test_torch_models.py's bound: only the two CPU backends'
  matmul summation orders differ), at tests/test_tf_ckpt.py's TINY
  widths and at the reference widths, and within 2e-4 of the float64
  `reference_forward` of the TF graph (tests/test_ckpt_parity.py's
  bound), on tests/test_ckpt_parity.py's cloud;
- the port's `reference_forward` and `ops/numpy_ref` bit for bit equal
  to JAX's (both are float64 NumPy).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulated_pose_tpu.models.ancsh import ANCSHModel as JaxANCSH
from articulated_pose_tpu.models.pointnet2 import BackboneSpec as JaxSpec
from articulated_pose_tpu.ops import numpy_ref as jnumpy_ref
from articulated_pose_tpu.utils import ref_forward as jref_forward
from articulated_pose_tpu.utils import tf_bundle as jtf_bundle
from articulated_pose_tpu.utils import tf_ckpt as jtf_ckpt
from articulated_pose_tpu_torch.config import load_config
from articulated_pose_tpu_torch.convert import state_dict_from_flax
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel, build_model
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.ops import numpy_ref
from articulated_pose_tpu_torch.utils import ref_forward, tf_bundle, tf_ckpt

TINY = dict(sa_npoints=(16, 8), sa_radii=(0.25, 0.5), sa_nsamples=(8, 8),
            sa_mlps=((8, 16), (16, 32)), global_mlp=(32, 64),
            fp_mlps=((32,), (32,), (16, 16)), head_width=16)
REF_CKPT = ref_forward.synth_reference_checkpoint(np.random.RandomState(1))
# tests/test_ckpt_parity.py's cloud
CLOUD = np.random.RandomState(7).rand(2, 1024, 3).astype(np.float32)
PACKAGES = {"jax": jtf_bundle, "port": tf_bundle}


def port_name(tf_name):
    """A TF variable's port state_dict name: JAX's Flax path, then
    `convert`'s leaf map."""
    path, is_stat = tf_ckpt.map_var_name(tf_name)
    key = "/".join(("batch_stats" if is_stat else "params",) + path)
    (name,) = state_dict_from_flax({key: np.zeros((1, 1), np.float32)})
    return name


# ------------------------------------------------------------ name map
@pytest.mark.parametrize("tf_name", sorted(REF_CKPT) + [
    "SPFN/est_net/layer1/conv0/weights",
    "SPFN/est_net/layer3/conv2/bn/gamma",
    "SPFN/est_net/fa_layer2/conv_0/bn/moving_mean",
    "SPFN/est_net/fc1/biases", "SPFN/nocs_net/fc2_1/weights",
    "SPFN/joint_net/fc4_3/weights", "SPFN/joint_net/fc3_0/bn/beta",
    "/SPFN/est_net/layer2/conv1/weights/",
    "beta1_power", "SPFN/other/fcX/weights", "SPFN/est_net/layer4/conv0/biases",
    "global_step"])
def test_map_var_name_equals_jax(tf_name):
    assert tf_ckpt.map_var_name(tf_name) == jtf_ckpt.map_var_name(tf_name)


def test_every_reference_variable_reaches_a_state_dict_entry():
    sd = build_model(load_config("cfg/network_config.yml",
                                 compute_dtype="float32")).state_dict()
    names = [port_name(n) for n in REF_CKPT]
    assert sorted(names) == sorted(sd)          # one TF variable an entry


@pytest.mark.parametrize("shape", [(1, 1, 3, 8), (1, 5, 7), (4, 6), (9,)])
def test_kernel_conversion_equals_jax(shape):
    a = np.random.RandomState(0).rand(*shape)
    np.testing.assert_array_equal(tf_ckpt._convert_kernel(a),
                                  jtf_ckpt._convert_kernel(a))


# -------------------------------------------------------------- bundles
def bundle_cases():
    rng = np.random.RandomState(0)
    basic = {
        "SPFN/est_net/layer1/conv0/weights":
            rng.randn(1, 1, 3, 64).astype(np.float32),
        "SPFN/est_net/layer1/conv0/biases": rng.randn(64).astype(np.float32),
        "global_step": np.asarray(100000, dtype=np.int64),
        "scalar_f64": np.asarray(2.5, dtype=np.float64),
        "int32_vec": rng.randint(-5, 5, size=(7,)).astype(np.int32),
        "u8": rng.randint(0, 255, size=(2, 3)).astype(np.uint8),
        "half": rng.randn(5).astype(np.float16),
        "flags": rng.rand(4) > 0.5,
    }
    many = {f"SPFN/est_net/layer{i % 4}/conv{i % 3}/unit_{i:03d}/weights":
            rng.randn(3, 5).astype(np.float32) for i in range(120)}
    return {"basic": (basic, {}), "multiblock": (many, {"block_size": 256}),
            "sharded_header": ({"w": np.arange(12, dtype=np.float32)
                                .reshape(3, 4)}, {"num_shards": 2}),
            "reference": (REF_CKPT, {})}


@pytest.mark.parametrize("case", list(bundle_cases()))
@pytest.mark.parametrize("writer", list(PACKAGES))
def test_bundles_read_back_equal_in_both(tmp_path, writer, case):
    tensors, kw = bundle_cases()[case]
    prefix = str(tmp_path / "tf_model.ckpt-1000")
    PACKAGES[writer].write_bundle(prefix, tensors, **kw)
    for reader in PACKAGES.values():
        out = reader.read_bundle(prefix)
        assert set(out) == set(tensors)
        for k, v in tensors.items():
            assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
            np.testing.assert_array_equal(out[k], v, err_msg=k)
        entries, shards = reader.read_bundle_index(prefix)
        assert shards == kw.get("num_shards", 1)
        assert set(entries) == set(tensors)


@pytest.mark.parametrize("case", list(bundle_cases()))
def test_written_files_equal_jax(tmp_path, case):
    tensors, kw = bundle_cases()[case]
    for name, pkg in PACKAGES.items():
        pkg.write_bundle(str(tmp_path / name), tensors, **kw)
    suffix = f".data-00000-of-{kw.get('num_shards', 1):05d}"
    for ext in (".index", suffix):
        assert ((tmp_path / f"port{ext}").read_bytes()
                == (tmp_path / f"jax{ext}").read_bytes()), ext


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_bad_magic_rejected(tmp_path, pkg):
    p = tmp_path / "junk.index"
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="magic"):
        PACKAGES[pkg].read_sstable(str(p))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_size_mismatch_rejected(tmp_path, pkg):
    """An index entry whose recorded byte size disagrees with its shape:
    field 5 (size) of the one BundleEntryProto rewritten from 32 to 16,
    same length, so every block offset still holds."""
    prefix = str(tmp_path / "ck")
    tf_bundle.write_bundle(prefix, {"v": np.zeros((8,), np.float32)})
    raw = open(prefix + ".index", "rb").read()
    assert raw.count(b"\x28\x20") == 1          # tag (5, varint), 32
    open(prefix + ".index", "wb").write(raw.replace(b"\x28\x20", b"\x28\x10"))
    with pytest.raises(ValueError, match="byte size 16"):
        PACKAGES[pkg].read_bundle(prefix)


# ------------------------------------------------------------- overlay
def tiny_checkpoint(sd, rng):
    """A TF checkpoint, in TF's names and layouts, for every entry of a
    port state_dict at other widths and depths than the reference's: the
    reference graph's names of its entries, with their shapes."""
    out = {}
    for name in REF_CKPT:
        if port_name(name) not in sd:
            continue                    # a layer the narrower model lacks
        shape = tuple(sd[port_name(name)].shape)
        if name.endswith("/weights"):
            arr = rng.randn(1, 1, shape[1], shape[0]) / np.sqrt(shape[1])
        elif name.endswith("moving_variance"):
            arr = 0.5 + rng.rand(*shape)
        else:
            arr = 0.2 * rng.randn(*shape)
        out[name] = arr.astype(np.float32)
    assert len(out) == len(sd)
    return out


def jax_forward(spec_kw, ckpt_path):
    model = JaxANCSH(n_max_parts=3, mixed=True, pred_joint=True,
                     early_split_nocs=True, backbone_spec=JaxSpec(**spec_kw),
                     dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(CLOUD))
    params, stats, report = jtf_ckpt.load_reference_weights(
        ckpt_path, jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"]))
    out = jax.device_get(model.apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(CLOUD), train=False))
    return out, report


def port_forward(spec_kw, ckpt_path):
    model = ANCSHModel(n_max_parts=3, mixed=True, pred_joint=True,
                       early_split_nocs=True,
                       backbone_spec=BackboneSpec(**spec_kw)).eval()
    sentinel = {k: torch.full_like(v, float("nan"))
                for k, v in model.state_dict().items()}
    sd, report = tf_ckpt.load_reference_weights(ckpt_path, sentinel)
    # every entry was overwritten: no NaN of the sentinel is left
    assert all(torch.isfinite(v).all() for v in sd.values())
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(torch.from_numpy(CLOUD))
    return {k: v.numpy() for k, v in out.items()}, report


@pytest.fixture(scope="module")
def reference_outputs():
    """The float64 TF graph on the cloud, by both packages (~10 s each)."""
    return (ref_forward.reference_forward(REF_CKPT, CLOUD),
            jref_forward.reference_forward(REF_CKPT, CLOUD))


@pytest.mark.parametrize("widths,fmt", [
    ("tiny", "npz"), ("tiny", "bundle"), ("tiny", "index"),
    ("reference", "bundle")])
def test_forward_with_tf_weights_equals_jax(tmp_path, widths, fmt):
    spec_kw = TINY if widths == "tiny" else {}
    ckpt = REF_CKPT
    if widths == "tiny":
        sd = ANCSHModel(backbone_spec=BackboneSpec(**TINY)).state_dict()
        ckpt = tiny_checkpoint(sd, np.random.RandomState(3))
    # JAX's loader reads an .npz or a bundle prefix; the port's also a
    # prefix ending in .index
    path = str(tmp_path / "tf_model.ckpt-7")
    jax_path = path + ".npz" if fmt == "npz" else path
    if fmt == "npz":
        np.savez(jax_path, **ckpt)
    else:
        tf_bundle.write_bundle(path, ckpt)
    got, report = port_forward(spec_kw,
                               path + ".index" if fmt == "index" else jax_path)
    want, jreport = jax_forward(spec_kw, jax_path)
    assert report == jreport
    assert report["unmapped"] == report["mismatched"] == []
    assert sorted(report["mapped"]) == sorted(ckpt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_forward_with_tf_weights_equals_reference_graph(tmp_path,
                                                        reference_outputs):
    ref, _ = reference_outputs
    np.savez(tmp_path / "ckpt.npz", **REF_CKPT)
    got, _ = port_forward({}, str(tmp_path / "ckpt.npz"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].astype(np.float64), ref[k],
                                   atol=2e-4, err_msg=k)


def test_reference_forward_bit_equal_to_jax(reference_outputs):
    got, want = reference_outputs
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("options", [
    dict(n_max_parts=2, mixed=False, early_split_nocs=False),
    dict(n_max_parts=4, scope="Other")])
def test_synth_reference_checkpoint_equals_jax(options):
    got = ref_forward.synth_reference_checkpoint(np.random.RandomState(5),
                                                 **options)
    want = jref_forward.synth_reference_checkpoint(np.random.RandomState(5),
                                                   **options)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_overlay_skips_and_reports_as_jax(tmp_path):
    """tests/test_tf_ckpt.py::TestOverlay on the port: one kernel and one
    statistic land, Adam slots are skipped, an unknown name and a wrong
    shape are reported as JAX reports them, the rest stays untouched."""
    model = ANCSHModel(backbone_spec=BackboneSpec(**TINY))
    sd = model.state_dict()
    w = np.full((1, 1, 3, 8), 0.123, np.float32)
    m = np.full((8,), 7.0, np.float32)
    npz = str(tmp_path / "ckpt.npz")
    np.savez(npz, **{
        "SPFN/est_net/layer1/conv0/weights": w,
        "SPFN/est_net/layer1/conv0/bn/moving_mean": m,
        "SPFN/est_net/layer1/conv0/weights/Adam": w,        # skipped
        "global_step": np.asarray(3),                       # skipped
        "some/unknown/var": np.zeros(3),                    # unmapped
        "SPFN/est_net/layer1/conv1/biases": np.zeros(5),    # mismatched
    })
    new, report = tf_ckpt.load_reference_weights(npz, sd)
    jmodel = JaxANCSH(backbone_spec=JaxSpec(**TINY))
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 3), jnp.float32))
    _, _, jreport = jtf_ckpt.load_reference_weights(
        npz, jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"]))
    assert report == jreport
    assert report["unmapped"] == ["some/unknown/var"]
    assert report["mismatched"] == [
        ("SPFN/est_net/layer1/conv1/biases", (16,), (5,))]
    assert torch.equal(new["backbone.sa1.mlp.conv0.dense.weight"],
                       torch.full((8, 3), 0.123))
    assert torch.equal(new["backbone.sa1.mlp.conv0.bn.running_mean"],
                       torch.full((8,), 7.0))
    changed = {"backbone.sa1.mlp.conv0.dense.weight",
               "backbone.sa1.mlp.conv0.bn.running_mean"}
    for k, v in sd.items():
        if k not in changed:
            assert torch.equal(new[k], v), k


def test_missing_bundle_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="neither"):
        tf_ckpt.load_reference_weights(str(tmp_path / "nope"), {})


# ------------------------------------------------------------- oracles
def test_numpy_ref_bit_equal_to_jax():
    rng = np.random.RandomState(11)
    xyz = rng.rand(2, 200, 3)
    new = rng.rand(2, 40, 3)
    for fn, args in [
            ("farthest_point_sample", (64, xyz)),
            ("query_ball_point", (0.2, 16, xyz, new)),
            ("three_nn", (new, xyz)), ("three_nn", (new, xyz[:, :2])),
            ("gather_point", (xyz, rng.randint(0, 200, (2, 40)))),
            ("group_point", (xyz, rng.randint(0, 200, (2, 40, 8)))),
            ("three_interpolate", (rng.rand(2, 30, 5),
                                   rng.randint(0, 30, (2, 40, 3)),
                                   rng.rand(2, 40, 3))),
            ("prob_sample", (rng.rand(2, 50), rng.rand(2, 70)))]:
        got = getattr(numpy_ref, fn)(*args)
        want = getattr(jnumpy_ref, fn)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype, fn
            np.testing.assert_array_equal(g, w, err_msg=fn)


def test_bn_epsilon_is_tf_contrib():
    from articulated_pose_tpu_torch.models.layers import ScheduledBatchNorm

    assert ref_forward.BN_EPS == 1e-3
    assert ScheduledBatchNorm(4).eps == 1e-3


def test_spec_fields_match():
    """The TINY widths build the same backbone in both packages."""
    jfields = {f.name for f in dataclasses.fields(JaxSpec)}
    assert set(TINY) <= jfields
    assert set(TINY) <= {f.name for f in dataclasses.fields(BackboneSpec)}
