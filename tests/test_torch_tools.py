"""The port's asset tools, `pc_util`, `sample_mesh_points` and
`prob_sample` against the JAX package's, on inputs built in tmp_path.

Written files (URDFs, PLY, split lists, HDF5 frames) must equal JAX's
(byte for byte, or dataset for dataset); the clouds of the depth
back-projection chain must be bit-equal (both are the same float64
NumPy); parsed URDFs, joint specs and norm info equal.  Also the
ImportErrors of the optional packages (PyYAML, h5py, pybullet), and
`chip_smoke.py`'s asset -> depth image -> frame round trip at a small
size on the CPU.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from articulated_pose_tpu.data import synthetic as jsynthetic
from articulated_pose_tpu.ops import core as jcore
from articulated_pose_tpu.tools import motion_json as jmotion_json
from articulated_pose_tpu.tools import preprocess as jpreprocess
from articulated_pose_tpu.tools import urdf as jurdf
from articulated_pose_tpu.tools import urdf_gen as jurdf_gen
from articulated_pose_tpu.utils import pc_util as jpc_util
from articulated_pose_tpu.utils import transforms as jtr
from articulated_pose_tpu_torch.data import synthetic
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.tools import (motion_json, preprocess, render,
                                              urdf, urdf_gen)
from articulated_pose_tpu_torch.utils import pc_util

MOTION = {                    # tests/test_tools.py's three-part tree
    "dof_name": "dof_rootd",
    "center": [0, 0, 0],
    "children": [
        {"dof_name": "dof_1", "center": [0.4, 0.0, 0.0],
         "direction": [0, 0, 1], "motion_type": "rotation", "children": None},
        {"dof_name": "dof_2", "center": [-0.4, 0.0, 0.0],
         "direction": [1, 0, 0], "motion_type": "translation",
         "children": [{"dof_name": "dof_3", "center": [-0.4, 0.2, 0.1],
                       "direction": [0, 1, 0], "motion_type": "rotation"}]},
    ],
}
MOBILITY = """<robot name="drawer">
  <link name="base">
    <visual><geometry><box size="1 1 1"/></geometry></visual>
    <collision><geometry><box size="1 1 1"/></geometry></collision>
  </link>
  <link name="link_0">
    <visual><origin xyz="0 0.1 0" rpy="0 0 0"/>
      <geometry><mesh filename="a.obj"/></geometry></visual>
    <visual><geometry><mesh filename="b.obj"/></geometry></visual>
    <collision><geometry><box size="0.5 0.4 0.1"/></geometry></collision>
  </link>
  <link name="link_1">
    <visual><geometry><box size="0.5 0.4 0.1"/></geometry></visual>
    <inertial><mass value="2.0"/></inertial>
  </link>
  <joint name="j0" type="prismatic">
    <parent link="base"/><child link="link_0"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="j1" type="continuous">
    <parent link="link_0"/><child link="link_1"/>
    <origin xyz="0 0 0.3" rpy="0 0 0"/><axis xyz="1 0 0"/>
  </joint>
</robot>"""


def assert_same_files(a, b):
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    for p, q in zip(a, b):
        assert open(p, "rb").read() == open(q, "rb").read(), p


def assert_equal_trees(got, want):
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            assert_equal_trees(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_equal_trees(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal_trees(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def gl_projection(fov=75.0, near=0.1, far=10.0):
    f = 1.0 / np.tan(np.radians(fov) / 2)
    return np.array([[f, 0, 0, 0], [0, f, 0, 0],
                     [0, 0, (far + near) / (near - far),
                      2 * far * near / (near - far)],
                     [0, 0, -1, 0]])


# ----------------------------------------------------------- motion JSON
def test_parse_motion_json_equals_jax(tmp_path):
    path = tmp_path / "motion.json"
    path.write_text(__import__("json").dumps(MOTION))
    for src in (MOTION, str(path)):
        assert_equal_trees(motion_json.parse_motion_json(src),
                           jmotion_json.parse_motion_json(src))


@pytest.mark.parametrize("per_part", [True, False])
def test_write_urdf_byte_equal(tmp_path, per_part):
    got = motion_json.write_urdf(motion_json.parse_motion_json(MOTION),
                                 str(tmp_path / "port"), obj_dir="objs",
                                 per_part=per_part)
    want = jmotion_json.write_urdf(jmotion_json.parse_motion_json(MOTION),
                                   str(tmp_path / "jax"), obj_dir="objs",
                                   per_part=per_part)
    assert len(got) == (5 if per_part else 1)
    assert_same_files(got, want)


# ------------------------------------------------------------------ URDF
def test_parse_urdf_and_joint_specs_equal_jax(tmp_path):
    paths = motion_json.write_urdf(motion_json.parse_motion_json(MOTION),
                                   str(tmp_path))
    (tmp_path / "mobility.urdf").write_text(MOBILITY)
    (tmp_path / "origins.urdf").write_text(MOBILITY.replace(
        "<visual><geometry><box", '<visual><origin xyz="0.5 0 0"/>'
        "<geometry><box"))
    for p in paths + [str(tmp_path / "mobility.urdf"),
                      str(tmp_path / "origins.urdf")]:
        got, want = urdf.parse_urdf(p), jurdf.parse_urdf(p)
        assert got == want, p
        try:
            jspecs = jurdf.urdf_to_joint_specs(want)
        except IndexError:
            # a child link with no visual origin (the per-part files,
            # mobility.urdf's link_1): JAX's reader fails, and so does
            # the port's copy
            with pytest.raises(IndexError):
                urdf.urdf_to_joint_specs(got)
            continue
        assert_equal_trees(urdf.urdf_to_joint_specs(got), jspecs)
    assert len(jurdf.urdf_to_joint_specs(
        jurdf.parse_urdf(str(tmp_path / "origins.urdf")))) == 2


def test_obj_vertices_and_norm_info_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    objs = []
    for i in range(3):
        p = tmp_path / f"p{i}.obj"
        v = rng.randn(20, 3)
        p.write_text("# part\n" + "".join(f"v {a} {b} {c}\n" for a, b, c in v)
                     + "vn 0 0 1\nf 1 2 3\n")
        objs.append(str(p))
        np.testing.assert_array_equal(urdf.load_obj_vertices(str(p)),
                                      jurdf.load_obj_vertices(str(p)))
    for paths, offsets in (
            (objs, None), ([objs[0], [objs[1], objs[2]]], None),
            (objs, [None, [0.1, 0.2, 0.3], np.ones(3)])):
        assert_equal_trees(urdf.norm_info_from_objs(paths, offsets),
                           jurdf.norm_info_from_objs(paths, offsets))


def test_modify_urdf_byte_equal(tmp_path):
    out = []
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        (d / "mobility.urdf").write_text(MOBILITY)
        mod = urdf_gen if name == "port" else jurdf_gen
        out.append(mod.modify_urdf(str(d)))
    assert len(out[0]) == 3
    assert_same_files(*out)


@pytest.mark.parametrize("parts", [2, 3, 5])
def test_generate_synthetic_urdf_byte_equal(tmp_path, parts):
    got = urdf_gen.generate_synthetic_urdf(parts, str(tmp_path / "port"),
                                           np.random.RandomState(parts))
    want = jurdf_gen.generate_synthetic_urdf(parts, str(tmp_path / "jax"),
                                             np.random.RandomState(parts))
    assert len(got) == parts + 1
    assert_same_files(got, want)


# ------------------------------------------------------------ preprocess
def test_backprojection_chain_bit_equal():
    rng = np.random.RandomState(1)
    H, W = 48, 64
    depth = -1.5 - rng.rand(H, W)
    mask = rng.rand(H, W) < 0.6
    proj = gl_projection()
    view = np.eye(4)
    view[:3, :3] = jtr.random_rotation(rng)
    view[:3, 3] = rng.randn(3)
    for flip_v in (True, False):
        for m in (None, mask):
            got = preprocess.depth_to_camera_points(depth, proj, m, flip_v)
            want = jpreprocess.depth_to_camera_points(depth, proj, m, flip_v)
            np.testing.assert_array_equal(got, want)
    cam = preprocess.depth_to_camera_points(depth, proj, mask)
    np.testing.assert_array_equal(preprocess.camera_to_world(cam, view),
                                  jpreprocess.camera_to_world(cam, view))
    m2w = jtr.similarity(1.3, jtr.random_rotation(rng), rng.randn(3))
    np.testing.assert_array_equal(preprocess.world_to_canonical(cam, m2w),
                                  jpreprocess.world_to_canonical(cam, m2w))


@pytest.mark.parametrize("min_points", [10, 400])
def test_preprocess_frame_bit_equal(min_points):
    rng = np.random.RandomState(2)
    H = W = 32
    depth = -2.0 - rng.rand(H, W)
    label = rng.randint(-1, 3, (H, W))
    view = np.eye(4)
    view[:3, 3] = [0.1, -0.2, 0.3]
    m2w = [jtr.similarity(1.0, jtr.random_rotation(rng), rng.randn(3))
           for _ in range(3)]
    got = preprocess.preprocess_frame(depth, label, gl_projection(), view,
                                      m2w, 3, min_points)
    want = jpreprocess.preprocess_frame(depth, label, gl_projection(), view,
                                        m2w, 3, min_points)
    if min_points == 400:                   # a part of < 400 pixels: skip
        assert got is None and want is None
        return
    assert_equal_trees(got, want)


def test_write_frame_h5_equal(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(3)
    cam = [rng.rand(10, 3), rng.rand(8, 3)]
    canon = [rng.rand(10, 3), rng.rand(8, 3)]
    rgb = (rng.rand(4, 4, 3) * 255).astype(np.uint8)
    mask = rng.randint(0, 2, (4, 4))
    files = {}
    for name, mod in (("port", preprocess), ("jax", jpreprocess)):
        files[name] = str(tmp_path / name / "sub" / "0.h5")
        mod.write_frame_h5(files[name], cam, canon, rgb=rgb, mask=mask)

    def read(path):
        out = {}
        with h5py.File(path) as f:
            f.visititems(lambda k, v: out.__setitem__(k, v[()])
                         if isinstance(v, h5py.Dataset) else None)
        return out

    assert_equal_trees(read(files["port"]), read(files["jax"]))


def test_write_pointcloud_byte_equal(tmp_path):
    rng = np.random.RandomState(4)
    xyz = rng.rand(50, 3)
    rgb = (rng.rand(50, 3) * 255).astype(np.uint8)
    for colors in (None, rgb):
        preprocess.write_pointcloud(str(tmp_path / "a.ply"), xyz, colors)
        jpreprocess.write_pointcloud(str(tmp_path / "b.ply"), xyz, colors)
        assert ((tmp_path / "a.ply").read_bytes()
                == (tmp_path / "b.ply").read_bytes())


def test_get_pose_equal(tmp_path):
    yaml = pytest.importorskip("yaml")
    rng = np.random.RandomState(5)
    objs = []
    for _ in range(2):
        q = jtr.quaternion_from_matrix(jtr.random_rotation(rng))   # wxyz
        objs.append([0, 0, 0, 0, rng.randn(3).tolist(),
                     [float(q[1]), float(q[2]), float(q[3]), float(q[0])]])
    meta = {"frame_3": {"viewMat": rng.randn(16).tolist(),
                        "projMat": gl_projection().T.reshape(-1).tolist(),
                        "obj": objs}}
    for sub, mode in (("render", "train"), ("demo", "demo")):
        d = tmp_path / sub / "oven" / "0001" / "2"
        d.mkdir(parents=True)
        with open(d / "gt.yml", "w") as f:
            yaml.safe_dump(meta, f)
        args = (str(tmp_path), "oven", "0001", "2", "3")
        assert_equal_trees(
            preprocess.get_pose(*args, mode=mode, num_parts=3),
            jpreprocess.get_pose(*args, mode=mode, num_parts=3))


def test_write_splits_equal(tmp_path):
    files = [f"hdf5/cat/{i:04d}/{j}/{k}.h5" for i in range(5)
             for j in range(2) for k in range(2)]
    for name, mod in (("port", preprocess), ("jax", jpreprocess)):
        mod.write_splits(str(tmp_path / name), "cat", files, ["0001", "0003"])
        mod.write_splits(str(tmp_path / name), "cat", files, [], "all")
    for sub in ("0.01/train.txt", "0.01/test.txt", "all/train.txt",
                "all/test.txt"):
        got = (tmp_path / "port" / "splits" / "cat" / sub).read_bytes()
        assert got == (tmp_path / "jax" / "splits" / "cat" / sub).read_bytes()
    assert (tmp_path / "port/splits/cat/all/test.txt").read_bytes() == b""


@pytest.mark.parametrize("module,call,needs", [
    ("yaml", lambda d: preprocess.get_pose(d, "oven", "0001", "0", "0"),
     "PyYAML"),
    ("h5py", lambda d: preprocess.write_frame_h5(
        os.path.join(d, "x", "0.h5"), [np.zeros((2, 3))], [np.zeros((2, 3))]),
     "h5py"),
    ("pybullet", lambda d: render.PyBulletRenderer(["x.urdf"]),
     "SyntheticArticulated")])
def test_optional_package_absent_raises(tmp_path, monkeypatch, module, call,
                                        needs):
    monkeypatch.setitem(sys.modules, module, None)     # `import` fails
    with pytest.raises(ImportError, match=needs):
        call(str(tmp_path))


def test_random_viewpoints_equal_jax():
    from articulated_pose_tpu.tools import render as jrender

    assert (render.random_viewpoints(np.random.RandomState(6), 5)
            == jrender.random_viewpoints(np.random.RandomState(6), 5))


# --------------------------------------------- sampling and rasterizing
def test_sample_mesh_points_equal_jax():
    rng = np.random.RandomState(7)
    verts = rng.randn(30, 3)
    faces = rng.randint(0, 30, (40, 3))
    got = synthetic.sample_mesh_points(verts, faces, 500,
                                       np.random.RandomState(8))
    want = jsynthetic.sample_mesh_points(verts, faces, 500,
                                         np.random.RandomState(8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,N,M", [(1, 5, 40), (3, 200, 64)])
def test_prob_sample_exact_on_the_same_draws(B, N, M):
    rng = np.random.RandomState(N)
    w = rng.rand(B, N).astype(np.float32)
    w[:, ::7] = 0.0                           # some categories never drawn
    u = rng.rand(B, M).astype(np.float32)
    u[0, 0] = 0.0
    got = core.prob_sample(torch.from_numpy(w), torch.from_numpy(u))
    want = np.asarray(jcore.prob_sample(jnp.asarray(w), jnp.asarray(u)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pc_util_equal_jax(tmp_path):
    rng = np.random.RandomState(9)
    pts = rng.rand(300, 3) * 2.2 - 1.1        # some outside the volume
    for vsize, radius in ((16, 1.0), (24, 0.8)):
        vol = pc_util.point_cloud_to_volume(pts, vsize, radius)
        np.testing.assert_array_equal(
            vol, jpc_util.point_cloud_to_volume(pts, vsize, radius))
        np.testing.assert_array_equal(
            pc_util.volume_to_point_cloud(vol, radius),
            jpc_util.volume_to_point_cloud(vol, radius))
    vals = rng.rand(300)
    for values in (None, vals):
        np.testing.assert_array_equal(
            pc_util.point_cloud_to_image(pts, 32, 1.0, values),
            jpc_util.point_cloud_to_image(pts, 32, 1.0, values))
    rgb = (rng.rand(300, 3) * 255).astype(np.uint8)
    pc_util.write_pointcloud(str(tmp_path / "a.ply"), pts, rgb)
    jpc_util.write_pointcloud(str(tmp_path / "b.ply"), pts, rgb)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    assert_equal_trees(pc_util.read_pointcloud(str(tmp_path / "a.ply")),
                       jpc_util.read_pointcloud(str(tmp_path / "a.ply")))


# ------------------------------------------ chip_smoke's asset round trip
def test_asset_round_trip_on_the_cpu(tmp_path):
    """chip_smoke.py phase 14(b)'s host side at a small size: a
    Shape2Motion JSON and OBJ parts -> URDF -> joint specs and norm
    info -> mesh samples at the articulated pose -> depth and label
    image -> preprocess_frame (canonical points within 1e-5 of the
    samples) -> build_sample frames."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    frames, worst = chip_smoke.asset_frames(str(tmp_path), views=2,
                                            num_points=256, size=96)
    assert worst < 1e-5
    assert frames["P"].shape == (2, 256, 3)
    assert np.isfinite(frames["P"]).all()
    assert set(np.unique(frames["cls_gt"])) == {0.0, 1.0}
