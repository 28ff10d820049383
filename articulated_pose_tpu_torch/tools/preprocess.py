"""Depth-render preprocessing: depth image → per-part point clouds → HDF5;
a copy of `articulated_pose_tpu/tools/preprocess.py`.  PyYAML (`get_pose`)
and h5py (`write_frame_h5`) are imported at the call.

Equivalent of the reference preprocessor (reference:
tools/preprocess_data.py:176-365): back-projects an NDC depth buffer
through the inverse projection matrix, lifts camera points to world via
the inverse view matrix, maps each part's points to its canonical/URDF
frame via the recorded link pose, and writes the `gt_points`/`gt_coords`
HDF5 schema the training loader consumes — plus model_info.json and the
train/test split files (replacing lib/data_utils.py:76-133
`split_dataset`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from articulated_pose_tpu_torch.utils import transforms as tr


def depth_to_camera_points(depth: np.ndarray, proj_mat: np.ndarray,
                           mask: Optional[np.ndarray] = None,
                           flip_v: bool = True) -> np.ndarray:
    """Back-project an OpenGL-style NDC depth buffer to camera points.

    depth (H, W): the w-channel depth (negative forward, as PyBullet's
    camera returns); proj_mat (4, 4): column-major projection (viewMat/
    projMat convention of tools/preprocess_data.py:265-298).
    Returns (N, 3) camera-space points at masked pixels.
    """
    H, W = depth.shape
    xmap, ymap = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    if mask is None:
        mask = np.ones_like(depth, bool)
    xs, ys = xmap[mask], ymap[mask]
    d = depth[mask]
    u = ys * 2.0 / W - 1.0
    v = ((H - xs) if flip_v else xs) * 2.0 / H - 1.0
    w_ch = -d
    ndc_xy = np.stack([u * w_ch, v * w_ch], axis=1)        # clip-space xy
    depth_col = -w_ch.reshape(-1, 1)
    P = np.asarray(proj_mat, np.float64)
    xy_cam = (ndc_xy - depth_col @ P[0:2, 2:3].T) @ np.linalg.pinv(P[:2, :2].T)
    return np.concatenate([xy_cam, depth_col], axis=1)


def camera_to_world(cloud_cam: np.ndarray, view_mat: np.ndarray) -> np.ndarray:
    """Camera → world with the reference's sign convention
    (tools/preprocess_data.py:299-303)."""
    hom = np.concatenate([cloud_cam, np.ones((len(cloud_cam), 1))], axis=1)
    pose = np.linalg.pinv(np.asarray(view_mat, np.float64).T)
    pose[:3, :] = -pose[:3, :]
    return (hom @ pose)[:, :3]


def world_to_canonical(cloud_world: np.ndarray,
                       model2world: np.ndarray) -> np.ndarray:
    """World → the part's canonical (rest) frame via its recorded pose."""
    hom = np.concatenate([cloud_world, np.ones((len(cloud_world), 1))], axis=1)
    return (hom @ np.linalg.pinv(np.asarray(model2world, np.float64).T))[:, :3]


def preprocess_frame(depth: np.ndarray, label: np.ndarray,
                     proj_mat: np.ndarray, view_mat: np.ndarray,
                     parts_model2world: Sequence[np.ndarray],
                     n_parts: int, min_points: int = 10
                     ) -> Optional[Tuple[List[np.ndarray], List[np.ndarray]]]:
    """One rendered frame → (per-part camera clouds, canonical clouds).

    label (H, W): per-pixel part id (−1 / >= n_parts = background).
    Returns None if any part has < min_points pixels (the reference skips
    such frames, preprocess_data.py:279-281).
    """
    parts_cam, parts_canon = [], []
    for j in range(n_parts):
        m = label == j
        if m.sum() < min_points:
            return None
        cam = depth_to_camera_points(depth, proj_mat, m)
        world = camera_to_world(cam, view_mat)
        canon = world_to_canonical(world, parts_model2world[j])
        parts_cam.append(cam)
        parts_canon.append(canon)
    return parts_cam, parts_canon


def write_frame_h5(path: str, parts_cam: Sequence[np.ndarray],
                   parts_canon: Sequence[np.ndarray],
                   rgb: Optional[np.ndarray] = None,
                   mask: Optional[np.ndarray] = None) -> None:
    """gt_points/gt_coords HDF5 schema (preprocess_data.py:337-348)."""
    try:
        import h5py
    except ImportError:
        raise ImportError("write_frame_h5 needs h5py, which is not "
                          "installed") from None

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        if rgb is not None:
            f.create_dataset("rgb", data=rgb)
        if mask is not None:
            f.create_dataset("mask", data=mask)
        gp = f.create_group("gt_points")
        gc = f.create_group("gt_coords")
        for j, (cam, canon) in enumerate(zip(parts_cam, parts_canon)):
            gp.create_dataset(str(j), data=cam.astype(np.float32))
            gc.create_dataset(str(j), data=canon.astype(np.float32))


def write_pointcloud(filename: str, xyz: np.ndarray,
                     rgb: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY writer (lib/data_utils.py:163-183),
    vectorized instead of the reference's per-point struct.pack loop."""
    xyz = np.asarray(xyz, np.float32)
    assert xyz.ndim == 2 and xyz.shape[1] == 3, "xyz must be (N, 3)"
    if rgb is None:
        rgb = np.full(xyz.shape, 255, np.uint8)
    rgb = np.asarray(rgb, np.uint8)
    assert rgb.shape == xyz.shape, "rgb must match xyz shape"
    rec = np.empty(xyz.shape[0], dtype=[("x", "<f4"), ("y", "<f4"),
                                        ("z", "<f4"), ("r", "u1"),
                                        ("g", "u1"), ("b", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz.T
    rec["r"], rec["g"], rec["b"] = rgb.T
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {xyz.shape[0]}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "end_header\n")
    with open(filename, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def get_pose(root_dir: str, category: str, item: str, art_index: str,
             frame_order: str, mode: str = "train", num_parts: int = 5):
    """Per-part model→world transforms + view/proj matrices from a
    rendered frame's gt.yml (lib/data_utils.py:186-228).

    Part 0 is the world-anchored base; parts k>0 carry PyBullet link
    (pos, orn-xyzw) states recorded by the renderer.
    Returns (parts_model2world [list of 4x4], viewMat, projMat).
    """
    try:
        import yaml
    except ImportError:
        raise ImportError("get_pose reads gt.yml with PyYAML (yaml), which "
                          "is not installed") from None

    from articulated_pose_tpu_torch.utils.transforms import quaternion_matrix

    sub = "demo" if mode == "demo" else "render"
    meta_path = os.path.join(root_dir, sub, category, item, str(art_index),
                             "gt.yml")
    with open(meta_path) as f:
        meta = yaml.safe_load(f)
    pose = meta[f"frame_{frame_order}"]
    view = np.asarray(pose["viewMat"], np.float64).reshape(4, 4).T
    proj = np.asarray(pose["projMat"], np.float64).reshape(4, 4).T
    m2w = []
    for k in range(num_parts):
        if k == 0:
            pos = np.zeros(3)
            orn = np.array([0.0, 0.0, 0.0, 1.0])
        else:
            pos = np.asarray(pose["obj"][k - 1][4], np.float64)
            orn = np.asarray(pose["obj"][k - 1][5], np.float64)
        # gt.yml orientation is xyzw; quaternion_matrix takes wxyz
        T = quaternion_matrix(np.array([orn[3], orn[0], orn[1], orn[2]]))
        T[:3, 3] = pos
        m2w.append(T)
    return m2w, view, proj


def write_splits(root_dir: str, category: str, files: Sequence[str],
                 test_instances: Sequence[str], num_expr: str = "0.01") -> None:
    """train/test split txts by held-out instances (lib/data_utils.py:76-133)."""
    from articulated_pose_tpu_torch.data.hdf5_dataset import instance_of

    train = [f for f in files if instance_of(f) not in set(test_instances)]
    test = [f for f in files if instance_of(f) in set(test_instances)]
    split_dir = os.path.join(root_dir, "splits", category, num_expr)
    os.makedirs(split_dir, exist_ok=True)
    for name, lst in (("train", train), ("test", test)):
        with open(os.path.join(split_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(lst) + ("\n" if lst else ""))
