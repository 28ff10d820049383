"""Point-cloud rasterization utilities: a copy of
`articulated_pose_tpu/utils/pc_util.py`.

Equivalent of the reference's pc_util helpers (reference:
pointnet_plusplus/utils/pc_util.py:24-175): voxel-occupancy volumes and
simple orthographic image projections, used for debugging/visualization.
"""

from __future__ import annotations

import numpy as np


def point_cloud_to_volume(points: np.ndarray, vsize: int = 32,
                          radius: float = 1.0) -> np.ndarray:
    """(N, 3) points in [-radius, radius]³ -> (vsize³) occupancy grid."""
    vol = np.zeros((vsize, vsize, vsize), np.float32)
    voxel = 2 * radius / vsize
    loc = ((points + radius) / voxel).astype(int)
    keep = ((loc >= 0) & (loc < vsize)).all(axis=1)
    loc = loc[keep]
    vol[loc[:, 0], loc[:, 1], loc[:, 2]] = 1.0
    return vol


def volume_to_point_cloud(vol: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Occupancy grid -> voxel-center points."""
    vsize = vol.shape[0]
    voxel = 2 * radius / vsize
    idx = np.argwhere(vol > 0.5)
    return idx * voxel - radius + voxel / 2


def point_cloud_to_image(points: np.ndarray, imgsize: int = 128,
                         radius: float = 1.0,
                         values: np.ndarray = None) -> np.ndarray:
    """Orthographic xy splat: (N, 3) -> (imgsize, imgsize) intensity."""
    img = np.zeros((imgsize, imgsize), np.float32)
    pix = ((points[:, :2] + radius) / (2 * radius) * imgsize).astype(int)
    keep = ((pix >= 0) & (pix < imgsize)).all(axis=1)
    pix = pix[keep]
    v = np.ones(len(pix)) if values is None else np.asarray(values)[keep]
    np.maximum.at(img, (pix[:, 1], pix[:, 0]), v)
    return img


def write_pointcloud(filename: str, xyz_points: np.ndarray,
                     rgb_points: np.ndarray = None) -> None:
    """Binary little-endian PLY writer (lib/data_utils.py:163-183).

    xyz_points (N, 3) float; rgb_points (N, 3) uint8 (default white).
    Vectorized via a structured array instead of the reference's
    per-point struct.pack loop.
    """
    xyz_points = np.asarray(xyz_points)
    assert xyz_points.ndim == 2 and xyz_points.shape[1] == 3, \
        "Input XYZ points should be Nx3 float array"
    if rgb_points is None:
        rgb_points = np.full(xyz_points.shape, 255, np.uint8)
    rgb_points = np.asarray(rgb_points, np.uint8)
    assert rgb_points.shape == xyz_points.shape, \
        "Input RGB colors should be Nx3 and match the XYZ points"
    n = xyz_points.shape[0]
    header = (b"ply\n"
              b"format binary_little_endian 1.0\n"
              + f"element vertex {n}\n".encode()
              + b"property float x\nproperty float y\nproperty float z\n"
              b"property uchar red\nproperty uchar green\n"
              b"property uchar blue\nend_header\n")
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("r", "u1"), ("g", "u1"), ("b", "u1")])
    rec["x"], rec["y"], rec["z"] = (xyz_points[:, i].astype("<f4")
                                    for i in range(3))
    rec["r"], rec["g"], rec["b"] = (rgb_points[:, i] for i in range(3))
    with open(filename, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())


def read_pointcloud(filename: str):
    """Read back a PLY written by write_pointcloud -> (xyz (N,3) f32,
    rgb (N,3) u8)."""
    with open(filename, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n = int([ln for ln in data[:end].split(b"\n")
             if ln.startswith(b"element vertex")][0].split()[-1])
    rec = np.frombuffer(data[end:], count=n,
                        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("r", "u1"), ("g", "u1"), ("b", "u1")])
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], 1).astype(np.float32)
    rgb = np.stack([rec["r"], rec["g"], rec["b"]], 1)
    return xyz, rgb
