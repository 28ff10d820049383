"""3D transform utilities of the host data feed: a NumPy copy of the
functions of `articulated_pose_tpu/utils/transforms.py` that the
synthetic generator uses (the evaluation helpers come with the eval
port).
"""

from __future__ import annotations

import numpy as np

EPS = 1e-12


def rotvec_to_matrix(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues: (3,) rotation vector -> (3, 3) rotation matrix."""
    theta = float(np.linalg.norm(rotvec))
    if theta < EPS:
        return np.eye(3)
    k = rotvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), EPS)
    return rotvec_to_matrix(axis * angle)


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    """Uniform random rotation via QR of a gaussian matrix."""
    A = rng.randn(3, 3)
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def similarity(scale: float, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(s, R, t) -> 4x4 homogeneous similarity transform."""
    T = np.eye(4)
    T[:3, :3] = scale * R
    T[:3, 3] = t
    return T


def decompose_similarity(T: np.ndarray):
    """4x4 similarity -> (s, R, t)."""
    M = T[:3, :3]
    s = float(np.cbrt(np.linalg.det(M)))
    return s, M / s, T[:3, 3].copy()


def apply_similarity(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def rotation_about_line(axis: np.ndarray, point: np.ndarray, angle: float) -> np.ndarray:
    """4x4 rotation about the line through `point` with direction `axis`."""
    R = axis_angle_matrix(axis, angle)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = point - R @ point
    return T


def translation_along(axis: np.ndarray, dist: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), EPS)
    T = np.eye(4)
    T[:3, 3] = axis * dist
    return T
