"""3D transform utilities: a NumPy copy of
`articulated_pose_tpu/utils/transforms.py`, the synthetic generator's
transforms and the evaluation helpers (quaternions, rotation and axis
angles, line distances, the joint estimate from correspondences).
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


def quaternion_matrix(q: np.ndarray) -> np.ndarray:
    """4x4 rotation matrix from a [w, x, y, z] quaternion
    (lib/transformations.py:1174-1201 convention, used by get_pose)."""
    q = np.asarray(q, np.float64).copy()
    n = np.dot(q, q)
    if n < EPS:
        return np.eye(4)
    q *= np.sqrt(2.0 / n)
    outer = np.outer(q, q)
    return np.array([
        [1.0 - outer[2, 2] - outer[3, 3], outer[1, 2] - outer[3, 0],
         outer[1, 3] + outer[2, 0], 0.0],
        [outer[1, 2] + outer[3, 0], 1.0 - outer[1, 1] - outer[3, 3],
         outer[2, 3] - outer[1, 0], 0.0],
        [outer[1, 3] - outer[2, 0], outer[2, 3] + outer[1, 0],
         1.0 - outer[1, 1] - outer[2, 2], 0.0],
        [0.0, 0.0, 0.0, 1.0]])


def quaternion_from_matrix(R: np.ndarray) -> np.ndarray:
    """[w, x, y, z] quaternion from a rotation matrix (Shepperd's method,
    lib/transformations.py:1204-1260 equivalent)."""
    M = np.asarray(R, np.float64)[:3, :3]
    tr = np.trace(M)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        return np.array([0.25 * s, (M[2, 1] - M[1, 2]) / s,
                         (M[0, 2] - M[2, 0]) / s, (M[1, 0] - M[0, 1]) / s])
    i = int(np.argmax(np.diag(M)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(M[i, i] - M[j, j] - M[k, k] + 1.0, EPS)) * 2.0
    q = np.zeros(4)
    q[0] = (M[k, j] - M[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (M[j, i] + M[i, j]) / s
    q[1 + k] = (M[k, i] + M[i, k]) / s
    return q


def rot_diff_degree(R1: np.ndarray, R2: np.ndarray) -> float:
    """Angle between two rotations in degrees (lib/d3_utils.py:144-148)."""
    cos = (np.trace(R1 @ R2.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def axis_diff_degree(v1: np.ndarray, v2: np.ndarray) -> float:
    """Unsigned angle between two axes, folded to [0, 90] (d3_utils.py:137-142)."""
    v1, v2 = v1.reshape(-1), v2.reshape(-1)
    cos = np.dot(v1, v2) / max(np.linalg.norm(v1) * np.linalg.norm(v2), EPS)
    d = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return min(d, 180.0 - d)


def dist_between_3d_lines(p1, e1, p2, e2) -> float:
    """Shortest distance between two 3D lines (d3_utils.py:165-174)."""
    p1, p2 = np.asarray(p1).reshape(-1), np.asarray(p2).reshape(-1)
    e1, e2 = np.asarray(e1).reshape(-1), np.asarray(e2).reshape(-1)
    orth = np.cross(e1, e2)
    n = np.linalg.norm(orth)
    if n < 1e-9:  # parallel lines: perpendicular distance
        d = p1 - p2
        e = e1 / max(np.linalg.norm(e1), EPS)
        return float(np.linalg.norm(d - np.dot(d, e) * e))
    return float(abs(np.dot(orth, p1 - p2)) / n)


def estimate_joint_from_correspondences(source_pts: np.ndarray,
                                        rotated_pts: np.ndarray):
    """Joint axis + a point on it from point correspondences across an
    articulation (lib/d3_utils.py:307-328 ``estimate_joint_HL``).

    Each displacement d_i = rotated_i − source_i of a point rotating
    about a fixed line is perpendicular to the axis, so the axis is the
    null direction of Σ d_i d_iᵀ (smallest eigenvector).  Each midpoint
    m_i = (source_i + rotated_i)/2 satisfies d_i·(m_i − c) = 0 for any
    axis point c, so c solves the least-squares system D c = D·m
    (rows d_iᵀ), decoupled from the axis estimate.  Vectorized; the
    reference loops per point and eig()s the non-symmetrized matrix.

    Returns (axis (3,) unit — sign arbitrary, position (3,) on the line).
    """
    source_pts = np.asarray(source_pts, dtype=np.float64)
    rotated_pts = np.asarray(rotated_pts, dtype=np.float64)
    delta = rotated_pts - source_pts                      # (n, 3)
    mid = 0.5 * (source_pts + rotated_pts)
    CC = delta.T @ delta                                  # Σ d dᵀ, symmetric
    w, v = np.linalg.eigh(CC)
    axis = v[:, 0] / max(np.linalg.norm(v[:, 0]), EPS)    # smallest eigval
    b = np.sum(delta * mid, axis=1)                       # d_i · m_i
    position = np.linalg.pinv(CC) @ (delta.T @ b)
    return axis, position
