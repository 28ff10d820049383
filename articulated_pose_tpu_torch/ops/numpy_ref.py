"""NumPy reference implementations (oracles) of the point-cloud ops: a
copy of `articulated_pose_tpu/ops/numpy_ref.py`, the float64 oracle the
port's `utils/ref_forward.py` is built on, independent of both the
kernels and their plain PyTorch versions.

These reproduce, op-for-op, the semantics of the reference's custom
CUDA/C++ TF ops (reference: pointnet_plusplus/utils/tf_ops/) and exist
purely as test oracles:

- farthest_point_sample: tf_ops/sampling/tf_sampling_g.cu:105-170
  (first pick is index 0, squared-distance metric, running min-distance).
- query_ball_point:      tf_ops/grouping/tf_grouping_g.cu:3-36
  (FIRST nsample points with euclidean distance < radius, in index
  order; all slots pre-filled with the first hit; cnt reported).
- group_point:           tf_ops/grouping/tf_grouping_g.cu:40-58 (gather).
- three_nn:              tf_ops/3d_interpolation/tf_interpolate.cpp:60-102
  (3 nearest neighbors, returns SQUARED distances, ascending).
- three_interpolate:     tf_interpolate.cpp:105-127 (weighted 3-gather).

Deliberately simple and loop-free-ish; not performance code.
"""

from __future__ import annotations

import numpy as np


def farthest_point_sample(npoint: int, xyz: np.ndarray) -> np.ndarray:
    """xyz: (B, N, 3) -> (B, npoint) int32 indices."""
    B, N, _ = xyz.shape
    idxs = np.zeros((B, npoint), dtype=np.int32)
    for b in range(B):
        mindist = np.full((N,), 1e38, dtype=np.float64)
        old = 0
        idxs[b, 0] = 0
        for j in range(1, npoint):
            d = np.sum((xyz[b] - xyz[b, old]) ** 2, axis=-1)
            mindist = np.minimum(mindist, d)
            old = int(np.argmax(mindist))
            idxs[b, j] = old
    return idxs


def gather_point(xyz: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """xyz: (B, N, C), idx: (B, M) -> (B, M, C)."""
    B = xyz.shape[0]
    return np.stack([xyz[b, idx[b]] for b in range(B)], axis=0)


def query_ball_point(radius: float, nsample: int, xyz: np.ndarray, new_xyz: np.ndarray):
    """xyz: (B, N, 3) points, new_xyz: (B, M, 3) queries.

    Returns (idx (B, M, nsample) int32, cnt (B, M) int32).
    """
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    idx = np.zeros((B, M, nsample), dtype=np.int32)
    cnt = np.zeros((B, M), dtype=np.int32)
    for b in range(B):
        for j in range(M):
            c = 0
            for k in range(N):
                if c == nsample:
                    break
                d = max(float(np.linalg.norm(xyz[b, k] - new_xyz[b, j])), 1e-20)
                if d < radius:
                    if c == 0:
                        idx[b, j, :] = k
                    idx[b, j, c] = k
                    c += 1
            cnt[b, j] = c
    return idx, cnt


def group_point(points: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """points: (B, N, C), idx: (B, M, S) -> (B, M, S, C)."""
    B = points.shape[0]
    return np.stack([points[b][idx[b]] for b in range(B)], axis=0)


def three_nn(xyz1: np.ndarray, xyz2: np.ndarray):
    """For each point in xyz1 (B, N, 3), 3 nearest in xyz2 (B, M, 3).

    Returns (dist (B, N, 3) SQUARED distances ascending, idx (B, N, 3)).
    """
    B, N, _ = xyz1.shape
    d2 = np.sum((xyz1[:, :, None, :] - xyz2[:, None, :, :]) ** 2, axis=-1)  # (B,N,M)
    M = d2.shape[-1]
    if M < 3:
        # fewer than 3 candidates: the reference kernel leaves the spare
        # slots at (index 0, distance 1e40 — inf once cast to f32)
        # (tf_interpolate.cpp:66-67)
        pad = np.full(d2.shape[:2] + (3 - M,), np.inf, d2.dtype)
        d2 = np.concatenate([d2, pad], axis=-1)
        order = np.argsort(d2, axis=-1, kind="stable")[:, :, :3]
        dist = np.take_along_axis(d2, order, axis=-1)
        idx = np.where(order < M, order, 0)
        return dist.astype(np.float32), idx.astype(np.int32)
    order = np.argsort(d2, axis=-1, kind="stable")[:, :, :3]
    dist = np.take_along_axis(d2, order, axis=-1)
    return dist.astype(np.float32), order.astype(np.int32)


def three_interpolate(points: np.ndarray, idx: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """points: (B, M, C), idx/weight: (B, N, 3) -> (B, N, C)."""
    B, N, _ = idx.shape
    out = np.zeros((B, N, points.shape[2]), dtype=points.dtype)
    for b in range(B):
        for k in range(3):
            out[b] += weight[b, :, k : k + 1] * points[b, idx[b, :, k]]
    return out


def prob_sample(inp: np.ndarray, inp_r: np.ndarray) -> np.ndarray:
    """Area-weighted categorical sampling (tf_sampling_g.cu:7-104).

    inp: (B, N) unnormalized weights; inp_r: (B, M) uniforms in [0,1).
    Returns (B, M) int32 sampled indices via inverse-CDF binary search.
    """
    cdf = np.cumsum(inp, axis=1)
    cdf = cdf / cdf[:, -1:]
    out = np.zeros(inp_r.shape, dtype=np.int32)
    for b in range(inp.shape[0]):
        out[b] = np.searchsorted(cdf[b], inp_r[b], side="right")
    return np.minimum(out, inp.shape[1] - 1).astype(np.int32)
