"""Point-cloud augmentations: a NumPy copy of
`articulated_pose_tpu/data/augment.py` (the reference's provider.py
augmentation set, provider.py:32-215).

Rotation about the up axis, small random rotations, Gaussian jitter,
global shift and scale, random point dropout.  Each draws from an
explicit RandomState in the JAX package's order, so a seed gives the
JAX package's arrays bit for bit.  The training feed applies only the
jitter (`train_noise_batch`).
"""

from __future__ import annotations

import numpy as np

from articulated_pose_tpu_torch.utils import transforms as tr


def rotate_point_cloud_y(pts: np.ndarray, rng: np.random.RandomState,
                         angle: float = None) -> np.ndarray:
    """Rotate (N, 3) points about the y (up) axis (augment.py:17-22)."""
    a = rng.uniform(0, 2 * np.pi) if angle is None else angle
    R = tr.axis_angle_matrix(np.array([0.0, 1.0, 0.0]), a)
    return pts @ R.T


def rotate_perturbation(pts: np.ndarray, rng: np.random.RandomState,
                        angle_sigma: float = 0.06,
                        angle_clip: float = 0.18) -> np.ndarray:
    """Small random rotation about all axes (augment.py:25-33)."""
    angles = np.clip(angle_sigma * rng.randn(3), -angle_clip, angle_clip)
    R = (tr.axis_angle_matrix(np.array([1.0, 0, 0]), angles[0])
         @ tr.axis_angle_matrix(np.array([0.0, 1, 0]), angles[1])
         @ tr.axis_angle_matrix(np.array([0.0, 0, 1]), angles[2]))
    return pts @ R.T


def jitter_point_cloud(pts: np.ndarray, rng: np.random.RandomState,
                       sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    """Gaussian per-point jitter (augment.py:36-39)."""
    return pts + np.clip(sigma * rng.randn(*pts.shape), -clip, clip)


def train_noise_batch(batch, rng: np.random.RandomState):
    """Train-time input jitter as a batch transform (augment.py:42-52):
    the iterators apply it after their epoch cache, so every
    presentation draws fresh noise.  Only the network input P is
    perturbed; labels stay exact."""
    out = dict(batch)
    out["P"] = jitter_point_cloud(batch["P"], rng).astype(np.float32)
    return out


def shift_point_cloud(pts: np.ndarray, rng: np.random.RandomState,
                      shift_range: float = 0.1) -> np.ndarray:
    """Global shift (augment.py:54-57)."""
    return pts + rng.uniform(-shift_range, shift_range, (1, 3))


def random_scale_point_cloud(pts: np.ndarray, rng: np.random.RandomState,
                             scale_low: float = 0.8,
                             scale_high: float = 1.25) -> np.ndarray:
    """Global scale (augment.py:60-64)."""
    return pts * rng.uniform(scale_low, scale_high)


def random_point_dropout(pts: np.ndarray, rng: np.random.RandomState,
                         max_dropout_ratio: float = 0.875) -> np.ndarray:
    """Replace a random fraction of the points with the first point
    (augment.py:67-75); shapes stay fixed."""
    ratio = rng.rand() * max_dropout_ratio
    drop = rng.rand(len(pts)) <= ratio
    out = pts.copy()
    out[drop] = pts[0]
    return out
