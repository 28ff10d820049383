"""Train-time input jitter: the part of `articulated_pose_tpu/data/augment.py`
that the training feed applies (`train_data_add_noise`), as NumPy.

Gaussian per-point jitter (the reference's provider.py:99-112), drawn
from an explicit RandomState so that a seed fixes it.
"""

from __future__ import annotations

import numpy as np


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
