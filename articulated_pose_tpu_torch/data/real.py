"""Real-depth-data support (BMVC15-style): a NumPy copy of
`articulated_pose_tpu/data/real.py`.

The reference's real-data path (reference: lib/dataset.py BMVC15
branches, lib/prediction_io.py:97-129 `save_batch_nn` real variant)
differs from synthetic data in that no canonical mesh normalization
exists: each input cloud is normalized per sample by its own centroid
and bounding-box diagonal, and (P_center, P_scale) are carried through
so fitted poses can be mapped back to metric camera space.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def normalize_cloud(P: np.ndarray):
    """Per-sample normalization: center on centroid, scale by 1/diagonal.

    Returns (P_norm, center (3,), scale ()).  Inverse:
    P = P_norm * scale + center.
    """
    center = P.mean(axis=0)
    extent = P.max(axis=0) - P.min(axis=0)
    scale = max(float(np.linalg.norm(extent)), 1e-9)
    return (P - center) / scale, center, scale


def denormalize_pose(R: np.ndarray, s: float, t: np.ndarray,
                     center: np.ndarray, scale: float):
    """Map a pose fitted in the normalized frame back to camera space.

    If P_norm = (P - c)/σ and P_norm ≈ s·R·nocs + t, then
    P ≈ (σ·s)·R·nocs + (σ·t + c).
    """
    return R, float(scale * s), scale * np.asarray(t) + np.asarray(center)


def build_real_sample(P: np.ndarray, cls: np.ndarray,
                      nocs_gt: Optional[np.ndarray] = None, *,
                      num_points: int = 1024, n_max_parts: int = 3,
                      rng: Optional[np.random.RandomState] = None
                      ) -> Dict[str, np.ndarray]:
    """Assemble a training/eval sample from a raw labeled depth cloud.

    P (N, 3) camera-space points, cls (N,) part labels, optional per-point
    NOCS labels.  Tiling/subsampling and mask construction mirror the
    synthetic path; adds sample_index/P_center/P_scale (the real-data
    extras of prediction_io.py:97-129).
    """
    rng = rng or np.random.RandomState(0)
    n_total = P.shape[0]
    if n_total < num_points:
        tile = num_points // n_total + 1
        P = np.concatenate([P] * tile, 0)
        cls = np.concatenate([cls] * tile, 0)
        if nocs_gt is not None:
            nocs_gt = np.concatenate([nocs_gt] * tile, 0)
        n_total = P.shape[0]
    sel = rng.permutation(n_total)[:num_points]
    P = np.asarray(P, np.float64)[sel]
    cls = np.asarray(cls)[sel]
    P_norm, center, scale = normalize_cloud(P)

    mask = np.zeros((num_points, n_max_parts), np.float32)
    mask[np.arange(num_points), cls.astype(np.int32)] = 1.0
    out = {
        "P": P_norm.astype(np.float32),
        "cls_gt": cls.astype(np.float32),
        "mask_array": mask,
        "P_center": center.astype(np.float32),
        "P_scale": np.float32(scale),
        "sample_index": sel.astype(np.int32),
    }
    if nocs_gt is not None:
        out["nocs_gt"] = np.asarray(nocs_gt, np.float32)[
            sel if nocs_gt.shape[0] == n_total else slice(None)]
    return out
