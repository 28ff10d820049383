"""Noisy-oracle predictions and the pose scorer of
`scripts/ab_ransac_strength.py`.

The predictions are the ground truth's labels with noise calibrated to a
trained model's errors: NOCS jitter, segmentation flips and joint-axis
jitter (ab_ransac_strength.py:55-75).  Everything is NumPy drawn from one
RandomState in the JAX script's order, so the frames and the predictions
are bit-equal to the JAX script's, and a fit of the two packages reads
on identical inputs.  The scorer (:79-97) compares each part's fitted
similarity with the frame's ground truth.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from articulated_pose_tpu_torch.data.synthetic import (FrameGT,
                                                       SyntheticArticulated)
from articulated_pose_tpu_torch.e2e import PRED_KEYS
from articulated_pose_tpu_torch.utils import transforms as tr

K = 3
JOINT_TYPES = ("revolute", "revolute")
AXIS_NOISE = 0.05


def make_frames(n_frames: int, num_points: int, rng: np.random.RandomState
                ) -> Tuple[List[Dict[str, np.ndarray]], List[FrameGT]]:
    """The script's frames (ab_ransac_strength.py:45-53): a three-part,
    two-revolute generator seeded 3, `n_frames` frames drawn from `rng`."""
    gen = SyntheticArticulated(n_parts=K, points_per_part=400,
                               joint_types=JOINT_TYPES, seed=3)
    frames, gts = [], []
    for _ in range(n_frames):
        s, g = gen.frame(rng, num_points=num_points, n_max_parts=K)
        frames.append(s)
        gts.append(g)
    return frames, gts


def noisy_oracle(frames: Sequence[Dict[str, np.ndarray]],
                 rng: np.random.RandomState, n_parts: int, nocs_noise: float,
                 seg_flip: float) -> Dict[str, np.ndarray]:
    """Predictions (B, N, ...) float32 from each frame's labels
    (ab_ransac_strength.py:55-75): a share `seg_flip` of the points gets
    a uniformly drawn label, each point's NOCS sits in its (noisy) part's
    slot plus N(0, nocs_noise²) per component, the joint axis is the GT
    orientation plus N(0, 0.05²), and the joint association is exact."""
    Kp = n_parts
    preds = {k: [] for k in PRED_KEYS}
    for s in frames:
        N = s["P"].shape[0]
        cls = s["cls_gt"].astype(int)
        flip = rng.rand(N) < seg_flip
        cls_noisy = np.where(flip, rng.randint(0, Kp, N), cls)
        W = np.eye(Kp, dtype=np.float32)[cls_noisy]
        nocs = np.zeros((N, 3 * Kp), np.float32)
        for j in range(Kp):
            sel = cls_noisy == j
            nocs[sel, 3 * j:3 * (j + 1)] = (
                s["nocs_gt"][sel] + nocs_noise * rng.randn(sel.sum(), 3))
        axis = (s["orient_gt"] + AXIS_NOISE * rng.randn(N, 3)).astype(
            np.float32)
        index = np.eye(Kp, dtype=np.float32)[
            s["joint_cls_gt"].astype(int) % Kp]
        preds["W"].append(W)
        preds["nocs_per_point"].append(nocs.astype(np.float32))
        preds["joint_axis_per_point"].append(axis)
        preds["index_per_point"].append(index)
    return {k: np.stack(v) for k, v in preds.items()}


def score(out: Dict[str, np.ndarray], gts: Sequence[FrameGT],
          n_parts: int) -> Dict[str, float]:
    """Rotation error (mean and median, degrees), translation error
    (mean) and the 5°5cm share over every part of every frame whose
    fitted rotation is finite (ab_ransac_strength.py:79-93)."""
    rots, trans, acc = [], [], []
    for i, g in enumerate(gts):
        for j in range(n_parts):
            _, R_, t_ = tr.decompose_similarity(g.rt_nocs2cam[j])
            Rp = out["nonlinear_R"][i, j]
            tp = out["nonlinear_t"][i, j]
            if not np.all(np.isfinite(Rp)):
                continue
            r = tr.rot_diff_degree(Rp, R_)
            d = float(np.linalg.norm(tp - t_))
            rots.append(r)
            trans.append(d)
            acc.append(float(r < 5 and d < 0.05))
    return {"rot_mean": float(np.mean(rots)),
            "rot_median": float(np.median(rots)),
            "trans_mean": float(np.mean(trans)),
            "acc_5deg5cm": float(np.mean(acc)), "n_parts": len(rots)}


def row(tag: str, s: Dict[str, float]) -> str:
    """The JAX script's table row (ab_ransac_strength.py:94-96)."""
    return (f"{tag:<44s} rot {s['rot_mean']:6.2f}°  med "
            f"{s['rot_median']:5.2f}°  trans {s['trans_mean']:7.4f}  5°5cm "
            f"{s['acc_5deg5cm']:.3f}")
