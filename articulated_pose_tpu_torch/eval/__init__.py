"""Evaluation: NumPy copies of the JAX package's metrics and pipeline."""

from articulated_pose_tpu_torch.eval.metrics import (
    box_iou_3d,
    bbox_from_nocs_extent,
    get_3d_bbox,
    pose_errors,
    pts_inside_box,
)
from articulated_pose_tpu_torch.eval.pipeline import (
    EvalReport,
    compute_gt_poses,
    evaluate_fits,
    gt_joint_lines,
    joint_errors,
    pred_joint_lines,
    vote_joint_line,
)

__all__ = [
    "EvalReport",
    "bbox_from_nocs_extent",
    "box_iou_3d",
    "compute_gt_poses",
    "evaluate_fits",
    "get_3d_bbox",
    "gt_joint_lines",
    "joint_errors",
    "pose_errors",
    "pred_joint_lines",
    "pts_inside_box",
    "vote_joint_line",
]
