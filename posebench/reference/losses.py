"""Loss functions: the benchmark's frozen copy of the port's `losses.py`.

- `compute_miou_loss`: 1 − relaxed IoU of a soft assignment against the
  one-hot labels, for part segmentation and joint association;
- `compute_nocs_loss`: masked multi-head coordinate regression, L2 /
  Soft-L1 / L1, optionally self-supervised by a confidence;
- `compute_vect_loss`: heatmap / unit-vector / axis regression weighted
  by the joint-association mask;
- `compute_all_losses` and `collect_losses`: the loss dict and the
  weighted total with the reference multipliers (losses.py:134-186);

Every loss returns per-batch (B,) values, (B, K) for the mIoU loss.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

DIVISION_EPS = 1e-10


def smooth_l1_diff(diff: torch.Tensor, threshold: float = 0.1
                   ) -> torch.Tensor:
    """Soft-L1 on a (nonnegative) distance (losses.py:33-37)."""
    coef = 1.0 / (2.0 * threshold)
    lt = (diff < threshold).to(diff.dtype)
    return lt * coef * diff**2 + (1.0 - lt) * (diff - threshold / 2.0)


def _coord_diff(pred: torch.Tensor, gt: torch.Tensor, type_l: str
                ) -> torch.Tensor:
    """Pointwise coordinate error (B, N): L2 norm, Soft-L1 of it, or L1 sum."""
    if type_l == "L1":
        return torch.sum(torch.abs(pred - gt), dim=-1)
    d = torch.linalg.vector_norm(pred - gt, dim=-1)
    if type_l == "Soft_L1":
        return smooth_l1_diff(d)
    return d  # L2


def compute_nocs_loss(nocs: torch.Tensor, nocs_gt: torch.Tensor,
                      confidence: Optional[torch.Tensor] = None, *,
                      num_parts: int, mask_array: torch.Tensor,
                      type_l: str = "L2", multi_head: bool = True,
                      self_supervise: bool = False) -> torch.Tensor:
    """Masked multi-head NOCS regression (losses.py:50-78).

    nocs (B, N, 3K) per-part predictions; nocs_gt (B, N, 3);
    mask_array (B, N, K) one-hot part membership.  Returns (B,).
    """
    if not multi_head:
        d = _coord_diff(nocs, nocs_gt, type_l)
        if self_supervise:
            c = confidence[..., 0]
            return torch.mean(d * c - 0.1 * torch.log(c), dim=1)
        return torch.mean(d, dim=1)

    loss = 0.0
    for i in range(num_parts):
        pred_i = nocs[..., 3 * i:3 * (i + 1)]
        mask_i = mask_array[..., i]
        d = _coord_diff(pred_i, nocs_gt, type_l)
        if self_supervise:
            c = confidence[..., 0]
            loss = loss + torch.mean(mask_i * d * c, dim=1) \
                - 0.1 * torch.mean(torch.log(c), dim=1)
        else:
            loss = loss + torch.mean(mask_i * d, dim=1)
    return loss


def compute_vect_loss(vect: torch.Tensor, vect_gt: torch.Tensor, *,
                      confidence: Optional[torch.Tensor] = None,
                      type_l: str = "L2") -> torch.Tensor:
    """Per-point vector regression weighted by a confidence/mask (B, N)
    (losses.py:81-105).  Returns (B,)."""
    if vect.dim() == 3 and vect.shape[-1] == 1:
        vect = vect[..., 0]
    if vect.dim() == 2:  # scalar per point (heatmap)
        d_l2 = torch.abs(vect - vect_gt)
        d_l1 = d_l2
    else:
        d_l2 = torch.linalg.vector_norm(vect - vect_gt, dim=-1)
        d_l1 = torch.sum(torch.abs(vect - vect_gt), dim=-1)
    if confidence is not None:
        d_l2 = d_l2 * confidence
        d_l1 = d_l1 * confidence
    if type_l == "Soft_L1":
        return torch.mean(smooth_l1_diff(d_l2), dim=1)
    if type_l == "L1":
        return torch.mean(d_l1, dim=1)
    return torch.mean(d_l2, dim=1)


def compute_miou_loss(W: torch.Tensor, I_gt: torch.Tensor) -> torch.Tensor:
    """Relaxed-IoU segmentation loss (losses.py:108-119).

    W (B, N, K) soft assignment; I_gt (B, N) integer labels, -1 (or any
    label outside [0, K)) giving a zero one-hot row, as
    `jax.nn.one_hot` does.  Returns (B, K).
    """
    K = W.shape[-1]
    classes = torch.arange(K, device=W.device)
    W_gt = (I_gt[..., None] == classes).to(W.dtype)           # (B, N, K)
    dot = torch.sum(W_gt * W, dim=1)                           # (B, K)
    denom = torch.sum(W_gt, dim=1) + torch.sum(W, dim=1) - dot
    miou = dot / (denom + DIVISION_EPS)
    return 1.0 - miou


def compute_all_losses(pred: Dict[str, torch.Tensor],
                       gt: Dict[str, torch.Tensor], config
                       ) -> Dict[str, torch.Tensor]:
    """Wire predictions and labels into the loss dict (losses.py:134-167)."""
    K = config.n_max_parts
    type_l = config.coord_regress_loss
    loss_dict: Dict[str, torch.Tensor] = {}

    loss_dict["miou_loss"] = compute_miou_loss(pred["W"], gt["cls_per_point"])
    loss_dict["nocs_loss"] = compute_nocs_loss(
        pred["nocs_per_point"], gt["nocs_per_point"],
        pred.get("confi_per_point"), num_parts=K,
        mask_array=gt["mask_array_per_point"], type_l=type_l)

    if config.is_mixed:
        loss_dict["gocs_loss"] = compute_nocs_loss(
            pred["gocs_per_point"], gt["gocs_per_point"],
            pred.get("confi_per_point"), num_parts=K,
            mask_array=gt["mask_array_per_point"], type_l=type_l)

    if config.pred_joint:
        jmask = gt["joint_cls_mask"]
        loss_dict["heatmap_loss"] = compute_vect_loss(
            pred["heatmap_per_point"], gt["heatmap_per_point"],
            confidence=jmask, type_l=type_l)
        loss_dict["unitvec_loss"] = compute_vect_loss(
            pred["unitvec_per_point"], gt["unitvec_per_point"],
            confidence=jmask, type_l=type_l)
        loss_dict["orient_loss"] = compute_vect_loss(
            pred["joint_axis_per_point"], gt["orient_per_point"],
            confidence=jmask, type_l=type_l)
        loss_dict["index_loss"] = compute_miou_loss(
            pred["index_per_point"], gt["index_per_point"])

    return loss_dict


def collect_losses(loss_dict: Dict[str, torch.Tensor], config):
    """Weighted total and the `total_*` scalar summaries
    (losses.py:170-186): (total, {name: 0-d tensor})."""
    totals = {f"total_{k}": torch.mean(v) for k, v in loss_dict.items()}
    total = (config.nocs_loss_multiplier * totals["total_nocs_loss"]
             + config.miou_loss_multiplier * totals["total_miou_loss"])
    if config.is_mixed:
        total = total + config.gocs_loss_multiplier * totals["total_gocs_loss"]
    if config.pred_joint:
        if config.is_mixed:
            total = total + (config.offset_loss_multiplier
                             * totals["total_heatmap_loss"])
            total = total + (config.offset_loss_multiplier
                             * totals["total_unitvec_loss"])
        total = total + config.orient_loss_multiplier * totals["total_orient_loss"]
        if config.pred_joint_ind:
            total = total + (config.index_loss_multiplier
                             * totals["total_index_loss"])
    total = total * config.total_loss_multiplier
    totals["total_loss"] = total
    return total, totals
