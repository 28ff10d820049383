"""NAOCS-space helpers: counterpart of `articulated_pose_tpu/pose/naocs.py`.

- `part_scale_translation`: the per-part scale and translation between
  the global NAOCS and part NOCS, estimated from predictions (reference:
  evaluation/eval_joint_params.py:160-174, lib/aligning.py:343-432
  `compute_scale_translation`);
- `naocs_pred_view`: the prediction dict for the NAOCS baseline pose
  fit (reference: evaluation/baseline_naocs.py:73-158), the gocs head as
  the fit's source.

Both run in torch on whatever device their inputs are on.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def part_scale_translation(nocs: torch.Tensor, gocs: torch.Tensor,
                           w: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares (s, t) with gocs ≈ s·nocs + t over weighted points.

    nocs/gocs (N, 3), w (N,).  The relation is axis-isotropic by
    construction (both spaces are corner/diagonal normalizations of the
    same canonical frame), so a single scalar scale is exact.
    Returns (s (), t (3,)).
    """
    wsum = torch.clamp_min(w.sum(), 1e-9)
    mu_n = (nocs * w[:, None]).sum(0) / wsum
    mu_g = (gocs * w[:, None]).sum(0) / wsum
    cn = (nocs - mu_n) * w[:, None]
    cg = gocs - mu_g
    s = (cn * cg).sum() / torch.clamp_min((cn * (nocs - mu_n)).sum(), 1e-9)
    t = mu_g - s * mu_n
    return s, t


def naocs_pred_view(pred: Dict[str, torch.Tensor],
                    n_parts: int) -> Dict[str, torch.Tensor]:
    """Prediction dict for a NAOCS-space pose fit: the per-part source
    coordinates are the (shared) gocs head tiled into the per-part slice
    layout the pose fit expects."""
    out = dict(pred)
    g = pred["gocs_per_point"]
    if g.shape[-1] == 3 * n_parts:
        out["nocs_per_point"] = g
    else:
        out["nocs_per_point"] = g.repeat((1,) * (g.ndim - 1) + (n_parts,))
    return out
