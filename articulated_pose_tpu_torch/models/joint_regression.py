"""Direct joint-parameter regression baseline: counterpart of
`articulated_pose_tpu/models/joint_regression.py`.

The reference baseline that regresses joint parameters globally instead
of voting per point (reference: lib/architecture.py:163-192
`get_direct_regression_model_baseline` over
pointnet_plusplus/architectures.py:97-122 `build_pointnet2_cls`):

- classification-style PointNet++ (SA ×2 + global SA → FC 512 → 256),
- per joint, three heads: axis (tanh), orthogonal offset direction
  (tanh), line distance (sigmoid) — the 7-dof 'orthogonal'
  parameterization of the GT joint_params (lib/dataset.py:499-506).

Module names follow the Flax tree (backbone.sa1.mlp.conv0.dense, ...,
fc3_<i>), so `convert.joint_regression_state_dict_from_flax` maps one
onto the other by name.  The two sampled SA stages group through
`pointnet2.sample_and_group`, so on the card they launch the
single-level FPS kernel (`fps`, which also takes npoint > N, picking
point 0 once every point is taken) and the exact ball query
(`ball_query_group`); on the CPU their plain versions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from articulated_pose_tpu_torch.models.layers import (PointConv, dropout,
                                                     init_weights)
from articulated_pose_tpu_torch.models.pointnet2 import (
    SetAbstraction, sample_and_group, sample_and_group_all)

# (npoint, radius, nsample, mlp) of the two sampled SA stages, the
# global stage's mlp and the FC widths (joint_regression.py:37-54)
SA_STAGES = ((512, 0.2, 32, (64, 64, 128)), (128, 0.4, 64, (128, 128, 256)))
GLOBAL_MLP = (256, 512, 1024)
FC_WIDTHS = (512, 256)


class PointNet2Cls(nn.Module):
    """Classification backbone (joint_regression.py:29-57): (B, N, 3+)
    clouds -> (B, 256) features.  In training mode batch norm takes
    `bn_momentum` and the two dropouts (after fc1 and fc2) draw from
    `generator`."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        width = 0
        for i, (_, _, _, mlp) in enumerate(SA_STAGES):
            sa = SetAbstraction(3 + width, mlp, dtype)
            self.add_module(f"sa{i + 1}", sa)
            width = sa.out_features
        self.sa3 = SetAbstraction(3 + width, GLOBAL_MLP, dtype)
        width = self.sa3.out_features
        for i, w in enumerate(FC_WIDTHS):
            self.add_module(f"fc{i + 1}", PointConv(width, w, dtype=dtype))
            width = w
        self.out_features = width

    def forward(self, P: torch.Tensor, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xyz = P[..., :3].float().contiguous()
        pts = None
        for i, (npoint, radius, nsample, _) in enumerate(SA_STAGES):
            sa = getattr(self, f"sa{i + 1}")
            xyz, grouped = sample_and_group(npoint, radius, nsample, xyz, pts,
                                            sa.dtype)
            pts = sa(grouped, bn_momentum)
        # group-all: [xyz, features] of every point as one neighbourhood
        # (pointnet2.py:66-77)
        _, glob = sample_and_group_all(xyz, pts, dtype=self.sa3.dtype)
        net = self.sa3(glob, bn_momentum).reshape(P.shape[0], -1)  # (B, 1024)
        for i in range(len(FC_WIDTHS)):
            net = dropout(getattr(self, f"fc{i + 1}")(net, bn_momentum),
                          self.dropout_rate, self.training, generator)
        return net


class DirectJointRegression(nn.Module):
    """Per-joint global regression of (axis, orth dir, distance)
    (joint_regression.py:60-83): {"joint_params": [(axis (B, 3),
    orth (B, 3), dist (B, 1)), ...]}, one tuple a joint, f32."""

    def __init__(self, n_max_parts: int = 3, line_space: str = "orthogonal",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if line_space not in ("orthogonal", "plucker"):
            raise ValueError(f"unknown line_space {line_space!r}")
        self.n_max_parts = n_max_parts
        self.line_space = line_space
        self.backbone = PointNet2Cls(dtype=dtype)
        width = self.backbone.out_features
        dims = (3, 3, 1) if line_space == "orthogonal" else (3, 3)
        for j in range(n_max_parts - 1):
            for h, d in enumerate(dims):
                self.add_module(f"fc3_{3 * j + h}",
                                PointConv(width, d, use_bn=False, relu=False,
                                          dtype=dtype))

    def forward(self, P: torch.Tensor, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, List[Tuple[torch.Tensor, ...]]]:
        net = self.backbone(P, bn_momentum, generator)

        def head(i):
            return getattr(self, f"fc3_{i}")(net).float()

        joint_params = []
        for j in range(self.n_max_parts - 1):
            axis = torch.tanh(head(3 * j))
            orth = torch.tanh(head(3 * j + 1))
            if self.line_space == "orthogonal":
                joint_params.append((axis, orth,
                                     torch.sigmoid(head(3 * j + 2))))
            else:
                joint_params.append((axis, orth))
        return {"joint_params": joint_params}


def build_joint_regression(n_max_parts: int,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> DirectJointRegression:
    """The model with the reference's initialisation drawn from
    `generator`, in eval mode."""
    model = init_weights(DirectJointRegression(n_max_parts=n_max_parts),
                         generator)
    return model.to(device).eval()


def direct_joint_loss(pred: Dict, joint_params_gt: torch.Tensor,
                      line_space: str = "orthogonal"
                      ) -> Dict[str, torch.Tensor]:
    """Residual loss vs the 7-dof GT, per sample (joint_regression.py:86-101;
    lib/loss.py:203-229).  joint_params_gt: (B, K, 7) with joint j stored
    at row j+1."""
    axis_l, orth_l, dist_l = [], [], []
    for j, jp in enumerate(pred["joint_params"]):
        gt = joint_params_gt[:, j + 1]
        axis_l.append(torch.linalg.vector_norm(jp[0] - gt[:, 0:3], dim=1))
        orth_l.append(torch.linalg.vector_norm(jp[1] - gt[:, 3:6], dim=1))
        if line_space == "orthogonal":
            dist_l.append((jp[2][:, 0] - gt[:, 6]).abs())
    out = {"axis_loss": torch.stack(axis_l, 1).mean(1),
           "orth_loss": torch.stack(orth_l, 1).mean(1)}
    if dist_l:
        out["dist_loss"] = torch.stack(dist_l, 1).mean(1)
    return out
