"""The ANCSH network in plain float32 PyTorch: the benchmark's frozen
reference of the port's `models/layers.py`, `models/pointnet2.py` and
`models/ancsh.py` at the configurations the benchmark runs (a two-level
PointNet++ pyramid, no input features, the exact or the packed ball
query).  Parameter and buffer names are the port's, so one state dict
loads into both.

Every layer computes in float32 and emits float32.  `matmul="bf16"`
rounds as a bf16 trunk does: each pointwise layer's product from bf16
inputs and weights, and its output (after batch norm) rounded to bf16;
the judge reads from it the rounding scale of the configuration's
precision.  `matmul="fp8"` computes each product from float8 (e4m3)
inputs and weights, each scaled to the format's range by its largest
magnitude: the control of a bf16 configuration.  In training mode batch norm uses
the batch's statistics and moves its running ones, and dropout draws
its masks from the generator it is given, in the port's order.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from posebench.reference import ops

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 at a per-tensor scale, back in float32."""
    scale = FP8_MAX / torch.clamp_min(x.abs().amax(), 1e-12)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """where(keep, x / (1 - rate), 0), keep = rand < 1 - rate."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


class BatchNorm(nn.Module):
    """Batch norm over the last axis, eps 1e-3; in training the biased
    batch variance, and ra = m·ra + (1 − m)·batch."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum) -> torch.Tensor:
        if self.training:
            var, mean = torch.var_mean(x, dim=tuple(range(x.dim() - 1)),
                                       correction=0)
            with torch.no_grad():
                self.running_mean.copy_(momentum * self.running_mean
                                        + (1.0 - momentum) * mean)
                self.running_var.copy_(momentum * self.running_var
                                       + (1.0 - momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class PointConv(nn.Module):
    """Pointwise Linear (+ batch norm) (+ ReLU)."""

    def __init__(self, cin: int, cout: int, matmul: str, use_bn: bool = True,
                 relu: bool = True):
        super().__init__()
        self.matmul = matmul
        self.relu = relu
        self.dense = nn.Linear(cin, cout)
        self.bn = BatchNorm(cout) if use_bn else None

    def forward(self, x: torch.Tensor, momentum=0.9) -> torch.Tensor:
        w, b = self.dense.weight, self.dense.bias
        if self.matmul == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        elif self.matmul == "bf16":
            x, w, b = (v.bfloat16() for v in (x, w, b))
        y = F.linear(x, w, b).float()
        if self.bn is not None:
            y = self.bn(y, momentum)
        if self.matmul == "bf16":
            y = y.bfloat16().float()
        return F.relu(y) if self.relu else y


class SharedMLP(nn.Module):
    def __init__(self, cin: int, channels: Sequence[int], matmul: str):
        super().__init__()
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", PointConv(cin, ch, matmul))
            cin = ch
        self.out_features = cin

    def forward(self, x, momentum=0.9):
        for layer in self.children():
            x = layer(x, momentum)
        return x


class SetAbstraction(nn.Module):
    """Shared MLP over each neighbourhood, max pool over its points."""

    def __init__(self, cin: int, mlp, matmul: str):
        super().__init__()
        self.mlp = SharedMLP(cin, mlp, matmul)
        self.out_features = self.mlp.out_features

    def forward(self, grouped, momentum=0.9):
        return self.mlp(grouped, momentum).amax(dim=2)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation, skip concat, shared MLP."""

    def __init__(self, cin: int, mlp, matmul: str):
        super().__init__()
        self.mlp = SharedMLP(cin, mlp, matmul)
        self.out_features = self.mlp.out_features

    def forward(self, xyz1, xyz2, skip, feats, momentum=0.9):
        if xyz2.shape[1] == 1:
            interp = feats.expand(-1, xyz1.shape[1], -1)
        else:
            dist, idx = ops.three_nn(xyz1, xyz2)
            interp = ops.three_interpolate(feats, idx,
                                           ops.interp_weights(dist))
        return self.mlp(torch.cat([interp, skip], dim=-1), momentum)


class Backbone(nn.Module):
    """(B, N, 3) -> (B, N, head_width), a two-level pyramid."""

    def __init__(self, widths: Dict, packed: bool, dropout_rate: float,
                 matmul: str):
        super().__init__()
        self.w = widths
        self.packed = packed
        self.dropout_rate = dropout_rate
        feats = [0]
        for i, mlp in enumerate(widths["sa_mlps"]):
            sa = SetAbstraction(3 + feats[-1], mlp, matmul)
            self.add_module(f"sa{i + 1}", sa)
            feats.append(sa.out_features)
        self.sa_global = SetAbstraction(3 + feats[-1], widths["global_mlp"],
                                        matmul)
        width = self.sa_global.out_features
        for i, (mlp, skip) in enumerate(zip(widths["fp_mlps"],
                                            feats[:0:-1] + [3])):
            fp = FeaturePropagation(width + skip, mlp, matmul)
            self.add_module(f"fp{i + 1}", fp)
            width = fp.out_features
        self.fc1 = PointConv(width, widths["head_width"], matmul)

    def forward(self, X, momentum=0.9, generator=None):
        w = self.w
        xyz0 = X.float().contiguous()
        _, x1, _, x2 = ops.fps2(xyz0, *w["sa_npoints"])
        l_xyz, l_pts = [xyz0], [None]
        for i, new_xyz in enumerate((x1, x2)):
            grouped, idx = ops.ball_query_group(
                w["sa_radii"][i], w["sa_nsamples"][i], l_xyz[-1], new_xyz,
                self.packed)
            if l_pts[-1] is not None:
                grouped = torch.cat([grouped,
                                     ops.group_point(l_pts[-1], idx)], -1)
            l_pts.append(getattr(self, f"sa{i + 1}")(grouped, momentum))
            l_xyz.append(new_xyz)
        glob = torch.cat([l_xyz[-1], l_pts[-1]], -1)[:, None]
        l_pts.append(self.sa_global(glob, momentum))
        l_xyz.append(torch.zeros((X.shape[0], 1, 3), device=X.device))
        feats = l_pts[-1]
        for i in range(len(w["fp_mlps"])):
            lvl = len(l_xyz) - 2 - i
            skip = l_xyz[0] if lvl == 0 else l_pts[lvl]
            feats = getattr(self, f"fp{i + 1}")(l_xyz[lvl], l_xyz[lvl + 1],
                                                skip, feats, momentum)
        return dropout(self.fc1(feats, momentum), self.dropout_rate,
                       self.training, generator)


def _head(cin: int, cout: int, matmul: str) -> PointConv:
    return PointConv(cin, cout, matmul, use_bn=False, relu=False)


class JointHead(nn.Module):
    """The joint head; its dropout rate is 0.5 whatever the config says."""

    def __init__(self, cin: int, K: int, matmul: str):
        super().__init__()
        self.fc3_0 = PointConv(cin, 128, matmul)
        self.fc3_1 = PointConv(128, 128, matmul)
        self.fc4_0 = _head(128, 3, matmul)
        self.fc4_1 = _head(128, 3, matmul)
        self.fc4_2 = _head(128, 1, matmul)
        self.fc4_3 = _head(128, K, matmul)

    def forward(self, x, momentum, generator):
        for fc in (self.fc3_0, self.fc3_1):
            x = dropout(fc(x, momentum), 0.5, self.training, generator)
        return (torch.tanh(self.fc4_0(x)), torch.tanh(self.fc4_1(x)),
                torch.sigmoid(self.fc4_2(x)),
                torch.softmax(self.fc4_3(x), dim=-1))


class ANCSH(nn.Module):
    """ANCSH's heads (part + global NOCS, joints) over the backbone."""

    def __init__(self, K: int, widths: Dict, packed: bool = False,
                 dropout_rate: float = 0.5, matmul: str = "f32"):
        super().__init__()
        self.K = K
        self.backbone = Backbone(widths, packed, dropout_rate, matmul)
        hw = widths["head_width"]
        for i, d in enumerate([K, 3 * K, K, 3 * K, 1]):
            cin = hw
            if i == 1:
                self.add_module("fc11_1", _head(hw, 128, matmul))
                cin = 128
            self.add_module(f"fc2_{i}", _head(cin, d, matmul))
        self.joint_net = JointHead(hw, K, matmul)

    def forward(self, P, *, bn_momentum=0.9, generator=None
                ) -> Dict[str, torch.Tensor]:
        feat = self.backbone(P, bn_momentum, generator)
        out = []
        for i in range(5):
            x = self.fc11_1(feat) if i == 1 else feat
            out.append(getattr(self, f"fc2_{i}")(x))
        w_logits, nocs_logits, scale_logits, trans_logits, confi_logits = out
        nocs = torch.sigmoid(nocs_logits)
        axis, unitvec, heatmap, joint_cls = self.joint_net(feat, bn_momentum,
                                                           generator)
        scale = torch.sigmoid(scale_logits)
        trans = torch.tanh(trans_logits)
        return {"W": torch.softmax(w_logits, dim=-1),
                "nocs_per_point": nocs,
                "confi_per_point": torch.sigmoid(confi_logits),
                "joint_axis_per_point": axis,
                "unitvec_per_point": unitvec,
                "heatmap_per_point": heatmap,
                "index_per_point": joint_cls,
                "gocs_per_point": nocs * scale.repeat_interleave(3, dim=-1)
                + trans,
                "global_scale": scale,
                "global_translation": trans}
