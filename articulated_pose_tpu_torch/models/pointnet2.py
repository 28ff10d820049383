"""PointNet++ backbone: counterpart of `articulated_pose_tpu/models/pointnet2.py`.

The grouping ops are the kernel wrappers of `ops/kernels/`, which choose
by device: the plain PyTorch version for a CPU tensor, the CUDA kernel
for a CUDA tensor.  Of the reference's per-stage `*_impl` strings the
ball query's is carried over, because its tiers compute different
functions (pointnet2.py:72-113):

- "xla" and "pallas" are the exact first-S-in-radius ball query; both
  run `ball_query_group` (K2), since they compute the same function;
- "pallas" with `ball_query_packed` takes the packed tier,
  `ball_query_group_packed`: the same hits, coordinates quantised to 10
  bits per component over the cloud's bounding box.  As in JAX, the
  "xla" route ignores `ball_query_packed`;
- "stream", the large-cloud tier, returns indices only
  (`ball_query_idx`), and the centred coordinates are gathered after;
- "bucket" and "bucket_xla" (B8, a bucket-sampled ball query) are not
  ported yet and raise.

FPS and 3-NN have one function whatever the reference's `fps_impl` or
`three_nn_impl` says, so those strings are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.ball_query import (
    ball_query_group, ball_query_group_packed, ball_query_idx)
from articulated_pose_tpu_torch.ops.kernels.fps import fps2
from articulated_pose_tpu_torch.ops.kernels.three_nn import three_nn
from articulated_pose_tpu_torch.models.layers import PointConv, SharedMLP


BALL_QUERY_IMPLS = ("xla", "pallas", "stream")


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    """Stage widths; defaults are the reference widths (architectures.py:62-93)."""

    sa_npoints: Tuple[int, ...] = (512, 128)
    sa_radii: Tuple[float, ...] = (0.2, 0.4)
    sa_nsamples: Tuple[int, ...] = (64, 64)
    sa_mlps: Tuple[Tuple[int, ...], ...] = ((64, 64, 128), (128, 128, 256))
    global_mlp: Tuple[int, ...] = (256, 512, 1024)
    fp_mlps: Tuple[Tuple[int, ...], ...] = ((256, 256), (256, 128),
                                            (128, 128, 128))
    head_width: int = 128
    dropout_rate: float = 0.5
    ball_query_impl: str = "xla"  # 'xla' | 'pallas' | 'stream'
    # with ball_query_impl="pallas": the 10-bit-quantised coordinate tier
    ball_query_packed: bool = False

    def __post_init__(self):
        if len(self.sa_npoints) != 2 or len(self.fp_mlps) != 3:
            # the port runs the fused two-level FPS kernel only; the
            # single-level kernel is still to be ported
            raise NotImplementedError(
                "the port supports the two-level SA pyramid (two SA stages, "
                "three FP stages) only")
        if self.ball_query_impl in ("bucket", "bucket_xla"):
            raise NotImplementedError(
                f"ball_query_impl={self.ball_query_impl!r}: the bucket "
                "ball query (B8, ball_query_bucket.py) is not ported yet")
        if self.ball_query_impl not in BALL_QUERY_IMPLS:
            raise ValueError(f"unknown ball_query_impl "
                             f"{self.ball_query_impl!r}")


# trimmed widths, same topology: CLI smokes and CPU tests (ancsh.py:164-168)
TINY_WIDTHS = dict(sa_npoints=(64, 32), sa_nsamples=(16, 16),
                   sa_mlps=((16, 16), (16, 32)), global_mlp=(32, 64),
                   fp_mlps=((32,), (32,), (16, 16)), head_width=16)


class SetAbstraction(nn.Module):
    """Shared MLP over each neighbourhood, then max pool over its S points.

    The neighbourhoods are built by the caller (`PointNet2Backbone`), so
    the module only holds weights: input (B, M, S, C) -> (B, M, C').
    """

    def __init__(self, in_features: int, mlp, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.mlp = SharedMLP(in_features, mlp, dtype=dtype)
        self.out_features = self.mlp.out_features

    def forward(self, grouped: torch.Tensor) -> torch.Tensor:
        return self.mlp(grouped).amax(dim=2).to(self.dtype)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation, skip concat, shared MLP."""

    def __init__(self, in_features: int, mlp, dtype: torch.dtype):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp, dtype=dtype)
        self.out_features = self.mlp.out_features

    def forward(self, xyz1, xyz2, points1: Optional[torch.Tensor],
                points2: torch.Tensor) -> torch.Tensor:
        if xyz2.shape[1] == 1:
            # a single global point: copy its feature everywhere
            interp = points2.expand(-1, xyz1.shape[1], -1)
        else:
            dist, idx = three_nn(xyz1, xyz2)
            interp = core.three_interpolate(points2, idx,
                                            core.interp_weights(dist))
        if points1 is not None:
            interp = torch.cat([interp, points1.to(interp.dtype)], dim=-1)
        return self.mlp(interp)


class PointNet2Backbone(nn.Module):
    """(B, N, 3) cloud -> (B, N, head_width) per-point feature.

    Module names follow the Flax tree (sa1, sa2, sa_global, fp1..fp3, fc1)
    so `convert.state_dict_from_flax` maps one onto the other by name.
    """

    def __init__(self, spec: BackboneSpec = BackboneSpec(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        s = spec
        self.sa1 = SetAbstraction(3, s.sa_mlps[0], dtype)
        self.sa2 = SetAbstraction(3 + self.sa1.out_features, s.sa_mlps[1],
                                  dtype)
        self.sa_global = SetAbstraction(3 + self.sa2.out_features,
                                        s.global_mlp, dtype)
        # FP l: interpolated coarse feature ++ skip of level 2 - l
        skips = [self.sa2.out_features, self.sa1.out_features, 3]
        width = self.sa_global.out_features
        for i, (mlp, skip) in enumerate(zip(s.fp_mlps, skips)):
            fp = FeaturePropagation(width + skip, mlp, dtype)
            self.add_module(f"fp{i + 1}", fp)
            width = fp.out_features
        self.fc1 = PointConv(width, s.head_width, dtype=dtype)

    def group(self, radius: float, nsample: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor, emit_idx: bool):
        """Centred neighbourhood coordinates (B, M, S, 3) and, when
        emit_idx, their indices (B, M, S), by the spec's ball-query tier
        (sample_and_group, pointnet2.py:72-113)."""
        s = self.spec
        if s.ball_query_impl == "stream":
            idx, _ = ball_query_idx(radius, nsample, xyz, new_xyz)
            return core.group_point(xyz, idx) - new_xyz[:, :, None], idx
        if s.ball_query_impl == "pallas" and s.ball_query_packed:
            grouped, _, idx = ball_query_group_packed(
                radius, nsample, xyz, new_xyz, emit_idx=emit_idx)
        else:
            grouped, _, idx = ball_query_group(radius, nsample, xyz, new_xyz,
                                               emit_idx=emit_idx)
        return grouped, idx

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        s = self.spec
        if X.shape[-1] != 3:
            raise NotImplementedError("the port takes xyz-only clouds "
                                      "(B, N, 3)")
        xyz0 = X.float().contiguous()
        _, xyz1, idx2, xyz2 = fps2(xyz0, s.sa_npoints[0], s.sa_npoints[1])

        # SA1: neighbourhoods of the np1 picks; the centred coordinates
        # are the whole input, so no index plane is needed
        g1, _ = self.group(s.sa_radii[0], s.sa_nsamples[0], xyz0, xyz1,
                           emit_idx=False)
        pts1 = self.sa1(g1)                                   # (B, np1, C1)

        # SA2: [centred xyz, grouped SA1 features] (pointnet2.py:116)
        g2, idx = self.group(s.sa_radii[1], s.sa_nsamples[1], xyz1, xyz2,
                             emit_idx=True)
        grouped_pts = core.group_point(pts1, idx)
        pts2 = self.sa2(torch.cat([g2.to(pts1.dtype), grouped_pts], dim=-1))

        # global SA over [xyz, features] of all np2 points (:130)
        glob = torch.cat([xyz2.to(pts2.dtype), pts2], dim=-1)[:, None]
        pts3 = self.sa_global(glob)                           # (B, 1, C3)
        xyz3 = torch.zeros((X.shape[0], 1, 3), dtype=torch.float32,
                           device=X.device)

        feats = self.fp1(xyz2, xyz3, pts2, pts3)
        feats = self.fp2(xyz1, xyz2, pts1, feats)
        feats = self.fp3(xyz0, xyz1, xyz0, feats)             # skip = raw xyz
        return self.fc1(feats)                                # dropout: identity
