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
- "bucket" and "bucket_xla" are the bucket-sampled ball query (B8,
  `ball_query_group_bucket`): one hit per bucket of the padded cloud.
  "bucket" takes the kernel's bf16-rounded coordinates; "bucket_xla"
  takes its indices and gathers f32 offsets, as JAX does after
  `ops.query_ball_point_bucket`.  JAX resolves both to the exact query
  off a TPU (`resolve_impl`, pointnet2.py:27-37); the port keeps the
  bucket semantics on every device.

FPS and 3-NN have one function whatever the reference's `fps_impl` or
`three_nn_impl` says, so those strings are not carried over: a
two-level pyramid runs the fused two-level kernel (`fps2`), any other
one the single-level kernel (`fps`) per stage, as JAX's Pallas tier does
(pointnet2.py:290-302).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.ball_query import (
    ball_query_group, ball_query_group_bucket, ball_query_group_packed,
    ball_query_idx)
from articulated_pose_tpu_torch.ops.kernels.fps import fps, fps2
from articulated_pose_tpu_torch.ops.kernels.knn import (MAX_K,
                                                       knn as knn_kernel)
from articulated_pose_tpu_torch.ops.kernels.three_nn import three_nn
from articulated_pose_tpu_torch.models.layers import (PointConv, SharedMLP,
                                                     dropout)


BALL_QUERY_IMPLS = ("xla", "pallas", "stream", "bucket", "bucket_xla")


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    """Stage widths; defaults are the reference widths (architectures.py:62-93).

    Any number of SA stages; the FP stages are one more (the backbone
    adds a global SA stage), so that the last one ends at full
    resolution (pointnet2.py:331-344).
    """

    sa_npoints: Tuple[int, ...] = (512, 128)
    sa_radii: Tuple[float, ...] = (0.2, 0.4)
    sa_nsamples: Tuple[int, ...] = (64, 64)
    sa_mlps: Tuple[Tuple[int, ...], ...] = ((64, 64, 128), (128, 128, 256))
    global_mlp: Tuple[int, ...] = (256, 512, 1024)
    fp_mlps: Tuple[Tuple[int, ...], ...] = ((256, 256), (256, 128),
                                            (128, 128, 128))
    head_width: int = 128
    dropout_rate: float = 0.5
    ball_query_impl: str = "xla"  # one of BALL_QUERY_IMPLS
    # with ball_query_impl="pallas": the 10-bit-quantised coordinate tier
    ball_query_packed: bool = False

    def __post_init__(self):
        n = len(self.sa_npoints)
        if n == 0 or not (len(self.sa_radii) == len(self.sa_nsamples)
                          == len(self.sa_mlps) == n):
            raise ValueError(
                "sa_npoints, sa_radii, sa_nsamples and sa_mlps need one "
                "entry per SA stage, at least one")
        if len(self.fp_mlps) != n + 1:
            raise ValueError(
                f"len(fp_mlps) must be len(sa_npoints) + 1 = {n + 1} (one "
                f"FP stage per SA stage and the global one), got "
                f"{len(self.fp_mlps)}")
        if self.ball_query_impl not in BALL_QUERY_IMPLS:
            raise ValueError(f"unknown ball_query_impl "
                             f"{self.ball_query_impl!r}")


# trimmed widths, same topology: CLI smokes and CPU tests (ancsh.py:164-168)
TINY_WIDTHS = dict(sa_npoints=(64, 32), sa_nsamples=(16, 16),
                   sa_mlps=((16, 16), (16, 32)), global_mlp=(32, 64),
                   fp_mlps=((32,), (32,), (16, 16)), head_width=16)


def group(radius: float, nsample: int, xyz: torch.Tensor,
          new_xyz: torch.Tensor, emit_idx: bool, ball_query_impl: str = "xla",
          ball_query_packed: bool = False):
    """Centred neighbourhood coordinates (B, M, S, 3) f32 and, when
    emit_idx, their indices (B, M, S), by ball-query tier
    (pointnet2.py:72-113)."""
    bq = ball_query_impl
    if bq == "stream":
        idx, _ = ball_query_idx(radius, nsample, xyz, new_xyz)
        grouped = None
    elif bq == "bucket_xla":
        _, _, idx = ball_query_group_bucket(radius, nsample, xyz, new_xyz)
        grouped = None
    elif bq == "bucket":
        grouped, _, idx = ball_query_group_bucket(radius, nsample, xyz,
                                                  new_xyz, emit_idx=emit_idx)
    elif bq == "pallas" and ball_query_packed:
        grouped, _, idx = ball_query_group_packed(radius, nsample, xyz,
                                                  new_xyz, emit_idx=emit_idx)
    else:
        grouped, _, idx = ball_query_group(radius, nsample, xyz, new_xyz,
                                           emit_idx=emit_idx)
    if grouped is None:
        grouped = core.group_point(xyz, idx) - new_xyz[:, :, None]
    return grouped, idx


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: Optional[torch.Tensor],
                     dtype: torch.dtype, ball_query_impl: str = "xla",
                     ball_query_packed: bool = False, precomputed_fps=None,
                     knn: bool = False, use_xyz: bool = True):
    """FPS → ball query (or, with knn, the nsample nearest points:
    JAX's SetAbstraction(knn=True), pointnet2.py:69-70; the `knn` kernel
    entry for nsample <= 16, else `core.knn_point`) → group → centre
    (pointnet2.py:40-120).

    xyz (B, N, 3) f32, points (B, N, C) or None -> (new_xyz (B, M, 3),
    new_points (B, M, S, 3 + C)), or (B, M, S, C) without `use_xyz`
    (the grouped features alone, pointnet2.py:114-116).
    `precomputed_fps` = (idx, new_xyz) from the two-level kernel.
    new_points is concatenated in `dtype`, the compute dtype of the MLP
    that consumes it: JAX concatenates in the promoted dtype and the
    MLP's first layer casts to its own, which rounds the same.
    """
    if precomputed_fps is not None:
        _, new_xyz = precomputed_fps
    else:
        _, new_xyz = fps(xyz, npoint)
    if knn:
        search = knn_kernel if nsample <= MAX_K else core.knn_point
        _, idx = search(nsample, xyz, new_xyz)
        grouped = core.group_point(xyz, idx) - new_xyz[:, :, None]
    else:
        grouped, idx = group(radius, nsample, xyz, new_xyz,
                             points is not None, ball_query_impl,
                             ball_query_packed)
    if points is None:
        return new_xyz, grouped
    grouped_points = core.group_point(points, idx).to(dtype)
    if not use_xyz:
        return new_xyz, grouped_points
    return new_xyz, torch.cat([grouped.to(dtype), grouped_points], dim=-1)


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor],
                         use_xyz: bool = True,
                         dtype: Optional[torch.dtype] = None):
    """The single global group (pointnet2.py:123-134): xyz (B, N, 3),
    points (B, N, C) or None -> (new_xyz (B, 1, 3) zeros, new_points
    (B, 1, N, 3 + C), or (B, 1, N, C) without `use_xyz`, or the cloud
    (B, 1, N, 3) without points).  new_points is in `dtype`, the compute
    dtype of the MLP that consumes it, each part cast before the concat;
    None keeps the promoted dtype, as JAX concatenates."""
    B = xyz.shape[0]
    new_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
    if dtype is not None:
        xyz = xyz.to(dtype)
        points = None if points is None else points.to(dtype)
    if points is None:
        return new_xyz, xyz[:, None]
    new_points = torch.cat([xyz, points], dim=-1) if use_xyz else points
    return new_xyz, new_points[:, None]


class SetAbstraction(nn.Module):
    """Shared MLP over each neighbourhood, then max pool over its S points.

    The neighbourhoods are built by the caller (`sample_and_group`, whose
    `knn` is JAX's `SetAbstraction(knn=True)`), so the module only holds
    weights: input (B, M, S, C) -> (B, M, C').
    The last MLP layer emits `pool_dtype` and the pool runs in it; the
    pooled output is cast to `act_dtype`, or else to `dtype`
    (pointnet2.py:177-195).
    """

    def __init__(self, in_features: int, mlp, dtype: torch.dtype,
                 pool_dtype: Optional[torch.dtype] = None,
                 act_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.out_dtype = act_dtype if act_dtype is not None else dtype
        self.mlp = SharedMLP(in_features, mlp, dtype=dtype,
                             out_dtype=pool_dtype, act_dtype=act_dtype)
        self.out_features = self.mlp.out_features

    def forward(self, grouped: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        # amax, not max(dim): its gradient splits evenly among ties, as
        # JAX's reduce_max does, and the ball query pads a neighbourhood
        # with repeats of its first hit, so ties are the rule
        return self.mlp(grouped, bn_momentum).amax(dim=2).to(self.out_dtype)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation, skip concat, shared MLP."""

    def __init__(self, in_features: int, mlp, dtype: torch.dtype,
                 act_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.mlp = SharedMLP(in_features, mlp, dtype=dtype,
                             act_dtype=act_dtype)
        self.out_features = self.mlp.out_features

    def forward(self, xyz1, xyz2, points1: Optional[torch.Tensor],
                points2: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        if xyz2.shape[1] == 1:
            # a single global point: copy its feature everywhere
            interp = points2.expand(-1, xyz1.shape[1], -1)
        else:
            dist, idx = three_nn(xyz1, xyz2)
            interp = core.three_interpolate(points2, idx,
                                            core.interp_weights(dist))
        if points1 is not None:
            # concatenated in the MLP's compute dtype (see sample_and_group)
            interp = torch.cat([interp.to(self.dtype),
                                points1.to(self.dtype)], dim=-1)
        return self.mlp(interp, bn_momentum)


class PointNet2Backbone(nn.Module):
    """(B, N, 3 + in_features) cloud -> (B, N, head_width) per-point feature.

    Module names follow the Flax tree (sa1..saL, sa_global, fp1..fp(L+1),
    fc1), so `convert.state_dict_from_flax` maps one onto the other by
    name.  Flax infers the width of the input features; a PyTorch module
    is built before it sees one, so it takes `in_features`.  The
    mixed-precision policy is the JAX backbone's: `pool_dtype` and
    `act_dtype` as in `SetAbstraction`, and `f32_stages` naming the stages
    that compute in f32 whatever `dtype` says (pointnet2.py:261-286).
    """

    def __init__(self, spec: BackboneSpec = BackboneSpec(),
                 dtype: torch.dtype = torch.float32, in_features: int = 0,
                 pool_dtype: Optional[torch.dtype] = None,
                 act_dtype: Optional[torch.dtype] = None,
                 f32_stages: Sequence[str] = ()):
        super().__init__()
        valid = ({f"sa{i + 1}" for i in range(len(spec.sa_npoints))}
                 | {f"fp{i + 1}" for i in range(len(spec.fp_mlps))}
                 | {"sa_global", "fc1"})
        bad = [n for n in f32_stages if n not in valid]
        if bad:
            raise ValueError(
                f"unknown f32_stages {bad}; valid: {sorted(valid)}")
        self.spec = spec
        self.in_features = in_features
        f32 = set(f32_stages)

        def stage_dtype(name: str) -> torch.dtype:
            return torch.float32 if name in f32 else dtype

        s = spec
        widths = [in_features]                  # feature width per level
        for i, mlp in enumerate(s.sa_mlps):
            sa = SetAbstraction(3 + widths[-1], mlp, stage_dtype(f"sa{i + 1}"),
                                pool_dtype, act_dtype)
            self.add_module(f"sa{i + 1}", sa)
            widths.append(sa.out_features)
        self.sa_global = SetAbstraction(3 + widths[-1], s.global_mlp,
                                        stage_dtype("sa_global"), pool_dtype,
                                        act_dtype)
        # FP i: interpolated coarse feature ++ skip of level L - i, where
        # level 0's skip is [xyz, input features] (pointnet2.py:331-344)
        width = self.sa_global.out_features
        skips = widths[:0:-1] + [3 + in_features]
        for i, (mlp, skip) in enumerate(zip(s.fp_mlps, skips)):
            fp = FeaturePropagation(width + skip, mlp,
                                    stage_dtype(f"fp{i + 1}"), act_dtype)
            self.add_module(f"fp{i + 1}", fp)
            width = fp.out_features
        self.fc1 = PointConv(width, s.head_width, dtype=stage_dtype("fc1"),
                             out_dtype=act_dtype)
        self.out_features = s.head_width

    def forward(self, X: torch.Tensor, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In training mode batch norm takes `bn_momentum` and dropout
        (dp1, after fc1) draws from `generator`."""
        s = self.spec
        C = X.shape[-1]
        if C != 3 + self.in_features:
            raise ValueError(f"expected (B, N, {3 + self.in_features}) "
                             f"clouds (in_features={self.in_features}), got "
                             f"{tuple(X.shape)}")
        l_xyz = [X[..., :3].float().contiguous()]
        l_pts = [X[..., 3:] if self.in_features else None]

        # both FPS levels in one kernel for the two-level pyramid
        pre = [None] * len(s.sa_npoints)
        if len(s.sa_npoints) == 2:
            i1, x1, i2, x2 = fps2(l_xyz[0], s.sa_npoints[0], s.sa_npoints[1])
            pre = [(i1, x1), (i2, x2)]

        for i in range(len(s.sa_npoints)):
            sa = getattr(self, f"sa{i + 1}")
            xyz, grouped = sample_and_group(
                s.sa_npoints[i], s.sa_radii[i], s.sa_nsamples[i], l_xyz[-1],
                l_pts[-1], sa.dtype, s.ball_query_impl, s.ball_query_packed,
                precomputed_fps=pre[i])
            l_xyz.append(xyz)
            l_pts.append(sa(grouped, bn_momentum))

        # global SA over [xyz, features] of the last level's points
        # (pointnet2.py:167), in the stage's compute dtype
        xyz, glob = sample_and_group_all(l_xyz[-1], l_pts[-1],
                                         dtype=self.sa_global.dtype)
        l_pts.append(self.sa_global(glob, bn_momentum))          # (B, 1, C)
        l_xyz.append(xyz)

        feats = l_pts[-1]
        for i in range(len(s.fp_mlps)):
            lvl = len(l_xyz) - 2 - i
            skip = l_pts[lvl]
            if lvl == 0:
                # the last skip is raw xyz ++ input features
                skip = (l_xyz[0] if skip is None
                        else torch.cat([l_xyz[0], skip.float()], dim=-1))
            fp = getattr(self, f"fp{i + 1}")
            feats = fp(l_xyz[lvl], l_xyz[lvl + 1], skip, feats, bn_momentum)
        return dropout(self.fc1(feats, bn_momentum), s.dropout_rate,
                       self.training, generator)             # dp1
