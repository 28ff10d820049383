"""ANCSH multi-head model: counterpart of `articulated_pose_tpu/models/ancsh.py`.

Heads over the shared PointNet++ per-point feature (all outputs f32):
W (B, N, K) softmax, nocs_per_point (B, N, 3K) sigmoid, confi_per_point
(B, N, 1) sigmoid; in ANCSH mode also global_scale (B, N, K) sigmoid,
global_translation (B, N, 3K) tanh and gocs_per_point = nocs · scale
(repeated 3× per part, interleaved) + translation; with pred_joint the
joint head's joint_axis / unitvec (tanh), heatmap (sigmoid) and
index_per_point (softmax).  `forward` follows `self.training`: batch norm
on the batch's statistics and dropout (dp1 in the backbone, dp_0 and
dp_1 in the joint head) in training mode.  The heads run in
`head_dtype` (None = the trunk's `dtype`); the backbone takes the rest
of the mixed-precision policy (ancsh.py:73-96).  The heads take their
input width from the backbone: PointNet++'s fc1 (128 at the reference
widths) or the Point Transformer's segmentation feature (32;
`models/point_transformer.py`), which a `PointTransformerSpec` as
`backbone_spec` selects, or Point Transformer V3's decoder output (64;
`models/point_transformer_v3.py`, a `PointTransformerV3Spec`), which
`forward` hands the order shuffle it is given, or MinkUNet34C's last
decoder stage (96; `models/minkunet.py`, a `MinkUNetSpec`).
`folded_bn_layers` counts the batch norms that a forward in the model's
current mode folds into their Linear (`layers.PointConv`): 17 in the
reference PointNet++ network in eval mode, 0 in training and on the
other backbones, whose own norms are not `PointConv`s; the joint head's
two are never folded (`JointHead`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from articulated_pose_tpu_torch.models.layers import (PointConv, dropout,
                                                     init_weights)
from articulated_pose_tpu_torch.models.minkunet import (MINK_TINY_WIDTHS,
                                                        MinkUNetBackbone,
                                                        MinkUNetSpec)
from articulated_pose_tpu_torch.models.point_transformer import (
    PT_TINY_WIDTHS, PointTransformerBackbone, PointTransformerSpec)
from articulated_pose_tpu_torch.models.point_transformer_v3 import (
    PTV3_TINY_WIDTHS, PointTransformerV3Backbone, PointTransformerV3Spec)
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec,
                                                         PointNet2Backbone)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _head(in_features: int, features: int, dtype) -> PointConv:
    return PointConv(in_features, features, use_bn=False, relu=False,
                     dtype=dtype)


class JointHead(nn.Module):
    """Joint-parameter head (lib/architecture.py:195-208).

    Its dropout rate is Flax's default, 0.5, whatever the config says:
    JAX's ANCSHModel builds its JointHead without passing one
    (ancsh.py:131).  fc3_0 and fc3_1 keep their batch norm apart from
    the Linear in eval mode too (`PointConv(fold_bn=False)`), on every
    backbone: the four joint outputs all come out of them, and a
    rounding moved there reaches each output (on the Point Transformer
    at the CPU tests' widths, joint_axis by 0.15 in bf16 and 7e-6 in
    f32), so the head rounds where a plain forward that normalises
    after the Linear does."""

    def __init__(self, in_features: int, n_parts: int, dtype):
        super().__init__()
        self.dropout_rate = 0.5
        self.fc3_0 = PointConv(in_features, 128, dtype=dtype, fold_bn=False)
        self.fc3_1 = PointConv(128, 128, dtype=dtype, fold_bn=False)
        self.fc4_0 = _head(128, 3, dtype)
        self.fc4_1 = _head(128, 3, dtype)
        self.fc4_2 = _head(128, 1, dtype)
        self.fc4_3 = _head(128, n_parts, dtype)

    def forward(self, feat: torch.Tensor, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None):
        x = feat
        for fc in (self.fc3_0, self.fc3_1):                  # dp_0, dp_1
            x = dropout(fc(x, bn_momentum), self.dropout_rate, self.training,
                        generator)
        joint_axis = torch.tanh(self.fc4_0(x).float())
        unitvec = torch.tanh(self.fc4_1(x).float())
        heatmap = torch.sigmoid(self.fc4_2(x).float())
        joint_cls = torch.softmax(self.fc4_3(x).float(), dim=-1)
        return joint_axis, unitvec, heatmap, joint_cls


class ANCSHModel(nn.Module):
    """Full per-point multi-head model; `mixed` selects ANCSH (part +
    global NOCS) over NPCS (part NOCS only).  A `PointTransformerSpec`
    builds the Point Transformer backbone, a `PointTransformerV3Spec`
    Point Transformer V3 and a `MinkUNetSpec` MinkUNet; they take none
    of PointNet++'s policy knobs (`pool_dtype`, `act_dtype`,
    `f32_stages`) and no input features."""

    def __init__(self, n_max_parts: int = 3, mixed: bool = True,
                 pred_joint: bool = True, early_split_nocs: bool = True,
                 backbone_spec: Union[BackboneSpec, PointTransformerSpec,
                                      PointTransformerV3Spec, MinkUNetSpec]
                 = BackboneSpec(),
                 dtype: torch.dtype = torch.float32,
                 head_dtype: Optional[torch.dtype] = None,
                 pool_dtype: Optional[torch.dtype] = None,
                 act_dtype: Optional[torch.dtype] = None,
                 f32_stages: Sequence[str] = (), in_features: int = 0):
        super().__init__()
        K = n_max_parts
        self.n_max_parts = K
        self.mixed = mixed
        self.pred_joint = pred_joint
        self.early_split_nocs = early_split_nocs
        others = {PointTransformerSpec: PointTransformerBackbone,
                  PointTransformerV3Spec: PointTransformerV3Backbone,
                  MinkUNetSpec: MinkUNetBackbone}
        if type(backbone_spec) in others:
            knobs = {"pool_dtype": pool_dtype, "act_dtype": act_dtype,
                     "f32_stages": tuple(f32_stages) or None,
                     "in_features": in_features or None}
            given = sorted(k for k, v in knobs.items() if v is not None)
            backbone = others[type(backbone_spec)]
            if given:
                raise ValueError(f"the {backbone.__name__} takes none of "
                                 f"{given}")
            self.backbone = backbone(backbone_spec, dtype=dtype)
        else:
            self.backbone = PointNet2Backbone(
                backbone_spec, dtype=dtype, in_features=in_features,
                pool_dtype=pool_dtype, act_dtype=act_dtype,
                f32_stages=tuple(f32_stages))
        hdt = dtype if head_dtype is None else head_dtype
        width = self.backbone.out_features
        out_dims = [K, 3 * K] + ([K, 3 * K] if mixed else []) + [1]
        self.n_heads = len(out_dims)
        for i, d in enumerate(out_dims):
            cin = width
            if early_split_nocs and i == 1:
                # private branch for part-NOCS (lib/architecture.py:110-113)
                self.add_module(f"fc11_{i}", _head(width, 128, hdt))
                cin = 128
            self.add_module(f"fc2_{i}", _head(cin, d, hdt))
        if pred_joint:
            self.joint_net = JointHead(width, K, hdt)

    @property
    def folded_bn_layers(self) -> int:
        """The batch norms a forward in the current mode folds into
        their Linear (`PointConv.folded`)."""
        return sum(isinstance(m, PointConv) and m.folded
                   for m in self.modules())

    def forward(self, P: torch.Tensor, *, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None,
                shuffle=None) -> Dict[str, torch.Tensor]:
        """In training mode batch norm moves its running statistics by
        `bn_momentum` (a float or a 0-d tensor) and dropout draws its
        masks from `generator`.  `shuffle` goes to a backbone that
        permutes its orders (Point Transformer V3's `draw_shuffle`)."""
        kw = {} if shuffle is None else {"shuffle": shuffle}
        feat = self.backbone(P, bn_momentum, generator, **kw)
        results = []
        for i in range(self.n_heads):
            x = feat
            if self.early_split_nocs and i == 1:
                x = getattr(self, f"fc11_{i}")(x)
            results.append(getattr(self, f"fc2_{i}")(x).float())
        if self.mixed:
            w_logits, nocs_logits, scale_logits, trans_logits, confi_logits = \
                results
        else:
            w_logits, nocs_logits, confi_logits = results

        nocs = torch.sigmoid(nocs_logits)
        pred = {
            "W": torch.softmax(w_logits, dim=-1),
            "nocs_per_point": nocs,
            "confi_per_point": torch.sigmoid(confi_logits),
        }
        if self.pred_joint:
            joint_axis, unitvec, heatmap, joint_cls = self.joint_net(
                feat, bn_momentum, generator)
            pred.update({
                "joint_axis_per_point": joint_axis,
                "unitvec_per_point": unitvec,
                "heatmap_per_point": heatmap,
                "index_per_point": joint_cls,
            })
        if self.mixed:
            scale = torch.sigmoid(scale_logits)               # (B, N, K)
            trans = torch.tanh(trans_logits)                  # (B, N, 3K)
            # K -> 3K interleaved per part (architecture.py:154)
            pred["gocs_per_point"] = (nocs * scale.repeat_interleave(3, dim=-1)
                                      + trans)
            pred["global_scale"] = scale
            pred["global_translation"] = trans
        return pred


def _dtype_or_none(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else DTYPES[name]


def build_model(config, generator: Optional[torch.Generator] = None,
                device=None,
                spec: Union[BackboneSpec, PointTransformerSpec, None] = None
                ) -> ANCSHModel:
    """The model of a NetworkConfig, in eval mode, with the reference's
    initialisation drawn from `generator`.  `config.backbone` picks
    PointNet++, the Point Transformer, Point Transformer V3 or MinkUNet.
    The ball-query route follows `use_pallas` and `ball_query_packed`,
    the dtypes the mixed-precision knobs, as the JAX package's
    build_model maps them (ancsh.py:153-186).
    `spec` gives the backbone's widths in place of `backbone_preset`'s
    (the tests' tiny backbones); the config still sets its dropout rate
    and ball-query route."""
    specs = {"point_transformer": (PointTransformerSpec, PT_TINY_WIDTHS),
             "point_transformer_v3": (PointTransformerV3Spec,
                                      PTV3_TINY_WIDTHS),
             "minkunet": (MinkUNetSpec, MINK_TINY_WIDTHS)}
    if config.backbone_preset not in ("tiny", "reference"):
        raise ValueError(f"unknown backbone_preset {config.backbone_preset!r}")
    tiny = config.backbone_preset == "tiny"
    if config.backbone in specs:
        cls, tiny_widths = specs[config.backbone]
        spec = dataclasses.replace(
            spec or cls(**(tiny_widths if tiny else {})),
            dropout_rate=config.dropout_rate)
    else:
        spec = dataclasses.replace(
            spec or BackboneSpec(**(TINY_WIDTHS if tiny else {})),
            dropout_rate=config.dropout_rate,
            ball_query_impl="pallas" if config.use_pallas else "xla",
            ball_query_packed=config.ball_query_packed)
    model = ANCSHModel(
        n_max_parts=config.n_max_parts,
        mixed=config.is_mixed,
        pred_joint=config.pred_joint,
        early_split_nocs=config.early_split_nocs,
        backbone_spec=spec,
        dtype=DTYPES[config.compute_dtype],
        head_dtype=_dtype_or_none(config.head_compute_dtype),
        pool_dtype=_dtype_or_none(config.pool_compute_dtype),
        act_dtype=_dtype_or_none(config.act_compute_dtype),
        f32_stages=tuple(config.f32_stages),
    )
    init_weights(model, generator)
    return model.to(device).eval()
