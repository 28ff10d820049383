"""Pointwise layers: counterparts of `articulated_pose_tpu/models/layers.py`.

Tensors are channels-last, (B, N, C) or (B, M, S, C), so a 1×1 conv is an
`nn.Linear` over the last axis.  Parameters and batch-norm statistics stay
f32; `dtype` is the compute dtype of the matmul and, unless `out_dtype`
says otherwise, of what the layer emits (the mixed-precision policy of
layers.py:75-123).  In training mode (`module.train()`) batch norm
normalises with the batch's statistics and moves its running ones by a
momentum given at run time; `dropout` is Flax's, its mask drawn from a
given torch.Generator.  Under a sharded train step
(`parallel/mesh.py::shard_train_setup`) batch norm reduces its
statistics over the 'data' ranks and a layer marked by `state_shardings`
computes its block of output features on the 'model' axis.  In eval mode
a `PointConv`'s batch norm is folded into its Linear on every call (its
running statistics are constants there), so the layer runs one GEMM and
no elementwise pass of its own but the ReLU; in training mode, on a
column-sharded layer, without a batch norm or on a layer built with
`fold_bn=False` nothing is folded.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from articulated_pose_tpu_torch.parallel.collectives import global_var_mean


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax's `nn.Dropout`: in training, where(keep, x / (1 - rate), 0)
    with keep ~ Bernoulli(1 - rate) drawn as torch.rand(...) < 1 - rate
    from `generator`; the identity in eval or at rate 0.
    (`F.dropout` takes no generator.)"""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


class ScheduledBatchNorm(nn.Module):
    """Batch norm over the last axis, eps 1e-3, stats in f32
    (layers.py:26-60); the output is cast to `dtype`.

    In training mode it normalises with the batch's mean and biased
    variance over every axis but the last, and moves the running
    statistics in place as ra = m * ra + (1 - m) * batch (the biased
    variance too).  `momentum` m is a float or a 0-d tensor, so a
    schedule on the device costs no host sync.  `F.batch_norm` is not
    used: it moves the running variance by the unbiased one, and its
    momentum is 1 - m.  With `data_group` set (a process group of the
    ranks that split the batch), the statistics are the global batch's,
    as under GSPMD, and their gradient reaches every rank's rows."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.data_group = None

    def forward(self, x: torch.Tensor, momentum=0.9) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if self.data_group is None:
                var, mean = torch.var_mean(x32, dim=dims, correction=0)
            else:
                var, mean = global_var_mean(x32, dims, self.data_group)
            with torch.no_grad():
                m = momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean) * inv + self.bias
        return y.to(self.dtype)


class PointConv(nn.Module):
    """Pointwise Linear (+ batch norm) (+ ReLU), computed in `dtype`; the
    batch norm emits `out_dtype` (None = dtype), or without one the
    output is cast to it (layers.py:75-98).  With `columns` set (a
    `ColumnShard`), `dense.weight` holds this rank's block of output
    features and the Linear's output is assembled to full width.

    In eval mode, with a batch norm and no `columns`, the norm is folded
    into the Linear from the current parameters on every call, in f32
    (`fold`); W' and b' are rounded to `dtype` as the unfolded weight
    is, one Linear runs, and its output is cast to `out_dtype` where
    that differs.  Nothing is cached, so a captured graph folds whatever
    the parameters hold when it replays.  Training mode, a
    column-sharded layer, a layer without a batch norm and one built
    with `fold_bn=False` run the Linear and the norm apart; `folded`
    says which path a call takes now."""

    def __init__(self, in_features: int, features: int, use_bn: bool = True,
                 relu: bool = True, dtype: torch.dtype = torch.float32,
                 out_dtype: Optional[torch.dtype] = None,
                 fold_bn: bool = True):
        super().__init__()
        self.dtype = dtype
        self.out_dtype = dtype if out_dtype is None else out_dtype
        self.relu = relu
        self.fold_bn = fold_bn
        self.dense = nn.Linear(in_features, features)
        self.bn = (ScheduledBatchNorm(features, self.out_dtype) if use_bn
                   else None)
        self.columns = None

    @property
    def folded(self) -> bool:
        """Whether a call folds the norm into the Linear: eval mode, a
        batch norm, no column shard and `fold_bn`."""
        return (self.bn is not None and self.fold_bn and not self.training
                and self.columns is None)

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W', b') in f32 from the current parameters: s = weight *
        rsqrt(running_var + eps), W' = dense.weight * s[:, None],
        b' = (dense.bias - running_mean) * s + bias."""
        bn = self.bn
        s = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        return (self.dense.weight * s[:, None],
                (self.dense.bias - bn.running_mean) * s + bn.bias)

    def forward(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        dt = self.dtype
        if self.folded:
            w, b = self.fold()
            y = F.linear(x.to(dt), w.to(dt), b.to(dt)).to(self.out_dtype)
        else:
            linear = F.linear if self.columns is None else self.columns.linear
            y = linear(x.to(dt), self.dense.weight.to(dt),
                       self.dense.bias.to(dt))
            y = (self.bn(y, bn_momentum) if self.bn is not None
                 else y.to(self.out_dtype))
        return F.relu(y) if self.relu else y


class SharedMLP(nn.Module):
    """A stack of PointConv layers named conv0, conv1, ... (as in Flax).

    The last layer emits `out_dtype`, every layer `act_dtype` when that
    is set (it overrides out_dtype); None means `dtype`
    (layers.py:104-123)."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 out_dtype: Optional[torch.dtype] = None,
                 act_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_features = in_features
        last = len(channels) - 1
        for i, ch in enumerate(channels):
            odt = act_dtype if act_dtype is not None else (
                out_dtype if i == last else None)
            self.add_module(f"conv{i}", PointConv(self.out_features, ch,
                                                  dtype=dtype, out_dtype=odt))
            self.out_features = ch

    def forward(self, x: torch.Tensor, bn_momentum=0.9) -> torch.Tensor:
        for layer in self.children():
            x = layer(x, bn_momentum)
        return x


def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None
                 ) -> nn.Module:
    """The reference's initialisation: Xavier-uniform Linear weights and
    zero biases (layers.py:83-90), batch norm as identity; drawn from
    `generator` so random weights are reproducible from a seed."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                fan_out, fan_in = m.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, ScheduledBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
