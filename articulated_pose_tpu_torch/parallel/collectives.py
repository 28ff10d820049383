"""The collectives of the sharded train step, as autograd functions.

Only `all_reduce` and `broadcast` are used: gloo on CUDA tensors offers
those two alone (and NCCL refuses two ranks on one card).  The worlds
that exist are gloo worlds (`parallel/launch.py::run_ranks`): ranks on
the CPU, or several ranks sharing a card; an NCCL world, a card a rank,
has not been built or run.  An all-gather is an all-reduce of
zero-padded buffers, which is exact: each entry is one rank's value
plus zeros.

- `all_reduce_sum`: a sum over the group whose gradient is the sum of
  the ranks' gradients, so that each rank's rows receive the gradient of
  every rank's loss (the batch-norm statistics of the 'data' axis).
- `copy_to_group` and `gather_columns`: Megatron's f and g pair of a
  column-parallel layer on the 'model' axis.  f is the identity whose
  gradient is summed over the group (each rank's columns contribute to
  the input's gradient); g assembles the output columns of every rank and
  hands each rank the gradient of its own.
- `gather_rows`: the same assembly along the leading axis, without a
  gradient, for collecting sharded state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _padded_sum(t: torch.Tensor, dim: int, index: int, size: int,
                group) -> torch.Tensor:
    """`t`, this rank's slice `index` of `size` along `dim`, assembled
    with the other ranks' into the whole: an all-reduce of zero-padded
    buffers (f32 on the wire, exact for any dtype that f32 holds)."""
    shape = list(t.shape)
    width = shape[dim]
    shape[dim] = width * size
    full = torch.zeros(shape, dtype=torch.float32, device=t.device)
    full.narrow(dim, index * width, width).copy_(t)
    dist.all_reduce(full, group=group)
    return full.to(t.dtype)


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, index, size):
        ctx.index, ctx.width = index, y.shape[-1]
        return _padded_sum(y, y.dim() - 1, index, size, group)

    @staticmethod
    def backward(ctx, grad):
        # every rank of the group computes the same loss from the same
        # assembled output, so each holds the whole gradient already
        return (grad.narrow(-1, ctx.index * ctx.width, ctx.width).contiguous(),
                None, None, None)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def gather_columns(y: torch.Tensor, group, index: int,
                   size: int) -> torch.Tensor:
    return _GatherColumns.apply(y, group, index, size)


@torch.no_grad()
def gather_rows(t: torch.Tensor, group, index: int, size: int
                ) -> torch.Tensor:
    return _padded_sum(t, 0, index, size, group)


def global_var_mean(x: torch.Tensor, dims, group):
    """(biased variance, mean) over `dims` of the rows of every rank of
    the group, each holding as many rows as this one: the sums and the
    count first, then the centred sum of squares, both differentiable."""
    count = x.numel() // x.shape[-1] * dist.get_world_size(group)
    mean = all_reduce_sum(x.sum(dims), group) / count
    var = all_reduce_sum(((x - mean) ** 2).sum(dims), group) / count
    return var, mean


@dataclasses.dataclass(frozen=True)
class ColumnShard:
    """This rank's block `index` of `size` of a layer's output features
    on the 'model' axis, whose ranks form `group`."""

    group: object
    index: int
    size: int

    def linear(self, x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
        """x @ weight.T + bias at full width from this rank's rows of
        the weight (its output features) and the whole bias."""
        y = torch.nn.functional.linear(copy_to_group(x, self.group), weight)
        return gather_columns(y, self.group, self.index, self.size) + bias
