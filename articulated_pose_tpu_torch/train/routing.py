"""A model's discrete choices in a train forward, for holding the
gradients of one step against another run of the same step.

Two runs of one step (on the card and on the CPU, or in this package and
in the JAX one) differ in their forwards by rounding, about 1e-6
relative.  Where a ReLU input, or a near-tie of a set-abstraction max,
lies that close, the two runs route the other way, and a max routes a
whole output's gradient.  The L2 loss's heatmap term is |h - h_gt| a
point, and where that residual lies within rounding of 0 its sign, and
so the point's whole gradient, is such a choice too.  So:

- `capture_routing` records where each ReLU passes, which of its S
  inputs reach each max and, given the heatmap's target, where the
  heatmap's residual is positive;
- `count_flips` counts the choices two records disagree on;
- `impose_routing` makes a model take a record's choices, so that two
  runs' gradients can be held to a bound of rounding size;
- `grad_deviations` reads each leaf's deviation against its scale, and
  `pre_bn_biases` names the leaves whose exact gradient is 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import torch
from torch import nn

from ..models.layers import PointConv
from ..models.pointnet2 import SetAbstraction

# the record's entry for the heatmap's residual signs (B, N): True where
# h > h_gt
HEATMAP = "joint_net.heatmap"


def _heatmap(out) -> torch.Tensor:
    """The (B, N) heatmap of a joint head's outputs."""
    return out[2][..., 0]


def capture_routing(model: nn.Module, record: Dict[str, torch.Tensor],
                    heatmap_gt: Optional[torch.Tensor] = None):
    """Forward hooks recording into `record` each ReLU's mask (by its
    PointConv's name), each set-abstraction max's selection, the inputs
    equal to the max (by the SetAbstraction's name) and, with the
    heatmap's target (B, N) on the model's device, where the heatmap
    exceeds it (`HEATMAP`).  Returns the hook handles."""
    hooks = []

    def keep(name, choose):
        return lambda m, i, out: record.__setitem__(name, choose(out))

    for name, mod in model.named_modules():
        if isinstance(mod, PointConv) and mod.relu:
            hooks.append(mod.register_forward_hook(
                keep(name, lambda out: (out > 0).detach())))
        elif isinstance(mod, SetAbstraction):
            hooks.append(mod.mlp.register_forward_hook(keep(
                name,
                lambda out: (out == out.amax(2, keepdim=True)).detach())))
    if heatmap_gt is not None:
        hooks.append(model.joint_net.register_forward_hook(keep(
            HEATMAP, lambda out: (_heatmap(out) > heatmap_gt).detach())))
    return hooks


def impose_routing(model: nn.Module, record: Dict[str, object],
                   heatmap_gt: Optional[torch.Tensor] = None):
    """Forward hooks that make the model take `record`'s choices (masks
    and selections as `capture_routing` records them, tensors or numpy
    arrays; a layer the record does not name keeps its own, and an entry
    for a layer without a ReLU is ignored): each ReLU emits its
    batch-norm output times the recorded mask, each max the mean of its
    recorded inputs (amax's gradient split among ties).  With the
    heatmap's target and a `HEATMAP` entry, the heatmap moves, by a
    constant, to the other side of its target where its residual's sign
    differs from the record's: there r = h - h_gt becomes -r, so |r|'s
    value stays and its gradient takes the recorded sign.  Returns the
    hook handles."""
    inner, hooks = {}, []
    if heatmap_gt is not None and HEATMAP in record:
        above = torch.as_tensor(record[HEATMAP]).to(heatmap_gt.device)

        def signed(m, i, out):
            r = _heatmap(out) - heatmap_gt
            shift = (torch.where(above, r.abs(), -r.abs()) - r).detach()
            return (*out[:2], out[2] + shift[..., None], *out[3:])

        hooks.append(model.joint_net.register_forward_hook(signed))

    def stash(name):
        return lambda m, i, out: inner.__setitem__(name, out)

    for name, mod in model.named_modules():
        if name not in record:
            continue
        choice = torch.as_tensor(record[name]).to(
            next(mod.parameters()).device)
        if isinstance(mod, PointConv) and mod.relu:
            hooks.append(mod.bn.register_forward_hook(stash(name)))
            hooks.append(mod.register_forward_hook(
                lambda m, i, out, name=name, mask=choice:
                inner.pop(name) * mask))
        elif isinstance(mod, SetAbstraction):
            weight = choice.float() / choice.float().sum(2, keepdim=True)
            hooks.append(mod.mlp.register_forward_hook(stash(name)))
            hooks.append(mod.register_forward_hook(
                lambda m, i, out, name=name, weight=weight:
                (inner.pop(name) * weight).sum(2).to(m.out_dtype)))
    return hooks


def count_flips(got: Dict[str, object], want: Dict[str, object]
                ) -> Tuple[int, int]:
    """(choices that differ, choices compared) over the layers both
    records name."""
    flipped = total = 0
    for name in got.keys() & want.keys():
        a = torch.as_tensor(got[name]).cpu()
        b = torch.as_tensor(want[name]).cpu()
        flipped += int((a != b).sum())
        total += b.numel()
    return flipped, total


def pre_bn_biases(model: nn.Module) -> Set[str]:
    """Dense biases ahead of a batch norm: in training mode the norm
    subtracts them out, so their exact gradient is 0 and any value is
    rounding noise."""
    return {f"{name}.dense.bias" for name, mod in model.named_modules()
            if isinstance(mod, PointConv) and mod.bn is not None}


def grad_deviations(got: Dict[str, object], want: Dict[str, object],
                    zero: Set[str]) -> List[Tuple[float, str, float, float]]:
    """(deviation / scale, leaf, deviation, scale) of every leaf of
    `want`, largest first: max|got - want| over the scale, the leaf's
    largest entry in `want`, for a leaf in `zero` its layer's weight
    gradient's."""
    out = []
    for name, w in want.items():
        w = torch.as_tensor(w)
        ref = (torch.as_tensor(want[name.replace(".bias", ".weight")])
               if name in zero else w)
        scale = ref.abs().max().item()
        dev = (torch.as_tensor(got[name]) - w).abs().max().item()
        out.append((dev / max(scale, 1e-30), name, dev, scale))
    return sorted(out, reverse=True)
