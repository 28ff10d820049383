"""ANCSH on a Point Transformer backbone in plain float32 PyTorch: the
benchmark's reference of the port's `models/point_transformer.py`,
written from the paper (Zhao et al., ICCV 2021, arXiv:2012.09164,
§3.2-3.4) and the segmentation network of its public reproduction
(POSTECH-CVLab/point-transformer, `model/pointtransformer/
pointtransformer_seg.py`, `pointtransformer_seg_repro`).  It imports
nothing of the port and nothing of JAX; ANCSH's heads are
`reference/model.py`'s.  Parameter and buffer names are the port's, so
one state dict loads into both.

The layer: δ_ij = θ(p_j − p_i), θ = Linear(3,3) → BN → ReLU →
Linear(3,C); a_ij = γ(k_j − q_i + δ_ij), γ = BN(C) → ReLU → Linear(C,C/s)
→ BN → ReLU → Linear(C/s,C/s); ρ_ij = softmax over j ∈ N(i) of a_ij;
y_i[c] = Σ_j ρ_ij[c mod C/s] (v_j[c] + δ_ij[c]); q, k, v Linear(C,C)
with bias.  N(i) are the k nearest points of p_i among its level's,
itself included: a stable sort of `ops.pairwise_sqdist`, ties to the
lower index, one cloud at a time.  Blocks, transitions and the head
transition as the port's docstring states them; batch norm eps 1e-5.

Departures from the paper and the reproduction, all shared with the
port: the input is xyz alone (c = 3, so the first stage's Linear reads
the coordinates); the layout is (B, n, ·), every cloud with N points, in
place of the reproduction's offset-packed (Σn, ·); FPS starts at each
cloud's point 0 and sends ties to the lower index; each level's self
k-NN is searched once and serves all of its blocks (the reproduction
searches again in each layer, with the same result); the segmentation
head stops at its last hidden layer, ReLU(BN(Linear(C0,C0))), then
dropout, and ANCSH's heads read it.

`matmul` as in `reference/model.py`: "f32" computes every product in
float32 (the forward sets TF32 off, `precision`);
"bf16" rounds as the port's bf16 trunk does (each Linear from bf16
inputs and weights, each layer's output and the attention's bf16
sums rounded to bf16; batch norm, the softmax, the weighted sum and the
xyz differences in f32); "fp8" computes each product from float8 (e4m3)
inputs and weights at a per-tensor scale, the control of a bf16
configuration.  In training mode batch norm uses the batch's
statistics and moves its running ones by `momentum`.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from posebench.reference import ops, precision
from posebench.reference.model import (ANCSH, BatchNorm, JointHead, _head,
                                       dropout, fp8_round)

BN_EPS = 1e-5
INTERP_EPS = 1e-8


def knn(k: int, xyz: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(B, M, k) indices of the k points of xyz nearest each query, by a
    stable sort of each row of squared distances, one cloud at a time."""
    return torch.cat([
        torch.sort(ops.pairwise_sqdist(queries[b:b + 1], xyz[b:b + 1]),
                   dim=-1, stable=True).indices[..., :k]
        for b in range(xyz.shape[0])])


class Rounding:
    """A matmul mode's products and roundings."""

    def __init__(self, matmul: str):
        if matmul not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown matmul mode {matmul!r}")
        self.matmul = matmul

    def linear(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        w, b = lin.weight, lin.bias
        if self.matmul == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        elif self.matmul == "bf16":
            x, w = x.bfloat16(), w.bfloat16()
            b = None if b is None else b.bfloat16()
        return F.linear(x, w, b).float()

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x.bfloat16().float() if self.matmul == "bf16" else x


class LinearBN(nn.Module):
    """Linear → batch norm → ReLU."""

    def __init__(self, cin: int, cout: int, bias: bool, r: Rounding):
        super().__init__()
        self.r = r
        self.linear = nn.Linear(cin, cout, bias=bias)
        self.bn = BatchNorm(cout, eps=BN_EPS)

    def forward(self, x, m):
        return F.relu(self.r.round(self.bn(self.r.linear(self.linear, x), m)))


class Layer(nn.Module):
    """The vector self-attention layer."""

    def __init__(self, C: int, share: int, r: Rounding):
        super().__init__()
        self.r = r
        self.share = share
        self.q = nn.Linear(C, C)
        self.k = nn.Linear(C, C)
        self.v = nn.Linear(C, C)
        self.pos = LinearBN(3, 3, True, r)
        self.pos_out = nn.Linear(3, C)
        self.w_bn = BatchNorm(C, eps=BN_EPS)
        self.w = LinearBN(C, C // share, True, r)
        self.w_out = nn.Linear(C // share, C // share)

    def forward(self, p, x, nbr, m):
        r = self.r
        B, n, k = nbr.shape
        C = x.shape[-1]
        q, key, v = (r.round(r.linear(lin, x))
                     for lin in (self.q, self.k, self.v))
        rel = ops.group_point(p, nbr) - p[:, :, None]
        delta = r.round(r.linear(self.pos_out, self.pos(rel, m)))
        a = r.round(r.round(ops.group_point(key, nbr) - q[:, :, None])
                    + delta)
        a = F.relu(r.round(self.w_bn(a, m)))
        a = r.round(r.linear(self.w_out, self.w(a, m)))
        rho = torch.softmax(a, dim=2)
        val = r.round(ops.group_point(v, nbr) + delta)
        y = (val.view(B, n, k, self.share, C // self.share)
             * rho[:, :, :, None]).sum(dim=2)
        return y.reshape(B, n, C)


class Block(nn.Module):
    def __init__(self, C: int, share: int, r: Rounding):
        super().__init__()
        self.r = r
        self.linear1 = nn.Linear(C, C, bias=False)
        self.bn1 = BatchNorm(C, eps=BN_EPS)
        self.attn = Layer(C, share, r)
        self.bn2 = BatchNorm(C, eps=BN_EPS)
        self.linear3 = nn.Linear(C, C, bias=False)
        self.bn3 = BatchNorm(C, eps=BN_EPS)

    def forward(self, p, x, nbr, m):
        r = self.r
        h = F.relu(r.round(self.bn1(r.linear(self.linear1, x), m)))
        h = F.relu(r.round(self.bn2(self.attn(p, h, nbr, m), m)))
        h = r.round(self.bn3(r.linear(self.linear3, h), m))
        return F.relu(r.round(h + x))


class TransitionDown(nn.Module):
    def __init__(self, cin: int, cout: int, r: Rounding, first: bool):
        super().__init__()
        self.r = r
        self.first = first
        self.mlp = LinearBN(3 if first else 3 + cin, cout, False, r)

    def forward(self, p, x, new_p, nbr, m):
        if self.first:
            return self.mlp(p, m)
        rel = self.r.round(ops.group_point(p, nbr) - new_p[:, :, None])
        return self.mlp(torch.cat([rel, ops.group_point(x, nbr)], -1),
                        m).amax(dim=2)


class TransitionUp(nn.Module):
    def __init__(self, cin: int, cout: int, r: Rounding, head: bool):
        super().__init__()
        self.r = r
        self.head = head
        if head:
            self.linear1 = LinearBN(2 * cin, cin, True, r)
            self.linear2 = nn.Linear(cin, cin)
        else:
            self.linear1 = LinearBN(cout, cout, True, r)
            self.linear2 = LinearBN(cin, cout, True, r)

    def forward(self, p, x, m, p_coarse=None, x_coarse=None):
        r = self.r
        if self.head:
            glob = F.relu(r.round(r.linear(self.linear2,
                                           x.mean(dim=1, keepdim=True))))
            return self.linear1(torch.cat(
                [x, glob.expand(-1, x.shape[1], -1)], -1), m)
        dist2, idx = ops.three_nn(p, p_coarse)
        w = 1.0 / (torch.sqrt(dist2) + INTERP_EPS)
        w = w / w.sum(dim=-1, keepdim=True)
        coarse = self.linear2(x_coarse, m)
        interp = r.round(r.round(ops.group_point(coarse, idx)
                                 * r.round(w)[..., None]).sum(dim=2))
        return r.round(self.linear1(x, m) + interp)


class Level(nn.Module):
    def __init__(self, transition: nn.Module, C: int, blocks: int,
                 share: int, r: Rounding):
        super().__init__()
        self.transition = transition
        self.blocks = nn.ModuleList(Block(C, share, r) for _ in range(blocks))


class PointTransformer(nn.Module):
    """(B, N, 3) -> (B, N, planes[0]).  `widths`: planes, blocks (after
    each transition down), nsample, stride, share."""

    def __init__(self, widths: Dict, dropout_rate: float, matmul: str):
        super().__init__()
        self.w = widths
        self.dropout_rate = dropout_rate
        r = Rounding(matmul)
        planes, share = widths["planes"], widths["share"]
        L = len(planes)
        cin = 3
        for i, (C, nb) in enumerate(zip(planes, widths["blocks"])):
            self.add_module(f"enc{i + 1}", Level(
                TransitionDown(cin, C, r, i == 0), C, nb, share, r))
            cin = C
        for i in reversed(range(L)):
            head = i == L - 1
            up = TransitionUp(planes[i] if head else planes[i + 1],
                              planes[i], r, head)
            self.add_module(f"dec{i + 1}", Level(up, planes[i], 1, share, r))
        self.seg = LinearBN(planes[0], planes[0], True, r)

    def forward(self, X, momentum=0.9, generator=None):
        w, m = self.w, momentum
        p: List[torch.Tensor] = [X.float().contiguous()]
        x, nbrs = [], []
        for i in range(len(w["planes"])):
            level = getattr(self, f"enc{i + 1}")
            k = w["nsample"][i]
            if i == 0:
                h = level.transition(p[0], None, None, None, m)
            else:
                new_p = ops.gather_point(p[-1], ops.farthest_point_sample(
                    p[-1].shape[1] // w["stride"], p[-1]))
                h = level.transition(p[-1], x[-1], new_p,
                                     knn(k, p[-1], new_p), m)
                p.append(new_p)
            nbrs.append(knn(k, p[-1], p[-1]))
            for block in level.blocks:
                h = block(p[-1], h, nbrs[-1], m)
            x.append(h)
        h = x[-1]
        for i in reversed(range(len(w["planes"]))):
            level = getattr(self, f"dec{i + 1}")
            if level.transition.head:
                h = level.transition(p[i], h, m)
            else:
                h = level.transition(p[i], x[i], m, p[i + 1], h)
            for block in level.blocks:
                h = block(p[i], h, nbrs[i], m)
        return dropout(self.seg(h, m), self.dropout_rate, self.training,
                       generator)


class ANCSHPointTransformer(ANCSH):
    """ANCSH's heads (`reference/model.py`) over the Point Transformer;
    its forward runs with TF32 off."""

    def __init__(self, K: int, widths: Dict, dropout_rate: float = 0.5,
                 matmul: str = "f32"):
        nn.Module.__init__(self)
        self.K = K
        self.backbone = PointTransformer(widths, dropout_rate, matmul)
        hw = widths["planes"][0]
        for i, d in enumerate([K, 3 * K, K, 3 * K, 1]):
            cin = hw
            if i == 1:
                self.add_module("fc11_1", _head(hw, 128, matmul))
                cin = 128
            self.add_module(f"fc2_{i}", _head(cin, d, matmul))
        self.joint_net = JointHead(hw, K, matmul)

    def forward(self, P, *, bn_momentum=0.9, generator=None):
        with precision(False):
            return super().forward(P, bn_momentum=bn_momentum,
                                   generator=generator)
