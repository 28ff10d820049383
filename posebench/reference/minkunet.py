"""ANCSH on a MinkUNet34C backbone in plain float32 PyTorch: the
benchmark's reference of the port's `models/minkunet.py`, written from
the paper (Choy, Gwak and Savarese, "4D Spatio-Temporal ConvNets:
Minkowski Convolutional Neural Networks", CVPR 2019, arXiv:1904.08755)
and the network of its reference code (NVIDIA/MinkowskiEngine
`examples/minkunet.py`, `MinkUNet34C`, ME's `BasicBlock`).  It imports
nothing of the port and nothing of JAX; ANCSH's heads are
`reference/model.py`'s.  Parameter and buffer names are the port's, so
one state dict loads into both.

The semantics:
- voxels: each cloud's grid floor(xyz / grid_size) minus its own
  minimum; the voxels at stride 1 are `torch.unique` of the (cloud, x,
  y, z) rows, one point kept a voxel (the one of smallest input index),
  every input point taking its voxel's output at the end; the voxels at
  stride 2^s are `unique` of the (cloud, x >> 1, y >> 1, z >> 1) rows
  of stride 2^(s-1), which gives each finer voxel its parent;
- a voxel's neighbour at offset (dx, dy, dz) is the voxel of its cloud
  at its coordinates plus the offset, found by `unique` over the
  voxels' rows and the queried rows together (a queried row that
  shares its unique row with a voxel's is that voxel);
- a submanifold convolution of kernel k sums, offset by offset in the
  weight's block order o = ((dx + r)·k + (dy + r))·k + (dz + r), r = k
  // 2, each voxel's present neighbour's row times block o of its weight
  (C_out, k³·C_in);
- a strided convolution (kernel 2, stride 2) sums into each parent, slot
  by slot, each child's row times the block of its slot δ = (dx·2 + dy)·2
  + dz, (dx, dy, dz) = child − 2·parent, of its weight (C_out, 8·C_in);
  a transposed one gives each child its parent's row times the rows
  δ·C_out .. (δ+1)·C_out of its weight (8·C_out, C_in);
- the stem: a 5³ submanifold convolution of the kept points' xyz (3 →
  init_dim), batch norm (eps 1e-5), ReLU; each encoder stage a strided
  convolution, batch norm, ReLU, then BasicBlocks; each decoder stage a
  transposed convolution, batch norm, ReLU, the encoder's output at
  that stride concatenated after it, then BasicBlocks;
- a BasicBlock: ReLU(BN(conv2(ReLU(BN(conv1(x))))) + proj(x)), the
  convolutions 3³ submanifold ones, proj a Linear without bias and batch
  norm where the width changes, else x.

`matmul` as in `reference/point_transformer_v3.py`: "f32" computes every
product in float32; "bf16" rounds as the port's bf16 trunk does (each
convolution's and projection's product from bf16 inputs and weights,
its output rounded to bf16; batch norm, the residual add and ReLU in
f32, each stage's and block's output rounded to bf16); "fp8" computes
each product from float8 (e4m3) inputs at a per-tensor scale.  In
training mode batch norm uses the batch's statistics and moves its
running ones by `momentum`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from posebench.reference import precision
from posebench.reference.model import (ANCSH, BatchNorm, JointHead, _head,
                                       dropout)
from posebench.reference.point_transformer_v3 import Rounding

BN_EPS = 1e-5
STEM_KERNEL = 5


def lookup(table: torch.Tensor, queries: torch.Tensor):
    """(index of each query row among the (n, 4) table's rows, whether it
    is there), by one `unique` over both."""
    n = len(table)
    _, inv = torch.unique(torch.cat([table, queries]), dim=0,
                          return_inverse=True)
    owner = torch.full((int(inv.max()) + 1,), -1, dtype=torch.long,
                       device=table.device)
    owner[inv[:n]] = torch.arange(n, device=table.device)
    idx = owner[inv[n:]]
    return idx.clamp(min=0), idx >= 0


class RefStride:
    """One stride's voxels: (n, 4) rows (cloud, x, y, z) in `unique`'s
    order, per-cloud counts and, from stride 2 on, each finer voxel's
    parent and slot."""

    def __init__(self, rows: torch.Tensor, B: int, parent=None, slot=None):
        self.rows = rows
        self.counts = torch.bincount(rows[:, 0], minlength=B).tolist()
        self.parent, self.slot = parent, slot
        self._nbrs: Dict[int, List] = {}

    def neighbours(self, k: int):
        """For each of the k³ offsets, in the weight's block order, the
        index of each voxel's neighbour there and whether it exists."""
        if k not in self._nbrs:
            r = k // 2
            d = torch.arange(-r, r + 1, device=self.rows.device)
            offs = torch.cartesian_prod(d, d, d)          # (k³, 3), dz fastest
            offs = F.pad(offs, (1, 0))                    # the cloud's 0
            q = (self.rows[None] + offs[:, None]).reshape(-1, 4)
            idx, hit = lookup(self.rows, q)
            n = len(self.rows)
            self._nbrs[k] = [(idx[o * n:(o + 1) * n], hit[o * n:(o + 1) * n])
                             for o in range(len(offs))]
        return self._nbrs[k]

    def pairs(self, k: int) -> int:
        return int(sum(int(hit.sum()) for _, hit in self.neighbours(k)))


def structure(X: torch.Tensor, widths: Dict):
    """(strides, kept point of each stride-1 voxel, stride-1 voxel of each
    input point) of the (B, N, 3) clouds."""
    B, N, _ = X.shape
    g = torch.floor(X.float() / widths["grid_size"]).long()
    g = g - g.min(dim=1, keepdim=True).values
    b = torch.arange(B, device=X.device).repeat_interleave(N)
    rows = torch.cat([b[:, None], g.reshape(-1, 3)], dim=1)
    uniq, voxel = torch.unique(rows, dim=0, return_inverse=True)
    kept = torch.full((len(uniq),), B * N, device=X.device).scatter_reduce(
        0, voxel, torch.arange(B * N, device=X.device), "amin")
    strides = [RefStride(uniq, B)]
    for _ in range(len(widths["planes"]) // 2):
        fine = strides[-1].rows
        up = torch.cat([fine[:, :1], fine[:, 1:] >> 1], dim=1)
        coarse, parent = torch.unique(up, dim=0, return_inverse=True)
        bit = fine[:, 1:] & 1
        slot = (bit[:, 0] * 2 + bit[:, 1]) * 2 + bit[:, 2]
        strides.append(RefStride(coarse, B, parent, slot))
    return strides, kept, voxel


# ------------------------------------------------------------- modules
class SubMConv3d(nn.Linear):
    """Weight (C_out, k³·C_in); a loop over the offsets."""

    def __init__(self, cin: int, cout: int, k: int, r: Rounding):
        super().__init__(k ** 3 * cin, cout, bias=False)
        self.k, self.cin, self.r = k, cin, r

    def forward(self, x: torch.Tensor, stride: RefStride) -> torch.Tensor:
        x, w = self.r.product_inputs(x, self.weight)
        out = torch.zeros((x.shape[0], self.out_features), device=x.device)
        for o, (idx, hit) in enumerate(stride.neighbours(self.k)):
            out[hit] += x[idx[hit]] @ w[:, o * self.cin:(o + 1) * self.cin].t()
        return self.r.round(out)


class StridedConv3d(nn.Linear):
    """Kernel 2, stride 2; weight (C_out, 8·C_in); a loop over the
    child slots."""

    def __init__(self, cin: int, cout: int, r: Rounding):
        super().__init__(8 * cin, cout, bias=False)
        self.cin, self.r = cin, r

    def forward(self, x: torch.Tensor, coarse: RefStride) -> torch.Tensor:
        x, w = self.r.product_inputs(x, self.weight)
        out = torch.zeros((len(coarse.rows), self.out_features),
                          device=x.device)
        for d in range(8):
            at = coarse.slot == d
            out.index_add_(0, coarse.parent[at],
                           x[at] @ w[:, d * self.cin:(d + 1) * self.cin].t())
        return self.r.round(out)


class TransposedConv3d(nn.Linear):
    """Kernel 2, stride 2; weight (8·C_out, C_in); a loop over the child
    slots."""

    def __init__(self, cin: int, cout: int, r: Rounding):
        super().__init__(cin, 8 * cout, bias=False)
        self.cout, self.r = cout, r

    def forward(self, x: torch.Tensor, coarse: RefStride) -> torch.Tensor:
        x, w = self.r.product_inputs(x, self.weight)
        out = torch.zeros((len(coarse.parent), self.cout), device=x.device)
        for d in range(8):
            at = coarse.slot == d
            out[at] = x[coarse.parent[at]] @ w[d * self.cout:
                                               (d + 1) * self.cout].t()
        return self.r.round(out)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, r: Rounding):
        super().__init__()
        self.r = r
        self.c1 = SubMConv3d(cin, cout, 3, r)
        self.bn1 = BatchNorm(cout, eps=BN_EPS)
        self.c2 = SubMConv3d(cout, cout, 3, r)
        self.bn2 = BatchNorm(cout, eps=BN_EPS)
        self.proj = self.proj_bn = None
        if cin != cout:
            self.proj = nn.Linear(cin, cout, bias=False)
            self.proj_bn = BatchNorm(cout, eps=BN_EPS)

    def forward(self, x, stride: RefStride, m):
        r = self.r
        h = r.round(F.relu(self.bn1(self.c1(x, stride), m)))
        h = self.bn2(self.c2(h, stride), m)
        res = x if self.proj is None else self.proj_bn(
            r.linear(self.proj, x), m)
        return r.round(F.relu(h + res))


class Stage(nn.Module):
    def __init__(self, conv, cout, cin_blocks, width, blocks, r):
        super().__init__()
        self.conv = conv
        self.bn = BatchNorm(cout, eps=BN_EPS)
        self.blocks = nn.ModuleList(
            BasicBlock(cin_blocks if j == 0 else width, width, r)
            for j in range(blocks))


class MinkUNet(nn.Module):
    """(B, N, 3) -> (B, N, planes[-1]).  `widths`: the `minkunet` group
    of a configuration (planes, layers, init_dim, grid_size)."""

    def __init__(self, widths: Dict, dropout_rate: float, matmul: str):
        super().__init__()
        self.w = widths
        self.dropout_rate = dropout_rate
        self.r = r = Rounding(matmul)
        P, layers = widths["planes"], widths["layers"]
        D = len(P) // 2
        self.D = D
        init = widths["init_dim"]
        self.stem = SubMConv3d(3, init, STEM_KERNEL, r)
        self.stem_bn = BatchNorm(init, eps=BN_EPS)
        inplanes = init
        for s in range(D):
            self.add_module(f"e{s + 1}", Stage(
                StridedConv3d(inplanes, inplanes, r), inplanes, inplanes,
                P[s], layers[s], r))
            inplanes = P[s]
        for j in range(D):
            skip = P[D - 2 - j] if D - 2 - j >= 0 else init
            w = P[D + j]
            self.add_module(f"d{j + 1}", Stage(
                TransposedConv3d(inplanes, w, r), w, w + skip, w,
                layers[D + j], r))
            inplanes = w
        self.strides: List[RefStride] = []

    def forward(self, X, momentum=0.9, generator=None):
        r, m = self.r, momentum
        B, N, _ = X.shape
        strides, kept, voxel = structure(X, self.w)
        self.strides = strides
        xyz = X.reshape(-1, 3).float()[kept]
        h = r.round(F.relu(self.stem_bn(self.stem(xyz, strides[0]), m)))
        skips = [h]
        for s in range(1, self.D + 1):
            stage = getattr(self, f"e{s}")
            h = r.round(F.relu(stage.bn(stage.conv(h, strides[s]), m)))
            for block in stage.blocks:
                h = block(h, strides[s], m)
            skips.append(h)
        for j in range(1, self.D + 1):
            stage = getattr(self, f"d{j}")
            l = self.D - j
            h = r.round(F.relu(stage.bn(stage.conv(h, strides[l + 1]), m)))
            h = torch.cat([h, skips[l]], dim=1)
            for block in stage.blocks:
                h = block(h, strides[l], m)
        return dropout(h[voxel].view(B, N, -1), self.dropout_rate,
                       self.training, generator)


class ANCSHMinkUNet(ANCSH):
    """ANCSH's heads (`reference/model.py`) over MinkUNet34C; its forward
    runs with TF32 off."""

    def __init__(self, K: int, widths: Dict, dropout_rate: float = 0.5,
                 matmul: str = "f32"):
        nn.Module.__init__(self)
        self.K = K
        self.backbone = MinkUNet(widths, dropout_rate, matmul)
        hw = widths["planes"][-1]
        for i, d in enumerate([K, 3 * K, K, 3 * K, 1]):
            cin = hw
            if i == 1:
                self.add_module("fc11_1", _head(hw, 128, matmul))
                cin = 128
            self.add_module(f"fc2_{i}", _head(cin, d, matmul))
        self.joint_net = JointHead(hw, K, matmul)

    def forward(self, P, *, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None):
        with precision(False):
            return super().forward(P, bn_momentum=bn_momentum,
                                   generator=generator)
