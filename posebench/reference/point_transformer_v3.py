"""ANCSH on a Point Transformer V3 backbone in plain float32 PyTorch: the
benchmark's reference of the port's `models/point_transformer_v3.py`,
written from the paper (Wu et al., "Point Transformer V3: Simpler,
Faster, Stronger", CVPR 2024, arXiv:2312.10035) and the semantics of its
reference implementation (Pointcept, `point_transformer_v3m1_base.py`,
`serialization/`, the base model of `semseg-pt-v3m1-0-base.py`).  It
imports nothing of the port and nothing of JAX; ANCSH's heads are
`reference/model.py`'s.  Parameter and buffer names are the port's, so
one state dict loads into both.

The semantics, as Pointcept computes them:
- grid sampling: each cloud's grid floor(xyz / grid_size) minus its
  own minimum; one point a voxel, the one of smallest input index;
  every input point takes its voxel's output at the end;
- serialization: depth = bit_length(the batch's largest grid
  coordinate); codes z (Morton, x's bit i at bit 3i+2, y's at 3i+1, z's
  at 3i), z-trans (the Morton code of (y, x, z)), hilbert (Pointcept's
  `hilbert.encode`: the bits of each coordinate, most significant
  first, put through Skilling's exchange-and-invert pass, interleaved
  x, y, z, then turned from Gray code to binary) and hilbert-trans (of
  (y, x, z)), each with the cloud's index above the 3·depth code bits;
  the code rows are permuted by the level's shuffle (row i of the new
  list is row perm[i] of the old) and each order is its row's argsort;
- the stem: a 5×5×5 submanifold convolution without bias (3 → C0),
  batch norm (eps 1e-3), GELU;
- a block: x += LN(Linear(SubMConv3d_k3(x))); x += proj(attention of
  LN1(x)); x += fc2(GELU(fc1(LN2(x)))), LayerNorm eps 1e-5;
- the attention of block j reads order row j % 4; its padding is
  Pointcept's `SerializedAttention.get_padding_and_inverse` with patch
  size K, written out below (`padding`); each sequence's softmax(q kᵀ ·
  head_dim^-0.5) v, one sequence at a time (its heads together);
- pooling: codes >> 3, `unique` of row 0 gives the clusters (sorted),
  each cluster's first member (in a stable sort) its head; features a
  Linear then the max over the cluster, batch norm, GELU; grid >> 1;
  the head's code rows, argsorted, then permuted by the shuffle;
- unpooling: GELU(BN(Linear(skip))) + GELU(BN(Linear(coarse)))[cluster].

The departures, shared with the port: one point a voxel is the one of
smallest index (Pointcept's training picks one at random); the shuffle
of the orders is data handed to the model (`shuffle`), not a draw of
each forward; a level's voxels are stored cloud after cloud, level 0 in
ascending Morton code and a pooled level in ascending code of its
parent's first order (Pointcept stores level 0 in its hash order, which
changes no result); the input feature is xyz (c = 3).

The submanifold convolution is a loop over the k³ offsets (dx, dy, dz)
in the weight's block order o = ((dx + r)·k + (dy + r))·k + (dz + r):
each voxel's neighbour at that offset found by a `searchsorted` of its
Morton key among the level's sorted Morton keys, and its rows times the
weight's block o summed in.

`matmul` as in `reference/point_transformer.py`: "f32" computes every
product in float32; "bf16" rounds as the port's bf16 trunk does (each
Linear, convolution and attention product from bf16 inputs and weights,
the LayerNorm's weights in bf16, each module's output rounded to bf16;
norms, GELU and the softmax computed in f32); "fp8" computes each
product from float8 (e4m3) inputs at a per-tensor scale.  In training
mode batch norm uses the batch's statistics and moves its running ones
by `momentum`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from posebench.reference import precision
from posebench.reference.model import (ANCSH, BatchNorm, JointHead, _head,
                                       dropout, fp8_round)

BN_EPS = 1e-3
LN_EPS = 1e-5
STEM_KERNEL = 5
CPE_KERNEL = 3
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


# ------------------------------------------------------------ the codes
def morton(grid: torch.Tensor, depth: int) -> torch.Tensor:
    """(n,) Morton codes of an (n, 3) integer grid, bit by bit."""
    code = torch.zeros(grid.shape[0], dtype=torch.int64, device=grid.device)
    x, y, z = grid.long().unbind(1)
    for i in range(depth):
        code |= ((x >> i) & 1) << (3 * i + 2)
        code |= ((y >> i) & 1) << (3 * i + 1)
        code |= ((z >> i) & 1) << (3 * i)
    return code


def hilbert(grid: torch.Tensor, depth: int) -> torch.Tensor:
    """(n,) Hilbert codes of an (n, 3) integer grid, as Pointcept's
    `hilbert.encode(grid, num_dims=3, num_bits=depth)` computes them, on
    a tensor of bits."""
    n = grid.shape[0]
    shifts = torch.arange(depth - 1, -1, -1, device=grid.device)
    # bits[p, d, b]: bit b (most significant first) of coordinate d
    bits = ((grid.long()[:, :, None] >> shifts) & 1).bool()
    for b in range(depth):
        for d in range(3):
            on = bits[:, d, b]
            low = slice(b + 1, depth)
            bits[:, 0, low] ^= on[:, None]
            flip = ~on[:, None] & (bits[:, 0, low] ^ bits[:, d, low])
            bits[:, d, low] ^= flip
            bits[:, 0, low] ^= flip
    gray = bits.transpose(1, 2).reshape(n, 3 * depth)
    binary = torch.cumsum(gray.long(), dim=1) % 2      # Gray to binary
    weights = 2 ** torch.arange(3 * depth - 1, -1, -1, device=grid.device)
    return (binary * weights).sum(dim=1)


def encode(grid: torch.Tensor, batch: torch.Tensor, depth: int,
           order: str) -> torch.Tensor:
    g = grid if order in ("z", "hilbert") else grid[:, [1, 0, 2]]
    code = morton(g, depth) if order.startswith("z") else hilbert(g, depth)
    return (batch.long() << (3 * depth)) | code


# ------------------------------------------------------------ a level
class RefLevel:
    """A level as Pointcept holds it: grid, cloud index, depth, the code
    rows in its permuted list, their orders and inverses, per-cloud
    counts, the padding of its patches and, for a pooled level, the
    finer level's cluster of each finer voxel."""

    def __init__(self, grid, batch, depth, code, B, K, cluster=None):
        self.grid, self.batch, self.depth = grid, batch, depth
        self.code = code
        self.order = torch.argsort(code, dim=1)
        self.inverse = torch.argsort(self.order, dim=1)
        self.counts = torch.bincount(batch, minlength=B).tolist()
        self.pad, self.unpad, self.cu_seqlens = padding(self.counts, K,
                                                        grid.device)
        self.cluster = cluster
        self._nbrs: Dict[int, List] = {}

    def neighbours(self, k: int):
        """For each of the k³ offsets, in the weight's block order, the
        index of each voxel's neighbour there and whether it exists."""
        if k not in self._nbrs:
            keys = encode(self.grid, self.batch, self.depth, "z")
            sorted_keys, idx = torch.sort(keys)
            r = k // 2
            out = []
            for dx in range(-r, r + 1):
                for dy in range(-r, r + 1):
                    for dz in range(-r, r + 1):
                        g = self.grid + torch.tensor([dx, dy, dz],
                                                     device=self.grid.device)
                        inside = ((g >= 0) & (g < (1 << self.depth))).all(1)
                        q = encode(g.clamp(min=0), self.batch, self.depth,
                                   "z")
                        pos = torch.searchsorted(sorted_keys, q).clamp(
                            max=len(keys) - 1)
                        hit = inside & (sorted_keys[pos] == q)
                        out.append((idx[pos], hit))
            self._nbrs[k] = out
        return self._nbrs[k]


def padding(counts: Sequence[int], K: int, device):
    """Pointcept's `get_padding_and_inverse` for clouds of `counts`
    points and patches of K: (pad, unpad, cu_seqlens)."""
    bincount = torch.tensor(counts, dtype=torch.int64)
    bincount_pad = (bincount + K - 1) // K * K
    mask_pad = bincount > K
    bincount_pad = torch.where(mask_pad, bincount_pad, bincount)
    _offset = F.pad(torch.cumsum(bincount, 0), (1, 0))
    _offset_pad = F.pad(torch.cumsum(bincount_pad, 0), (1, 0))
    pad = torch.arange(int(_offset_pad[-1]))
    unpad = torch.arange(int(_offset[-1]))
    cu_seqlens = []
    for i in range(len(counts)):
        unpad[_offset[i]:_offset[i + 1]] += _offset_pad[i] - _offset[i]
        if bincount[i] != bincount_pad[i]:
            r = int(bincount[i] % K)
            end = int(_offset_pad[i + 1])
            pad[end - K + r:end] = pad[end - 2 * K + r:end - K].clone()
        pad[_offset_pad[i]:_offset_pad[i + 1]] -= _offset_pad[i] - _offset[i]
        cu_seqlens.append(torch.arange(int(_offset_pad[i]),
                                       int(_offset_pad[i + 1]), K))
    cu_seqlens = F.pad(torch.cat(cu_seqlens), (0, 1),
                       value=int(_offset_pad[-1]))
    return pad.to(device), unpad.to(device), cu_seqlens.tolist()


def permuted(code: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    return code[list(perm)]


def structure(X: torch.Tensor, widths: Dict,
              shuffle: Optional[Sequence[Sequence[int]]] = None):
    """(levels, kept point of each level-0 voxel, level-0 voxel of each
    input point) of the (B, N, 3) clouds."""
    B, N, _ = X.shape
    L = len(widths["enc_channels"])
    K = widths["patch_size"]
    shuffle = shuffle if shuffle is not None else [range(4)] * L
    grids, kept, voxel_of = [], [], []
    for b in range(B):
        g = torch.floor(X[b].float() / widths["grid_size"]).long()
        g = g - g.min(dim=0).values
        uniq, inv = torch.unique(g, dim=0, return_inverse=True)
        first = torch.full((len(uniq),), N, device=X.device).scatter_reduce(
            0, inv, torch.arange(N, device=X.device), "amin")
        grids.append(g)
        kept.append(b * N + first)
        voxel_of.append(inv)
    grid_all = torch.cat(grids)
    depth = int(grid_all.max()).bit_length()
    kept = torch.cat(kept)
    grid, batch = grid_all[kept], kept // N
    # level 0 in ascending Morton code, cloud after cloud
    rank = torch.argsort(encode(grid, batch, depth, "z"))
    kept, grid, batch = kept[rank], grid[rank], batch[rank]
    where = torch.empty_like(rank)
    where[rank] = torch.arange(len(rank), device=X.device)
    starts = [0]
    for b in range(B - 1):
        starts.append(starts[-1] + int(voxel_of[b].max()) + 1)
    voxel = torch.cat([where[starts[b] + voxel_of[b]] for b in range(B)])
    code = torch.stack([encode(grid, batch, depth, o) for o in ORDERS])
    levels = [RefLevel(grid, batch, depth, permuted(code, shuffle[0]), B, K)]
    for l in range(1, L):
        lv = levels[-1]
        shift = (widths["stride"][l - 1] - 1).bit_length()
        if shift > lv.depth:
            shift = 0
        code = lv.code >> (3 * shift)
        _, cluster = torch.unique(code[0], sorted=True, return_inverse=True)
        idx = torch.sort(cluster, stable=True).indices
        counts = torch.bincount(cluster)
        head = idx[F.pad(torch.cumsum(counts, 0), (1, 0))[:-1]]
        levels.append(RefLevel(
            lv.grid[head] >> shift, lv.batch[head], lv.depth - shift,
            permuted(code[:, head], shuffle[l]), B, K, cluster))
    return levels, kept, voxel


# ------------------------------------------------------------- modules
class Rounding:
    """A matmul mode's products and roundings."""

    def __init__(self, matmul: str):
        if matmul not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown matmul mode {matmul!r}")
        self.matmul = matmul

    def product_inputs(self, *ts):
        if self.matmul == "fp8":
            return tuple(fp8_round(t) for t in ts)
        if self.matmul == "bf16":
            return tuple(t.bfloat16().float() for t in ts)
        return ts

    def linear(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        x, w = self.product_inputs(x, lin.weight)
        b = lin.bias
        if b is not None and self.matmul == "bf16":
            b = self.round(b)
        return self.round(F.linear(x, w, b))

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x.bfloat16().float() if self.matmul == "bf16" else x

    def norm(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return self.round(F.layer_norm(x, ln.normalized_shape,
                                       self.round(ln.weight),
                                       self.round(ln.bias), ln.eps))


class SubMConv3d(nn.Linear):
    """Weight (C_out, k³·C_in); a loop over the offsets."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool, r: Rounding):
        super().__init__(k ** 3 * cin, cout, bias=bias)
        self.k, self.cin, self.r = k, cin, r

    def forward(self, x: torch.Tensor, level: RefLevel) -> torch.Tensor:
        x, w = self.r.product_inputs(x, self.weight)
        out = torch.zeros((x.shape[0], self.out_features), device=x.device)
        for o, (idx, hit) in enumerate(level.neighbours(self.k)):
            w_o = w[:, o * self.cin:(o + 1) * self.cin]
            out[hit] += x[idx[hit]] @ w_o.t()
        if self.bias is not None:
            out = out + self.r.round(self.bias)
        return self.r.round(out)


class SerializedAttention(nn.Module):
    def __init__(self, C: int, heads: int, r: Rounding):
        super().__init__()
        self.r, self.heads = r, heads
        self.qkv = nn.Linear(C, 3 * C)
        self.proj = nn.Linear(C, C)

    def forward(self, x: torch.Tensor, level: RefLevel, j: int):
        r, H = self.r, self.heads
        C = x.shape[1]
        d = C // H
        row = j % level.order.shape[0]
        order = level.order[row][level.pad]
        inverse = level.unpad[level.inverse[row]]
        qkv = r.linear(self.qkv, x)[order].view(-1, 3, H, d)
        feat = torch.empty((len(order), H, d), device=x.device)
        cu = level.cu_seqlens
        for s in range(len(cu) - 1):
            seq = slice(cu[s], cu[s + 1])
            q, k, v = (qkv[seq, i].transpose(0, 1) for i in range(3))
            q, k = r.product_inputs(q, k)
            p = torch.softmax((q @ k.transpose(1, 2)) * d ** -0.5, dim=-1)
            p, v = r.product_inputs(p, v)
            feat[seq] = (p @ v).transpose(0, 1)
        return r.linear(self.proj, r.round(feat.view(-1, C)[inverse]))


class Block(nn.Module):
    def __init__(self, C: int, heads: int, mlp_ratio: int, k: int,
                 r: Rounding):
        super().__init__()
        self.r = r
        self.cpe = SubMConv3d(C, C, k, True, r)
        self.cpe_linear = nn.Linear(C, C)
        self.cpe_norm = nn.LayerNorm(C, eps=LN_EPS)
        self.norm1 = nn.LayerNorm(C, eps=LN_EPS)
        self.attn = SerializedAttention(C, heads, r)
        self.norm2 = nn.LayerNorm(C, eps=LN_EPS)
        self.fc1 = nn.Linear(C, mlp_ratio * C)
        self.fc2 = nn.Linear(mlp_ratio * C, C)

    def forward(self, x, level: RefLevel, j: int):
        r = self.r
        h = r.norm(self.cpe_norm, r.linear(self.cpe_linear,
                                           self.cpe(x, level)))
        x = r.round(x + h)
        x = r.round(x + self.attn(r.norm(self.norm1, x), level, j))
        h = r.round(F.gelu(r.linear(self.fc1, r.norm(self.norm2, x))))
        return r.round(x + r.linear(self.fc2, h))


class LinearBNGELU(nn.Module):
    def __init__(self, cin: int, cout: int, r: Rounding):
        super().__init__()
        self.r = r
        self.linear = nn.Linear(cin, cout)
        self.bn = BatchNorm(cout, eps=BN_EPS)

    def forward(self, x, m, cluster=None):
        y = self.r.linear(self.linear, x)
        if cluster is not None:
            y = torch.zeros((int(cluster.max()) + 1, y.shape[1]),
                            device=y.device).scatter_reduce(
                0, cluster[:, None].expand_as(y), y, "amax",
                include_self=False)
        return self.r.round(F.gelu(self.r.round(self.bn(y, m))))


class EncoderLevel(nn.Module):
    def __init__(self, pool, C, depth, heads, mlp_ratio, k, r):
        super().__init__()
        self.pool = pool
        self.blocks = nn.ModuleList(Block(C, heads, mlp_ratio, k, r)
                                    for _ in range(depth))


class DecoderLevel(nn.Module):
    def __init__(self, cin, skip, C, depth, heads, mlp_ratio, k, r):
        super().__init__()
        self.proj = LinearBNGELU(cin, C, r)
        self.skip = LinearBNGELU(skip, C, r)
        self.blocks = nn.ModuleList(Block(C, heads, mlp_ratio, k, r)
                                    for _ in range(depth))


class PointTransformerV3(nn.Module):
    """(B, N, 3) -> (B, N, out) under `shuffle` (one permutation of the
    four orders a level; None keeps the canonical order).  `widths`:
    the `point_transformer_v3` group of a configuration."""

    def __init__(self, widths: Dict, dropout_rate: float, matmul: str,
                 shuffle=None):
        super().__init__()
        self.w = widths
        self.dropout_rate = dropout_rate
        self.shuffle = shuffle
        self.r = r = Rounding(matmul)
        enc, dec = widths["enc_channels"], widths["dec_channels"]
        mr, k = widths["mlp_ratio"], CPE_KERNEL
        self.stem = SubMConv3d(3, enc[0], STEM_KERNEL, False, r)
        self.stem_bn = BatchNorm(enc[0], eps=BN_EPS)
        for l in range(len(enc)):
            pool = LinearBNGELU(enc[l - 1], enc[l], r) if l else None
            self.add_module(f"enc{l}", EncoderLevel(
                pool, enc[l], widths["enc_depths"][l],
                widths["enc_heads"][l], mr, k, r))
        outs = list(dec) + [enc[-1]]
        for l in reversed(range(len(enc) - 1)):
            self.add_module(f"dec{l}", DecoderLevel(
                outs[l + 1], enc[l], outs[l], widths["dec_depths"][l],
                widths["dec_heads"][l], mr, k, r))
        self.levels: List[RefLevel] = []

    def forward(self, X, momentum=0.9, generator=None):
        r, m = self.r, momentum
        B, N, _ = X.shape
        levels, kept, voxel = structure(X, self.w, self.shuffle)
        self.levels = levels
        xyz = X.reshape(-1, 3).float()[kept]
        h = r.round(F.gelu(r.round(self.stem_bn(self.stem(xyz, levels[0]),
                                                m))))
        skips = []
        for l, lv in enumerate(levels):
            enc = getattr(self, f"enc{l}")
            if enc.pool is not None:
                h = enc.pool(h, m, lv.cluster)
            for j, block in enumerate(enc.blocks):
                h = block(h, lv, j)
            skips.append(h)
        for l in reversed(range(len(levels) - 1)):
            dec = getattr(self, f"dec{l}")
            h = r.round(dec.skip(skips[l], m)
                        + dec.proj(h, m)[levels[l + 1].cluster])
            for j, block in enumerate(dec.blocks):
                h = block(h, levels[l], j)
        return dropout(h[voxel].view(B, N, -1), self.dropout_rate,
                       self.training, generator)


class ANCSHPointTransformerV3(ANCSH):
    """ANCSH's heads (`reference/model.py`) over Point Transformer V3,
    under the order shuffle `shuffle`; its forward runs with TF32
    off."""

    def __init__(self, K: int, widths: Dict, dropout_rate: float = 0.5,
                 matmul: str = "f32", shuffle=None):
        nn.Module.__init__(self)
        self.K = K
        self.backbone = PointTransformerV3(widths, dropout_rate, matmul,
                                           shuffle)
        hw = (list(widths["dec_channels"]) or widths["enc_channels"])[0]
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
