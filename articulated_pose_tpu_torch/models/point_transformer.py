"""Point Transformer backbone (Zhao, Jiang, Jia, Torr and Koltun, ICCV
2021, arXiv:2012.09164, §3.2-3.4): per-point vector self-attention over
each point's k nearest neighbours, in an encoder of transitions down and
a decoder of transitions up, at the segmentation network's widths
(POSTECH-CVLab/point-transformer, `model/pointtransformer/
pointtransformer_seg.py`, `pointtransformer_seg_repro`).  It has no
counterpart in the JAX package; ANCSH's heads sit on its per-point
feature (`models/ancsh.py`).

The layer equations, N(i) the k nearest points of p_i among its level's
points (itself included, ties to the lower index), s = `share`:
- θ(r) = Linear(3,3) → BN → ReLU → Linear(3,C); δ_ij = θ(p_j − p_i);
- q, k, v = Linear(C,C) of x, with bias;
- a_ij = γ(k_j − q_i + δ_ij), γ = BN(C) → ReLU → Linear(C,C/s) → BN →
  ReLU → Linear(C/s,C/s);
- ρ_ij = softmax over j ∈ N(i) of a_ij;
- y_i[c] = Σ_j ρ_ij[c mod C/s] · (v_j[c] + δ_ij[c]).
A block is ReLU(BN(Linear_nb(x))), then ReLU(BN(layer)), then
ReLU(BN(Linear_nb(h)) + x); Linear_nb has no bias.  Transition down
(stride 4): FPS to n/4 points, each sampled point's k nearest as
[p_j − p_i, x_j] → Linear_nb → BN → ReLU, max over j; the first stage
(stride 1) is ReLU(BN(Linear_nb(3 → C))) of the xyz.  Transition up:
ReLU(BN(Linear(x_fine))) + interp(ReLU(BN(Linear(x_coarse)))), the
interpolation over the 3 nearest coarse points with weights 1/(d + 1e-8),
normalised, d the Euclidean distance.  The deepest level's transition
up is the head transition: ReLU(BN(Linear(2C,C)([x_i, ReLU(Linear(C,C)
(mean x))]))).  The decoder has one transition up and one block a level,
and the output is the published head's last hidden layer,
ReLU(BN(Linear(C0,C0))), then dropout (dp1).  Batch norm eps 1e-5.

Every cloud has N points, so the reproduction's offset-packed layout
becomes (B, n, ·).  Each level's self k-NN is computed once and serves
every block of the level, encoder and decoder alike (the reproduction
searches again in each layer, with the same result).  The searches run
on the `knn` kernel, FPS on the single-level kernel (B2) and the
interpolation's 3-NN on K3; a CPU tensor takes their plain versions.

Under a bf16 `dtype` the Linear layers run in bf16; batch norm, the
softmax, the attention's weighted sum and the xyz differences run in
f32, and each layer emits `dtype`.  Nothing syncs with the host, so a
forward can be captured (`compiled.py`).

Instruments: stage marks (`utils/profiling.stage`) name each stretch of
a captured forward, "ptv1.<level>.<step>": those that end a k-NN
search end in ".knn", those that end an attention layer in ".attn", a
mark before each attention layer (".pre") closes the work before it.
`knn_pairs`, `grouped_bytes`, `attention_kernel_layers` and
`attention_plain_layers` count what the last forward that Python ran
searched, materialised and dispatched: the (query, candidate) pairs of
its k-NN searches; the bytes of every tensor with a neighbour axis
(B, n, k, ·) that a step of it produced (a gather, a difference, a
Linear's, batch norm's or activation's output, the softmax, the
weighted terms), one count a step, none for an attention layer that
took the kernel; and the attention layers that took the
`vector_attention` kernel and the plain composition.  A replay repeats
that forward, so its counts are each replay's.

The attention layer after its q, k, v Linears (`attention_path`): a
CUDA input in eval mode with grad off, in bf16 or f32, launches the
`vector_attention` kernel (`ops/kernels/vector_attention.py`), one
launch a layer that writes only the layer's output; training mode, a
call that wants a gradient and a CPU tensor run the plain composition
(`PointTransformerLayer.plain`), which is the kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from articulated_pose_tpu_torch.models.layers import (ScheduledBatchNorm,
                                                     dropout)
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels import vector_attention as va
from articulated_pose_tpu_torch.ops.kernels.fps import fps
from articulated_pose_tpu_torch.ops.kernels.knn import knn
from articulated_pose_tpu_torch.ops.kernels.three_nn import three_nn
from articulated_pose_tpu_torch.utils.profiling import stage

BN_EPS = 1e-5
# the interpolation's weights 1 / (d + INTERP_EPS)
INTERP_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class PointTransformerSpec:
    """Widths of each level; the defaults are the published segmentation
    network's (pointtransformer_seg_repro): `blocks` counts the blocks
    after each level's transition down; the decoder has one a level."""

    planes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    blocks: Tuple[int, ...] = (1, 2, 3, 5, 2)
    nsample: Tuple[int, ...] = (8, 16, 16, 16, 16)
    stride: int = 4
    share: int = 8
    dropout_rate: float = 0.5

    def __post_init__(self):
        if not len(self.planes) == len(self.blocks) == len(self.nsample) > 0:
            raise ValueError("planes, blocks and nsample need one entry "
                             "per level, at least one")
        bad = [c for c in self.planes if c % self.share]
        if bad:
            raise ValueError(f"planes {bad} do not divide by share "
                             f"{self.share}")

    def level_points(self, n: int) -> List[int]:
        """The points of each level of an n-point cloud."""
        out = [n]
        for _ in self.planes[1:]:
            out.append(out[-1] // self.stride)
        return out


# trimmed widths, same modules (two levels): CLI smokes and CPU tests
# (N >= 32)
PT_TINY_WIDTHS = dict(planes=(16, 32), blocks=(1, 1), nsample=(8, 8))


# --------------------------------------------- the steps a fault may touch
def neighbours(k: int, xyz: torch.Tensor, queries: torch.Tensor
               ) -> torch.Tensor:
    """(B, M, k) indices of the k points of xyz nearest each query."""
    return knn(k, xyz, queries)[1]


def neighbour_softmax(a: torch.Tensor) -> torch.Tensor:
    """ρ: the softmax of (B, n, k, C/s) logits over the neighbours, in
    f32."""
    return torch.softmax(a.float(), dim=2)


def interp_weights(dist2: torch.Tensor) -> torch.Tensor:
    """Normalised 1 / (d + 1e-8) of the 3 nearest points' squared
    distances (B, n, 3): d is the Euclidean distance."""
    w = 1.0 / (torch.sqrt(dist2) + INTERP_EPS)
    return w / w.sum(dim=-1, keepdim=True)


class Tally:
    """The counts of one forward."""

    def __init__(self):
        self.pairs = 0
        self.grouped_bytes = 0
        self.kernel_layers = 0
        self.plain_layers = 0

    def grouped(self, t: torch.Tensor) -> torch.Tensor:
        self.grouped_bytes += t.numel() * t.element_size()
        return t

    def search(self, k: int, xyz: torch.Tensor, queries: torch.Tensor
               ) -> torch.Tensor:
        self.pairs += xyz.shape[0] * queries.shape[1] * xyz.shape[1]
        return neighbours(k, xyz, queries)


def attention_path(device: torch.device, training: bool, grad: bool,
                   dtype: torch.dtype) -> str:
    """"kernel" (`vector_attention`) for a CUDA input in eval mode with
    grad off, in bf16 or f32; "plain" otherwise."""
    if (device.type == "cuda" and not training and not grad
            and dtype in va.DTYPES):
        return "kernel"
    return "plain"


def _linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


class LinearBN(nn.Module):
    """Linear (bias or not) → batch norm (eps 1e-5) → ReLU, in `dtype`."""

    def __init__(self, cin: int, cout: int, bias: bool, dtype):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(cin, cout, bias=bias)
        self.bn = ScheduledBatchNorm(cout, dtype, eps=BN_EPS)

    def forward(self, x, m, tally: Optional[Tally] = None):
        g = tally.grouped if tally is not None else (lambda t: t)
        y = g(self.bn(g(_linear(self.linear, x, self.dtype)), m))
        return g(F.relu(y))


class PointTransformerLayer(nn.Module):
    """The vector self-attention layer over precomputed neighbours."""

    def __init__(self, C: int, share: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.share = share
        self.q = nn.Linear(C, C)
        self.k = nn.Linear(C, C)
        self.v = nn.Linear(C, C)
        self.pos = LinearBN(3, 3, True, dtype)           # θ's first half
        self.pos_out = nn.Linear(3, C)
        self.w_bn = ScheduledBatchNorm(C, dtype, eps=BN_EPS)  # γ
        self.w = LinearBN(C, C // share, True, dtype)
        self.w_out = nn.Linear(C // share, C // share)

    def forward(self, p, x, nbr, m, tally: Tally):
        dt = self.dtype
        q, key, v = (_linear(lin, x, dt) for lin in (self.q, self.k, self.v))
        if attention_path(x.device, self.training, torch.is_grad_enabled(),
                          dt) == "kernel":
            tally.kernel_layers += 1
            return va.vector_attention(self, p, q, key, v, nbr)
        tally.plain_layers += 1
        return self.plain(p, q, key, v, nbr, m, tally)

    def plain(self, p, q, key, v, nbr, m=0.9,
              tally: Optional[Tally] = None) -> torch.Tensor:
        """The layer after its q, k, v Linears as plain torch ops, every
        (B, n, k, ·) step in memory (counted on `tally`, if given); the
        `vector_attention` kernel's plain version."""
        dt = self.dtype
        g = tally.grouped if tally is not None else (lambda t: t)
        B, n, k = nbr.shape
        C = q.shape[-1]
        rel = g(g(core.group_point(p, nbr)) - p[:, :, None])   # f32
        delta = g(_linear(self.pos_out, self.pos(rel, m, tally), dt))
        a = g(g(g(core.group_point(key, nbr)) - q[:, :, None]) + delta)
        a = g(F.relu(g(self.w_bn(a, m))))
        a = g(_linear(self.w_out, self.w(a, m, tally), dt))
        rho = g(neighbour_softmax(a))                         # f32
        val = g(g(core.group_point(v, nbr)) + delta)
        terms = g(val.view(B, n, k, self.share, C // self.share)
                  * rho[:, :, :, None])                         # f32
        return terms.sum(dim=2).view(B, n, C)


class Block(nn.Module):
    """The residual bottleneck block around one attention layer."""

    def __init__(self, C: int, share: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(C, C, bias=False)
        self.bn1 = ScheduledBatchNorm(C, dtype, eps=BN_EPS)
        self.attn = PointTransformerLayer(C, share, dtype)
        self.bn2 = ScheduledBatchNorm(C, dtype, eps=BN_EPS)
        self.linear3 = nn.Linear(C, C, bias=False)
        self.bn3 = ScheduledBatchNorm(C, dtype, eps=BN_EPS)

    def forward(self, p, x, nbr, m, tally: Tally, name: str):
        dt = self.dtype
        h = F.relu(self.bn1(_linear(self.linear1, x, dt), m))
        stage(f"{name}.pre")
        y = self.attn(p, h, nbr, m, tally)
        stage(f"{name}.attn")
        h = F.relu(self.bn2(y, m))
        return F.relu(self.bn3(_linear(self.linear3, h, dt), m) + x)


class TransitionDown(nn.Module):
    """[p_j − p_i, x_j] over each sampled point's neighbours → Linear_nb →
    BN → ReLU → max over j; with no input features (the first stage),
    Linear_nb → BN → ReLU of the xyz."""

    def __init__(self, cin: int, cout: int, dtype, first: bool):
        super().__init__()
        self.dtype = dtype
        self.first = first
        self.mlp = LinearBN(3 if first else 3 + cin, cout, False, dtype)

    def forward(self, p, x, new_p, nbr, m, tally: Tally):
        if self.first:
            return self.mlp(p, m)
        g = tally.grouped
        rel = g(g(core.group_point(p, nbr)) - new_p[:, :, None])   # f32
        grouped = g(torch.cat([rel.to(self.dtype),
                               g(core.group_point(x, nbr))], dim=-1))
        return self.mlp(grouped, m, tally).amax(dim=2)


class TransitionUp(nn.Module):
    """A level's transition up from the coarser level, or, at the deepest
    level (`head`), the head transition over the level's own points."""

    def __init__(self, cin: int, cout: int, dtype, head: bool):
        super().__init__()
        self.dtype = dtype
        self.head = head
        if head:
            self.linear1 = LinearBN(2 * cin, cin, True, dtype)
            self.linear2 = nn.Linear(cin, cin)
        else:
            self.linear1 = LinearBN(cout, cout, True, dtype)
            self.linear2 = LinearBN(cin, cout, True, dtype)

    def forward(self, p, x, m, p_coarse=None, x_coarse=None):
        if self.head:
            mean = x.float().mean(dim=1, keepdim=True)
            glob = F.relu(_linear(self.linear2, mean, self.dtype))
            return self.linear1(torch.cat(
                [x.to(self.dtype), glob.expand(-1, x.shape[1], -1)], -1), m)
        dist2, idx = three_nn(p, p_coarse)
        coarse = self.linear2(x_coarse, m)
        interp = core.three_interpolate(coarse, idx, interp_weights(dist2))
        return self.linear1(x, m) + interp


class Level(nn.Module):
    """One level: its transition and its blocks."""

    def __init__(self, transition: nn.Module, C: int, blocks: int, share: int,
                 dtype):
        super().__init__()
        self.transition = transition
        self.blocks = nn.ModuleList(Block(C, share, dtype)
                                    for _ in range(blocks))


class PointTransformerBackbone(nn.Module):
    """(B, N, 3) cloud -> (B, N, planes[0]) per-point feature."""

    def __init__(self, spec: PointTransformerSpec = PointTransformerSpec(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        s = spec
        L = len(s.planes)
        cin = 3
        for i, (C, nb) in enumerate(zip(s.planes, s.blocks)):
            self.add_module(f"enc{i + 1}", Level(
                TransitionDown(cin, C, dtype, first=i == 0), C, nb, s.share,
                dtype))
            cin = C
        for i in reversed(range(L)):
            head = i == L - 1
            up = TransitionUp(s.planes[i] if head else s.planes[i + 1],
                              s.planes[i], dtype, head)
            self.add_module(f"dec{i + 1}", Level(up, s.planes[i], 1, s.share,
                                                 dtype))
        self.seg = LinearBN(s.planes[0], s.planes[0], True, dtype)
        self.out_features = s.planes[0]
        self.knn_pairs = 0
        self.grouped_bytes = 0
        self.attention_kernel_layers = 0
        self.attention_plain_layers = 0

    def forward(self, X: torch.Tensor, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In training mode batch norm takes `bn_momentum` and dropout
        (dp1, after the segmentation feature) draws from `generator`.
        Raises ValueError when a level would hold fewer points than its
        k."""
        s, m = self.spec, bn_momentum
        if X.dim() != 3 or X.shape[-1] != 3:
            raise ValueError(f"expected (B, N, 3) clouds, got "
                             f"{tuple(X.shape)}")
        sizes = s.level_points(X.shape[1])
        short = [(i + 1, n, k) for i, (n, k) in enumerate(zip(sizes,
                                                               s.nsample))
                 if n < k]
        if short:
            raise ValueError(
                f"a cloud of {X.shape[1]} points leaves levels with fewer "
                f"points than their k (level, points, k): {short}")
        tally = Tally()
        p = [X.float().contiguous()]
        x, nbrs = [], []
        for i in range(len(s.planes)):
            name = f"ptv1.e{i + 1}"
            level = getattr(self, f"enc{i + 1}")
            k = s.nsample[i]
            if i == 0:
                h = level.transition(p[0], None, None, None, m, tally)
            else:
                _, new_p = fps(p[-1], sizes[i])
                stage(f"{name}.fps")
                td = tally.search(k, p[-1], new_p)
                stage(f"{name}.td.knn")
                h = level.transition(p[-1], x[-1], new_p, td, m, tally)
                p.append(new_p)
            stage(f"{name}.td")
            nbrs.append(tally.search(k, p[-1], p[-1]))
            stage(f"{name}.knn")
            for j, block in enumerate(level.blocks):
                h = block(p[-1], h, nbrs[-1], m, tally, f"{name}.b{j + 1}")
            x.append(h)
        h = x[-1]
        for i in reversed(range(len(s.planes))):
            name = f"ptv1.d{i + 1}"
            level = getattr(self, f"dec{i + 1}")
            if level.transition.head:
                h = level.transition(p[i], h, m)
            else:
                h = level.transition(p[i], x[i], m, p[i + 1], h)
            stage(f"{name}.up")
            for j, block in enumerate(level.blocks):
                h = block(p[i], h, nbrs[i], m, tally, f"{name}.b{j + 1}")
        feat = self.seg(h, m)
        stage("ptv1.out")
        self.knn_pairs = tally.pairs
        self.grouped_bytes = tally.grouped_bytes
        self.attention_kernel_layers = tally.kernel_layers
        self.attention_plain_layers = tally.plain_layers
        return dropout(feat, s.dropout_rate, self.training, generator)
