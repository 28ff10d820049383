"""MinkUNet34C, the sparse-voxel U-Net of Choy, Gwak and Savarese ("4D
Spatio-Temporal ConvNets: Minkowski Convolutional Neural Networks",
CVPR 2019, arXiv:1904.08755), at the widths of its reference code
(NVIDIA/MinkowskiEngine `examples/minkunet.py`, class `MinkUNet34C`,
with ME's `BasicBlock`).  It has no counterpart in the JAX package;
ANCSH's heads sit on its per-point feature (`models/ancsh.py`).

The network, from the input points down (D = len(planes) / 2 = 4):
- Voxels: stride 1 is Point Transformer V3's grid sampling
  (`models/sparse.py`): each cloud's grid floor(xyz / grid_size) minus
  its own minimum, one point kept a voxel (the one of smallest input
  index), every input point taking its voxel's output at the end.  The
  voxels at stride 2^s are each cloud's distinct floor(g / 2^s).  A
  stride stores its voxels cloud after cloud in ascending Morton code.
- Stem: a submanifold convolution, k = 5, no bias, 3 → init_dim on the
  kept points' xyz, then batch norm and ReLU (`out_p1`).
- Down s (s = 1..D): a strided convolution, kernel 2, stride 2, C → C,
  no bias: out[p] = Σ over p's children c = 2p + δ present of W[δ]·x[c];
  batch norm, ReLU; then layers[s-1] BasicBlocks to planes[s-1].
- BasicBlock: y = ReLU(BN(SubM3(ReLU(BN(SubM3(x))))) + proj(x)), SubM3 a
  submanifold convolution, k = 3, no bias; proj a 1×1 convolution
  (a Linear without bias) and batch norm where the width changes, else
  the identity.
- Up j (j = 1..D): a transposed convolution, kernel 2, stride 2: y[c]
  = W[δ(c)]·x[parent(c)], δ(c) = c − 2·parent(c); batch norm, ReLU;
  then the encoder's output at that stride concatenated after it
  (ME's `ME.cat(out, skip)`: the upsampled tensor first), and
  layers[D+j-1] BasicBlocks to planes[D+j-1].
- The last block's output (planes[-1] wide) is the per-point feature;
  ANCSH's heads read it in place of ME's `final` 1×1 convolution, after
  the dp1 dropout in training.
Batch norm's eps is 1e-5, ME's default.

Weights are 2-D.  A submanifold convolution's is (C_out, k³·C_in), the
block of offset o = ((dx + r)·k + (dy + r))·k + (dz + r), r = k // 2,
over the grid's (x, y, z) (`sparse.SubMConv3d`).  A strided
convolution's is (C_out, 8·C_in) and a transposed one's (8·C_out,
C_in), the block of child slot δ = (dx·2 + dy)·2 + dz, which is the
low three bits of the child's Morton code.

The forward first plans, then computes.  The plan depends only on the
points, and its shapes do too, so it reads the host twice
(`host_syncs`): the grid's depth, then every stride's per-cloud voxel
counts at once (each stride's clusters come from the points' Morton
keys shifted by three bits a stride).  It builds one map a stride and
reuses it, as ME's `indice_key` does: the 3³ neighbour map of each
stride, the stem's 5³ map, and between strides s and 2s each coarse
voxel's eight child slots (`children`, n where absent), which the
strided convolution gathers through and the transposed one reads the
other way (`slot`, each fine voxel's parent·8 + δ).  The feature pass
then queues its work with no host read.  A forward can therefore not
be captured whole (`capturable`); `serving.PosePredictor` runs it
eagerly and captures the fit.

Under a bf16 `dtype` every convolution runs in bf16 (a gather of the
map's rows, then one GEMM); batch norm, the residual add and ReLU
compute in f32, and every module emits `dtype`.

Instruments: spans (`utils/profiling.span`) name the host work that
launched each kernel of an eager forward: "minkunet.grid",
"minkunet.s<1,2,4,8,16>.map" (each stride's maps; stride 1's holds the
stem's), "minkunet.stem", "minkunet.down<1..4>", "minkunet.up<1..4>",
and "minkunet.<e1..e4, d1..d4>.b<j>.{c1, c2, proj}"; each convolution's
span holds its gather and its product only, its batch norm, ReLU and
residual add outside.  Counters of the last forward Python ran:
`level_points` (the voxels at each stride), `conv_pairs` (each stride's
(voxel, offset) pairs present in its 3³ map), `stem_pairs`,
`host_syncs`; `structure` holds what the benchmark compares with its
reference: each stride's per-cloud counts and its 3³ map's pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from articulated_pose_tpu_torch.models.layers import (ScheduledBatchNorm,
                                                     dropout)
from articulated_pose_tpu_torch.models.sparse import (SubMConv3d, _linear,
                                                     clusters, first_members,
                                                     gather_rows, grid_cells,
                                                     morton_keys,
                                                     neighbour_map)
from articulated_pose_tpu_torch.utils.profiling import span

BN_EPS = 1e-5
STEM_KERNEL = 5
CONV_KERNEL = 3
# a strided or transposed convolution's kernel: 2³ child slots
CHILDREN = 8


@dataclasses.dataclass(frozen=True)
class MinkUNetSpec:
    """The widths; the defaults are MinkUNet34C's (ME's
    `examples/minkunet.py`): `planes` and `layers` give each stage's
    width and BasicBlocks, the D encoder stages first, then the D
    decoder stages.  `grid_size` is in the clouds' units."""

    planes: Tuple[int, ...] = (32, 64, 128, 256, 256, 128, 96, 96)
    layers: Tuple[int, ...] = (2, 3, 4, 6, 2, 2, 2, 2)
    init_dim: int = 32
    grid_size: float = 1.0 / 256.0
    dropout_rate: float = 0.5

    def __post_init__(self):
        if not (len(self.planes) == len(self.layers)
                and len(self.planes) % 2 == 0 and self.planes):
            raise ValueError("planes and layers need one entry a stage, "
                             "as many decoder stages as encoder ones")
        if min(self.layers) < 1:
            raise ValueError(f"every stage needs a block, got {self.layers}")

    @property
    def downs(self) -> int:
        return len(self.planes) // 2

    @property
    def strides(self) -> int:
        """The voxel sets: stride 1 and one a down."""
        return self.downs + 1

    @property
    def out_features(self) -> int:
        return self.planes[-1]

    def stage_widths(self) -> List[Tuple[int, int, int, int]]:
        """(conv in, conv out, blocks in, blocks out) of each stage,
        encoder then decoder, as ME's `network_initialization` threads
        `inplanes`: a down keeps its width, an up maps to the stage's
        width, and the concatenated skip (the encoder's output at that
        stride, `init_dim` at stride 1) widens the blocks' input."""
        D, P = self.downs, self.planes
        out, inplanes = [], self.init_dim
        for s in range(D):
            out.append((inplanes, inplanes, inplanes, P[s]))
            inplanes = P[s]
        for j in range(D):
            skip = P[D - 2 - j] if D - 2 - j >= 0 else self.init_dim
            out.append((inplanes, P[D + j], P[D + j] + skip, P[D + j]))
            inplanes = P[D + j]
        return out


# trimmed widths, same modules (every stage, a projection where the width
# changes and none where it holds): CLI smokes and CPU tests
MINK_TINY_WIDTHS = dict(planes=(8, 16, 16, 16, 16, 16, 8, 8),
                        layers=(1, 2, 1, 1, 1, 1, 1, 1), init_dim=8,
                        grid_size=1.0 / 16.0)


# ------------------------------------------------------------- modules
class TransposedConv3d(nn.Linear):
    """A transposed convolution of kernel 2 and stride 2: its weight
    (8·C_out, C_in) maps each coarse voxel to its eight child slots in
    one GEMM, and each fine voxel reads its own slot (`slot`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, CHILDREN * cout, bias=False)
        self.cout = cout

    def conv(self, x: torch.Tensor, slot: torch.Tensor, dtype
             ) -> torch.Tensor:
        y = _linear(self, x, dtype).view(-1, self.cout)
        return gather_rows(y, slot)


def _bn(C: int) -> ScheduledBatchNorm:
    # normalises in f32 and emits f32: the residual add and ReLU follow
    return ScheduledBatchNorm(C, torch.float32, eps=BN_EPS)


class BasicBlock(nn.Module):
    """ME's BasicBlock on one stride's 3³ neighbour map."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.c1 = SubMConv3d(cin, cout, CONV_KERNEL, bias=False)
        self.bn1 = _bn(cout)
        self.c2 = SubMConv3d(cout, cout, CONV_KERNEL, bias=False)
        self.bn2 = _bn(cout)
        self.proj = self.proj_bn = None
        if cin != cout:
            self.proj = nn.Linear(cin, cout, bias=False)
            self.proj_bn = _bn(cout)

    def forward(self, x: torch.Tensor, nbr: torch.Tensor, m, name: str
                ) -> torch.Tensor:
        dt = self.dtype
        with span(f"{name}.c1"):
            h = self.c1.conv(x, nbr, dt)
        h = F.relu(self.bn1(h, m)).to(dt)
        with span(f"{name}.c2"):
            h = self.c2.conv(h, nbr, dt)
        h = self.bn2(h, m)
        if self.proj is None:
            return F.relu(h + x.float()).to(dt)
        with span(f"{name}.proj"):
            r = _linear(self.proj, x, dt)
        return F.relu(h + self.proj_bn(r, m)).to(dt)


class Stage(nn.Module):
    """A down (strided) or up (transposed) convolution with its batch
    norm, then the stage's BasicBlocks."""

    def __init__(self, conv: nn.Module, cout: int, cin_blocks: int,
                 width: int, blocks: int, dtype):
        super().__init__()
        self.conv = conv
        self.bn = _bn(cout)
        self.blocks = nn.ModuleList(
            BasicBlock(cin_blocks if j == 0 else width, width, dtype)
            for j in range(blocks))


@dataclasses.dataclass
class Stride:
    """The plan of one stride: its voxels (grid >> s, cloud), per-cloud
    counts, depth, 3³ neighbour map and, from stride 2 on, the finer
    stride's voxels in its child slots and each finer voxel's slot."""

    grid: torch.Tensor          # (n, 3) int64
    batch: torch.Tensor         # (n,) int64
    counts: List[int]
    depth: int
    nbr: Optional[torch.Tensor] = None       # (n, 27), n where absent
    pairs: Optional[torch.Tensor] = None     # 0-d: neighbours present
    children: Optional[torch.Tensor] = None  # (n, 8), n_finer where absent
    slot: Optional[torch.Tensor] = None      # (n_finer,) parent·8 + δ

    @property
    def n(self) -> int:
        return sum(self.counts)


@dataclasses.dataclass
class Plan:
    """What a forward computes before its features: the strides, the
    stem's map, the kept points' xyz and each input point's voxel."""

    strides: List[Stride]
    stem_nbr: torch.Tensor
    stem_pairs: torch.Tensor
    xyz: torch.Tensor           # (n0, 3) f32
    voxel: torch.Tensor         # (B·N,) stride-1 voxel of each point


class MinkUNetBackbone(nn.Module):
    """(B, N, 3) cloud -> (B, N, out_features) per-point feature."""

    # its plan reads the host (module docstring): a forward runs eagerly
    capturable = False

    def __init__(self, spec: MinkUNetSpec = MinkUNetSpec(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = s = spec
        self.dtype = dtype
        self.stem = SubMConv3d(3, s.init_dim, STEM_KERNEL, bias=False)
        self.stem_bn = _bn(s.init_dim)
        D = s.downs
        for i, (ci, co, cb, w) in enumerate(s.stage_widths()):
            if i < D:
                name = f"e{i + 1}"
                conv = SubMConv3d(ci, co, 2, bias=False)
            else:
                name = f"d{i - D + 1}"
                conv = TransposedConv3d(ci, co)
            self.add_module(name, Stage(conv, co, cb, w, s.layers[i], dtype))
        self.out_features = s.out_features
        self.level_points: List[int] = []
        self.host_syncs = 0
        self.structure: List[Dict] = []
        self._pairs: List[torch.Tensor] = []
        self._stem_pairs: Optional[torch.Tensor] = None

    # ----------------------------------------------------------- counters
    @property
    def conv_pairs(self) -> List[int]:
        """Each stride's (voxel, offset) pairs whose neighbour is present
        in the last forward's 3³ maps (read from the device when
        asked)."""
        return [int(p) for p in self._pairs]

    @property
    def stem_pairs(self) -> int:
        return 0 if self._stem_pairs is None else int(self._stem_pairs)

    def _read(self, t: torch.Tensor):
        self.host_syncs += 1
        return t.tolist()

    # --------------------------------------------------------------- plan
    def plan(self, X: torch.Tensor) -> Plan:
        """The strides' voxels and maps; its two host reads come first,
        before the device has work queued to wait for."""
        s = self.spec
        B = X.shape[0]
        L = s.strides
        with span("minkunet.grid"):
            g, batch = grid_cells(X, s.grid_size)
            depth = int(self._read(g.max())).bit_length()
            z = morton_keys(g, batch, depth)
            ids, counts = [], []
            for l in range(L):
                # past the grid's depth every cloud is one voxel
                shift = min(l, depth)
                c, k = clusters(z >> (3 * shift), 3 * (depth - shift), B)
                ids.append(c)
                counts.append(k)
            counts = self._read(torch.stack(counts))
            heads = [first_members(c, sum(k)) for c, k in zip(ids, counts)]
            strides = [Stride(g[h] >> l, batch[h], counts[l],
                              max(depth - l, 0))
                       for l, h in enumerate(heads)]
        for l, st in enumerate(strides):
            with span(f"minkunet.s{1 << l}.map"):
                if l == 0:
                    stem_nbr, stem_pairs = neighbour_map(
                        st.grid, st.batch, st.depth, STEM_KERNEL)
                st.nbr, st.pairs = neighbour_map(st.grid, st.batch, st.depth,
                                                 CONV_KERNEL)
                if l:
                    fine = strides[l - 1]
                    bit = fine.grid & 1
                    delta = (bit[:, 0] << 2) | (bit[:, 1] << 1) | bit[:, 2]
                    st.slot = ids[l][heads[l - 1]] * CHILDREN + delta
                    st.children = torch.full(
                        (st.n * CHILDREN,), fine.n,
                        device=X.device).scatter_(
                        0, st.slot, torch.arange(fine.n, device=X.device)
                    ).view(st.n, CHILDREN)
        xyz = X.reshape(-1, 3).float()[heads[0]]
        return Plan(strides, stem_nbr, stem_pairs, xyz, ids[0])

    # ------------------------------------------------------------ forward
    def forward(self, X: torch.Tensor, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """In training mode batch norm takes `bn_momentum` and dropout
        (dp1, on the output) draws from `generator`."""
        s, m, dt = self.spec, bn_momentum, self.dtype
        if X.dim() != 3 or X.shape[-1] != 3:
            raise ValueError(f"expected (B, N, 3) clouds, got "
                             f"{tuple(X.shape)}")
        B, N, _ = X.shape
        self.host_syncs = 0
        plan = self.plan(X)
        st = plan.strides
        with span("minkunet.stem"):
            h = self.stem.conv(plan.xyz, plan.stem_nbr, dt)
        h = F.relu(self.stem_bn(h, m)).to(dt)
        skips = [h]
        D = s.downs
        for i in range(1, D + 1):
            stage = getattr(self, f"e{i}")
            with span(f"minkunet.down{i}"):
                h = stage.conv.conv(h, st[i].children, dt)
            h = F.relu(stage.bn(h, m)).to(dt)
            for j, block in enumerate(stage.blocks):
                h = block(h, st[i].nbr, m, f"minkunet.e{i}.b{j}")
            skips.append(h)
        for j in range(1, D + 1):
            stage = getattr(self, f"d{j}")
            l = D - j
            with span(f"minkunet.up{j}"):
                h = stage.conv.conv(h, st[l + 1].slot, dt)
            h = torch.cat([F.relu(stage.bn(h, m)).to(dt), skips[l]], dim=1)
            for k, block in enumerate(stage.blocks):
                h = block(h, st[l].nbr, m, f"minkunet.d{j}.b{k}")
        feat = gather_rows(h, plan.voxel).view(B, N, -1)
        self._record(plan)
        return dropout(feat, s.dropout_rate, self.training, generator)

    def _record(self, plan: Plan) -> None:
        self.level_points = [st.n for st in plan.strides]
        self._pairs = [st.pairs for st in plan.strides]
        self._stem_pairs = plan.stem_pairs
        self.structure = [dict(counts=st.counts, pairs=st.pairs)
                          for st in plan.strides]
