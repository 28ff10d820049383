"""Point Transformer V3 backbone (Wu, Jiang, Wang, Liu, Liu, Qiao, Ouyang,
He and Zhao, "Point Transformer V3: Simpler, Faster, Stronger", CVPR
2024, arXiv:2312.10035) at the widths of its reference implementation
(Pointcept, `pointcept/models/point_transformer_v3/
point_transformer_v3m1_base.py` with `configs/scannet/
semseg-pt-v3m1-0-base.py`).  It has no counterpart in the JAX package;
ANCSH's heads sit on its per-point feature (`models/ancsh.py`).

The network, from the input points down:
- Grid sampling: each cloud's grid is floor(xyz / grid_size) minus the
  cloud's own minimum; one point is kept a voxel, the one of smallest
  input index, and every input point remembers its voxel, whose output
  it takes at the end.  A level stores its voxels cloud after cloud;
  level 0 in ascending Morton code.
- Serialization: depth = bit_length(largest grid coordinate of the
  batch); four codes a voxel, in the canonical order (z, z-trans,
  hilbert, hilbert-trans), each with the cloud's index above its
  3·depth code bits.  z is the Morton code, x's bit i at bit 3i+2, y's
  at 3i+1, z's at 3i (OCNN's interleave, as Pointcept's `z_order.py`);
  z-trans the Morton code of (y, x, z); hilbert Skilling's transform of
  (x, y, z) ("Programming the Hilbert curve", AIP Conf. Proc. 707, 2004,
  the transform of Pointcept's `hilbert.py`, run as a state machine
  over the Morton code's octal digits), its transposed bits
  interleaved as the Morton code's; hilbert-trans that of (y, x, z).  A
  code >> 3 is the parent voxel's code at half the resolution.  Each
  order is the argsort of its code, with its inverse.
- The level's list of orders is the canonical one permuted by the
  level's shuffle: `shuffle[0]` at the serialization and `shuffle[l]`
  at the pooling into level l, each applied to the list it finds
  (new[i] = old[perm[i]]), as Pointcept's `shuffle_orders` permutes the
  code rows.  The shuffle is data (`draw_shuffle`), so a served forward
  repeats itself; without one every level keeps the canonical list.
- Stem: a submanifold 3-D convolution, k=5, no bias, 3 → C0 on the
  kept points' xyz, then batch norm (eps 1e-3) and GELU (exact).
- Block (pre-norm): x += LN(Linear(SubMConv_k3(x))) (the xCPE), x +=
  Attn(LN1(x)), x += Linear(GELU(Linear(LN2(x)))) (4C wide); LayerNorm
  eps 1e-5; drop path and dropout are the identity when serving.
- Attention: qkv one Linear with bias, head dim C / heads, scale
  head_dim^-0.5, then a Linear projection.  Block j of a level takes
  order j % 4 of the level's list.  Serialized patches of K points
  (`patch_layout`, Pointcept's `get_padding_and_inverse`): a cloud of at
  most K points is one sequence of its own length; a longer one is
  padded to a multiple of K, the last short patch filled with copies of
  the points before it, which its real points attend to; every
  position reads its output back from its first occurrence.
- Pooling (stride 2): the codes >> 3, `unique` on the code of the
  level's first order gives the clusters, stored in that code's
  ascending order; features Linear(C_in, C_out), a max over each
  cluster, batch norm, GELU; grid >> 1; the cluster's codes and its
  orders those of its first member.
- Unpooling (the map backend): GELU(BN(Linear(skip))) of the finer
  level plus GELU(BN(Linear(coarse))) of each finer voxel's cluster.
- The decoder's last level is 64 wide; every input point takes its
  voxel's feature, then dropout (dp1) in training.

A submanifold convolution's weight is 2-D, (C_out, k³·C_in): the block
of columns o·C_in .. (o+1)·C_in multiplies the neighbour at offset
(dx, dy, dz), o = ((dx + r)·k + (dy + r))·k + (dz + r), r = k // 2,
over the grid's (x, y, z); a voxel's output sums the neighbours present
in its own cloud (the grid sampling, the maps and the convolution are
`models/sparse.py`'s, shared with MinkUNet).  The neighbour map of a
level (Pointcept's `indice_key`) is built once and serves every block
of the level, encoder and decoder alike; the stem's 5×5×5 map is its
own.  A map is a `searchsorted` of each voxel's k³ neighbour keys in
the level's sorted keys, and the convolution one GEMM over the gathered
(n, k³·C) rows (an absent neighbour reads a zero row).

The forward first plans, then computes.  The plan (grid, codes,
orders, pooling clusters, patch layouts, neighbour maps) depends only
on the points; its shapes depend on them too, so it reads the host:
the depth and each level's per-cloud counts of voxels, which give the
size of its `unique` (`host_syncs` counts these reads, 1 + L a
forward).  The feature pass then queues its
work with no host read.  A forward of this backbone can therefore not
be captured whole (`capturable`); `serving.PosePredictor` runs it
eagerly and captures the fit.

Under a bf16 `dtype` every Linear, convolution and the attention run
in bf16, LayerNorm, batch norm and GELU compute in f32, and every
module emits `dtype`.  The attention is torch's fused attention
(`F.scaled_dot_product_attention`, flash-attention or the
memory-efficient kernel, `ATTENTION_BACKENDS`): a level whose sequences
all hold K points runs unmasked, else its shorter sequences are padded
to the longest with their key slots masked.

Instruments: spans (`utils/profiling.span`) name the host work that
launched each kernel of an eager forward: "ptv3.grid", "ptv3.serialize",
"ptv3.stem", "ptv3.<e0..e4>.nbr" (a level's neighbour map),
"ptv3.<e1..e4>.pool" (the pooling's plan and its features),
"ptv3.<e0..e4, d3..d0>.b<j>.{cpe, attn, mlp}" and
"ptv3.<d3..d0>.unpool".  Counters of the last forward Python ran:
`level_points` and `sequences` (each level's sequence lengths),
`pad_points` (each level's padding copies), `cpe_pairs` (each level's
(voxel, offset) pairs with a neighbour present; `stem_pairs` the
stem's), `host_syncs`; `structure` holds what the benchmark compares
with its reference: each level's per-cloud counts, its list's orders
and PTv3's padding index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from articulated_pose_tpu_torch.models.layers import (ScheduledBatchNorm,
                                                     dropout)
from articulated_pose_tpu_torch.models.sparse import (SubMConv3d, _cast,
                                                     _linear, clusters,
                                                     first_members,
                                                     gather_rows, grid_cells,
                                                     interleave, morton_keys,
                                                     neighbour_map, spread3)
from articulated_pose_tpu_torch.utils.profiling import span

BN_EPS = 1e-3
LN_EPS = 1e-5
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
# the stem's and the xCPE's kernels (Pointcept's Embedding and Block)
STEM_KERNEL = 5
CPE_KERNEL = 3
# the fused attention's kernels: flash-attention, else the memory-
# efficient kernel (a masked level), built with torch; cuDNN's is left
# out, since it builds a plan for each new shape (a level's sequence
# count follows the points), which stalled served calls by up to 1.2 s
ATTENTION_BACKENDS = [SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


@dataclasses.dataclass(frozen=True)
class PointTransformerV3Spec:
    """The widths; the defaults are PTv3's base model (Pointcept's
    `point_transformer_v3m1_base.py`, semseg-pt-v3m1-0-base): the
    decoder's level l (l = L-2 .. 0) is `dec_channels[l]` wide and reads
    level l + 1 of the decoder (the encoder's last level first).
    `grid_size` is in the clouds' units."""

    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_heads: Tuple[int, ...] = (2, 4, 8, 16, 32)
    dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_heads: Tuple[int, ...] = (4, 4, 8, 16)
    patch_size: int = 1024
    stride: Tuple[int, ...] = (2, 2, 2, 2)
    mlp_ratio: int = 4
    grid_size: float = 1.0 / 256.0
    dropout_rate: float = 0.5

    def __post_init__(self):
        L = len(self.enc_channels)
        if not (L > 0 and len(self.enc_depths) == len(self.enc_heads) == L
                and len(self.dec_channels) == len(self.dec_depths)
                == len(self.dec_heads) == len(self.stride) == L - 1):
            raise ValueError("enc_* need one entry a level, dec_* and stride "
                             "one a level but the last")
        widths = list(zip(self.enc_channels, self.enc_heads)) + list(
            zip(self.dec_channels, self.dec_heads))
        bad = [(c, h) for c, h in widths if c % h]
        if bad:
            raise ValueError(f"channels do not divide by heads: {bad}")
        if any(s < 2 or s & (s - 1) for s in self.stride):
            raise ValueError(f"strides must be powers of two, got "
                             f"{self.stride}")

    @property
    def levels(self) -> int:
        return len(self.enc_channels)

    @property
    def out_features(self) -> int:
        return self.dec_channels[0] if self.dec_channels else \
            self.enc_channels[0]


# trimmed widths, same modules (three levels, a level of five blocks so
# every order of its list is taken): CLI smokes and CPU tests
PTV3_TINY_WIDTHS = dict(enc_channels=(16, 32, 32), enc_depths=(1, 5, 1),
                        enc_heads=(2, 4, 4), dec_channels=(16, 32),
                        dec_depths=(1, 1), dec_heads=(2, 4), patch_size=16,
                        stride=(2, 2), grid_size=1.0 / 16.0)


# ------------------------------------------------------------ the codes
def _hilbert_table() -> List[int]:
    """Skilling's transform as a state machine over a Morton code's
    octal digits, most significant first.  A state is the signed
    permutation of the axes (perm, flips) that the exchanges and
    inversions of the higher levels apply to every lower bit; the
    digit's transposed bits are its bits under that permutation, and
    the level's own exchanges and inversions give the next state.  Entry
    state·8 + digit holds next state·8 + the transposed bits (48 states
    are reachable)."""
    states = [((0, 1, 2), (0, 0, 0))]
    table: Dict[int, int] = {}
    for s, (perm, flips) in enumerate(states):
        for digit in range(8):
            bits = ((digit >> 2) & 1, (digit >> 1) & 1, digit & 1)
            t = [bits[perm[j]] ^ flips[j] for j in range(3)]
            p, f = list(perm), list(flips)
            for i in range(3):
                if t[i]:                               # invert X0
                    f[0] ^= 1
                else:                                  # exchange X0, Xi
                    p[0], p[i], f[0], f[i] = p[i], p[0], f[i], f[0]
            nxt = (tuple(p), tuple(f))
            if nxt not in states:
                states.append(nxt)
            table[s * 8 + digit] = (states.index(nxt) * 8
                                    + ((t[0] << 2) | (t[1] << 1) | t[2]))
    return [table[k] for k in range(len(states) * 8)]


# the levels of a code the Hilbert state machine takes in one step
HILBERT_STEP = 3


def hilbert_table(levels: int) -> torch.Tensor:
    """The state machine over `levels` octal digits at once: entry
    state·8^levels + digits holds next state·8^levels + the digits'
    transposed bits, composed from `_hilbert_table`'s single levels."""
    one = _hilbert_table()
    width = 8 ** levels
    out = []
    for s in range(len(one) // 8):
        for digits in range(width):
            state, bits = s, 0
            for k in reversed(range(levels)):
                v = one[state * 8 + ((digits >> (3 * k)) & 7)]
                bits, state = (bits << 3) | (v & 7), v >> 3
            out.append(state * width + bits)
    return torch.tensor(out, dtype=torch.int64)


def hilbert_from_morton(m: torch.Tensor, depth: int,
                        tables: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The Hilbert codes of the cells whose Morton codes (of depth
    levels, no cloud bits) are m: the state machine's transposed bits,
    the leading depth % HILBERT_STEP levels one at a time (`tables[1]`)
    and then HILBERT_STEP at a time (`tables[HILBERT_STEP]`),
    interleaved, then turned from Gray code to binary (a prefix XOR
    from the most significant bit)."""
    state = torch.zeros_like(m)
    gray = torch.zeros_like(m)
    b = depth
    while b > 0:
        k = HILBERT_STEP if b % HILBERT_STEP == 0 else 1
        b -= k
        width = 8 ** k
        v = tables[k][state * width + ((m >> (3 * b)) & (width - 1))]
        gray |= (v & (width - 1)) << (3 * b)
        state = v >> (3 * k)
    for shift in (1, 2, 4, 8, 16, 32):
        gray ^= gray >> shift
    return gray


def hilbert_tables() -> Dict[int, torch.Tensor]:
    """The tables `hilbert_from_morton` steps with."""
    return {1: hilbert_table(1), HILBERT_STEP: hilbert_table(HILBERT_STEP)}


def serial_codes(grid: torch.Tensor, batch: torch.Tensor, depth: int,
                 tables: Dict[int, torch.Tensor]) -> torch.Tensor:
    """(4, n) codes of the (n, 3) grid in the canonical order
    (`ORDERS`), the cloud's index above the 3·depth code bits;
    `tables` are `hilbert_tables()` on the grid's device."""
    s = spread3(grid.t())                              # (3, n)
    z = torch.stack([interleave(s), interleave(s[[1, 0, 2]])])
    codes = torch.cat([z, hilbert_from_morton(z, depth, tables)])
    return codes | (batch << (3 * depth))


# ------------------------------------------------------------- patches
@dataclasses.dataclass
class Patches:
    """A level's serialized patches (Pointcept's `get_padding_and_inverse`):
    `pad` (n_pad,) holds the ordered position each padded slot reads,
    `seqlens` each sequence's length; `slots` (S, L) is the same
    layout as one tensor of S sequences of the longest length L,
    `mask` (S, 1, 1, L) marks the key slots that hold a point (None when
    every sequence holds L), and `first` (n,) the flat slot of each
    ordered position's first occurrence."""

    pad: torch.Tensor
    seqlens: List[int]
    slots: torch.Tensor
    mask: Optional[torch.Tensor]
    first: torch.Tensor

    @property
    def copies(self) -> int:
        return len(self.pad) - len(self.first)


def patch_layout(counts: Sequence[int], K: int, device) -> Patches:
    """The patches of K of clouds of `counts` points: a cloud of n <= K
    points is one sequence of n; a longer one is padded to n_pad =
    ceil(n / K)·K, slot s reading ordered point s, or s − K past the
    cloud's end (the last patch's copies of the points before it).
    Built on the device from the counts (host ints), one small copy of
    them in."""
    pads = [-(-n // K) * K if n > K else n for n in counts]
    seqlens = []
    for n, p in zip(counts, pads):
        seqlens += [K] * (p // K) if n > K else [n]
    S, L, n_pad, n = len(seqlens), max(seqlens), sum(pads), sum(counts)
    starts = np.cumsum([0] + seqlens[:-1])
    table = _device_array(np.concatenate([
        counts, np.cumsum([0] + list(counts[:-1])), np.cumsum([0] + pads[:-1]),
        pads, seqlens, starts]).astype(np.int64), device)
    B = len(counts)
    n_t, off, pad_off, pad_t = table[:4 * B].view(4, B)
    lens, start = table[4 * B:].view(2, S)
    ar = torch.arange(max(n_pad, n), device=device)
    cloud = torch.repeat_interleave(ar[:B], pad_t, output_size=n_pad)
    s = ar[:n_pad] - pad_off[cloud]
    pad = off[cloud] + torch.where(s < n_t[cloud], s, s - K)
    owner = torch.repeat_interleave(ar[:B], n_t, output_size=n)
    first = pad_off[owner] + ar[:n] - off[owner]
    if all(q == L for q in seqlens):
        return Patches(pad, seqlens, pad.view(S, L), None, first)
    row = torch.repeat_interleave(ar[:S], lens, output_size=n_pad)
    flat = row * L + ar[:n_pad] - start[row]
    slots = torch.zeros(S * L, dtype=pad.dtype, device=device)
    mask = torch.zeros(S * L, dtype=torch.bool, device=device)
    slots[flat] = pad
    mask[flat] = True
    return Patches(pad, seqlens, slots.view(S, L), mask.view(S, 1, 1, L),
                   flat[first])


def _device_array(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: from the card's page-locked memory with
    the copy queued, so no host read waits on it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# ------------------------------------------------------------- a level
@dataclasses.dataclass
class Level:
    """The plan of one level: its voxels (grid, cloud), codes and orders
    (canonical), its list of orders, per-cloud counts, patches,
    neighbour map and, for a pooled level, the finer level's cluster
    index."""

    grid: torch.Tensor          # (n, 3) int64
    batch: torch.Tensor         # (n,) int64
    codes: torch.Tensor         # (4, n) canonical
    order: torch.Tensor         # (4, n) argsort of each code
    inverse: torch.Tensor       # (4, n)
    depth: int
    orders: Tuple[int, ...]     # the level's list, canonical indices
    counts: List[int]
    patches: Optional[Patches] = None
    nbr: Optional[torch.Tensor] = None      # (n, k³), n where absent
    pairs: Optional[torch.Tensor] = None    # 0-d: neighbours present
    cluster: Optional[torch.Tensor] = None  # finer voxel -> this level's
    _index: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return sum(self.counts)

    def attention_index(self, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(voxel of each slot (S, L), flat slot each voxel reads back
        (n,)) of block j's order, `self.orders[j % 4]`."""
        c = self.orders[j % len(self.orders)]
        if c not in self._index:
            p = self.patches
            self._index[c] = (self.order[c][p.slots],
                              p.first[self.inverse[c]])
        return self._index[c]


def _orders(codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    order = torch.argsort(codes, dim=1)
    inverse = torch.empty_like(order)
    inverse.scatter_(1, order, torch.arange(
        order.shape[1], device=order.device).expand_as(order))
    return order, inverse


# ------------------------------------------------------------- modules
def _norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    return F.layer_norm(x.to(dtype), ln.normalized_shape,
                        _cast(ln.weight, dtype), _cast(ln.bias, dtype),
                        ln.eps)


class SerializedAttention(nn.Module):
    """Patch attention over a level's serialized order."""

    def __init__(self, C: int, heads: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.heads = heads
        self.qkv = nn.Linear(C, 3 * C)
        self.proj = nn.Linear(C, C)

    def forward(self, x: torch.Tensor, level: Level, j: int) -> torch.Tensor:
        n, C = x.shape
        H = self.heads
        slots, back = level.attention_index(j)
        S, L = slots.shape
        qkv = gather_rows(_linear(self.qkv, x, self.dtype), slots.view(-1))
        q, k, v = qkv.view(S, L, 3, H, C // H).permute(2, 0, 3, 1, 4)
        with sdpa_kernel(ATTENTION_BACKENDS):
            o = F.scaled_dot_product_attention(q, k, v,
                                               attn_mask=level.patches.mask)
        o = gather_rows(o.transpose(1, 2).reshape(S * L, C), back)
        return _linear(self.proj, o, self.dtype)


class Block(nn.Module):
    """xCPE, attention and MLP, each pre-norm and residual."""

    def __init__(self, C: int, heads: int, mlp_ratio: int, k: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.cpe = SubMConv3d(C, C, k, bias=True)
        self.cpe_linear = nn.Linear(C, C)
        self.cpe_norm = nn.LayerNorm(C, eps=LN_EPS)
        self.norm1 = nn.LayerNorm(C, eps=LN_EPS)
        self.attn = SerializedAttention(C, heads, dtype)
        self.norm2 = nn.LayerNorm(C, eps=LN_EPS)
        self.fc1 = nn.Linear(C, mlp_ratio * C)
        self.fc2 = nn.Linear(mlp_ratio * C, C)

    def forward(self, x: torch.Tensor, level: Level, j: int, name: str
                ) -> torch.Tensor:
        dt = self.dtype
        with span(f"{name}.cpe"):
            h = _linear(self.cpe_linear, self.cpe.conv(x, level.nbr, dt), dt)
            x = x + _norm(self.cpe_norm, h, dt)
        with span(f"{name}.attn"):
            x = x + self.attn(_norm(self.norm1, x, dt), level, j)
        with span(f"{name}.mlp"):
            h = F.gelu(_linear(self.fc1, _norm(self.norm2, x, dt), dt))
            return x + _linear(self.fc2, h, dt)


class LinearBNGELU(nn.Module):
    """Linear → batch norm (eps 1e-3) → GELU, in `dtype`; `pool` maxes
    the Linear's output over clusters first."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(cin, cout)
        self.bn = ScheduledBatchNorm(cout, dtype, eps=BN_EPS)

    def forward(self, x, m, cluster: Optional[torch.Tensor] = None,
                clusters: int = 0):
        y = _linear(self.linear, x, self.dtype)
        if cluster is not None:
            y = torch.empty((clusters, y.shape[1]), dtype=y.dtype,
                            device=y.device).scatter_reduce_(
                0, cluster[:, None].expand_as(y), y, "amax",
                include_self=False)
        return F.gelu(self.bn(y, m))


class EncoderLevel(nn.Module):
    def __init__(self, pool: Optional[nn.Module], C: int, depth: int,
                 heads: int, mlp_ratio: int, k: int, dtype):
        super().__init__()
        self.pool = pool
        self.blocks = nn.ModuleList(Block(C, heads, mlp_ratio, k, dtype)
                                    for _ in range(depth))


class DecoderLevel(nn.Module):
    def __init__(self, cin: int, skip: int, C: int, depth: int, heads: int,
                 mlp_ratio: int, k: int, dtype):
        super().__init__()
        self.proj = LinearBNGELU(cin, C, dtype)
        self.skip = LinearBNGELU(skip, C, dtype)
        self.blocks = nn.ModuleList(Block(C, heads, mlp_ratio, k, dtype)
                                    for _ in range(depth))

    def unpool(self, skip: torch.Tensor, coarse: torch.Tensor,
               cluster: torch.Tensor, m) -> torch.Tensor:
        """The finer level's skip features plus its clusters' coarse
        features, each projected (the map backend)."""
        return self.skip(skip, m) + self.proj(coarse, m)[cluster]


@dataclasses.dataclass
class Plan:
    """What a forward computes before its features: the levels, the
    stem's map, the kept points' xyz and each input point's voxel."""

    levels: List[Level]
    stem_nbr: torch.Tensor
    stem_pairs: torch.Tensor
    xyz: torch.Tensor           # (n0, 3) f32
    voxel: torch.Tensor         # (B·N,) level-0 voxel of each point


class PointTransformerV3Backbone(nn.Module):
    """(B, N, 3) cloud -> (B, N, out_features) per-point feature."""

    # its plan reads the host (module docstring): a forward runs eagerly
    capturable = False

    def __init__(self, spec: PointTransformerV3Spec = PointTransformerV3Spec(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = s = spec
        self.dtype = dtype
        L = s.levels
        k = CPE_KERNEL
        self.stem = SubMConv3d(3, s.enc_channels[0], STEM_KERNEL,
                               bias=False)
        self.stem_bn = ScheduledBatchNorm(s.enc_channels[0], dtype,
                                          eps=BN_EPS)
        for l in range(L):
            pool = (LinearBNGELU(s.enc_channels[l - 1], s.enc_channels[l],
                                 dtype) if l else None)
            self.add_module(f"enc{l}", EncoderLevel(
                pool, s.enc_channels[l], s.enc_depths[l], s.enc_heads[l],
                s.mlp_ratio, k, dtype))
        widths = list(s.dec_channels) + [s.enc_channels[-1]]
        for l in reversed(range(L - 1)):
            self.add_module(f"dec{l}", DecoderLevel(
                widths[l + 1], s.enc_channels[l], widths[l], s.dec_depths[l],
                s.dec_heads[l], s.mlp_ratio, k, dtype))
        self.out_features = s.out_features
        # the Hilbert state machine's tables, moved with the model
        for k, table in hilbert_tables().items():
            self.register_buffer(f"hilbert{k}", table, persistent=False)
        self.level_points: List[int] = []
        self.sequences: List[List[int]] = []
        self.pad_points: List[int] = []
        self.host_syncs = 0
        self.structure: List[Dict] = []
        self._pairs: List[torch.Tensor] = []
        self._stem_pairs: Optional[torch.Tensor] = None

    # ----------------------------------------------------------- counters
    @property
    def cpe_pairs(self) -> List[int]:
        """Each level's (voxel, offset) pairs whose neighbour is present,
        in the last forward's maps (read from the device when asked)."""
        return [int(p) for p in self._pairs]

    @property
    def stem_pairs(self) -> int:
        return 0 if self._stem_pairs is None else int(self._stem_pairs)

    def draw_shuffle(self, generator: torch.Generator
                     ) -> Tuple[Tuple[int, ...], ...]:
        """A shuffle of the orders, one permutation a level, drawn from
        `generator` (PTv3's `shuffle_orders`, drawn once)."""
        return tuple(tuple(torch.randperm(
            len(ORDERS), generator=generator,
            device=generator.device).tolist())
            for _ in range(self.spec.levels))

    def _read(self, t: torch.Tensor):
        self.host_syncs += 1
        return t.tolist()

    def _clusters(self, keys: torch.Tensor, batch_bits: int, B: int
                  ) -> Tuple[torch.Tensor, List[int]]:
        """`sparse.clusters` with one host read of the per-cloud
        counts."""
        cluster, counts = clusters(keys, batch_bits, B)
        return cluster, self._read(counts)

    # --------------------------------------------------------------- plan
    def plan(self, X: torch.Tensor, shuffle) -> Plan:
        """The levels' structure; its host reads come first, before the
        device has work queued to wait for."""
        s = self.spec
        B = X.shape[0]
        dev = X.device
        with span("ptv3.grid"):
            xyz = X.reshape(-1, 3).float()
            g, batch = grid_cells(X, s.grid_size)
            depth = int(self._read(g.max())).bit_length()
            voxel, counts = self._clusters(morton_keys(g, batch, depth),
                                           3 * depth, B)
            kept = first_members(voxel, sum(counts))
            grid, vbatch = g[kept], batch[kept]
        with span("ptv3.serialize"):
            codes = serial_codes(grid, vbatch, depth, {
                k: getattr(self, f"hilbert{k}") for k in (1, HILBERT_STEP)})
            order, inverse = _orders(codes)
            levels = [Level(grid, vbatch, codes, order, inverse, depth,
                            tuple(shuffle[0]), counts)]
        for l in range(1, s.levels):
            with span(f"ptv3.e{l}.pool"):
                levels.append(self._pool(levels[-1], s.stride[l - 1],
                                         shuffle[l], B))
        with span("ptv3.stem"):
            stem_nbr, stem_pairs = neighbour_map(grid, vbatch, depth,
                                                 STEM_KERNEL)
        for l, lv in enumerate(levels):
            with span(f"ptv3.e{l}.pool" if l else "ptv3.serialize"):
                lv.patches = patch_layout(lv.counts, s.patch_size, dev)
            with span(f"ptv3.e{l}.nbr"):
                lv.nbr, lv.pairs = neighbour_map(lv.grid, lv.batch, lv.depth,
                                                 CPE_KERNEL)
        return Plan(levels, stem_nbr, stem_pairs, xyz[kept], voxel)

    def _pool(self, lv: Level, stride: int, perm, B: int) -> Level:
        """The level pooled from `lv` by `stride`."""
        shift = (stride - 1).bit_length()
        if shift > lv.depth:
            shift = 0
        code = lv.codes >> (3 * shift)
        depth = lv.depth - shift
        cluster, counts = self._clusters(code[lv.orders[0]], 3 * depth, B)
        head = first_members(cluster, sum(counts))
        codes = code[:, head]
        order, inverse = _orders(codes)
        return Level(lv.grid[head] >> shift, lv.batch[head], codes, order,
                     inverse, depth, tuple(lv.orders[p] for p in perm),
                     counts, cluster=cluster)

    # ------------------------------------------------------------ forward
    def forward(self, X: torch.Tensor, bn_momentum=0.9,
                generator: Optional[torch.Generator] = None,
                shuffle: Optional[Sequence[Sequence[int]]] = None
                ) -> torch.Tensor:
        """In training mode batch norm takes `bn_momentum` and dropout
        (dp1, on the output) draws from `generator`; `shuffle` (one
        permutation of the four orders a level, `draw_shuffle`) permutes
        the orders, None keeps the canonical lists."""
        s, m, dt = self.spec, bn_momentum, self.dtype
        if X.dim() != 3 or X.shape[-1] != 3:
            raise ValueError(f"expected (B, N, 3) clouds, got "
                             f"{tuple(X.shape)}")
        if shuffle is None:
            shuffle = [tuple(range(len(ORDERS)))] * s.levels
        if len(shuffle) != s.levels:
            raise ValueError(f"a shuffle holds one permutation a level "
                             f"({s.levels}), got {len(shuffle)}")
        B, N, _ = X.shape
        self.host_syncs = 0
        plan = self.plan(X, shuffle)
        levels = plan.levels
        with span("ptv3.stem"):
            h = F.gelu(self.stem_bn(self.stem.conv(plan.xyz, plan.stem_nbr,
                                                   dt), m))
        skips = []
        for l, lv in enumerate(levels):
            enc = getattr(self, f"enc{l}")
            if enc.pool is not None:
                with span(f"ptv3.e{l}.pool"):
                    h = enc.pool(h, m, lv.cluster, lv.n)
            for j, block in enumerate(enc.blocks):
                h = block(h, lv, j, f"ptv3.e{l}.b{j}")
            skips.append(h)
        for l in reversed(range(s.levels - 1)):
            dec = getattr(self, f"dec{l}")
            with span(f"ptv3.d{l}.unpool"):
                h = dec.unpool(skips[l], h, levels[l + 1].cluster, m)
            for j, block in enumerate(dec.blocks):
                h = block(h, levels[l], j, f"ptv3.d{l}.b{j}")
        feat = h[plan.voxel].view(B, N, -1)
        self._record(plan)
        return dropout(feat, s.dropout_rate, self.training, generator)

    def _record(self, plan: Plan) -> None:
        self.level_points = [lv.n for lv in plan.levels]
        self.sequences = [lv.patches.seqlens for lv in plan.levels]
        self.pad_points = [lv.patches.copies for lv in plan.levels]
        self._pairs = [lv.pairs for lv in plan.levels]
        self._stem_pairs = plan.stem_pairs
        self.structure = [dict(counts=lv.counts, pad=lv.patches.pad,
                               order=lv.order[list(lv.orders)])
                          for lv in plan.levels]
