"""Sparse voxel pieces shared by the port's voxel backbones, Point
Transformer V3 (`models/point_transformer_v3.py`) and MinkUNet
(`models/minkunet.py`).

- Grid sampling: each cloud's grid cell is floor(xyz / grid_size) minus
  the cloud's own minimum (`grid_cells`); a point's key is its cell's
  Morton code (x's bit i at bit 3i+2, y's at 3i+1, z's at 3i) with the
  cloud's index above the 3·depth code bits (`morton_keys`), so a key
  >> 3 is the key of the cell's parent at half the resolution.
- Clusters: `clusters` numbers the distinct keys in ascending order
  (torch's `unique`, queued: no host read) and counts each cloud's;
  `first_members` gives each cluster's smallest member index (the kept
  point of a voxel).
- A kernel map (`neighbour_map`): each voxel's neighbour at each of the
  k³ offsets, n where its cloud has none; offset o = ((dx + r)·k + (dy +
  r))·k + (dz + r), r = k // 2, over the grid's (x, y, z).
- A sparse convolution (`SubMConv3d`): its weight (C_out, taps·C_in)
  times the gathered (n, taps·C_in) rows of a map; with a level's
  neighbour map it is the submanifold convolution, with any map whose
  rows list an output's inputs it is that convolution.
- `_cast` keeps a parameter's low-precision copy across eager forwards,
  `_linear` runs a Linear in a given dtype, `gather_rows` is one
  `index_select`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# the largest kernel radius a neighbour key leaves room for (a 5×5×5
# kernel, the stems')
KEY_RADIUS = 2


# ------------------------------------------------------------ the codes
def spread3(v: torch.Tensor) -> torch.Tensor:
    """Each of the low 21 bits of v moved to bit 3i (int64)."""
    v = v & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    return (v | (v << 2)) & 0x1249249249249249


def interleave(s: torch.Tensor) -> torch.Tensor:
    """The code of spread coordinates s (..., 3, n): s[0]'s bits most
    significant in each triple."""
    return (s[..., 0, :] << 2) | (s[..., 1, :] << 1) | s[..., 2, :]


# ------------------------------------------------------- grid sampling
def grid_cells(X: torch.Tensor, grid_size: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B·N, 3) int64 grid cell of each point of the (B, N, 3) clouds,
    (B·N,) cloud of each point): floor(xyz / grid_size) minus the
    cloud's minimum."""
    B, N, _ = X.shape
    g = torch.floor(X.float() / grid_size).long()
    g = (g - g.amin(dim=1, keepdim=True)).reshape(-1, 3)
    return g, torch.arange(B, device=X.device).repeat_interleave(N)


def morton_keys(grid: torch.Tensor, batch: torch.Tensor, depth: int
                ) -> torch.Tensor:
    """Each cell's Morton code of depth levels, the cloud above it."""
    return interleave(spread3(grid.t())) | (batch << (3 * depth))


def clusters(keys: torch.Tensor, batch_bits: int, B: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`unique` of the keys, queued: each key's cluster, the clusters
    numbered in ascending key order, and (B,) each cloud's count of
    clusters on the device (the cloud's index lies above `batch_bits`
    of a key)."""
    sorted_keys, perm = torch.sort(keys)
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    ids = torch.cumsum(first, 0) - 1
    cluster = torch.empty_like(ids).scatter_(0, perm, ids)
    counts = torch.zeros(B, dtype=torch.long, device=keys.device)
    counts.scatter_add_(0, sorted_keys >> batch_bits, first.long())
    return cluster, counts


def first_members(cluster: torch.Tensor, m: int) -> torch.Tensor:
    """The smallest index of each of the m clusters."""
    n = len(cluster)
    idx = torch.arange(n, device=cluster.device)
    return torch.full((m,), n, device=cluster.device).scatter_reduce_(
        0, cluster, idx, "amin")


def neighbour_map(grid: torch.Tensor, batch: torch.Tensor, depth: int,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, k³) index of each voxel's neighbour at each offset (in the
    weight's offset order), n where the cloud has no voxel there, and the
    0-d count of neighbours present: a `searchsorted` of each neighbour's
    key in the level's sorted keys, key = ((b·S + x')·S + y')·S + z',
    each coordinate shifted by KEY_RADIUS into [0, S)."""
    n = grid.shape[0]
    S = (1 << depth) + 2 * KEY_RADIUS
    g = grid + KEY_RADIUS
    key = ((batch * S + g[:, 0]) * S + g[:, 1]) * S + g[:, 2]
    sorted_key, idx = torch.sort(key)
    d = torch.arange(-(k // 2), k // 2 + 1, device=grid.device)
    offs = ((d[:, None, None] * S + d[None, :, None]) * S
            + d[None, None, :]).reshape(-1)
    q = key[:, None] + offs
    pos = torch.searchsorted(sorted_key, q).clamp_(max=n - 1)
    found = sorted_key[pos] == q
    return torch.where(found, idx[pos], n), found.sum()


# ------------------------------------------------------------- modules
def _cast(p: torch.Tensor, dtype) -> torch.Tensor:
    """Parameter p in `dtype`.  Where no gradient is asked for, the copy
    is kept on p until p changes (its version or its storage): an eager
    forward would otherwise cast every weight anew, ~400 of PTv3's
    ~2,500 operations."""
    if p.dtype == dtype:
        return p
    if p.requires_grad and torch.is_grad_enabled():
        return p.to(dtype)
    key = (dtype, p._version, p.data_ptr())
    kept = getattr(p, "_kept_cast", None)
    if kept is None or kept[0] != key:
        kept = p._kept_cast = (key, p.detach().to(dtype))
    return kept[1]


def _linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    b = None if lin.bias is None else _cast(lin.bias, dtype)
    return F.linear(x.to(dtype), _cast(lin.weight, dtype), b)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] of (n, C) x, shaped (*idx.shape, C): one `index_select`,
    which dispatches in less host time than Python's indexing."""
    return x.index_select(0, idx.reshape(-1)).view(*idx.shape, x.shape[1])


class SubMConv3d(nn.Linear):
    """A sparse 3-D convolution of kernel k: its weight (C_out,
    k³·C_in) over the gathered inputs of a map whose row lists an
    output's input at each offset (a level's neighbour map: the
    submanifold convolution)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool):
        super().__init__(k ** 3 * cin, cout, bias=bias)
        self.k = k

    def conv(self, x: torch.Tensor, nbr: torch.Tensor, dtype
             ) -> torch.Tensor:
        x = x.to(dtype)
        rows = gather_rows(torch.cat([x, x.new_zeros(1, x.shape[1])]), nbr)
        return _linear(self, rows.view(len(nbr), -1), dtype)
