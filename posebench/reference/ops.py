"""Plain point-cloud ops of the benchmark's reference: a frozen copy of
the port's `ops/core.py` (the plain versions its CUDA kernels are held
to) and of the plain semantics of the kernel entries the ANCSH
backbone calls (`fps2`, `ball_query_group`, `ball_query_group_packed`,
`three_nn`).  Plain PyTorch, any device.
"""

from __future__ import annotations

import numpy as np
import torch


def _sqnorm(a: torch.Tensor) -> torch.Tensor:
    x, y, z = a.unbind(-1)
    return (x * x + y * y) + z * z


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances, the
    expansion form |a|² + |b|² − 2·a·b clamped at 0."""
    a = a.float()
    b = b.float()
    ax, ay, az = (v.unsqueeze(-1) for v in a.unbind(-1))
    bx, by, bz = (v.unsqueeze(-2) for v in b.unbind(-1))
    inner = (ax * bx + ay * by) + az * bz
    d2 = _sqnorm(a).unsqueeze(-1) + _sqnorm(b).unsqueeze(-2) - 2.0 * inner
    return torch.clamp_min(d2, 0.0)


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3) -> (B, npoint) int32: the first pick is index 0,
    each later one maximises the running min squared distance to the
    picked set, ties to the lowest index."""
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)
    mind = torch.full((B, N), 1e38, dtype=torch.float32, device=xyz.device)
    picks = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    last = picks[:, :1]
    for j in range(1, npoint):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = mind.argmax(dim=1, keepdim=True)
        picks[:, j:j + 1] = last
    return picks.to(torch.int32)


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    idx = idx.long().unsqueeze(-1).expand(-1, -1, points.shape[-1])
    return points.gather(1, idx)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather_point(points, idx.reshape(B, M * S)).reshape(
        B, M, S, points.shape[-1])


def fps2(xyz: torch.Tensor, np1: int, np2: int):
    """Two FPS levels with a gather between -> (idx1, xyz1, idx2, xyz2)."""
    idx1 = farthest_point_sample(np1, xyz)
    xyz1 = gather_point(xyz.float(), idx1)
    idx2 = farthest_point_sample(np2, xyz1)
    return idx1, xyz1, idx2, gather_point(xyz1, idx2)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    """First-`nsample`-in-index-order ball query: xyz (B, N, 3), new_xyz
    (B, M, 3) -> (idx (B, M, nsample) int32, cnt (B, M) int32).  Hits
    are d² < r² with r² rounded to f32 once; slots past the hit count
    hold the first hit; zero hits give index 0; cnt is capped."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    r2 = float(np.float32(radius * radius))
    hit = pairwise_sqdist(new_xyz, xyz) < r2
    rank = torch.cumsum(hit, dim=-1, dtype=torch.int32)
    slot = torch.where(hit, rank - 1, nsample).clamp_max(nsample).long()
    n_iota = torch.arange(N, device=xyz.device, dtype=torch.int32)
    buf = torch.zeros((B, M, nsample + 1), dtype=torch.int32,
                      device=xyz.device)
    buf.scatter_(2, slot, n_iota.expand(B, M, N).contiguous())
    idx = buf[..., :nsample]
    cnt = rank[..., -1].clamp_max(nsample)
    first = torch.where(cnt > 0, idx[..., 0], 0)
    col = torch.arange(nsample, device=xyz.device)
    idx = torch.where(col < cnt.unsqueeze(-1), idx, first.unsqueeze(-1))
    return idx.to(torch.int32), cnt.to(torch.int32)


# the packed tier's grid: 10 bits per component
QUANT_LEVELS = 1023
INV_LEVELS = float(np.float32(1.0) / np.float32(QUANT_LEVELS))


def _fma(a: torch.Tensor, b: torch.Tensor, c):
    """a·b + c rounded once to f32 (float64 holds the product exactly)."""
    return (a.double() * b.double() + c).float()


def quantize_coords(xyz: torch.Tensor) -> torch.Tensor:
    """The packed ball query's coordinates: each component rounded to a
    10-bit grid over the cloud's bounding box, then dequantised."""
    x = xyz.float()
    mn = x.amin(dim=1, keepdim=True)
    ext = torch.clamp_min(x.amax(dim=1, keepdim=True) - mn, 1e-6)
    scl = torch.full_like(ext, float(QUANT_LEVELS)) / ext
    q = torch.clamp(torch.floor(_fma(x - mn, scl, 0.5)), 0.0,
                    float(QUANT_LEVELS))
    return _fma(q, ext * INV_LEVELS, mn.double())


def ball_query_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, packed: bool = False):
    """(grouped (B, M, S, 3) = point − query, idx (B, M, S)); with
    `packed` the grouped points are the 10-bit-quantised cloud's."""
    idx, _ = query_ball_point(radius, nsample, xyz, new_xyz)
    src = quantize_coords(xyz) if packed else xyz.float()
    return group_point(src, idx) - new_xyz.float()[:, :, None], idx


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """3 nearest neighbours of each xyz1 point among xyz2 -> (dist
    (B, N, 3) squared ascending, idx (B, N, 3) int32), ties to the
    lowest index."""
    d = pairwise_sqdist(xyz1, xyz2)
    M = d.shape[-1]
    iota = torch.arange(M, device=d.device)
    dists, idxs = [], []
    for _ in range(3):
        v = d.min(dim=-1, keepdim=True).values
        i = torch.where(d == v, iota, M).min(dim=-1, keepdim=True).values
        dists.append(v)
        idxs.append(i)
        d = torch.where(iota == i, torch.inf, d)
    return torch.cat(dists, -1), torch.cat(idxs, -1).to(torch.int32)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """points (B, M, C), idx (B, N, 3), weight (B, N, 3) -> (B, N, C)."""
    gathered = group_point(points, idx)
    return (gathered * weight.unsqueeze(-1).to(points.dtype)).sum(dim=2)


def interp_weights(dist: torch.Tensor) -> torch.Tensor:
    """Normalised inverse squared-distance weights (B, N, 3)."""
    w = 1.0 / torch.clamp_min(dist, 1e-10)
    return w / w.sum(dim=-1, keepdim=True)
