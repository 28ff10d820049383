"""Plain PyTorch point-cloud ops: counterparts of `articulated_pose_tpu/ops/core.py`.

These are the CPU path of every kernel wrapper in `ops/kernels/` and the
oracle the CUDA kernels are held against on the card.  Distances are
written out elementwise in a fixed operation order, because the kernels
repeat that order with round-to-nearest intrinsics: with matched
arithmetic the comparison on the card can demand exact indices.

- `pairwise_sqdist` is the expansion form |a|² + |b|² − 2·a·b clamped at
  0 (core.py:35-51), with the inner product (ax·bx + ay·by) + az·bz.
- FPS uses the direct (x − lx)² sum (pallas/fps.py:146).
"""

from __future__ import annotations

import numpy as np
import torch


def _sqnorm(a: torch.Tensor) -> torch.Tensor:
    x, y, z = a.unbind(-1)
    return (x * x + y * y) + z * z


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared euclidean distance."""
    a = a.float()
    b = b.float()
    ax, ay, az = (v.unsqueeze(-1) for v in a.unbind(-1))
    bx, by, bz = (v.unsqueeze(-2) for v in b.unbind(-1))
    inner = (ax * bx + ay * by) + az * bz
    d2 = _sqnorm(a).unsqueeze(-1) + _sqnorm(b).unsqueeze(-2) - 2.0 * inner
    return torch.clamp_min(d2, 0.0)


def farthest_point_sample(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Iterative farthest point sampling. xyz (B, N, 3) -> (B, npoint) int32.

    The first pick is index 0; each later pick maximises the running min
    squared distance to the picked set, ties to the lowest index.
    """
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)                          # (B, N) each
    mind = torch.full((B, N), 1e38, dtype=torch.float32, device=xyz.device)
    picks = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    last = picks[:, :1]
    for j in range(1, npoint):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        last = mind.argmax(dim=1, keepdim=True)               # first max
        picks[:, j:j + 1] = last
    return picks.to(torch.int32)


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    idx = idx.long().unsqueeze(-1).expand(-1, -1, points.shape[-1])
    return points.gather(1, idx)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    """First-`nsample`-in-index-order ball query (core.py:86-123).

    xyz (B, N, 3), new_xyz (B, M, 3) -> (idx (B, M, nsample) int32,
    cnt (B, M) int32).  Hits are d² < r² (strict); slots past the hit
    count hold the first hit; zero hits give index 0; cnt is capped at
    nsample.  Each hit's slot is its exclusive prefix rank among hits,
    scattered into an (nsample + 1)-wide buffer whose last column
    absorbs every non-hit and every hit past nsample.
    """
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    # r² rounded to f32 once, as a Python scalar: a host-made tensor
    # would be a copy that waits for the stream
    r2 = float(np.float32(radius * radius))
    hit = pairwise_sqdist(new_xyz, xyz) < r2                  # (B, M, N)
    rank = torch.cumsum(hit, dim=-1, dtype=torch.int32)       # inclusive
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


def bucket_width(n: int, nsample: int) -> int:
    """W, the points per slot of the bucket ball query: the cloud padded
    to a multiple of 128, over nsample.  Raises unless that is a whole
    power of two (ball_query_bucket.py:160-167, core.py:148-153)."""
    n_pad = -(-n // 128) * 128
    w = n_pad // nsample
    if n_pad % nsample or (w & (w - 1)):
        raise ValueError(
            f"bucket ball query needs padded N ({n_pad}) = nsample "
            f"({nsample}) * power-of-two bucket; use the exact ball query")
    return w


def query_ball_point_bucket(radius: float, nsample: int, xyz: torch.Tensor,
                            new_xyz: torch.Tensor):
    """Bucket-sampled ball query (core.py:126-176).

    xyz (B, N, 3), new_xyz (B, M, 3) -> (idx (B, M, nsample) int32,
    cnt (B, M) int32).  Slot j holds the first point with d² < r² among
    [j·W, (j+1)·W), W = `bucket_width(N, nsample)`, points at or past N
    never hitting; slots whose bucket has no hit repeat the first filled
    slot; zero hits give index 0; cnt counts every hit, capped at
    nsample.
    """
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    W = bucket_width(N, nsample)
    r2 = float(np.float32(radius * radius))
    hit = pairwise_sqdist(new_xyz, xyz) < r2                  # (B, M, N)
    cnt = hit.sum(-1).clamp_max(nsample).to(torch.int32)
    hit = torch.nn.functional.pad(hit, (0, nsample * W - N))
    # first hit within each bucket: min lane over the bucket axis
    w_iota = torch.arange(W, device=xyz.device)
    w_star = torch.where(hit.reshape(B, M, nsample, W), w_iota,
                         W).amin(-1)                          # (B, M, S)
    filled = w_star < W
    s_iota = torch.arange(nsample, device=xyz.device)
    idx = s_iota * W + w_star.clamp_max(W - 1)
    # the first filled slot holds the cloud's first hit
    first_slot = torch.where(filled, s_iota, nsample).amin(-1, keepdim=True)
    fill = idx.gather(-1, first_slot.clamp_max(nsample - 1))
    fill = torch.where(first_slot < nsample, fill, 0)
    return torch.where(filled, idx, fill).to(torch.int32), cnt


def query_ball_group_bucket_plain(radius: float, nsample: int,
                                  xyz: torch.Tensor, new_xyz: torch.Tensor,
                                  emit_idx: bool = True):
    """The bucket ball query with its centred coordinates: the plain
    version of B8 (ball_query_bucket.py:146).

    -> (grouped (B, M, nsample, 3) f32, cnt (B, M) int32, idx or None).
    A selected point's offset p − q is rounded to bf16 and returned as
    f32, as the TPU kernel's bf16 matmul carries it (:92-97); with zero
    hits the offset of point 0 stays unrounded f32 (:128-132).
    """
    idx, cnt = query_ball_point_bucket(radius, nsample, xyz, new_xyz)
    grouped = group_point(xyz.float(), idx) - new_xyz.float()[:, :, None]
    grouped = torch.where((cnt > 0)[:, :, None, None],
                          grouped.to(torch.bfloat16).float(), grouped)
    return grouped, cnt, (idx if emit_idx else None)


# the packed tier's grid: 10 bits per component (ball_query_butterfly.py:197)
QUANT_LEVELS = 1023
# f32(1/1023), as the reference rounds its `ext * (1.0 / 1023.0)` scalar
INV_LEVELS = float(np.float32(1.0) / np.float32(QUANT_LEVELS))


def _fma(a: torch.Tensor, b: torch.Tensor, c: float | torch.Tensor):
    """a·b + c rounded once to f32, as a fused multiply-add does.

    float64 holds the product of two f32 values exactly; at the packed
    tier's magnitudes it holds the sum exactly too (for the quantiser
    wherever the floor that follows could change; for the dequantiser
    unless a cloud's offset is 2^18 times its extent), so the one
    rounding to f32 is the fused operation's.
    """
    return (a.double() * b.double() + c).float()


def quantize_coords(xyz: torch.Tensor) -> torch.Tensor:
    """The packed ball-query tier's coordinates (ball_query_butterfly.py:
    197-227, 297-305): each component rounded to a 10-bit grid over the
    cloud's bounding box, then dequantised.

    xyz (B, N, 3) -> (B, N, 3) f32: fma(q, ext·f32(1/1023), mn) with
    ext = max(mx − mn, 1e-6) and q = clip(floor(fma(p − mn, 1023/ext,
    0.5)), 0, 1023).  The multiply-adds are fused because XLA fuses the
    reference's `x * s + c` on the CPU, where the tests hold the two
    packages to equal coordinates; the kernel uses `__fmaf_rn`.
    1023/ext is a tensor division: `scalar / tensor` takes the
    reciprocal first and rounds twice.
    """
    x = xyz.float()
    mn = x.amin(dim=1, keepdim=True)                          # (B, 1, 3)
    ext = torch.clamp_min(x.amax(dim=1, keepdim=True) - mn, 1e-6)
    scl = torch.full_like(ext, float(QUANT_LEVELS)) / ext
    q = torch.clamp(torch.floor(_fma(x - mn, scl, 0.5)), 0.0,
                    float(QUANT_LEVELS))
    return _fma(q, ext * INV_LEVELS, mn.double())


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, S) -> (B, M, S, C) plain gather."""
    B, M, S = idx.shape
    return gather_point(points, idx.reshape(B, M * S)).reshape(
        B, M, S, points.shape[-1])


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """3 nearest neighbours of each xyz1 point among xyz2.

    xyz1 (B, N, 3), xyz2 (B, M, 3) -> (dist (B, N, 3) squared, ascending,
    idx (B, N, 3) int32), ties to the lowest index: three masked arg-min
    sweeps, as in core.py:212-237.
    """
    d = pairwise_sqdist(xyz1, xyz2)                           # (B, N, M)
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


# the packed 3-NN key keeps the candidate's index in its low 16 bits
PACKED_MAX_CANDIDATES = 1 << 16
_KEY_HIGH = -65536                 # 0xFFFF0000 as int32
_KEY_SPARE = 2**31 - 1             # padded and taken lanes


def three_nn_packed(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """3-NN on an int32 sort key (three_nn.py:62-107, the packed tier).

    key = (f32 bits of d² & 0xFFFF0000) | j for candidate j: the top 16
    bits keep 7 mantissa bits of d² (d² >= 0, so its bits order as an
    int32), and the index in the low bits makes the keys unique and ties
    go to the lowest index.  Three min-and-mask sweeps take the three
    smallest keys; idx = key & 0xFFFF and dist = the key's high half as
    f32 (d² truncated, <= exact).  With fewer than 3 candidates a spare
    slot holds the spare key 0x7FFFFFFF: idx 65535 and dist NaN (bits
    0x7FFF0000), as the TPU kernel emits.  M <= 65536.
    """
    M = xyz2.shape[1]
    if M > PACKED_MAX_CANDIDATES:
        raise ValueError(f"three_nn_packed: M={M} exceeds the key's 16-bit "
                         f"index (65536)")
    d = pairwise_sqdist(xyz1, xyz2)                           # (B, N, M)
    iota = torch.arange(M, dtype=torch.int32, device=d.device)
    key = (d.view(torch.int32) & _KEY_HIGH) | iota
    keys = []
    for _ in range(3):
        v = key.min(dim=-1, keepdim=True).values
        keys.append(v)
        key = torch.where(iota == (v & 0xFFFF), _KEY_SPARE, key)
    keys = torch.cat(keys, -1)
    return (keys & _KEY_HIGH).view(torch.float32), keys & 0xFFFF


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """points (B, M, C), idx (B, N, 3), weight (B, N, 3) -> (B, N, C)."""
    gathered = group_point(points, idx)                       # (B, N, 3, C)
    return (gathered * weight.unsqueeze(-1).to(points.dtype)).sum(dim=2)


def interp_weights(dist: torch.Tensor) -> torch.Tensor:
    """Normalised inverse squared-distance weights (B, N, 3)."""
    w = 1.0 / torch.clamp_min(dist, 1e-10)
    return w / w.sum(dim=-1, keepdim=True)


def knn_point(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """k nearest neighbours (core.py:259, tf_grouping.py:48-73): xyz
    (B, N, 3), new_xyz (B, M, 3) -> (dist (B, M, k) squared ascending,
    idx (B, M, k) int32), ties to the lowest index, as lax.top_k sends
    them.  The plain version of the `knn` kernel entry
    (`ops/kernels/knn.py`).  Each (distance, index) pair is one int64
    key, the distance's bits above the index: the bits of a float >= 0
    order as the float does, so the keys are distinct and a topk over
    them orders ties by index, at a topk's cost and not a sort's."""
    d2 = pairwise_sqdist(new_xyz, xyz)                      # >= 0
    col = torch.arange(d2.shape[-1], device=d2.device)
    key = (d2.view(torch.int32).to(torch.int64) << 32) | col
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)[0] \
        & 0xFFFFFFFF
    return torch.gather(d2, -1, idx), idx.to(torch.int32)


def prob_sample(weights: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical sampling (core.py:269, tf_sampling
    ProbSample): weights (B, N) unnormalised, uniforms (B, M) in [0, 1),
    drawn by the caller -> (B, M) int32."""
    cdf = torch.cumsum(weights, dim=1)
    cdf = cdf / cdf[:, -1:]
    idx = torch.searchsorted(cdf.contiguous(), uniforms.contiguous(),
                             right=True)
    return torch.clamp_max(idx, weights.shape[1] - 1).to(torch.int32)
