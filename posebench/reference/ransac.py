"""Batched RANSAC for similarity alignment: the benchmark's frozen copy of
the port's `pose/ransac.py`.

The hypotheses' randomness comes in as data: uniforms in [0, 1) that
index the valid-first buffers as min(int(u·cnt), cnt − 1)
(ransac.py:49-51).  Production draws them from a torch.Generator; the
parity tests hand in the JAX package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from posebench.reference import umeyama


class SimilarityFit(NamedTuple):
    R: torch.Tensor          # (..., 3, 3)
    s: torch.Tensor          # (...,)
    t: torch.Tensor          # (..., 3)
    inliers: torch.Tensor    # (..., P) bool
    score: torch.Tensor      # (...,) inlier count


def masked_sample_indices(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Indices into valid-first buffers from uniforms (the reference's
    compact=True path).  u (..., *draw), mask (..., P) -> int64 like u."""
    cnt = torch.clamp_min((mask > 0).sum(-1, dtype=torch.int32), 1)
    cnt = cnt.reshape(cnt.shape + (1,) * (u.dim() - cnt.dim()))
    return torch.minimum((u * cnt.float()).to(torch.int32), cnt - 1).long()


def gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., P, 3), idx (..., *shape) -> (..., *shape, 3)."""
    flat = idx.reshape(idx.shape[:x.dim() - 2] + (-1,))
    out = x.gather(-2, flat.unsqueeze(-1).expand(*flat.shape, 3))
    return out.reshape(idx.shape + (3,))


def hypothesis_inlier_counts(Rs, ss, ts, source, target, maskf,
                             inlier_th: float) -> torch.Tensor:
    """Inlier counts of H hypotheses as ONE (H,16)@(16,P) product
    (ransac.py:67-120): the squared residual expands bilinearly, so no
    (H, P, 3) prediction is materialised.

    Rs (..., H, 3, 3), ss (..., H), ts (..., H, 3); source/target
    (..., P, 3); maskf (..., P) bool -> (..., H) int64 counts.
    """
    outer = target.unsqueeze(-1) * source.unsqueeze(-2)          # (..., P, 3, 3)
    Bmat = torch.cat([
        -2.0 * outer.flatten(-2),
        2.0 * source,
        -2.0 * target,
        (source * source).sum(-1, keepdim=True),
    ], dim=-1)                                                    # (..., P, 16)
    Rt_t = (Rs * ts.unsqueeze(-1)).sum(-2)                        # Rᵀt (..., H, 3)
    A = torch.cat([
        ss.unsqueeze(-1) * Rs.flatten(-2),
        ss.unsqueeze(-1) * Rt_t,
        ts,
        (ss * ss).unsqueeze(-1),
    ], dim=-1)                                                    # (..., H, 16)
    row = (ts * ts).sum(-1)
    col = (target * target).sum(-1)
    res2 = (A @ Bmat.transpose(-1, -2) + row.unsqueeze(-1)
            + col.unsqueeze(-2))
    inl = (res2 < inlier_th * inlier_th) & maskf.unsqueeze(-2)
    return inl.sum(-1)


def ransac_similarity(u: torch.Tensor, source: torch.Tensor,
                      target: torch.Tensor, mask: torch.Tensor, *,
                      inlier_th: float = 0.1, chunk: Optional[int] = None,
                      score_points: Optional[int] = None) -> SimilarityFit:
    """RANSAC similarity fit on valid-first masked buffers.

    u (..., H, 3) uniforms; source/target (..., P, 3); mask (..., P).
    Hypotheses are ranked on the first `score_points` points; the best
    one's inlier set over all points is refit with transform_pts.
    `chunk` bounds how many hypotheses are scored at once (memory only).
    """
    P = source.shape[-2]
    idx = masked_sample_indices(u, mask)                          # (..., H, 3)
    Rs, ss, ts = umeyama.fit_3pt_similarity(gather_points(source, idx),
                                            gather_points(target, idx))
    maskf = mask > 0
    cap = score_points if (score_points is not None and score_points < P) \
        else P
    H = u.shape[-2]
    step = H if chunk is None else chunk
    scores = torch.cat([
        hypothesis_inlier_counts(Rs[..., h:h + step, :, :], ss[..., h:h + step],
                                 ts[..., h:h + step, :], source[..., :cap, :],
                                 target[..., :cap, :], maskf[..., :cap],
                                 inlier_th)
        for h in range(0, H, step)], dim=-1)

    best = scores.argmax(dim=-1)                                  # first max
    Rb = Rs.gather(-3, best[..., None, None, None].expand(
        *best.shape, 1, 3, 3)).squeeze(-3)
    sb = ss.gather(-1, best.unsqueeze(-1)).squeeze(-1)
    tb = ts.gather(-2, best[..., None, None].expand(*best.shape, 1, 3)
                   ).squeeze(-2)
    res = umeyama.similarity_residual(Rb, sb, tb, source, target)
    inliers = (res < inlier_th) & maskf
    enough = inliers.sum(-1, keepdim=True) >= 3
    w = torch.where(enough, inliers, maskf).to(source.dtype)
    Rf, sf, tf = umeyama.transform_pts(source, target, w)
    return SimilarityFit(R=Rf, s=sf, t=tf, inliers=inliers,
                         score=scores.gather(-1, best.unsqueeze(-1)).squeeze(-1))
