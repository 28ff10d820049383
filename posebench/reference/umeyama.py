"""Batched similarity alignment: the benchmark's frozen copy of
the port's `pose/umeyama.py`.

Every function takes arbitrary leading batch dims (the reference's vmap
written out): points are (..., N, 3), weights (..., N).  The rotation is
Horn's quaternion method with a fixed-iteration power method, as in the
reference: no SVD or eigensolver, so the cost is fixed and degenerate
samples cannot stall it.  `kabsch_rotation(method="svd")` and
`transform_pts(method="svd")` take the SVD of the cross-covariance
instead, as the reference's NumPy `rotate_pts` does; no path of the fit
uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-9


def _wmean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the point axis. x (..., N, 3), w (..., N)."""
    wsum = torch.clamp_min(w.sum(dim=-1, keepdim=True), EPS)
    return (x * w.unsqueeze(-1)).sum(dim=-2) / wsum


def _mm4(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) product with the reference's summation order
    (((a0·b0 + a1·b1) + a2·b2) + a3·b3), written as broadcast products."""
    out = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, 4):
        out = out + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return out


def _fro(A: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((A * A).sum(dim=(-2, -1), keepdim=True))


def _horn_rotation(M: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Proper rotation maximising tr(Rᵀ M) from a (..., 3, 3)
    cross-covariance M = Σ w·target·sourceᵀ (umeyama.py:46-117).

    Horn's 4×4 matrix is shifted positive, then squared `iters` times
    with renormalisation, so every column converges to the dominant
    eigenvector; the largest column is the quaternion.
    """
    Sxx, Syx, Szx = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Sxy, Syy, Szy = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Sxz, Syz, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [[Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]]
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    shift = _fro(N) + 1e-6
    B = N + shift * torch.eye(4, dtype=M.dtype, device=M.device)
    B = B / _fro(B)
    for _ in range(iters):
        B2 = _mm4(B, B)
        B = B2 / torch.clamp_min(_fro(B2), EPS)

    # every column is ∝ the eigenvector: take the largest (first on ties
    # within each pair, as the reference's >= comparisons do)
    colnorm = (B * B).sum(dim=-2)                            # (..., 4)
    best01 = torch.where(colnorm[..., 0] >= colnorm[..., 1], 0, 1)
    best23 = torch.where(colnorm[..., 2] >= colnorm[..., 3], 2, 3)
    n01 = torch.maximum(colnorm[..., 0], colnorm[..., 1])
    n23 = torch.maximum(colnorm[..., 2], colnorm[..., 3])
    col = torch.where(n01 >= n23, best01, best23)
    q = torch.gather(B, -1, col[..., None, None].expand(
        *col.shape, 4, 1)).squeeze(-1)                       # (..., 4)
    q = q / torch.clamp_min(torch.sqrt((q * q).sum(-1, keepdim=True)), EPS)
    a, b, c, d = q.unbind(-1)
    R = [[a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
          2 * (b * d + a * c)],
         [2 * (b * c + a * d), a * a - b * b + c * c - d * d,
          2 * (c * d - a * b)],
         [2 * (b * d - a * c), 2 * (c * d + a * b),
          a * a - b * b - c * c + d * d]]
    return torch.stack([torch.stack(r, dim=-1) for r in R], dim=-2)


def _cross_cov(tc: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """M = tcᵀ @ sc over the point axis: (..., N, 3) x2 -> (..., 3, 3).

    Tiny point sets (N <= 8: RANSAC minimal samples, axis-augmented
    sweeps) sum point by point, as the reference unrolls them.
    """
    N = tc.shape[-2]
    if N <= 8:
        M = tc[..., 0, :, None] * sc[..., 0, None, :]
        for p in range(1, N):
            M = M + tc[..., p, :, None] * sc[..., p, None, :]
        return M
    return tc.transpose(-1, -2) @ sc


def _svd_rotation(M: torch.Tensor) -> torch.Tensor:
    """Proper rotation from a (..., 3, 3) cross-covariance by SVD with
    the determinant flip (umeyama.py:37-43)."""
    U, _, Vh = torch.linalg.svd(M)
    d = torch.linalg.det(U) * torch.linalg.det(Vh)
    flip = torch.where(d < 0.0, -1.0, 1.0).to(M.dtype)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * flip[..., None, None]], -1)
    return U @ Vh


def kabsch_rotation(source: torch.Tensor, target: torch.Tensor,
                    w: torch.Tensor, method: str = "horn") -> torch.Tensor:
    """Rotation R with target ≈ R @ source, both centred internally.

    method "horn" (the default, and the fit's): the fixed-iteration
    quaternion solve; "svd": `torch.linalg.svd` of the cross-covariance,
    as umeyama.py:122-146."""
    if method not in ("horn", "svd"):
        raise ValueError(f"method must be 'horn' or 'svd', got {method!r}")
    sc = (source - _wmean(source, w).unsqueeze(-2)) * w.unsqueeze(-1)
    tc = target - _wmean(target, w).unsqueeze(-2)
    if method == "svd":
        return _svd_rotation(tc.transpose(-1, -2) @ sc)
    return _horn_rotation(_cross_cov(tc, sc))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min((v * v).sum(-1), 0.0))


def _pairwise_sums(source: torch.Tensor, target: torch.Tensor,
                   w: torch.Tensor, max_exact: int):
    """(A, B, C) = (Σww·a², Σww·b², Σww·a·b) over the pair set, a/b the
    source/target pair distances (umeyama.py:151-186): all pairs up to
    `max_exact` points, else 16 cyclic strides spread over [1, N)."""
    N = source.shape[-2]
    if N <= max_exact:
        a = _norm(source.unsqueeze(-2) - source.unsqueeze(-3))   # (..., N, N)
        b = _norm(target.unsqueeze(-2) - target.unsqueeze(-3))
        ww = w.unsqueeze(-1) * w.unsqueeze(-2)
        dims = (-2, -1)
        return ((ww * a * a).sum(dims), (ww * b * b).sum(dims),
                (ww * a * b).sum(dims))
    A = B = C = 0.0
    for k in [max(1, (i * N) // 33) for i in range(1, 17)]:
        a = _norm(source - torch.roll(source, k, dims=-2))
        b = _norm(target - torch.roll(target, k, dims=-2))
        ww = w * torch.roll(w, k, dims=-1)
        A = A + (ww * a * a).sum(-1)
        B = B + (ww * b * b).sum(-1)
        C = C + (ww * a * b).sum(-1)
    return A, B, C


def pairwise_scale(source, target, w, max_exact: int = 256):
    """Scale from the pairwise-distance ratio Σ|ds||dt| / Σ|ds|²."""
    A, _, C = _pairwise_sums(source, target, w, max_exact)
    return C / (A + 1e-6)


def pairwise_scale_both(source, target, w, max_exact: int = 256):
    """(scale source→target, scale target→source) from one sweep."""
    A, B, C = _pairwise_sums(source, target, w, max_exact)
    return C / (A + 1e-6), C / (B + 1e-6)


def transform_pts(source: torch.Tensor, target: torch.Tensor,
                  w: torch.Tensor, method: str = "horn"):
    """(R, s, t) with target ≈ s·R@source + t (d3_utils.py:223-234); the
    rotation by `kabsch_rotation(method=)`."""
    R = kabsch_rotation(source, target, w, method=method)
    s = pairwise_scale(source, target, w)
    mu_s = _wmean(source, w)
    t = _wmean(target, w) - s.unsqueeze(-1) * (R @ mu_s.unsqueeze(-1)
                                               ).squeeze(-1)
    return R, s, t


def fit_3pt_similarity(src3: torch.Tensor, tgt3: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """transform_pts for RANSAC minimal samples, unrolled over the 3 points
    (umeyama.py:234-269).  src3/tgt3 (..., 3, 3) (points × xyz)."""
    s = [src3[..., p, :] for p in range(3)]                  # (..., 3) each
    t = [tgt3[..., p, :] for p in range(3)]
    mus = (s[0] + s[1] + s[2]) / 3.0
    mut = (t[0] + t[1] + t[2]) / 3.0
    sc = torch.stack([v - mus for v in s], dim=-2)
    tc = torch.stack([v - mut for v in t], dim=-2)
    R = _horn_rotation(_cross_cov(tc, sc))
    num = torch.zeros_like(mus[..., 0])
    den = torch.zeros_like(mus[..., 0])
    for p, q in ((0, 1), (0, 2), (1, 2)):
        ds = s[p] - s[q]
        dt = t[p] - t[q]
        a2 = (ds[..., 0] * ds[..., 0] + ds[..., 1] * ds[..., 1]) \
            + ds[..., 2] * ds[..., 2]
        b2 = (dt[..., 0] * dt[..., 0] + dt[..., 1] * dt[..., 1]) \
            + dt[..., 2] * dt[..., 2]
        a = torch.sqrt(torch.clamp_min(a2, 0.0))
        num = num + a * torch.sqrt(torch.clamp_min(b2, 0.0))
        den = den + a2
    scale = num / (den + 1e-6 / 2.0)
    Rmu = (R * mus.unsqueeze(-2)).sum(-1)                    # R @ mus
    return R, scale, mut - scale.unsqueeze(-1) * Rmu


def umeyama_similarity(source: torch.Tensor, target: torch.Tensor,
                       w: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Umeyama similarity with its variance-based scale (umeyama.py:272,
    aligning.py:580-622): (R, s, t) with target ≈ s·R@source + t.

    The SVD oracle of the Horn fits above; no path of the port calls
    it.  source/target (..., N, 3), w (..., N) or None.
    """
    if w is None:
        n = source.shape[-2]
        mu_s, mu_t = source.mean(dim=-2), target.mean(dim=-2)
        sc, tc = source - mu_s.unsqueeze(-2), target - mu_t.unsqueeze(-2)
        cov = tc.transpose(-1, -2) @ sc / n
        var_s = (sc * sc).sum(dim=(-2, -1)) / n
    else:
        wsum = torch.clamp_min(w.sum(dim=-1), EPS)
        mu_s, mu_t = _wmean(source, w), _wmean(target, w)
        sc, tc = source - mu_s.unsqueeze(-2), target - mu_t.unsqueeze(-2)
        cov = ((tc * w.unsqueeze(-1)).transpose(-1, -2) @ sc
               / wsum[..., None, None])
        var_s = (sc * sc * w.unsqueeze(-1)).sum(dim=(-2, -1)) / wsum
    U, D, Vh = torch.linalg.svd(cov)
    flip = torch.where(torch.linalg.det(U) * torch.linalg.det(Vh) < 0.0,
                       -1.0, 1.0).to(cov.dtype)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * flip[..., None, None]], -1)
    D = torch.cat([D[..., :2], D[..., 2:] * flip[..., None]], -1)
    R = U @ Vh
    s = D.sum(dim=-1) / torch.clamp_min(var_s, EPS)
    t = mu_t - s.unsqueeze(-1) * (R @ mu_s.unsqueeze(-1)).squeeze(-1)
    return R, s, t


def similarity_residual(R, s, t, source, target) -> torch.Tensor:
    """Per-point residual norm |target − (s·R@source + t)|, (..., N)."""
    pred = s[..., None, None] * (source @ R.transpose(-1, -2)) \
        + t.unsqueeze(-2)
    return torch.linalg.vector_norm(target - pred, dim=-1)
