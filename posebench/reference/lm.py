"""Joint-constrained rotation refinement: the benchmark's frozen copy of
the port's `pose/lm.py`.

A fixed-iteration damped Gauss-Newton on the 6-dof rotation-vector pair
with the normal equations assembled analytically (lm.py:108-199), and the
closed-form alternating-Kabsch estimator used for RANSAC hypotheses.
All functions take leading batch dims.  Control flow on tensor values is
`torch.where`, never a host branch, and the 6×6 solve does not check for
singularity (`solve_ex`), so the whole path can run without a host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from posebench.reference import umeyama

EPS = 1e-12


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _theta_axis(rotvec: torch.Tensor):
    theta = torch.sqrt((rotvec * rotvec).sum(-1, keepdim=True) + EPS)
    return theta, rotvec / theta


def rotvec_rotate(points: torch.Tensor, rotvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of (..., N, 3) points by (..., 3) rotation vectors."""
    theta, v = _theta_axis(rotvec)
    cos = torch.cos(theta).unsqueeze(-2)
    sin = torch.sin(theta).unsqueeze(-2)
    v = v.unsqueeze(-2)
    dot = (points * v).sum(-1, keepdim=True)
    return (cos * points + sin * _cross(v.expand_as(points), points)
            + (1.0 - cos) * dot * v)


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], dim=-2)


def _eye(ref: torch.Tensor, n: int = 3) -> torch.Tensor:
    return torch.eye(n, dtype=ref.dtype, device=ref.device)


def rotvec_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    theta, k = _theta_axis(rotvec)
    K = _skew(k)
    th = theta.unsqueeze(-1)
    return _eye(rotvec) + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def matrix_to_rotvec(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues; stable near θ=0, falls back near θ=π (lm.py:52-66)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    axis_raw = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                            R[..., 0, 2] - R[..., 2, 0],
                            R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin = torch.sqrt(torch.clamp_min(1.0 - cos * cos, EPS))
    axis = axis_raw / (2.0 * sin.unsqueeze(-1))
    diag = torch.sqrt(torch.clamp_min(
        (torch.diagonal(R, dim1=-2, dim2=-1) + 1.0) / 2.0, 0.0))
    dom = diag.argmax(dim=-1, keepdim=True)
    alt = diag * torch.sign(axis_raw + 1e-30)
    is_dom = torch.arange(3, device=R.device) == dom
    alt = torch.where(is_dom, diag, alt)
    alt = alt / torch.clamp_min(torch.linalg.vector_norm(alt, dim=-1,
                                                         keepdim=True), EPS)
    use_alt = (theta > (math.pi - 1e-3)).unsqueeze(-1)
    return torch.where(use_alt, alt, axis) * theta.unsqueeze(-1)


def joint_residuals(params, x0, y0, m0, x1, y1, m1, joint_dir, joint_mult,
                    prismatic: bool) -> torch.Tensor:
    """Stacked masked residuals of the rotvec pair params (..., 6)
    (lm.py:69-85); joint_mult (...,) is the joint row's multiplicity."""
    v0, v1 = params[..., :3], params[..., 3:]
    r0 = (y0 - rotvec_rotate(x0, v0)) * m0.unsqueeze(-1)
    r1 = (y1 - rotvec_rotate(x1, v1)) * m1.unsqueeze(-1)
    sqm = torch.sqrt(joint_mult).unsqueeze(-1)
    if prismatic:
        rj = (v0 - v1) * sqm
    else:
        a = joint_dir.unsqueeze(-2)
        rj = (rotvec_rotate(a, v0) - rotvec_rotate(a, v1)).squeeze(-2) * sqm
    return torch.cat([r0.flatten(-2), r1.flatten(-2), rj], dim=-1)


def _right_jacobian(rotvec: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian with the same θ smoothing as rotvec_rotate."""
    theta, k = _theta_axis(rotvec)
    K = _skew(k)
    th = theta.unsqueeze(-1)
    a = (1.0 - torch.cos(th)) / th
    b = (th - torch.sin(th)) / th
    return _eye(rotvec) - a * K + b * (K @ K)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def lm_refine_joint(rotvec0, rotvec1, x0, y0, m0, x1, y1, m1, joint_dir,
                    joint_mult, *, iters: int = 20, prismatic: bool = False):
    """Damped Gauss-Newton from (rotvec0, rotvec1) (lm.py:108-199).

    x*/y* (..., P, 3) centred buffers (targets pre-scaled), m* (..., P)
    masks, joint_dir (..., 3), joint_mult (...,).  With
    D(v, x) = −R(v)·skew(x)·Jr(v), the point blocks of JᵀJ are
    Jrᵀ[Σ m²(|x|²I − xxᵀ) + mult(|a|²I − aaᵀ)]Jr, whose bracket is
    constant over the iterations.
    """
    a = joint_dir
    mult = joint_mult[..., None, None]
    sqm = torch.sqrt(joint_mult).unsqueeze(-1)
    I3 = _eye(x0)

    def moment(x, m):
        xx = (x * (m * m).unsqueeze(-1)).transpose(-1, -2) @ x
        tr = torch.diagonal(xx, dim1=-2, dim2=-1).sum(-1)
        return tr[..., None, None] * I3 - xx

    Ma = mult * ((a * a).sum(-1)[..., None, None] * I3
                 - a.unsqueeze(-1) * a.unsqueeze(-2))
    M0 = moment(x0, m0) + (0.0 if prismatic else 1.0) * Ma
    M1 = moment(x1, m1) + (0.0 if prismatic else 1.0) * Ma
    Ka = _skew(a)
    w0 = (m0 * m0).unsqueeze(-1)
    w1 = (m1 * m1).unsqueeze(-1)

    def cost(p):
        r = joint_residuals(p, x0, y0, m0, x1, y1, m1, joint_dir, joint_mult,
                            prismatic)
        return (r * r).sum(-1)

    p = torch.cat([rotvec0, rotvec1], dim=-1)
    lam = torch.full(p.shape[:-1], 1e-3, dtype=p.dtype, device=p.device)
    for _ in range(iters):
        v0, v1 = p[..., :3], p[..., 3:]
        R0, R1 = rotvec_to_matrix(v0), rotvec_to_matrix(v1)
        Jr0, Jr1 = _right_jacobian(v0), _right_jacobian(v1)
        e0 = y0 - x0 @ R0.transpose(-1, -2)
        e1 = y1 - x1 @ R1.transpose(-1, -2)
        c0 = (_cross(x0, e0 @ R0) * w0).sum(-2)
        c1 = (_cross(x1, e1 @ R1) * w1).sum(-2)

        H00 = Jr0.transpose(-1, -2) @ M0 @ Jr0
        H11 = Jr1.transpose(-1, -2) @ M1 @ Jr1
        if prismatic:
            H00 = H00 + mult * I3
            H11 = H11 + mult * I3
            H01 = -mult * I3
            rj = (v0 - v1) * sqm
            g0 = -_mv(Jr0.transpose(-1, -2), c0) + sqm * rj
            g1 = -_mv(Jr1.transpose(-1, -2), c1) - sqm * rj
        else:
            Da0 = -R0 @ Ka @ Jr0
            Da1 = -R1 @ Ka @ Jr1
            H01 = -mult * (Da0.transpose(-1, -2) @ Da1)
            rj = (_mv(R0, a) - _mv(R1, a)) * sqm
            g0 = -_mv(Jr0.transpose(-1, -2), c0) \
                + sqm * _mv(Da0.transpose(-1, -2), rj)
            g1 = -_mv(Jr1.transpose(-1, -2), c1) \
                - sqm * _mv(Da1.transpose(-1, -2), rj)
        H = torch.cat([torch.cat([H00, H01], -1),
                       torch.cat([H01.transpose(-1, -2), H11], -1)], -2)
        g = torch.cat([g0, g1], dim=-1)
        Hd = H + lam[..., None, None] * _eye(H, 6)
        # a singular system gives inf/NaN, which the cost test rejects
        dp = torch.linalg.solve_ex(Hd, -g.unsqueeze(-1),
                                   check_errors=False).result.squeeze(-1)
        p_new = p + dp
        base = ((e0 * e0 * w0).sum((-2, -1)) + (e1 * e1 * w1).sum((-2, -1))
                + (rj * rj).sum(-1))
        better = cost(p_new) < base
        p = torch.where(better.unsqueeze(-1), p_new, p)
        lam = torch.clamp(torch.where(better, lam * 0.33, lam * 3.0),
                          1e-8, 1e6)
    return p[..., :3], p[..., 3:]


def alternating_joint_rotations(x0, y0, w0, x1, y1, w1, joint_dir,
                                iters: int = 20):
    """Alternately refit R0 with the joint axis rotated by R1 appended as
    a correspondence, then R1 with the axis rotated by R0 (lm.py:237-270).
    The joint row weighs min(Σw0, Σw1)."""
    mult = torch.minimum(w0.sum(-1), w1.sum(-1)).unsqueeze(-1)
    a = joint_dir.unsqueeze(-2)                                   # (..., 1, 3)

    def aug_fit(x, y, w, axis_target):
        return umeyama.kabsch_rotation(torch.cat([x, a], -2),
                                       torch.cat([y, axis_target], -2),
                                       torch.cat([w, mult], -1))

    R0 = umeyama.kabsch_rotation(x0, y0, w0)
    R1 = umeyama.kabsch_rotation(x1, y1, w1)
    for _ in range(iters):
        R0 = aug_fit(x0, y0, w0, (a @ R1.transpose(-1, -2)))
        R1 = aug_fit(x1, y1, w1, (a @ R0.transpose(-1, -2)))
    return R0, R1


class JointFit(NamedTuple):
    R0: torch.Tensor
    s0: torch.Tensor
    t0: torch.Tensor
    R1: torch.Tensor
    s1: torch.Tensor
    t1: torch.Tensor


def _wmean1(x, w):
    """Σ x·w / max(Σ w, 1): the joint estimators' mean (lm.py:304-306)."""
    return (x * w.unsqueeze(-1)).sum(-2) / torch.clamp_min(
        w.sum(-1, keepdim=True), 1.0)


def _prepare(src0, tgt0, m0, src1, tgt1, m1):
    """Pairwise scales both ways, and the centred, masked buffers."""
    w0 = m0.to(src0.dtype)
    w1 = m1.to(src1.dtype)
    scale0, scale0_inv = umeyama.pairwise_scale_both(src0, tgt0, w0)
    scale1, scale1_inv = umeyama.pairwise_scale_both(src1, tgt1, w1)

    def centered(x, w):
        mu = _wmean1(x, w)
        return (x - mu.unsqueeze(-2)) * w.unsqueeze(-1)

    y0 = centered(tgt0 * scale0_inv[..., None, None], w0)
    x0 = centered(src0, w0)
    y1 = centered(tgt1 * scale1_inv[..., None, None], w1)
    x1 = centered(src1, w1)
    return w0, w1, scale0, scale1, x0, y0, x1, y1


def _translations(src0, tgt0, w0, s0, R0, src1, tgt1, w1, s1, R1) -> JointFit:
    def trans(tgt, src, w, s, R):
        return _wmean1(tgt, w) - s.unsqueeze(-1) * _mv(R, _wmean1(src, w))

    return JointFit(R0=R0, s0=s0, t0=trans(tgt0, src0, w0, s0, R0),
                    R1=R1, s1=s1, t1=trans(tgt1, src1, w1, s1, R1))


def joint_transformation_estimate_alt(src0, tgt0, m0, src1, tgt1, m1,
                                      joint_dir, *, sweeps: int = 3,
                                      prismatic: bool = False) -> JointFit:
    """Closed-form coupled similarity fit by alternating Kabsch sweeps
    (lm.py:282-329); prismatic joints share one rotation over the union."""
    w0, w1, scale0, scale1, x0, y0, x1, y1 = _prepare(src0, tgt0, m0, src1,
                                                      tgt1, m1)
    if prismatic:
        R0 = R1 = umeyama.kabsch_rotation(torch.cat([x0, x1], -2),
                                          torch.cat([y0, y1], -2),
                                          torch.cat([w0, w1], -1))
    else:
        R0, R1 = alternating_joint_rotations(x0, y0, w0, x1, y1, w1,
                                             joint_dir, iters=sweeps)
    return _translations(src0, tgt0, w0, scale0, R0, src1, tgt1, w1, scale1,
                         R1)


def joint_transformation_estimate(src0, tgt0, m0, src1, tgt1, m1, joint_dir,
                                  *, lm_iters: int = 20,
                                  prismatic: bool = False) -> JointFit:
    """Two-part coupled similarity fit: Kabsch init, joint LM, closed-form
    translations with the forward pairwise scales (lm.py:332-374)."""
    w0, w1, scale0, scale1, x0, y0, x1, y1 = _prepare(src0, tgt0, m0, src1,
                                                      tgt1, m1)
    v0 = matrix_to_rotvec(umeyama.kabsch_rotation(src0, tgt0, w0))
    v1 = matrix_to_rotvec(umeyama.kabsch_rotation(src1, tgt1, w1))
    mult = torch.minimum(w0.sum(-1), w1.sum(-1))
    v0, v1 = lm_refine_joint(v0, v1, x0, y0, w0, x1, y1, w1, joint_dir, mult,
                             iters=lm_iters, prismatic=prismatic)
    return _translations(src0, tgt0, w0, scale0, rotvec_to_matrix(v0),
                         src1, tgt1, w1, scale1, rotvec_to_matrix(v1))
