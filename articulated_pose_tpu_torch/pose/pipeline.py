"""Pose fitting from network predictions: counterpart of
`articulated_pose_tpu/pose/pipeline.py`.

Per frame, batched over frames (B) and parts (K):
1. argmax segmentation -> valid-first per-part buffers (one sort of a
   composite key, then one gather of the points and NOCS along each
   part's rows),
2. per-part RANSAC similarity fits ("baseline"),
3. per-joint vote (median, or the normalised mean) of the predicted
   joint axis over the points associated with that joint: by the joint
   head, or by the GT labels when `use_gt_association` is set and they
   are given,
4. per joint, joint-constrained RANSAC (alternating-Kabsch or full LM
   hypotheses) and a damped Gauss-Newton refit on the best inlier sets
   ("nonlinear"); with `batch_joints`, joints of one type are solved in
   one batched call.  Part 0's pose comes from the first joint's solve.
   On CUDA buffers with alternating hypotheses, every joint of the batch
   is solved in one launch of the `joint_fit` kernel
   (`ops/kernels/joint_fit.py`), which picks the hypotheses and inliers
   this plain path (`joint_fit_plain`) picks; elsewhere (the CPU, "lm"
   hypotheses) the plain path runs.  `JOINT_PROBLEMS` counts the
   problems each solved.

The randomness comes in as `PoseDraws`, so a run is a pure function of
its inputs, and the parity tests can hand in the JAX package's draws.
Nothing here branches on tensor values on the host.  Inside a captured
program the ends of steps 1, 2 and 4 are stage marks ("fit.partition",
"fit.ransac", "fit.joint"; `utils/profiling.stage`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from articulated_pose_tpu_torch.ops.kernels.joint_fit import (JointStage,
                                                              joint_fit)
from articulated_pose_tpu_torch.pose import umeyama
from articulated_pose_tpu_torch.pose.lm import (
    joint_transformation_estimate, joint_transformation_estimate_alt)
from articulated_pose_tpu_torch.pose.ransac import (gather_points,
                                                    hypothesis_inlier_counts,
                                                    masked_sample_indices,
                                                    ransac_similarity)
from articulated_pose_tpu_torch.utils.profiling import stage


@dataclasses.dataclass(frozen=True)
class PoseFitConfig:
    """Production defaults of the reference (pipeline.py:41-106); the
    reasons for each value are documented there."""

    n_parts: int = 3
    niter_part: int = 128
    niter_joint: int = 64
    inlier_th: float = 0.1
    # the joint hypotheses' LM iterations under hypo_estimator="lm"
    lm_iters_hypo: int = 10
    lm_iters_refit: int = 6
    part_points: Optional[int] = 1024
    ransac_score_points: Optional[int] = 1024
    # the joint hypotheses: "alternating" (closed-form Kabsch sweeps) or
    # "lm" (the full coupled LM per hypothesis, batched over (B, H))
    hypo_estimator: str = "alternating"
    # vote the axes over the GT joint labels (`joint_cls_gt` of
    # fit_frame_batch) when they are given, as the reference's
    # evaluation/ solver does (pipeline.py:385-386)
    use_gt_association: bool = False
    joint_types: Tuple[str, ...] = ("revolute", "revolute")
    ransac_chunk: Optional[int] = 512
    lm_refit_points: Optional[int] = 512
    # solve the joints of one type in one batched call (K > 2); the same
    # draws give the loop's fits (pipeline.py:401-428): bit for bit on
    # the CPU, to float rounding on the card, whose batched products may
    # take other kernels at another batch count
    batch_joints: bool = False
    # the reference's two part-buffer builds ("sort", "gather") give the
    # same masked buffers; the port has one (build_part_buffers_sorted),
    # so either name is taken and selects nothing
    buffer_build: str = "sort"
    # the axis vote: "median" or "mean" (masked mean, normalised)
    axis_agg: str = "median"

    def __post_init__(self):
        for name, valid in (("hypo_estimator", ("alternating", "lm")),
                            ("buffer_build", ("sort", "gather")),
                            ("axis_agg", ("median", "mean"))):
            if getattr(self, name) not in valid:
                raise ValueError(f"{name} must be one of {valid}, got "
                                 f"{getattr(self, name)!r}")


@dataclasses.dataclass
class PoseDraws:
    """Uniforms in [0, 1) that pick the RANSAC minimal samples.

    part (B, K, niter_part, 3): part j's hypotheses; joint
    (B, K - 1, 2, niter_joint, 3): joint j's base-part and moving-part
    hypotheses.
    """

    part: torch.Tensor
    joint: torch.Tensor

    @classmethod
    def sample(cls, batch: int, cfg: PoseFitConfig,
               generator: Optional[torch.Generator] = None,
               device=None) -> "PoseDraws":
        K = cfg.n_parts
        return cls(
            part=torch.rand((batch, K, cfg.niter_part, 3),
                            generator=generator, device=device),
            joint=torch.rand((batch, max(K - 1, 0), 2, cfg.niter_joint, 3),
                             generator=generator, device=device))

    def to(self, device) -> "PoseDraws":
        return PoseDraws(part=self.part.to(device),
                         joint=self.joint.to(device))


# the composite sort key (cls << ceil_log2(N)) | index must stay below this
KEY_LIMIT = 2**31


def partition_by_class(cls: torch.Tensor, n_parts: int,
                       cap: Optional[int] = None):
    """Valid-first per-part index rows (pipeline.py:109-157).

    cls (B, N) int -> (order (B, K, cap) int32, cnt (B, K) int32); cap
    defaults to N.  Labels are clamped into [0, n_parts).  Row j's first
    min(cnt[j], cap) entries are part j's member indices in ascending
    order; later entries are arbitrary in-range indices (callers mask on
    cnt).  One sort of the composite key (cls << ceil_log2(N)) | index
    groups every part at once, and masking the key back out is the
    stable argsort; where that key would overflow int32 a stable argsort
    of the labels gives the same permutation.
    """
    B, N = cls.shape
    if cap is None or cap > N:
        cap = N
    cls = cls.clamp(0, n_parts - 1).to(torch.int32)
    shift = max(1, (N - 1).bit_length())
    if (n_parts << shift) < KEY_LIMIT:
        iota = torch.arange(N, dtype=torch.int32, device=cls.device)
        skey = torch.sort((cls << shift) | iota, dim=-1).values
        order = skey & ((1 << shift) - 1)
    else:
        order = torch.argsort(cls, dim=-1, stable=True).to(torch.int32)
    part_ids = torch.arange(n_parts, dtype=torch.int32, device=cls.device)
    cnts = (cls.unsqueeze(1) == part_ids[:, None]).sum(-1, dtype=torch.int32)
    starts = torch.cumsum(cnts, dim=-1) - cnts                     # (B, K)
    # pad so that start + cap never runs past the row
    order = torch.cat([order, order.new_zeros(B, cap)], dim=1)
    rows = starts.unsqueeze(-1).long() + torch.arange(cap, device=cls.device)
    return order.gather(1, rows.reshape(B, -1)).reshape(B, n_parts, cap), cnts


def build_part_buffers_sorted(nocs: torch.Tensor, P: torch.Tensor,
                              cls: torch.Tensor, n_parts: int, cap: int):
    """Valid-first part buffers (pipeline.py:160-205).

    nocs (B, N, 3K), P (B, N, 3), cls (B, N) -> (src (B, K, cap, 3),
    tgt (B, K, cap, 3), mask (B, K, cap), cnts (B, K) int32).  Part j's
    rows come from `partition_by_class`, and one gather takes P and the
    K NOCS planes along them.  After masking these are the buffers of
    both of the reference's builds ("sort" and "gather",
    pipeline.py:344-355); where the composite key would overflow int32,
    partition_by_class's argsort branch takes over, so no N is refused.
    """
    B = cls.shape[0]
    K = n_parts
    rows, cnts = partition_by_class(cls, K, cap)                   # (B, K, cap)
    cap = rows.shape[-1]
    payload = torch.cat([P, nocs], dim=-1)                         # (B, N, 3+3K)
    bufs = payload.gather(1, rows.long().reshape(B, K * cap, 1).expand(
        B, K * cap, 3 + 3 * K)).reshape(B, K, cap, 3 + 3 * K)
    mask = (torch.arange(cap, device=cls.device) < cnts.unsqueeze(-1)
            ).to(P.dtype)
    tgt = bufs[..., :3]
    src = torch.stack([bufs[:, j, :, 3 + 3 * j:6 + 3 * j] for j in range(K)],
                      dim=1)
    m = mask.unsqueeze(-1)
    return src * m, tgt * m, mask, cnts


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-column median over masked rows. x (..., N, C), mask (..., N)
    -> (..., C); no masked row gives inf."""
    big = torch.where(mask.unsqueeze(-2) > 0, x.transpose(-1, -2), torch.inf)
    v = torch.sort(big, dim=-1).values                             # (..., C, N)
    cnt = torch.clamp_min((mask > 0).sum(-1), 1)
    lo = ((cnt - 1) // 2)[..., None, None].expand(*v.shape[:-1], 1)
    hi = (cnt // 2)[..., None, None].expand(*v.shape[:-1], 1)
    return ((v.gather(-1, lo) + v.gather(-1, hi)) / 2.0).squeeze(-1)


def vote_joint_axes(axis_pp: torch.Tensor, assocs: torch.Tensor,
                    agg: str = "median") -> torch.Tensor:
    """Joint-axis vote over the associated points (pipeline.py:225-253).
    axis_pp (B, N, 3), assocs (B, J, N) {0, 1} -> (B, J, 3).  "median":
    the per-component median; "mean": the masked mean normalised to unit
    length (a mean of unit vectors shrinks, and the axis's length scales
    the joint row of the LM).  A joint with no associated point, or
    whose mean cancels to under 1e-6, falls back to +z."""
    if agg == "mean":
        cnt = assocs.sum(-1, keepdim=True)                        # (B, J, 1)
        v = (axis_pp.unsqueeze(1) * assocs.unsqueeze(-1)).sum(-2) \
            / torch.clamp_min(cnt, 1.0)
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        axes = torch.where((cnt > 0) & (n > 1e-6),
                           v / torch.clamp_min(n, 1e-6), torch.nan)
    else:
        axes = masked_median(axis_pp.unsqueeze(1), assocs)
    # +z built on the device: a host-made constant would be a copy that
    # waits for the stream
    z = (torch.arange(3, device=axes.device) == 2).to(axes.dtype)
    return torch.where(torch.isfinite(axes), axes, z)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x (B, H, *rest), i (B,) -> (B, *rest)."""
    idx = i.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], 1) + tuple(x.shape[2:]))
    return x.gather(1, idx).squeeze(1)


def joint_hypotheses(u0, u1, src0, tgt0, m0, src1, tgt1, m1, jt_axis,
                     cfg: PoseFitConfig, prismatic: bool):
    """The hypothesis half of the joint RANSAC for one (base, moving-part)
    pair, batched over frames (pipeline.py:266-301): fits of the drawn
    minimal samples (alternating Kabsch, or the full LM with
    `lm_iters_hypo` iterations, by `cfg.hypo_estimator`) and their mean
    inlier ratio over both parts' score prefix.  u0/u1 (B, H, 3)
    uniforms; buffers (B, P, 3), masks (B, P), jt_axis (B, 3) ->
    (JointFit of (B, H, ...), scores (B, H))."""
    B, H = u0.shape[:2]
    i0 = masked_sample_indices(u0, m0)
    i1 = masked_sample_indices(u1, m1)
    ones3 = torch.ones((B, H, 3), dtype=src0.dtype, device=src0.device)
    args = (gather_points(src0, i0), gather_points(tgt0, i0), ones3,
            gather_points(src1, i1), gather_points(tgt1, i1), ones3,
            jt_axis.unsqueeze(1).expand(B, H, 3))
    if cfg.hypo_estimator == "lm":
        fits = joint_transformation_estimate(
            *args, lm_iters=cfg.lm_iters_hypo, prismatic=prismatic)
    else:
        fits = joint_transformation_estimate_alt(*args, sweeps=3,
                                                 prismatic=prismatic)

    P = src0.shape[1]
    sp = cfg.ransac_score_points
    sp = sp if (sp is not None and sp < P) else P
    c0 = hypothesis_inlier_counts(fits.R0, fits.s0, fits.t0, src0[:, :sp],
                                  tgt0[:, :sp], m0[:, :sp] > 0, cfg.inlier_th)
    c1 = hypothesis_inlier_counts(fits.R1, fits.s1, fits.t1, src1[:, :sp],
                                  tgt1[:, :sp], m1[:, :sp] > 0, cfg.inlier_th)
    frac0 = c0 / torch.clamp_min(m0[:, :sp].sum(-1, keepdim=True), 1.0)
    frac1 = c1 / torch.clamp_min(m1[:, :sp].sum(-1, keepdim=True), 1.0)
    return fits, (frac0 + frac1) / 2.0


def joint_inliers(fits, scores, src0, tgt0, m0, src1, tgt1, m1,
                  cfg: PoseFitConfig):
    """The best hypothesis (the first maximum of `scores`, (B, H)) and its
    inlier sets over every row of both parts (pipeline.py:305-317): its
    residual under `inlier_th`, or the part's mask where that leaves
    fewer than 3 points.  -> (best (B,), w0 (B, P), w1 (B, P))."""
    best = scores.argmax(dim=-1)                                   # (B,)

    def inliers(R, s, t, src, tgt, m):
        res = umeyama.similarity_residual(_take(R, best), _take(s, best),
                                          _take(t, best), src, tgt)
        bi = (res < cfg.inlier_th) & (m > 0)
        return torch.where(bi.sum(-1, keepdim=True) >= 3, bi, m > 0
                           ).to(src.dtype)

    return (best, inliers(fits.R0, fits.s0, fits.t0, src0, tgt0, m0),
            inliers(fits.R1, fits.s1, fits.t1, src1, tgt1, m1))


def _joint_ransac(u0, u1, src0, tgt0, m0, src1, tgt1, m1, jt_axis,
                  cfg: PoseFitConfig, prismatic: bool):
    """Joint-constrained RANSAC for one (base, moving-part) pair, batched
    over frames (pipeline.py:256-320): `joint_hypotheses`, then the full
    joint LM on the best one's inliers.  -> (the refit's JointFit (B,),
    the hypotheses' JointFit (B, H), scores (B, H), best (B,), w0, w1
    (B, P))."""
    fits, scores = joint_hypotheses(u0, u1, src0, tgt0, m0, src1, tgt1, m1,
                                    jt_axis, cfg, prismatic)
    best, w0, w1 = joint_inliers(fits, scores, src0, tgt0, m0, src1, tgt1,
                                 m1, cfg)
    return (_joint_refit(src0, tgt0, w0, src1, tgt1, w1, jt_axis, cfg,
                         prismatic), fits, scores, best, w0, w1)


def _joint_refit(src0, tgt0, w0, src1, tgt1, w1, jt_axis,
                 cfg: PoseFitConfig, prismatic: bool):
    """The joint LM on inlier weights w0/w1, over the first
    `lm_refit_points` rows."""
    cap = cfg.lm_refit_points
    if cap is not None and cap < src0.shape[1]:
        src0, tgt0, w0 = src0[:, :cap], tgt0[:, :cap], w0[:, :cap]
        src1, tgt1, w1 = src1[:, :cap], tgt1[:, :cap], w1[:, :cap]
    return joint_transformation_estimate(
        src0, tgt0, w0, src1, tgt1, w1, jt_axis,
        lm_iters=cfg.lm_iters_refit, prismatic=prismatic)


def fit_frame(pred: Dict[str, torch.Tensor], P: torch.Tensor,
              draws: PoseDraws, cfg: PoseFitConfig,
              joint_cls_gt: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """One frame: pred values (N, ...), P (N, 3), draws (and joint_cls_gt)
    without the batch axis -> fit_frame_batch's outputs without it."""
    out = fit_frame_batch({k: v[None] for k, v in pred.items()}, P[None],
                          PoseDraws(draws.part[None], draws.joint[None]), cfg,
                          None if joint_cls_gt is None else joint_cls_gt[None])
    return {k: v[0] for k, v in out.items()}


def _joint_group(js, draws: torch.Tensor, src, tgt, mask, axes,
                 cfg: PoseFitConfig, prismatic: bool,
                 diagnostics: bool = False) -> JointStage:
    """The joints `js` (all of one type) solved in one batched call: the
    frames and the joints flattened into one batch axis, the base part's
    buffers repeated for each joint (draws `PoseDraws.joint`).  Returns
    the group's JointStage, (B, len(js), ...).  The loop solves one joint
    a call through the same function, so the two give the same fits."""
    B, J = src.shape[0], len(js)

    def flat(x, idx):            # (B, ...) slices x[:, i] -> (B*J, ...)
        if J == 1:               # the loop's call: the slice itself
            return x[:, idx[0]]
        # stacked from slices: an index tensor made on the host would be
        # a copy that waits for the stream
        return torch.stack([x[:, i] for i in idx], 1).reshape(
            (B * J,) + x.shape[2:])

    def unflat(x):
        return x.reshape((B, J) + x.shape[1:])

    moving, joint, base = js, [j - 1 for j in js], [0] * J
    fit, fits, scores, best, w0, w1 = _joint_ransac(
        flat(draws[:, :, 0], joint), flat(draws[:, :, 1], joint),
        flat(src, base), flat(tgt, base), flat(mask, base),
        flat(src, moving), flat(tgt, moving), flat(mask, moving),
        flat(axes, joint), cfg, prismatic)
    hyp = (torch.cat([fits.R0.flatten(-2), fits.s0[..., None], fits.t0,
                      fits.R1.flatten(-2), fits.s1[..., None], fits.t1], -1)
           if diagnostics else None)
    return JointStage(
        *(unflat(x) for x in fit), best=unflat(best.to(torch.int32)),
        scores=unflat(scores),
        inliers=unflat(torch.stack([w0 > 0, w1 > 0], 1)),
        hypotheses=None if hyp is None else unflat(hyp))


@dataclasses.dataclass
class JointProblems:
    """How many (frame, joint) problems `fit_frame_batch` handed to the
    `joint_fit` kernel and to the plain path, counted each time Python
    runs the fit (eagerly, or once as a program is captured)."""

    kernel: int = 0
    plain: int = 0

    def share(self) -> float:
        """The kernel's share of the problems counted (0 when none)."""
        n = self.kernel + self.plain
        return self.kernel / n if n else 0.0

    def reset(self) -> None:
        self.kernel = self.plain = 0


JOINT_PROBLEMS = JointProblems()


def takes_kernel(src: torch.Tensor, cfg: PoseFitConfig) -> bool:
    """Whether the joint stage on these part buffers runs the `joint_fit`
    kernel: CUDA buffers and alternating hypotheses.  The kernel refuses
    a dtype other than float32, so such buffers raise on the card."""
    return src.device.type == "cuda" and cfg.hypo_estimator == "alternating"


def joint_fit_plain(src, tgt, mask, axes, draws: torch.Tensor,
                    cfg: PoseFitConfig, diagnostics: bool = False
                    ) -> JointStage:
    """What the `joint_fit` kernel returns, by the plain path, and what
    fit_frame_batch solves where the kernel does not run.  The joints go
    in groups, in the order they are solved: one a joint, or with
    batch_joints (K > 2) one a type, in order of first appearance; each
    joint's fields land in its place.  Buffers (B, K, cap, ·), axes
    (B, K - 1, 3), draws `PoseDraws.joint`."""
    K = src.shape[1]
    groups = {}
    for j in range(1, K):
        prismatic = cfg.joint_types[j - 1] == "prismatic"
        key = prismatic if cfg.batch_joints and K > 2 else j
        groups.setdefault(key, (prismatic, []))[1].append(j)
    per_joint = [None] * (K - 1)
    for prismatic, js in groups.values():
        st = _joint_group(js, draws, src, tgt, mask, axes, cfg, prismatic,
                          diagnostics)
        for i, j in enumerate(js):
            per_joint[j - 1] = [None if x is None else x[:, i] for x in st]
    return JointStage(*(
        None if per_joint[0][f] is None
        else torch.stack([p[f] for p in per_joint], 1)
        for f in range(len(JointStage._fields))))


def part_poses(st: JointStage):
    """The nonlinear (R, s, t) of every part, (B, K, ...), from a joint
    stage: part 0 from the first solve (joint 1's base part), part j from
    joint j's moving part."""
    return (torch.cat([st.R0[:, :1], st.R1], 1),
            torch.cat([st.s0[:, :1], st.s1], 1),
            torch.cat([st.t0[:, :1], st.t1], 1))


def joint_stage(src, tgt, mask, axes, draws: PoseDraws, cfg: PoseFitConfig):
    """The joint stage of `fit_frame_batch` for K >= 2 parts: the
    `joint_fit` kernel where `takes_kernel`, else `joint_fit_plain`;
    both give the nonlinear (R, s, t) of every part, (B, K, ...)."""
    B, K = src.shape[:2]
    if takes_kernel(src, cfg):
        st = joint_fit(src, tgt, mask, axes, draws.joint, cfg)
        JOINT_PROBLEMS.kernel += B * (K - 1)
    else:
        st = joint_fit_plain(src, tgt, mask, axes, draws.joint, cfg)
        JOINT_PROBLEMS.plain += B * (K - 1)
    return part_poses(st)


def fit_frame_batch(pred: Dict[str, torch.Tensor], P: torch.Tensor,
                    draws: PoseDraws, cfg: PoseFitConfig,
                    joint_cls_gt: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Fit every part pose of a batch of frames.

    pred: W (B, N, K), nocs_per_point (B, N, 3K), and for the joint
    stage joint_axis_per_point (B, N, 3) and index_per_point (B, N, K);
    P (B, N, 3) input clouds; joint_cls_gt (B, N), the GT joint labels
    that the axis vote takes in place of the joint head's under
    `cfg.use_gt_association`.  Returns baseline_{R,s,t} (B, K, 3, 3) /
    (B, K) / (B, K, 3), nonlinear_{R,s,t} when the joint heads are
    present, and part_counts (B, K).
    """
    K = cfg.n_parts
    N = P.shape[1]
    cls = pred["W"].argmax(dim=-1)
    cap = N if cfg.part_points is None else min(cfg.part_points, N)
    src, tgt, mask, cnts = build_part_buffers_sorted(
        pred["nocs_per_point"], P, cls, K, cap)
    stage("fit.partition")

    fits = ransac_similarity(draws.part, src, tgt, mask,
                             inlier_th=cfg.inlier_th, chunk=cfg.ransac_chunk,
                             score_points=cfg.ransac_score_points)
    stage("fit.ransac")
    out = {"baseline_R": fits.R, "baseline_s": fits.s, "baseline_t": fits.t}

    if "joint_axis_per_point" in pred:
        if cfg.use_gt_association and joint_cls_gt is not None:
            assoc_cls = joint_cls_gt
        else:
            assoc_cls = pred["index_per_point"].argmax(dim=-1)     # (B, N)
        joint_ids = torch.arange(1, K, device=P.device)
        assocs = (assoc_cls.unsqueeze(1) == joint_ids[:, None]).to(P.dtype)
        axes = vote_joint_axes(pred["joint_axis_per_point"], assocs,
                               cfg.axis_agg)

        if K > 1:
            nl_R, nl_s, nl_t = joint_stage(src, tgt, mask, axes, draws, cfg)
        else:  # a single-part object has no joint: its baseline pose stands
            nl_R, nl_s, nl_t = fits.R[:, :1], fits.s[:, :1], fits.t[:, :1]
        stage("fit.joint")
        out.update({"nonlinear_R": nl_R, "nonlinear_s": nl_s,
                    "nonlinear_t": nl_t})
    out["part_counts"] = cnts
    return out
