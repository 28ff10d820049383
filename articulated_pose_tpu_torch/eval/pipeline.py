"""Evaluation pipeline: GT pose fitting, metric aggregation, joint params.
A NumPy copy of `articulated_pose_tpu/eval/pipeline.py`; the one torch
call is `pred_joint_lines`' global→part (s, t) (`pose/naocs.py`, on CPU
tensors).

Rebuilds the reference's offline eval scripts as library functions:

- compute_gt_poses:  evaluation/compute_gt_pose.py:55-105 (per-part
  Umeyama of GT NOCS → input points),
- evaluate_fits:     evaluation/eval_pose_err.py:90-170 (mean per-part
  rotation/translation errors, 5°, 5°5cm) + compute_miou.py:145-241
  (3D mIoU of posed NOCS-extent boxes),
- vote_joint_params: evaluation/eval_joint_params.py:160-256 (voted
  joint point/axis, camera-frame transform via the base pose, axis angle
  and 3D line distance errors).

Unlike the reference, per-frame failures are *counted and reported*
instead of swallowed by bare try/except (SURVEY.md §4 note).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from articulated_pose_tpu_torch.eval import metrics as M
from articulated_pose_tpu_torch.utils import transforms as tr


@dataclasses.dataclass
class EvalReport:
    per_part: List[Dict[str, float]]
    overall: Dict[str, float]
    n_frames: int
    n_dropped: int
    # relative inter-part ("joint state") errors, one dict per joint
    # j = 1..K-1 (eval_pose_err.py:307-335); empty unless evaluate_fits
    # was given GT global poses.
    per_joint: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        lines = [f"frames: {self.n_frames} (dropped {self.n_dropped})"]
        for j, stats in enumerate(self.per_part):
            lines.append(
                f"part {j}: rot {stats['rot_err_deg_mean']:.2f}° "
                f"trans {stats['trans_err_mean']:.4f} "
                f"5° {stats['acc_5deg']:.3f} 5°5cm {stats['acc_5deg5cm']:.3f} "
                f"mIoU {stats.get('miou_mean', float('nan')):.3f}")
        o = self.overall
        lines.append(f"overall: rot {o['rot_err_deg_mean']:.2f}° "
                     f"trans {o['trans_err_mean']:.4f} "
                     f"5°5cm {o['acc_5deg5cm']:.3f}")
        for j, stats in enumerate(self.per_joint):
            bits = [f"joint {j + 1}:"]
            if "rel_rot_err_deg_mean" in stats:
                bits.append(f"rel rot {stats['rel_rot_err_deg_mean']:.2f}°")
            if "rel_trans_err_mean" in stats:
                bits.append(f"rel trans {stats['rel_trans_err_mean']:.4f}")
            lines.append(" ".join(bits))
        return "\n".join(lines)


def _umeyama_np(source: np.ndarray, target: np.ndarray):
    """Pure-NumPy Umeyama similarity (aligning.py:580-622 semantics).

    The math of pose/umeyama.py in NumPy float64, as the JAX package
    keeps it: the eval loop calls this per part per frame on the host,
    where one small 3×3 SVD in NumPy costs less than a device round
    trip.
    """
    mu_s = source.mean(axis=0)
    mu_t = target.mean(axis=0)
    sc = source - mu_s
    tc = target - mu_t
    n = source.shape[0]
    cov = tc.T @ sc / n
    var_s = (sc * sc).sum() / n
    U, D, Vh = np.linalg.svd(cov)
    det = np.linalg.det(U) * np.linalg.det(Vh)
    if det < 0.0:
        U[:, -1] *= -1.0
        D[-1] *= -1.0
    R = U @ Vh
    s = D.sum() / max(var_s, 1e-9)
    t = mu_t - s * (R @ mu_s)
    return R, s, t


def compute_gt_poses(nocs_gt: np.ndarray, P: np.ndarray, cls: np.ndarray,
                     n_parts: int):
    """Per-part Umeyama similarity from GT NOCS to input points.

    nocs_gt/P (N, 3), cls (N,) -> list of dicts with R, s, t per part
    (None for parts with <5 points — the reference crashes there).
    """
    out = []
    for j in range(n_parts):
        sel = cls == j
        if sel.sum() < 5:
            out.append(None)
            continue
        R, s, t = _umeyama_np(nocs_gt[sel].astype(np.float64),
                              P[sel].astype(np.float64))
        out.append({"R": np.asarray(R), "s": float(s), "t": np.asarray(t)})
    return out


def _slice_per_part(arr: np.ndarray, cls: np.ndarray, n_parts: int) -> np.ndarray:
    """Collapse a per-part-sliced (N, 3K) prediction to (N, 3) by taking
    each point's own part's slice (eval_joint_params.py:161-165); (N, 3)
    inputs pass through."""
    if arr.shape[1] == 3:
        return arr
    out = np.zeros((arr.shape[0], 3), arr.dtype)
    for j in range(n_parts):
        sel = cls == j
        out[sel] = arr[sel, 3 * j:3 * (j + 1)]
    return out


def vote_joint_line(nocs_g: np.ndarray, unitvec: np.ndarray,
                    heatmap: np.ndarray, joint_axis: np.ndarray,
                    assoc_mask: np.ndarray, *, thres_r: float = 0.2,
                    axis_reduce: str = "median"):
    """Voted joint line in the global-NOCS frame (eval_joint_params.py
    :177-207): point = median over associated points of
    nocs_g + unitvec·(1 − heatmap)·thres_r; axis = median (predictions)
    or mean (GT labels, reference :200) of the per-point axis."""
    sel = assoc_mask > 0
    if sel.sum() == 0:
        return None
    hm = heatmap[sel].reshape(-1, 1)
    offset = unitvec[sel] * (1.0 - hm) * thres_r
    joint_pt = np.median(nocs_g[sel] + offset, axis=0)
    reduce = np.median if axis_reduce == "median" else np.mean
    axis = reduce(joint_axis[sel], axis=0)
    axis = axis / max(np.linalg.norm(axis), 1e-9)
    return {"point_nocs": joint_pt, "axis_nocs": axis}


def segmentation_iou(W: np.ndarray, cls_gt: np.ndarray, n_parts: int,
                     *, hungarian: bool = False) -> float:
    """Mean per-part segmentation IoU of argmax(W) against GT labels.

    With hungarian=True, prediction channels are first assigned to GT
    parts by linear sum assignment on (1 − IoU) cost — the reference
    computes this matching in-graph as a stop-gradient side output
    (lib/network.py:463, lib/loss.py:14-21) but never consumes it; here
    it powers a channel-permutation-robust eval metric.
    """
    from articulated_pose_tpu_torch.losses import hungarian_matching

    cls_pred = np.argmax(np.asarray(W), axis=-1)
    cls_gt = np.asarray(cls_gt).astype(int)
    iou = np.zeros((n_parts, n_parts))
    for a in range(n_parts):
        pa = cls_pred == a
        for b in range(n_parts):
            gb = cls_gt == b
            union = (pa | gb).sum()
            iou[a, b] = (pa & gb).sum() / union if union else 0.0
    if not hungarian:
        return float(np.mean(np.diag(iou)))
    m = hungarian_matching((1.0 - iou)[None], np.asarray([n_parts]))[0]
    return float(np.mean([iou[a, m[a]] for a in range(n_parts)]))


def _line_to_camera(line: Dict, pose: Dict) -> Dict:
    R, s, t = pose["R"], pose["s"], pose["t"]
    out = dict(line)
    out["point"] = s * R @ line["point_nocs"] + t
    out["axis"] = R @ line["axis_nocs"]
    return out


def pred_joint_lines(pred: Dict[str, np.ndarray], base_fit: Dict,
                     n_parts: int, *, thres_r: float = 0.2,
                     naocs_fit: bool = False) -> List[Optional[Dict]]:
    """Predicted joint lines in the camera frame, one per joint
    j = 1..K-1 (eval_joint_params.py:105-241).

    pred holds the per-frame heads: W, nocs_per_point, gocs_per_point,
    unitvec/heatmap/joint_axis/index_per_point.  base_fit is the fitted
    part-0 pose.  When the fit ran in part-NOCS space (naocs_fit=False,
    the reference protocol), the voted NAOCS joint point is first mapped
    into part-0 NOCS with the global→part (s, t) recovered from the
    predictions themselves (:166-174, via pose.naocs.part_scale_translation)
    and then to camera with base_fit; when the fit ran in NAOCS space,
    base_fit applies to the NAOCS point directly.
    """
    import torch

    from articulated_pose_tpu_torch.pose.naocs import part_scale_translation

    cls_pred = np.argmax(pred["W"], axis=-1)
    jcls_pred = np.argmax(pred["index_per_point"], axis=-1)
    gn = _slice_per_part(np.asarray(pred["gocs_per_point"]), cls_pred, n_parts)
    heat = np.asarray(pred["heatmap_per_point"]).reshape(-1)
    unitv = np.asarray(pred["unitvec_per_point"])
    orient = np.asarray(pred["joint_axis_per_point"])

    if not naocs_fit:
        pn = _slice_per_part(np.asarray(pred["nocs_per_point"]), cls_pred,
                             n_parts)
        w0 = (cls_pred == 0).astype(np.float32)
        if w0.sum() < 3:
            return [None] * (n_parts - 1)
        s2, t2 = part_scale_translation(torch.as_tensor(gn),
                                        torch.as_tensor(pn),
                                        torch.as_tensor(w0))
        s2, t2 = float(s2), t2.numpy()

    lines: List[Optional[Dict]] = []
    for j in range(1, n_parts):
        line = vote_joint_line(gn, unitv, heat, orient,
                               (jcls_pred == j).astype(np.float32),
                               thres_r=thres_r, axis_reduce="median")
        if line is None or base_fit is None:
            lines.append(None)
            continue
        if not naocs_fit:
            # NAOCS point -> part-0 NOCS -> camera (reference :224-229)
            line = dict(line, point_nocs=line["point_nocs"] * s2 + t2)
        lines.append(_line_to_camera(line, base_fit))
    return lines


def gt_joint_lines(batch: Dict[str, np.ndarray], P: np.ndarray,
                   n_parts: int, *, thres_r: float = 0.2
                   ) -> List[Optional[Dict]]:
    """GT joint lines in the camera frame, voted from the GT label
    arrays and mapped with the GT NAOCS base pose (eval_joint_params.py
    :193-207, :234-241 — the reference derives GT joints from labels in
    the saved h5, not from the model files)."""
    cls_gt = np.asarray(batch["cls_gt"]).astype(int)
    nocs_g = np.asarray(batch["nocs_gt_g"])
    base_sel = cls_gt == 0
    if base_sel.sum() < 5:
        return [None] * (n_parts - 1)
    base = compute_gt_poses(nocs_g, np.asarray(P), cls_gt, 1)[0]
    jcls_gt = np.asarray(batch["joint_cls_gt"]).astype(int)
    heat = np.asarray(batch["heatmap_gt"]).reshape(-1)
    unitv = np.asarray(batch["unitvec_gt"])
    orient = np.asarray(batch["orient_gt"])
    lines: List[Optional[Dict]] = []
    for j in range(1, n_parts):
        line = vote_joint_line(nocs_g, unitv, heat, orient,
                               (jcls_gt == j).astype(np.float32),
                               thres_r=thres_r, axis_reduce="mean")
        lines.append(None if line is None else _line_to_camera(line, base))
    return lines


def joint_errors(pred_line: Dict, gt_axis: np.ndarray, gt_point: np.ndarray):
    """Axis angle (deg) + line distance (eval_joint_params.py:249-256)."""
    return {
        "axis_err_deg": tr.axis_diff_degree(pred_line["axis"], gt_axis),
        "line_dist": tr.dist_between_3d_lines(
            pred_line["point"], pred_line["axis"], gt_point, gt_axis),
    }


def relative_pose_errors(fit: Dict, gt_part: Dict, gt_global: Optional[Dict],
                         n_parts: int, *,
                         nocs_pred: Optional[np.ndarray] = None,
                         P: Optional[np.ndarray] = None,
                         cls_pred: Optional[np.ndarray] = None,
                         naocs_fit: bool = False
                         ) -> List[Dict[str, float]]:
    """Relative inter-part ("joint state") pose errors for ONE frame —
    the reference's eval_pose_err.py:307-335 family, one dict per joint
    j = 1..n_parts-1.

    Relative rotation (reported per joint for every revolute category):
    ``rot_diff_degree(R0_predᵀ·Rj_pred, R0_gtᵀ·Rj_gt)`` with the GT pair
    taken from the part-NOCS GT poses (``gt_part``, :323-325).

    Relative translation (reported for prismatic drawers): the GT delta
    is ``tj − t0`` of the *global-NOCS* GT poses (``gt_global``, :326-330
    — both parts share the NAOCS frame, so the difference is a real
    camera-space displacement).  The predicted delta is

    - NAOCS fits (naocs_fit=True): ``tj_pred − t0_pred`` (:317-318);
    - part-NOCS fits: the part-boundary trick (:319-321) — part j's
      input points are mapped into the base's canonical frame with the
      fitted ``(R0, t0)`` (rotation+translation only — the reference's
      ``compose_rt`` carries no scale, a quirk kept for parity), and the
      drawer extension is ``min x − (−scale_pred_x/2 + 0.5)`` where
      ``scale_pred`` is part j's predicted amodal NOCS extent
      (:263-266), projected through ``R0·[d, 0, 0]``.

    Entries are NaN when a term is uncomputable (missing GT part, empty
    predicted part) — callers scrub like the reference's
    ``r_diff_arr[isnan] = 0`` (:358) or drop, but we *count* them.
    """
    out: List[Dict[str, float]] = []
    R0p = np.asarray(fit["R"][0])
    t0p = np.asarray(fit["t"][0])
    for j in range(1, n_parts):
        entry: Dict[str, float] = {}
        # --- relative rotation -------------------------------------------
        if gt_part["R"][0] is not None and gt_part["R"][j] is not None:
            r_pred = R0p.T @ np.asarray(fit["R"][j])
            r_gt = np.asarray(gt_part["R"][0]).T @ np.asarray(gt_part["R"][j])
            entry["rel_rot_err_deg"] = tr.rot_diff_degree(r_gt, r_pred)
        else:
            entry["rel_rot_err_deg"] = float("nan")
        # --- relative translation ----------------------------------------
        t_err = float("nan")
        if (gt_global is not None and gt_global["t"][0] is not None
                and gt_global["t"][j] is not None):
            t_diff_gt = np.asarray(gt_global["t"][j]) - np.asarray(
                gt_global["t"][0])
            t_diff_pred = None
            if naocs_fit:
                t_diff_pred = np.asarray(fit["t"][j]) - t0p
            elif (nocs_pred is not None and P is not None
                  and cls_pred is not None and np.all(np.isfinite(R0p))):
                sel = cls_pred == j
                if sel.sum() >= 1:
                    nj = np.asarray(nocs_pred)[sel]
                    if nj.shape[1] != 3:
                        nj = nj[:, 3 * j:3 * (j + 1)]
                    scale_pred_x = 2.0 * np.max(np.abs(nj[:, 0] - 0.5))
                    canon = -scale_pred_x / 2.0 + 0.5
                    shifted = (np.asarray(P)[sel] - t0p) @ R0p  # R0ᵀ(p−t0)
                    dynam = float(np.min(shifted[:, 0]))
                    t_diff_pred = R0p @ np.array([dynam - canon, 0.0, 0.0])
            if t_diff_pred is not None:
                t_err = float(np.linalg.norm(t_diff_gt - t_diff_pred))
        entry["rel_trans_err"] = t_err
        out.append(entry)
    return out


def evaluate_fits(fits: Sequence[Dict], gts: Sequence[Dict], n_parts: int,
                  *, nocs_pred: Optional[Sequence] = None,
                  nocs_gt: Optional[Sequence] = None,
                  cls_list: Optional[Sequence] = None,
                  miou_nres: int = 50,
                  gts_global: Optional[Sequence] = None,
                  P_list: Optional[Sequence] = None,
                  cls_pred_list: Optional[Sequence] = None,
                  naocs_fit: bool = False) -> EvalReport:
    """Aggregate pose metrics over frames.

    fits[i]: {"R": (K,3,3), "s": (K,), "t": (K,3)} predicted poses
    gts[i]:  same keys with GT values (entries may be None → dropped)
    Optional nocs_pred/nocs_gt/cls_list (per frame, (N,3K)/(N,3)/(N,))
    enable 3D mIoU of posed NOCS-extent boxes.

    Passing gts_global (per-frame GLOBAL-NOCS GT poses, same schema as
    gts) additionally aggregates the relative inter-part errors
    (relative_pose_errors) into report.per_joint — the predicted
    relative translation for part-NOCS fits also needs P_list +
    cls_pred_list (argmax segmentation) for the part-boundary trick.
    """
    K = n_parts
    rot = [[] for _ in range(K)]
    trans = [[] for _ in range(K)]
    scale = [[] for _ in range(K)]
    miou = [[] for _ in range(K)]
    rel_rot = [[] for _ in range(K - 1)]
    rel_trans = [[] for _ in range(K - 1)]
    dropped = 0

    for i, (fit, gt) in enumerate(zip(fits, gts)):
        if fit is None or gt is None:
            dropped += 1
            continue
        if gts_global is not None and gts_global[i] is not None:
            rel = relative_pose_errors(
                fit, gt, gts_global[i], K,
                nocs_pred=None if nocs_pred is None else nocs_pred[i],
                P=None if P_list is None else P_list[i],
                cls_pred=None if cls_pred_list is None else cls_pred_list[i],
                naocs_fit=naocs_fit)
            for j, e in enumerate(rel):
                # NaN scrub like the reference's r_diff_arr[isnan]=0
                # (eval_pose_err.py:358) — but only for computed terms
                if np.isfinite(e["rel_rot_err_deg"]):
                    rel_rot[j].append(e["rel_rot_err_deg"])
                if np.isfinite(e["rel_trans_err"]):
                    rel_trans[j].append(e["rel_trans_err"])
        for j in range(K):
            if gt["R"][j] is None:
                continue
            e = M.pose_errors(fit["R"][j], fit["t"][j], fit["s"][j],
                              gt["R"][j], gt["t"][j], gt["s"][j])
            rot[j].append(e["rot_err_deg"])
            # NaN translation scrub (eval_pose_err.py:132)
            trans[j].append(0.0 if not np.isfinite(e["trans_err"]) else e["trans_err"])
            scale[j].append(e["scale_err"])
            if nocs_pred is not None:
                sel = cls_list[i] == j
                if sel.sum() >= 5:
                    box_p = M.bbox_from_nocs_extent(
                        nocs_pred[i][sel][:, 3 * j:3 * (j + 1)])
                    box_g = M.bbox_from_nocs_extent(nocs_gt[i][sel])
                    bp = M.transform_bbox(box_p, fit["s"][j], fit["R"][j], fit["t"][j])
                    bg = M.transform_bbox(box_g, gt["s"][j], gt["R"][j], gt["t"][j])
                    miou[j].append(M.box_iou_3d(bp, bg, nres=miou_nres))

    per_part = []
    for j in range(K):
        r = np.asarray(rot[j]) if rot[j] else np.asarray([np.nan])
        t = np.asarray(trans[j]) if trans[j] else np.asarray([np.nan])
        stats = {
            "rot_err_deg_mean": float(np.nanmean(r)),
            "trans_err_mean": float(np.nanmean(t)),
            "scale_err_mean": float(np.nanmean(scale[j])) if scale[j] else float("nan"),
        }
        stats.update(M.accuracy_5deg5cm(r, t))
        if miou[j]:
            stats["miou_mean"] = float(np.mean(miou[j]))
        per_part.append(stats)

    all_r = np.concatenate([np.asarray(x) for x in rot if x]) if any(rot) else np.asarray([np.nan])
    all_t = np.concatenate([np.asarray(x) for x in trans if x]) if any(trans) else np.asarray([np.nan])
    overall = {
        "rot_err_deg_mean": float(np.nanmean(all_r)),
        "trans_err_mean": float(np.nanmean(all_t)),
    }
    overall.update(M.accuracy_5deg5cm(all_r, all_t))
    all_miou = [x for part in miou for x in part]
    if all_miou:
        overall["miou_mean"] = float(np.mean(all_miou))
    per_joint: List[Dict[str, float]] = []
    if gts_global is not None:
        for j in range(K - 1):
            stats = {}
            if rel_rot[j]:
                stats["rel_rot_err_deg_mean"] = float(np.mean(rel_rot[j]))
                stats["n_rel_rot"] = len(rel_rot[j])
            if rel_trans[j]:
                stats["rel_trans_err_mean"] = float(np.mean(rel_trans[j]))
                stats["n_rel_trans"] = len(rel_trans[j])
            per_joint.append(stats)
        all_rr = [x for jj in rel_rot for x in jj]
        all_rt = [x for jj in rel_trans for x in jj]
        if all_rr:
            overall["rel_rot_err_deg_mean"] = float(np.mean(all_rr))
        if all_rt:
            overall["rel_trans_err_mean"] = float(np.mean(all_rt))
    return EvalReport(per_part=per_part, overall=overall,
                      n_frames=len(fits) - dropped, n_dropped=dropped,
                      per_joint=per_joint)
