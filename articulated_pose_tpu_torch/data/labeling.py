"""Per-sample label construction (host-side NumPy): a copy of
`articulated_pose_tpu/data/labeling.py` (its `to_gt_dict` is
`train.state.gt_from_batch` here).

Rebuild of the reference's HDF5→training-sample math (reference:
lib/dataset.py:251-554 `create_unit_data_from_hdf5` /
`create_data_shape2motion` / `create_data_mobility`):

- part NOCS / global NAOCS normalization from per-part / global corner
  boxes and 1/diagonal factors (lib/dataset.py:490-498),
- 7-dof joint parameters (axis, orthogonal unit offset from origin,
  distance) (lib/dataset.py:499-506),
- per-point joint heatmap / unit-vector / axis / association labels
  within thres_r of each joint line (lib/dataset.py:535-547), with the
  prismatic/fixed variants of the SAPIEN path (lib/dataset.py:674-687),
- tiling short clouds and random subsampling to num_points
  (lib/dataset.py:290-317,346-368),
- the one-hot part mask array and joint-association mask
  (lib/dataset.py:357-361).

This is pure NumPy on purpose: it runs on host workers feeding the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class JointSpec:
    """One joint in the canonical (rest) frame.

    `position` is a point on the joint axis; `axis` its direction;
    `parent`/`child` are part indices; `jtype` one of
    'revolute' | 'prismatic' | 'fixed'.
    """

    position: np.ndarray
    axis: np.ndarray
    parent: int
    child: int
    jtype: str = "revolute"


@dataclasses.dataclass(frozen=True)
class NormInfo:
    """Normalization of one frame: corner boxes + 1/diagonal factors.

    Index 0 is the global (whole object) box; index j+1 is part j
    (reference: lib/data_utils.py:447-575).
    """

    corners: Sequence[np.ndarray]   # each (2, 3): min corner, max corner
    factors: Sequence[float]        # 1 / diagonal length

    @classmethod
    def from_parts(cls, parts_canon: Sequence[np.ndarray]) -> "NormInfo":
        allpts = np.concatenate(parts_canon, axis=0)
        boxes = [np.stack([allpts.min(0), allpts.max(0)])]
        boxes += [np.stack([p.min(0), p.max(0)]) for p in parts_canon]
        factors = [1.0 / max(float(np.linalg.norm(b[1] - b[0])), EPS) for b in boxes]
        return cls(corners=boxes, factors=factors)


def nocs_normalize(pts: np.ndarray, corner: np.ndarray, factor: float) -> np.ndarray:
    """Corner/diagonal NOCS normalization (lib/dataset.py:494).

    nocs = (pts - c0)*f + 0.5 - 0.5*(c1 - c0)*f  — i.e. centered on the
    box center, scaled by 1/diagonal, shifted to ~[0.5-ish] cube.
    """
    c0, c1 = corner[0], corner[1]
    return (pts - c0) * factor + 0.5 - 0.5 * (c1 - c0) * factor


def point_line_offset(position: np.ndarray, axis: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Perpendicular offset vectors from points to the line (P0, l).

    Mirrors lib/d3_utils.py:192-203: PP = (P0P·l) l/|l|² − P0P, the vector
    FROM each point TO its projection on the line.
    """
    l = axis.reshape(1, 3)
    P0P = points - position.reshape(1, 3)
    return (P0P @ l.T) * l / max(float(np.sum(l * l)), EPS) - P0P


def build_sample(
    parts_pts: Sequence[np.ndarray],
    parts_canon: Sequence[np.ndarray],
    joints: Sequence[JointSpec],
    norm: NormInfo,
    *,
    num_points: int = 1024,
    n_max_parts: Optional[int] = None,
    thres_r: float = 0.2,
    nocs_type: str = "AC",
    rng: Optional[np.random.RandomState] = None,
    permute: bool = True,
    metric_input: bool = False,
) -> Dict[str, np.ndarray]:
    """Assemble one training sample from per-part camera points + canonical coords.

    parts_pts[j]:   (Nj, 3) camera-space points of part j
    parts_canon[j]: (Nj, 3) canonical (rest URDF frame) coordinates
    joints:         joint list; joint k attaches part `child` to `parent`
    Returns the dict of arrays the train step consumes (keys as in
    lib/dataset.py:381-429, nocs_type 'A'/'C'/'AC').
    """
    if nocs_type not in ("A", "C", "AC"):
        # reference lib/dataset.py:395-401 silently mishandles type 'B'
        # (per-part NAOCS slices) — unsupported here, fail loudly instead
        raise ValueError(f"unsupported nocs_type {nocs_type!r}; "
                         "expected 'A' (part), 'C' (global) or 'AC' (both)")
    n_parts = len(parts_pts)
    K = n_max_parts or n_parts
    assert n_parts <= K, f"n_parts {n_parts} > n_max_parts {K}"
    rng = rng or np.random.RandomState(0)

    g_corner, g_factor = norm.corners[0], norm.factors[0]

    # --- per-part NOCS/NAOCS + joint labels --------------------------------
    cls_list, pts_list, p_list, g_list = [], [], [], []
    heat_list, unit_list, orient_list, jcls_list = [], [], [], []

    # joints touching each part: its parent joint + joints it parents
    part_joints: List[List[int]] = [[] for _ in range(n_parts)]
    for k, jt in enumerate(joints):
        if 0 <= jt.child < n_parts:
            part_joints[jt.child].append(k)
        if 0 <= jt.parent < n_parts:
            part_joints[jt.parent].append(k)

    joint_params = np.zeros((K, 7), dtype=np.float32)
    for k, jt in enumerate(joints):
        # joint line in global NOCS (lib/dataset.py:499-506)
        P0 = nocs_normalize(jt.position.reshape(1, 3), g_corner, g_factor)[0]
        axis = np.asarray(jt.axis, np.float64)
        axis = axis / max(float(np.linalg.norm(axis)), EPS)
        slot = min(k + 1, K - 1)
        joint_params[slot, 0:3] = axis
        orth = point_line_offset(P0, axis, np.zeros((1, 3)))[0]
        d = float(np.linalg.norm(orth))
        joint_params[slot, 6] = d
        joint_params[slot, 3:6] = orth / max(d, EPS)

    for j in range(n_parts):
        canon = np.asarray(parts_canon[j], np.float64)
        pts_list.append(np.asarray(parts_pts[j], np.float64))
        cls_list.append(np.full((canon.shape[0],), j, np.float32))
        p_list.append(nocs_normalize(canon, norm.corners[j + 1], norm.factors[j + 1]))
        nocs_g = nocs_normalize(canon, g_corner, g_factor)
        g_list.append(nocs_g)

        heat = np.zeros((canon.shape[0],), np.float64)
        unit = np.zeros((canon.shape[0], 3), np.float64)
        orient = np.zeros((canon.shape[0], 3), np.float64)
        jcls = np.zeros((canon.shape[0],), np.float64)
        for k in part_joints[j]:
            jt = joints[k]
            if jt.jtype == "fixed":
                continue
            P0 = nocs_normalize(jt.position.reshape(1, 3), g_corner, g_factor)[0]
            axis = np.asarray(jt.axis, np.float64)
            axis = axis / max(float(np.linalg.norm(axis)), EPS)
            if jt.jtype == "prismatic":
                # constant mid-heatmap labels (lib/dataset.py:633-635,678-679)
                offset = np.full_like(canon, 0.5 * thres_r)
            else:
                offset = point_line_offset(P0, axis, nocs_g)
            hm = np.linalg.norm(offset, axis=1)
            uv = offset / (hm.reshape(-1, 1) + EPS)
            idc = np.where(hm < thres_r)[0] if jt.jtype != "prismatic" \
                else np.where(hm > 0)[0]
            heat[idc] = 1.0 - hm[idc] / thres_r
            unit[idc] = uv[idc]
            orient[idc] = axis
            jcls[idc] = k + 1       # joint k associates as class k+1 (0 = none)
        heat_list.append(heat)
        unit_list.append(unit)
        orient_list.append(orient)
        jcls_list.append(jcls)

    cat = lambda xs: np.concatenate(xs, axis=0)  # noqa: E731
    cls_arr, pts_arr = cat(cls_list), cat(pts_list)
    p_arr, g_arr = cat(p_list), cat(g_list)
    heat_arr, unit_arr = cat(heat_list), cat(unit_list)
    orient_arr, jcls_arr = cat(orient_list), cat(jcls_list)

    n_total = pts_arr.shape[0]
    if n_total < num_points:
        # tile short clouds (lib/dataset.py:290-317)
        tile_n = num_points // n_total + 1
        rep = lambda a: np.concatenate([a] * tile_n, axis=0)  # noqa: E731
        cls_arr, pts_arr = rep(cls_arr), rep(pts_arr)
        p_arr, g_arr = rep(p_arr), rep(g_arr)
        heat_arr, unit_arr = rep(heat_arr), rep(unit_arr)
        orient_arr, jcls_arr = rep(orient_arr), rep(jcls_arr)
        n_total = pts_arr.shape[0]

    sel = (rng.permutation(n_total)[:num_points] if permute
           else np.arange(num_points) % n_total)
    cls_arr = cls_arr[sel]
    # input cloud is scaled by the GLOBAL norm factor (lib/dataset.py:351);
    # real (BMVC15) data stays in metric camera units (dataset.py:348)
    pts_arr = pts_arr[sel] * (1.0 if metric_input else norm.factors[0])
    p_arr, g_arr = p_arr[sel], g_arr[sel]
    heat_arr, unit_arr = heat_arr[sel], unit_arr[sel]
    orient_arr, jcls_arr = orient_arr[sel], jcls_arr[sel]

    mask_array = np.zeros((num_points, K), np.float32)
    mask_array[np.arange(num_points), cls_arr.astype(np.int32)] = 1.0
    joint_cls_mask = (jcls_arr > 0).astype(np.float32)

    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    result = {
        "P": f32(pts_arr),
        "cls_gt": f32(cls_arr),
        "mask_array": mask_array,
        "nocs_gt": f32(p_arr),
        "heatmap_gt": f32(heat_arr),
        "unitvec_gt": f32(unit_arr),
        "orient_gt": f32(orient_arr),
        "joint_cls_gt": f32(jcls_arr),
        "joint_cls_mask": joint_cls_mask,
        "joint_params_gt": joint_params,
    }
    if nocs_type in ("AC", "A"):
        result["nocs_gt_g"] = f32(g_arr)
    if nocs_type == "C":
        result["nocs_gt"] = f32(g_arr)
    return result
