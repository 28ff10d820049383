"""The port's evaluation modules against the JAX package's, on the CPU.

`utils/transforms.py`'s evaluation helpers, `eval/metrics.py` and
`eval/pipeline.py` are NumPy float64 copies: on the same seeded inputs
their results must be equal to JAX's.  `pose/naocs.py` computes in torch
where JAX computes in f32 `jnp`, and `pred_joint_lines` goes through it:
those within 1e-5.  Then the cases of tests/test_eval.py, on the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from articulated_pose_tpu.data.synthetic import \
    SyntheticArticulated as JaxSynthetic
from articulated_pose_tpu.eval import metrics as JM
from articulated_pose_tpu.eval import pipeline as JE
from articulated_pose_tpu.pose import naocs as jnaocs
from articulated_pose_tpu.utils import transforms as jtr
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.eval import metrics as M
from articulated_pose_tpu_torch.eval import pipeline as E
from articulated_pose_tpu_torch.pose import naocs
from articulated_pose_tpu_torch.utils import transforms as tr

F32_TOL = 1e-5


def assert_same(got, want, path="."):
    """Nested dicts / lists / arrays / floats equal, NaN equal to NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


def rotations(seed, n):
    rng = np.random.RandomState(seed)
    return [tr.random_rotation(rng) for _ in range(n)]


# ---------------------------------------------------------------- transforms
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quaternions_match_jax(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(4)
    assert_same(tr.quaternion_matrix(q), jtr.quaternion_matrix(q))
    assert_same(tr.quaternion_matrix(np.zeros(4)),
                jtr.quaternion_matrix(np.zeros(4)))
    R = tr.random_rotation(rng)
    # the trace > 0 branch and each diagonal branch
    for M_ in (R, np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
               np.diag([-1.0, -1.0, 1.0])):
        assert_same(tr.quaternion_from_matrix(M_),
                    jtr.quaternion_from_matrix(M_))


@pytest.mark.parametrize("seed", [0, 3])
def test_angles_and_lines_match_jax(seed):
    rng = np.random.RandomState(seed)
    R1, R2 = rotations(seed, 2)
    assert tr.rot_diff_degree(R1, R2) == jtr.rot_diff_degree(R1, R2)
    v1, v2 = rng.randn(3), rng.randn(3)
    assert tr.axis_diff_degree(v1, v2) == jtr.axis_diff_degree(v1, v2)
    assert tr.axis_diff_degree(v1, -v1) == jtr.axis_diff_degree(v1, -v1)
    p1, p2 = rng.randn(3), rng.randn(3)
    assert tr.dist_between_3d_lines(p1, v1, p2, v2) == \
        jtr.dist_between_3d_lines(p1, v1, p2, v2)
    # parallel lines take the perpendicular-distance branch
    assert tr.dist_between_3d_lines(p1, v1, p2, 2 * v1) == \
        jtr.dist_between_3d_lines(p1, v1, p2, 2 * v1)


def test_joint_from_correspondences_matches_jax():
    rng = np.random.RandomState(4)
    src = rng.randn(50, 3)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    point = rng.randn(3)
    T = tr.rotation_about_line(axis, point, 0.7)
    dst = tr.apply_similarity(T, src)
    got = tr.estimate_joint_from_correspondences(src, dst)
    assert_same(got, jtr.estimate_joint_from_correspondences(src, dst))
    assert tr.axis_diff_degree(got[0], axis) < 1e-6


# ------------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", [0, 5])
def test_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    scale, shift = rng.rand(3) + 0.5, rng.randn(3)
    assert_same(M.get_3d_bbox(scale, shift), JM.get_3d_bbox(scale, shift))
    b1 = M.get_3d_bbox(rng.rand(3) + 0.5)
    R, = rotations(seed + 10, 1)
    scale2, t2 = rng.rand(3) + 0.5, 0.2 * rng.randn(3)
    b2 = M.transform_bbox(M.get_3d_bbox(scale2), 1.1, R, t2)
    assert_same(b2, JM.transform_bbox(JM.get_3d_bbox(scale2), 1.1, R, t2))
    pts = rng.randn(200, 3)
    assert_same(M.pts_inside_box(pts, b2), JM.pts_inside_box(pts, b2))
    for nres in (20, 50):
        assert M.box_iou_3d(b1, b2, nres) == JM.box_iou_3d(b1, b2, nres)
    nocs = rng.rand(100, 3)
    assert_same(M.bbox_from_nocs_extent(nocs), JM.bbox_from_nocs_extent(nocs))
    R2, = rotations(seed + 20, 1)
    args = (R, rng.randn(3), 1.2, R2, rng.randn(3), 0.9)
    assert_same(M.pose_errors(*args), JM.pose_errors(*args))
    rot = np.concatenate([rng.rand(20) * 10, [np.nan]])
    trans = np.concatenate([rng.rand(20) * 0.1, [0.0]])
    for unit in (1.0, 0.5):
        assert_same(M.accuracy_5deg5cm(rot, trans, unit),
                    JM.accuracy_5deg5cm(rot, trans, unit))


def test_transform_bbox_matches_jax():
    rng = np.random.RandomState(8)
    box = M.get_3d_bbox(rng.rand(3) + 0.5, 0.5)
    R, = rotations(9, 1)
    t = rng.randn(3)
    assert_same(M.transform_bbox(box, 1.3, R, t),
                JM.transform_bbox(box, 1.3, R, t))


# --------------------------------------------------------------------- naocs
@pytest.mark.parametrize("seed", [0, 1])
def test_part_scale_translation_matches_jax(seed):
    rng = np.random.RandomState(seed)
    nocs = rng.rand(300, 3).astype(np.float32)
    gocs = (0.7 * nocs + rng.randn(3) * 0.1
            + 0.01 * rng.randn(300, 3)).astype(np.float32)
    w = (rng.rand(300) > 0.4).astype(np.float32)
    s, t = naocs.part_scale_translation(torch.from_numpy(nocs),
                                        torch.from_numpy(gocs),
                                        torch.from_numpy(w))
    js, jt = jnaocs.part_scale_translation(jnp.asarray(nocs),
                                           jnp.asarray(gocs), jnp.asarray(w))
    np.testing.assert_allclose(float(s), float(js), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(s), 0.7, atol=0.02)


@pytest.mark.parametrize("width", [3, 6])
def test_naocs_pred_view_matches_jax(width):
    rng = np.random.RandomState(width)
    pred = {"gocs_per_point": rng.rand(2, 16, width).astype(np.float32),
            "W": rng.rand(2, 16, 2).astype(np.float32)}
    got = naocs.naocs_pred_view({k: torch.from_numpy(v)
                                 for k, v in pred.items()}, 2)
    want = jnaocs.naocs_pred_view({k: jnp.asarray(v)
                                   for k, v in pred.items()}, 2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------------ pipeline
def frames(n_parts, n, seed, num_points=256, points_per_part=150):
    """n frames of both generators (equal, as test_torch_data holds)."""
    kw = dict(n_parts=n_parts, points_per_part=points_per_part, seed=seed)
    rng = np.random.RandomState(seed + 1)
    out = [SyntheticArticulated(**kw).frame(rng, num_points=num_points,
                                            use_native=False)
           for _ in range(n)]
    jrng = np.random.RandomState(seed + 1)
    jgen = JaxSynthetic(**kw)
    for s, _ in out:
        js, _ = jgen.frame(jrng, num_points=num_points, use_native=False)
        assert_same(s, js)
    return out


def noisy_prediction(sample, K, rng):
    """Per-frame heads from the labels, perturbed: a few segmentation
    flips, NOCS noise, a noisy joint head."""
    N = sample["P"].shape[0]
    cls = sample["cls_gt"].astype(int)
    flip = rng.rand(N) < 0.05
    cls_p = np.where(flip, rng.randint(0, K, N), cls)
    W = np.eye(K, dtype=np.float32)[cls_p] * 0.8 + 0.2 / K
    nocs = np.zeros((N, 3 * K), np.float32)
    gocs = np.zeros((N, 3 * K), np.float32)
    for j in range(K):
        nocs[:, 3 * j:3 * j + 3] = sample["nocs_gt"] + 0.01 * rng.randn(N, 3)
        gocs[:, 3 * j:3 * j + 3] = sample["nocs_gt_g"] + 0.01 * rng.randn(N, 3)
    return {
        "W": W,
        "nocs_per_point": nocs,
        "gocs_per_point": gocs,
        "heatmap_per_point": np.clip(sample["heatmap_gt"].reshape(-1, 1)
                                     + 0.02 * rng.randn(N, 1), 0, 1
                                     ).astype(np.float32),
        "unitvec_per_point": (sample["unitvec_gt"]
                              + 0.02 * rng.randn(N, 3)).astype(np.float32),
        "joint_axis_per_point": (sample["orient_gt"]
                                 + 0.02 * rng.randn(N, 3)).astype(np.float32),
        "index_per_point": np.eye(K, dtype=np.float32)[
            sample["joint_cls_gt"].astype(int)],
    }


def gt_poses(gt, K):
    g = {"R": [], "s": [], "t": []}
    for j in range(K):
        s_, R_, t_ = tr.decompose_similarity(gt.rt_nocs2cam[j])
        g["R"].append(R_)
        g["s"].append(s_)
        g["t"].append(t_)
    return g


@pytest.mark.parametrize("K", [2, 3])
def test_compute_gt_poses_matches_jax(K):
    for sample, _ in frames(K, 2, seed=K):
        cls = sample["cls_gt"].astype(int)
        for key in ("nocs_gt", "nocs_gt_g"):
            assert_same(E.compute_gt_poses(sample[key], sample["P"], cls, K),
                        JE.compute_gt_poses(sample[key], sample["P"], cls, K))
    # a part with fewer than 5 points gives None
    cls = np.zeros(20, int)
    cls[:3] = 1
    P = np.random.RandomState(0).rand(20, 3)
    assert_same(E.compute_gt_poses(P, P, cls, 2),
                JE.compute_gt_poses(P, P, cls, 2))


@pytest.mark.parametrize("K", [2, 3])
def test_joint_lines_and_errors_match_jax(K):
    rng = np.random.RandomState(K + 10)
    for sample, _ in frames(K, 2, seed=K + 20, num_points=400):
        pred = noisy_prediction(sample, K, rng)
        cls = sample["cls_gt"].astype(int)
        base = E.compute_gt_poses(sample["nocs_gt"], sample["P"], cls, 1)[0]
        gl = E.gt_joint_lines(sample, sample["P"], K)
        assert_same(gl, JE.gt_joint_lines(sample, sample["P"], K))
        pl = E.pred_joint_lines(pred, base, K)
        jpl = JE.pred_joint_lines(pred, base, K)
        assert len(pl) == len(jpl) == K - 1
        for a, b in zip(pl, jpl):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=F32_TOL,
                                           err_msg=k)
        for a, b in zip(pl, gl):
            assert_same(E.joint_errors(a, b["axis"], b["point"]),
                        JE.joint_errors(a, b["axis"], b["point"]))
        # the NAOCS-fit protocol skips the global->part step
        assert_same(E.pred_joint_lines(pred, base, K, naocs_fit=True),
                    JE.pred_joint_lines(pred, base, K, naocs_fit=True))


def test_vote_and_segmentation_match_jax():
    rng = np.random.RandomState(3)
    N = 300
    args = (rng.rand(N, 3), rng.randn(N, 3), rng.rand(N), rng.randn(N, 3),
            (rng.rand(N) > 0.5).astype(np.float32))
    for reduce in ("median", "mean"):
        assert_same(E.vote_joint_line(*args, axis_reduce=reduce),
                    JE.vote_joint_line(*args, axis_reduce=reduce))
    assert E.vote_joint_line(*args[:4], np.zeros(N)) is None
    cls = rng.randint(0, 3, N)
    W = rng.rand(N, 3)
    for hungarian in (False, True):
        assert E.segmentation_iou(W, cls, 3, hungarian=hungarian) == \
            JE.segmentation_iou(W, cls, 3, hungarian=hungarian)


@pytest.mark.parametrize("K,naocs_fit", [(2, False), (3, False), (3, True)])
def test_evaluate_fits_matches_jax(K, naocs_fit):
    """The e2e script's whole report: noisy fits, mIoU, global GT poses and
    the part-boundary trick; a dropped frame and a missing GT part."""
    rng = np.random.RandomState(K)
    fits, gts, nocs_pred, nocs_gt, cls_l, gts_g, P_l, cls_p = \
        [], [], [], [], [], [], [], []
    for sample, gt in frames(K, 3, seed=K + 30):
        cls = sample["cls_gt"].astype(int)
        g = gt_poses(gt, K)
        gts.append(g)
        pert = [R @ tr.axis_angle_matrix(rng.randn(3), 0.05 * rng.rand())
                for R in g["R"]]
        fits.append({"R": np.stack(pert).astype(np.float32),
                     "s": (np.asarray(g["s"]) * (1 + 0.01 * rng.randn(K))
                           ).astype(np.float32),
                     "t": (np.stack(g["t"]) + 0.02 * rng.randn(K, 3)
                           ).astype(np.float32)})
        pred = noisy_prediction(sample, K, rng)
        nocs_pred.append(pred["nocs_per_point"])
        nocs_gt.append(sample["nocs_gt"])
        cls_l.append(cls)
        gg = E.compute_gt_poses(sample["nocs_gt_g"], sample["P"], cls, K)
        gts_g.append({kk: [None if e is None else e[kk] for e in gg]
                      for kk in ("R", "s", "t")})
        P_l.append(sample["P"])
        cls_p.append(np.argmax(pred["W"], -1))
    fits.append(None)                       # a dropped frame
    gts.append(gts[0])
    gts[1] = dict(gts[1], R=[None] + gts[1]["R"][1:])   # a missing GT part
    for lst in (nocs_pred, nocs_gt, cls_l, gts_g, P_l, cls_p):
        lst.append(lst[0])
    kw = dict(nocs_pred=nocs_pred, nocs_gt=nocs_gt, cls_list=cls_l,
              miou_nres=30, gts_global=gts_g, P_list=P_l,
              cls_pred_list=cls_p, naocs_fit=naocs_fit)
    got = E.evaluate_fits(fits, gts, K, **kw)
    want = JE.evaluate_fits(fits, gts, K, **kw)
    for field in ("per_part", "overall", "n_frames", "n_dropped",
                  "per_joint"):
        assert_same(getattr(got, field), getattr(want, field), field)
    assert got.summary() == want.summary()
    assert got.n_dropped == 1 and math.isfinite(got.overall["miou_mean"])


def test_relative_pose_errors_match_jax():
    rng = np.random.RandomState(6)
    Rs = rotations(6, 3)
    fit = {"R": Rs, "s": [1.0] * 3, "t": [rng.randn(3) for _ in range(3)]}
    gt = {"R": [R @ tr.axis_angle_matrix(rng.randn(3), 0.1) for R in Rs],
          "s": [1.0] * 3, "t": [rng.randn(3) for _ in range(3)]}
    nocs = rng.rand(90, 9)
    P = rng.randn(90, 3)
    cls = rng.randint(0, 3, 90)
    for naocs_fit in (False, True):
        assert_same(E.relative_pose_errors(fit, gt, gt, 3, nocs_pred=nocs,
                                           P=P, cls_pred=cls,
                                           naocs_fit=naocs_fit),
                    JE.relative_pose_errors(fit, gt, gt, 3, nocs_pred=nocs,
                                            P=P, cls_pred=cls,
                                            naocs_fit=naocs_fit))


# ----------------------------------------- tests/test_eval.py, on the port
class TestIoU:
    """The reference self-test (lib/d3_utils.py:331-346)."""

    def test_identity(self):
        b = M.get_3d_bbox([2.0, 2.0, 2.0])
        assert M.box_iou_3d(b, b) == 1.0

    def test_shifted(self):
        b1 = M.get_3d_bbox([2.0, 2.0, 2.0])
        b2 = b1 + np.array([1.0, 0, 0])
        # overlap 1x2x2 = 4, union 12 -> 1/3
        np.testing.assert_allclose(M.box_iou_3d(b1, b2), 1 / 3, atol=0.02)

    def test_disjoint(self):
        b1 = M.get_3d_bbox([2.0, 2.0, 2.0])
        assert M.box_iou_3d(b1, b1 + np.array([2.0, 0, 0])) < 0.02

    def test_rotated_45(self):
        b1 = M.get_3d_bbox([2.0, 2.0, 2.0])
        R = tr.axis_angle_matrix(np.array([0, 0, 1.0]), np.pi / 4)
        assert 0.6 < M.box_iou_3d(b1, b1 @ R.T) < 0.8

    def test_pts_inside_box(self):
        b = M.get_3d_bbox([2.0, 2.0, 2.0])
        pts = np.array([[0.0, 0, 0], [0.9, 0.9, 0.9], [1.1, 0, 0]])
        np.testing.assert_array_equal(M.pts_inside_box(pts, b),
                                      [True, True, False])


class TestGTandEval:
    def test_compute_gt_poses_recovers_synthetic(self):
        gen = SyntheticArticulated(n_parts=2, points_per_part=200, seed=9)
        sample, gt = gen.frame(np.random.RandomState(2), num_points=400)
        cls = sample["cls_gt"].astype(int)
        fits = E.compute_gt_poses(sample["nocs_gt"], sample["P"], cls, 2)
        for j in range(2):
            s_gt, R_gt, t_gt = tr.decompose_similarity(gt.rt_nocs2cam[j])
            assert tr.rot_diff_degree(fits[j]["R"], R_gt) < 0.5
            np.testing.assert_allclose(fits[j]["s"], s_gt, rtol=1e-3)
            np.testing.assert_allclose(fits[j]["t"], t_gt, atol=1e-3)

    def test_segmentation_iou_and_hungarian(self):
        rng = np.random.RandomState(0)
        cls = rng.randint(0, 3, size=400)
        W = np.eye(3, dtype=np.float32)[cls]
        assert E.segmentation_iou(W, cls, 3) == 1.0
        Wp = W[:, [2, 0, 1]]
        assert E.segmentation_iou(Wp, cls, 3) < 0.1
        assert E.segmentation_iou(Wp, cls, 3, hungarian=True) == 1.0

    def test_gt_joint_lines_match_renderer_gt(self):
        gen = SyntheticArticulated(n_parts=2, points_per_part=300, seed=12)
        sample, gt = gen.frame(np.random.RandomState(8), num_points=600)
        lines = E.gt_joint_lines(sample, sample["P"], 2)
        errs = E.joint_errors(lines[0], gt.joint_axes_cam[0],
                              gt.joint_points_cam[0])
        assert errs["axis_err_deg"] < 2.0
        assert errs["line_dist"] < 0.05

    def test_pred_joint_lines_from_perfect_predictions(self):
        gen = SyntheticArticulated(n_parts=2, points_per_part=300, seed=3)
        sample, gt = gen.frame(np.random.RandomState(5), num_points=600)
        cls = sample["cls_gt"].astype(int)
        N, K = sample["P"].shape[0], 2
        nocs = np.zeros((N, 3 * K), np.float32)
        for j in range(K):
            nocs[cls == j, 3 * j:3 * (j + 1)] = sample["nocs_gt"][cls == j]
        pred = {
            "W": np.eye(K, dtype=np.float32)[cls],
            "nocs_per_point": nocs,
            "gocs_per_point": sample["nocs_gt_g"],
            "heatmap_per_point": sample["heatmap_gt"].reshape(-1, 1),
            "unitvec_per_point": sample["unitvec_gt"],
            "joint_axis_per_point": sample["orient_gt"],
            "index_per_point": np.eye(K, dtype=np.float32)[
                sample["joint_cls_gt"].astype(int)],
        }
        base = E.compute_gt_poses(sample["nocs_gt"], sample["P"], cls, 1)[0]
        lines = E.pred_joint_lines(pred, base, K)
        errs = E.joint_errors(lines[0], gt.joint_axes_cam[0],
                              gt.joint_points_cam[0])
        assert errs["axis_err_deg"] < 2.0
        assert errs["line_dist"] < 0.06
