"""The `joint_fit` kernel entry's rules on the CPU: its place among the
kernels, fit_frame_batch's dispatch between it and the plain joint stage
(with the counters that say which ran), its launch scalars and the
product orders it takes from the batch counts, its work count, and the
plain version it is held to.  The kernel itself runs on the card only
(tests/test_torch_kernels_cuda.py)."""

import types
import warnings

import numpy as np
import pytest
import torch

from articulated_pose_tpu_torch import roofline
from articulated_pose_tpu_torch.ops.kernels import KERNELS, joint_fit as jf
from articulated_pose_tpu_torch.pose import pipeline as pp
from articulated_pose_tpu_torch.programs import random_predictions


def _inputs(B=2, N=96, K=3, seed=0, **knobs):
    knobs.setdefault("joint_types", ("revolute",) * (K - 1))
    cfg = pp.PoseFitConfig(n_parts=K, niter_part=8, niter_joint=6, **knobs)
    rng = np.random.RandomState(seed)
    pred = random_predictions(rng, B, N, K, torch.device("cpu"))
    P = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32))
    draws = pp.PoseDraws.sample(B, cfg, torch.Generator().manual_seed(seed))
    return cfg, pred, P, draws


def test_kernels_has_joint_fit_with_its_source_and_counter():
    assert len(KERNELS) == 14
    k = KERNELS["joint_fit"]
    assert k is jf.KERNEL
    assert k.source == "joint_fit.cu"
    assert k.source_path == "articulated_pose_tpu_torch/csrc/joint_fit.cu"
    assert isinstance(k.launches, int)
    assert k._lib is None               # nothing built on the CPU


def test_cpu_fit_takes_the_plain_joint_stage():
    cfg, pred, P, draws = _inputs()
    pp.JOINT_PROBLEMS.reset()
    before = KERNELS["joint_fit"].launches
    out = pp.fit_frame_batch(pred, P, draws, cfg)
    assert KERNELS["joint_fit"].launches == before
    assert (pp.JOINT_PROBLEMS.kernel, pp.JOINT_PROBLEMS.plain) == (0, 4)
    assert pp.JOINT_PROBLEMS.share() == 0.0
    assert out["nonlinear_R"].shape == (2, 3, 3, 3)
    assert torch.isfinite(out["nonlinear_t"]).all()


def test_lm_hypotheses_take_the_plain_joint_stage():
    cfg, pred, P, draws = _inputs(hypo_estimator="lm", lm_iters_hypo=2)
    pp.JOINT_PROBLEMS.reset()
    pp.fit_frame_batch(pred, P, draws, cfg)
    assert (pp.JOINT_PROBLEMS.kernel, pp.JOINT_PROBLEMS.plain) == (0, 4)


@pytest.mark.parametrize("device,dtype,estimator,takes", [
    ("cuda", torch.float32, "alternating", True),
    ("cuda", torch.float32, "lm", False),
    ("cuda", torch.bfloat16, "alternating", True),
    ("cpu", torch.float32, "alternating", False),
])
def test_the_dispatch_rule(device, dtype, estimator, takes):
    # a stand-in for the buffers: the rule reads their device alone, so
    # CUDA buffers of another dtype reach the kernel, which raises
    buf = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert pp.takes_kernel(buf, pp.PoseFitConfig(hypo_estimator=estimator)) \
        is takes
    if takes and dtype != torch.float32:
        with pytest.raises(ValueError, match="float32"):
            jf.joint_fit(buf, buf, buf, buf, buf, pp.PoseFitConfig())


def test_counters_share_and_reset():
    c = pp.JointProblems(kernel=3, plain=1)
    assert c.share() == 0.75
    c.reset()
    assert (c.kernel, c.plain, c.share()) == (0, 0, 0.0)


def test_single_part_objects_keep_their_baseline_pose():
    cfg, pred, P, draws = _inputs(K=1)
    pp.JOINT_PROBLEMS.reset()
    out = pp.fit_frame_batch(pred, P, draws, cfg)
    assert torch.equal(out["nonlinear_R"], out["baseline_R"])
    assert (pp.JOINT_PROBLEMS.kernel, pp.JOINT_PROBLEMS.plain) == (0, 0)


def test_launch_config_cuts_and_flags():
    cfg = pp.PoseFitConfig(n_parts=4, ransac_score_points=1024,
                           lm_refit_points=512, inlier_th=0.1,
                           joint_types=("revolute", "prismatic", "revolute"))
    lc = jf.launch_config(cfg, 64, 4, 1024)
    assert (lc.score_points, lc.refit_points, lc.prismatic) == (1024, 512, 2)
    assert lc.inlier_th == 0.1 and lc.inlier_th2 == 0.1 * 0.1
    assert (lc.order_hyp, lc.order_mv, lc.order_mvt) == (
        jf.dot_order(64 * 64), jf.dot_order(64), jf.dot_order(64, True))
    small = jf.launch_config(
        pp.PoseFitConfig(ransac_score_points=None, lm_refit_points=None),
        2, 3, 100)
    assert (small.score_points, small.refit_points) == (100, 100)
    for parts in (1, jf.MAX_JOINTS + 2):
        with pytest.raises(ValueError):
            jf.launch_config(pp.PoseFitConfig(), 2, parts, 100)


@pytest.mark.parametrize("n,transposed,order", [
    (16 * 64, False, 1), (64 * 64, False, 1), (256 * 64, False, 2),
    (64 * 128, False, 1), (40000, False, 1), (16, False, 1), (256, False, 1),
    (13000, False, 2), (37300, False, 1), (1, True, 1), (2, True, 0),
    (16, True, 0), (64, True, 0), (128, True, 4), (140, True, 1),
    (160, True, 0), (256, True, 1), (2000, True, 2), (5000, True, 1),
])
def test_dot_orders_at_the_served_batch_counts(n, transposed, order):
    assert jf.dot_order(n, transposed) == order


@pytest.mark.parametrize("version,cuda,release", [
    ("2.11.0+cu128", "12.8", ("2.11", "12.8")),
    ("2.11.1", "12.8", ("2.11", "12.8")),
    ("2.13.0+cpu", None, ("2.13", None)),
    ("2.12.0+cu128", "12.8", ("2.12", "12.8")),
])
def test_toolkit_release(version, cuda, release):
    assert jf.toolkit_of(version, cuda) == release


def test_other_toolkits_warn_once():
    assert jf.check_toolkit("2.11.0+cu128", "12.8")
    jf.check_toolkit.cache_clear()
    with pytest.warns(RuntimeWarning, match="--joint-orders"):
        assert not jf.check_toolkit("2.12.0+cu130", "13.0")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not jf.check_toolkit("2.12.0+cu130", "13.0")   # once


def test_launch_config_warns_where_no_order_was_read():
    cfg = pp.PoseFitConfig()                       # niter_joint 64
    unmatched = [s for s, o in jf.MV_ORDERS if o is None][0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jf.launch_config(cfg, 256, 3, 1024)
        jf.launch_config(cfg, unmatched // 64, 3, 1024)
    for batch in (-(-unmatched // 64), jf.ORDERS_CHECKED_TO // 64 + 1):
        with pytest.warns(RuntimeWarning, match="no product order"):
            lc = jf.launch_config(cfg, batch, 3, 1024)
        assert lc.order_hyp in range(5)


def test_the_product_forms_and_their_tables():
    assert jf.PRODUCT_FORMS == {"mv": jf.MV_ORDERS, "row": jf.MV_ORDERS,
                                "mvt": jf.MVT_ORDERS}
    with pytest.raises(ValueError, match="CUDA"):
        jf.dot3_products(torch.zeros(2, 3, 3), torch.zeros(2, 3), 1)


def test_dot_order_tables_step_upwards():
    for table in (jf.MV_ORDERS, jf.MVT_ORDERS):
        starts = [s for s, _ in table]
        assert starts == sorted(starts) and starts[0] == 1
        assert all(o is None or o in range(5) for _, o in table)
        assert table[0][1] is not None


def test_the_entry_refuses_cpu_tensors():
    cfg, pred, P, draws = _inputs()
    src, tgt, mask, _ = pp.build_part_buffers_sorted(
        pred["nocs_per_point"], P, pred["W"].argmax(-1), 3, 96)
    with pytest.raises(ValueError, match="CUDA"):
        jf.joint_fit(src, tgt, mask, torch.zeros(2, 2, 3), draws.joint, cfg)


def test_work_count_of_the_entry():
    w = roofline.joint_fit_work(64, 3, 1024, 64, 1024)
    assert w.flops == 64 * 2 * 2 * 64 * 1024 * roofline.SCORE_FLOPS
    assert w.bytes == (4 * 64 * 3 * 1024 * 7 + 4 * 128 * 3 + 4 * 128 * 2 * 64
                       * 3 + 4 * 128 * (26 + 1 + 64) + 128 * 2 * 1024)


@pytest.mark.parametrize("joint_types", [
    ("revolute", "prismatic", "revolute"), ("revolute",) * 3])
def test_batched_joints_give_the_loops_fits(joint_types):
    """With batch_joints the plain version solves the joints a type at
    once and gives the loop's fields, bit for bit on the CPU; the
    hypotheses and inliers included."""
    cfg, pred, P, draws = _inputs(B=3, K=4, joint_types=joint_types)
    src, tgt, mask, _ = pp.build_part_buffers_sorted(
        pred["nocs_per_point"], P, pred["W"].argmax(-1), 4, 96)
    axes = pp.vote_joint_axes(pred["joint_axis_per_point"], (
        pred["index_per_point"].argmax(-1).unsqueeze(1)
        == torch.arange(1, 4)[:, None]).float())
    loop = pp.joint_fit_plain(src, tgt, mask, axes, draws.joint, cfg,
                              diagnostics=True)
    batched = pp.joint_fit_plain(
        src, tgt, mask, axes, draws.joint,
        pp.PoseFitConfig(**{**cfg.__dict__, "batch_joints": True}),
        diagnostics=True)
    for f in pp.JointStage._fields:
        assert torch.equal(getattr(loop, f), getattr(batched, f)), f


def test_plain_version_matches_the_plain_joint_stage():
    """joint_fit_plain (what the kernel is held to) gives the poses
    fit_frame_batch returns on the CPU, its chosen hypotheses are the
    first maxima of its scores, and its inlier sets lie inside the
    masks."""
    cfg, pred, P, draws = _inputs(B=3, K=4, joint_types=(
        "revolute", "prismatic", "revolute"))
    src, tgt, mask, _ = pp.build_part_buffers_sorted(
        pred["nocs_per_point"], P, pred["W"].argmax(-1), 4, 96)
    axes = pp.vote_joint_axes(pred["joint_axis_per_point"], (
        pred["index_per_point"].argmax(-1).unsqueeze(1)
        == torch.arange(1, 4)[:, None]).float())
    st = pp.joint_fit_plain(src, tgt, mask, axes, draws.joint, cfg,
                            diagnostics=True)
    out = pp.fit_frame_batch(pred, P, draws, cfg)
    R, s, t = (out[f"nonlinear_{f}"] for f in "Rst")
    assert torch.equal(R[:, 0], st.R0[:, 0]) and torch.equal(R[:, 1:], st.R1)
    assert torch.equal(s[:, 0], st.s0[:, 0]) and torch.equal(s[:, 1:], st.s1)
    assert torch.equal(t[:, 1:], st.t1)
    assert torch.equal(st.best.long(), st.scores.argmax(-1))
    assert st.hypotheses.shape == (3, 3, 6, jf.FIT_WIDTH)
    inside = st.inliers <= (torch.stack([mask[:, :1].expand(3, 3, 96),
                                         mask[:, 1:]], 2) > 0)
    assert inside.all()


def test_the_order_probe_bisects_each_step(monkeypatch):
    """chip_smoke.py --joint-orders' host side, with a stand-in for the
    card's reading: it finds each step of a table to its count, gives
    None where no order matches, and fails where the module's table
    names an order that does not match at a count it read."""
    import chip_smoke

    truth = {"mv": ((1, (1, 3)), (2, (1,)), (13000, (2,)), (37294, (1,)),
                    (74000, ()), (110000, (1,))),
             "mvt": ((1, (1,)), (2, (0,)), (150, (4,)), (2853, (1,)))}
    truth["row"] = truth["mv"]

    def reading(n, form, dev, draws=4, seed=0):
        return [found for start, found in truth[form] if n >= start][-1]

    monkeypatch.setattr(jf, "dot3_orders", reading)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    with pytest.raises(AssertionError, match="other products") as e:
        chip_smoke.joint_orders("cpu")
    assert '"mvt": [[127' in str(e.value)
    assert chip_smoke.order_table(truth["mv"]) == (
        (1, 1), (13000, 2), (37294, 1), (74000, None), (110000, 1))
    truth["mvt"] = tuple((s, (o,) if o is not None else ())
                         for s, o in jf.MVT_ORDERS)
    truth["mv"] = truth["row"] = tuple(
        (s, (o,) if o is not None else ()) for s, o in jf.MV_ORDERS)
    read = chip_smoke.joint_orders("cpu")
    assert read["tables"] == {"mv": jf.MV_ORDERS, "row": jf.MV_ORDERS,
                              "mvt": jf.MVT_ORDERS}
    assert not any(read["off"].values())
