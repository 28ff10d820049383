"""The timing tools (`ab/overlap.py`, `ab/batch.py`, `ab/batch_joints.py`,
`probe_card.py`, `roofline_session.py`) on the CPU, at tiny widths
(tests/test_torch_models.py's), B <= 3, N = 128.

- Overlap: the pipelined arm's fits equal the serial arm's, bit for bit
  (same clouds, same draws).
- Batch: each B's first fit equals one `fit_frame_batch` call at that B
  on the same prediction, cloud and draws.
- Batch-joints: the two arms' fits are bit for bit on the CPU (ROADMAP
  C7); the GT predictions are those of the JAX script's frames.
- Every tool raises without a card unless given `--device cpu`;
  `probe_card` raises on the CPU, and its FMA chain's plain version is
  the closed form of the chain.
- The session joins each profiled stage with its count's floors.
- The fold tool (`ab/bn_fold.py`) reads its rounding on the CPU, leaves
  the model's fold choices as it found them, and reads a gap array
  scaled by a factor as that factor one way and its inverse the other.
"""

import numpy as np
import pytest
import torch

from articulated_pose_tpu.data.synthetic import \
    SyntheticArticulated as JaxSynthetic
from articulated_pose_tpu_torch import (probe_card, profile_stages,
                                        profile_train_stages, roofline,
                                        roofline_session)
from articulated_pose_tpu_torch.ab import (batch, batch_joints, bn_fold,
                                          overlap)
from articulated_pose_tpu_torch.ab.common import BenchProgram, fits_equal
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec)
from articulated_pose_tpu_torch.ops.kernels import probe
from articulated_pose_tpu_torch.pose.pipeline import fit_frame_batch
from articulated_pose_tpu_torch.programs import bench_model

TINY = BackboneSpec(**TINY_WIDTHS)
CPU = torch.device("cpu")
N = 128


def test_overlap_pipelined_fits_equal_serial():
    args = overlap.parser().parse_args(["--device", "cpu", "--batch", "2",
                                        "--points", str(N), "--iters", "3"])
    res = overlap.run(args, spec=TINY)
    serial = res["fits"]["serial (fwd->pose)"]
    piped = res["fits"]["pipelined (fwd || pose-1)"]
    assert len(serial) == len(piped) == 3
    for a, b in zip(serial, piped):
        assert fits_equal(a, b)
    # each iteration's cloud is its own
    assert not fits_equal(serial[0], serial[1])
    assert res["card"] is None
    assert set(res["ms"]) == set(overlap.ARMS)


def test_overlap_cheap_knobs_are_the_jax_flags():
    assert overlap.CHEAP_KNOBS == dict(niter_part=64, lm_iters_refit=3,
                                       ransac_score_points=512)
    args = overlap.parser().parse_args(["--cheap-knobs"])
    assert args.cheap_knobs and args.iters == 64 and args.batch == 64


def test_batch_fits_equal_one_fit_per_b():
    args = batch.parser().parse_args(["--device", "cpu", "--iters", "1",
                                      "--batches", "2,3"])
    res = batch.run(args, spec=TINY, points=N)
    assert [r["batch"] for r in res["rows"]] == [2, 3]
    for B in (2, 3):
        prog = BenchProgram(B, N, 1, CPU, TINY)
        with torch.inference_mode():
            pred = prog.forward(0)
            want = fit_frame_batch(pred, prog.clouds[0], prog.draws[0],
                                   prog.cfg)
        assert fits_equal(res["fits"][B], want)
        row = res["rows"][[2, 3].index(B)]
        assert row["device_ms"] is None and len(row["runs"]) == 2


def test_batch_joints_arms_are_bit_for_bit():
    args = batch_joints.parser().parse_args(
        ["--device", "cpu", "--batch", "2", "--points", str(N), "--iters",
         "1"])
    res = batch_joints.run(args)
    assert res["max_fit_difference"] == 0.0
    assert fits_equal(*res["fits"])
    assert all(len(w) == 2 for w in res["windows"].values())


def test_batch_joints_frames_are_the_jax_scripts():
    K = 3
    P, pred = batch_joints.gt_predictions(2, N, K, CPU)
    gen = JaxSynthetic(n_parts=K, points_per_part=500,
                       joint_types=("revolute",) * (K - 1), seed=0)
    rs = np.random.RandomState(0)
    frames = [gen.frame(rs, num_points=N)[0] for _ in range(2)]
    np.testing.assert_array_equal(P.numpy(),
                                  np.stack([f["P"] for f in frames]))
    np.testing.assert_array_equal(
        pred["W"].argmax(-1).numpy(),
        np.stack([f["cls_gt"] for f in frames]).astype(int))


def test_bn_fold_reads_the_rounding_on_the_cpu():
    args = bn_fold.parser().parse_args(["--device", "cpu", "--batch", "2",
                                        "--points", str(N)])
    res = bn_fold.run(args, spec=TINY)
    assert res["card"] is None and "fold_ms" not in res
    assert res["layers"] > 0
    for state in ("as_built", "calibrated"):
        r = res["rounding"][state]
        assert set(r) == {"ratio", "reverse", "median", "worst_head"}
        assert r["worst_head"] in bn_fold.HEADS
        for k in ("ratio", "reverse", "median"):
            assert np.isfinite(r[k]) and r[k] > 0, (state, k)


def test_bn_fold_keeps_the_models_fold_choices():
    model = bench_model(CPU, TINY)
    kept = {n: m.fold_bn for n, m in model.named_modules()
            if hasattr(m, "fold_bn")}
    assert not all(kept.values()) and any(kept.values())
    with bn_fold.norms_apart(model):
        assert model.folded_bn_layers == 0
    assert kept == {n: m.fold_bn for n, m in model.named_modules()
                    if hasattr(m, "fold_bn")}


def test_bn_fold_readings_of_scaled_gaps():
    g = np.random.RandomState(0).rand(len(bn_fold.HEADS), 5) + 0.5
    same = bn_fold.readings(g, g)
    assert same["ratio"] == same["reverse"] == same["median"] == 1.0
    twice = bn_fold.readings(2 * g, g)
    assert twice["ratio"] == pytest.approx(2.0)
    assert twice["median"] == pytest.approx(2.0)
    assert twice["reverse"] == pytest.approx(0.5)


TOOLS = {"roofline": roofline.main, "roofline_session": roofline_session.main,
         "profile_train_stages": profile_train_stages.main,
         "ab.overlap": overlap.main, "ab.batch": batch.main,
         "ab.batch_joints": batch_joints.main, "probe_card": probe_card.main,
         "ab.bn_fold": bn_fold.main}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_without_a_card_each_tool_raises(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    # the probe names the device it did not find, as timing.require_card
    with pytest.raises(RuntimeError, match="device cuda is not (an )?"
                       "available"):
        TOOLS[tool]([])


def test_probe_has_no_cpu_path():
    with pytest.raises(RuntimeError, match="device cpu"):
        probe_card.main(["--device", "cpu"])
    with pytest.raises(ValueError, match="CUDA device"):
        probe.fma_chain(torch.ones(8))


def test_fma_chain_plain_is_the_closed_form():
    x = np.random.RandomState(0).rand(64).astype(np.float32) + 0.5
    a, b = float(np.float32(probe.A)), float(np.float32(probe.B))
    d = probe.DEPTH
    want = x.astype(np.float64) * a ** d + b * (a ** d - 1) / (a - 1)
    np.testing.assert_allclose(probe.fma_chain_plain(x), want, rtol=1e-12)


def test_session_joins_the_profile_with_the_floors():
    counts = roofline_session.count_stages(2, N, CPU, TINY)
    assert set(counts) == set(profile_stages.STAGES)
    profile = [dict(stage=s, label=s, device_ms=2.0)
               for s in profile_stages.STAGES]
    ceilings = dict(hbm_bytes_per_s=1e12, f32_flops=2e13)
    rows = roofline_session.table(profile, counts, ceilings)
    for r in rows:
        c = counts[r["stage"]]
        pub = c.floors()["floor_ms"]
        meas = c.floors(f32_flops=2e13, hbm=1e12)
        assert r["share_published"] == pub / 2.0
        assert r["measured_floor_ms"] == meas["floor_ms"]
        assert r["share_measured"] == meas["floor_ms"] / 2.0
    # no ceilings, no device ms: no shares
    rows = roofline_session.table(
        [dict(p, device_ms=None) for p in profile], counts, None)
    assert all(r["share_published"] is None
               and "measured_floor_ms" not in r for r in rows)


def test_session_on_the_cpu_profiles_and_counts_every_stage(capsys):
    res = roofline_session.run(batch=2, points=N, iters=1, device="cpu",
                               spec=TINY)
    assert [r["stage"] for r in res["rows"]] == list(profile_stages.STAGES)
    assert res["ceilings"] is None
    fwd = res["rows"][0]
    assert fwd["kernels"] == {"fps2": 1, "ball_query_group": 2,
                              "three_nn": 2}
    assert "not measured" in capsys.readouterr().out
