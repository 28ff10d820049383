"""The port's end-to-end learning proof (`e2e.run`) and its sweep, on the
CPU at a tiny width: B=2, N=256, a few steps, 2 held-out frames.

report.json must carry the JAX script's keys (docs/e2e_laptop_report.json)
with finite values; `--resume` must continue from the newest snapshot and
end where an uninterrupted run ends, bit for bit (each step's batch and
dropout masks are functions of (seed, step)).  The flags resolve the
category as scripts/train_synthetic_e2e.py does.
"""

import json
import math
import pathlib

import pytest
import torch

from articulated_pose_tpu_torch import e2e, e2e_sweep
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.train.trainer import checkpoint_steps

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = BackboneSpec(sa_npoints=(32, 16), sa_radii=(0.25, 0.5),
                    sa_nsamples=(8, 8), sa_mlps=((16,), (16,)),
                    global_mlp=(32,), fp_mlps=((16,), (16,), (16,)),
                    head_width=16)
# present only when some frame predicts a point of a moving part (the
# part-boundary trick), which a tiny model after a few steps need not
CONDITIONAL = {"rel_trans_err_mean"}


def tiny_args(work, *extra):
    return e2e.parse_args(["--category", "laptop", "--seed", "2",
                           "--batch", "2", "--points", "256",
                           "--test-frames", "2", "--steps-per-call", "1",
                           "--work", str(work), "--device", "cpu", *extra])


def numbers(report):
    for d in (report["overall"], *report["per_part"], *report["per_joint"]):
        yield from d.values()
    yield report["seg_acc"]


def test_report_has_jax_keys_and_finite_values(tmp_path):
    out = e2e.run(tiny_args(tmp_path, "--steps", "3"), spec=TINY)
    with open(tmp_path / "report.json") as f:
        report = json.load(f)
    assert report == json.loads(json.dumps(out))
    with open(ROOT / "docs" / "e2e_laptop_report.json") as f:
        ref = json.load(f)
    assert set(ref) <= set(report)
    assert set(ref["overall"]) - CONDITIONAL <= set(report["overall"])
    assert len(report["per_part"]) == report["n_parts"] == 2
    for part in report["per_part"]:
        assert set(part) == set(ref["per_part"][0])
    assert len(report["per_joint"]) == 1
    assert set(report["per_joint"][0]) - {"rel_trans_err_mean",
                                          "n_rel_trans"} == \
        set(ref["per_joint"][0]) - {"rel_trans_err_mean", "n_rel_trans"}
    assert all(math.isfinite(v) for v in numbers(report))
    assert (report["category"], report["seed"], report["joint_types"],
            report["train_steps"], report["steps_this_run"]) == \
        ("laptop", 2, ["revolute"], 3, 3)
    assert report["train_clouds_per_sec"] > 0
    assert report["device"] == "cpu"
    assert checkpoint_steps(str(tmp_path / "model")) == [3]


def test_resume_continues_from_the_snapshot(tmp_path, monkeypatch):
    monkeypatch.setattr(e2e, "SNAPSHOT_EVERY", 2)
    straight = e2e.run(tiny_args(tmp_path / "a", "--steps", "5"), spec=TINY)
    # snapshots every 2 steps before the end, then the last step's
    assert checkpoint_steps(str(tmp_path / "a" / "model")) == [2, 4, 5]
    e2e.run(tiny_args(tmp_path / "b", "--steps", "3"), spec=TINY)
    resumed = e2e.run(tiny_args(tmp_path / "b", "--steps", "5", "--resume"),
                      spec=TINY)
    assert resumed["steps_this_run"] == 2
    assert checkpoint_steps(str(tmp_path / "b" / "model")) == [2, 3, 5]
    a = torch.load(tmp_path / "a" / "model" / "ckpt_5.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "model" / "ckpt_5.pt", weights_only=True)
    assert int(b["step"]) == int(b["count"]) == 5
    for part in ("model", "mu", "nu"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for key in ("per_part", "overall", "per_joint", "seg_acc"):
        assert resumed[key] == straight[key], key


def test_without_resume_starts_over(tmp_path):
    e2e.run(tiny_args(tmp_path, "--steps", "2"), spec=TINY)
    again = e2e.run(tiny_args(tmp_path, "--steps", "2"), spec=TINY)
    assert again["steps_this_run"] == 2


@pytest.mark.parametrize("argv,want", [
    (["--category", "laptop"], (2, ("revolute",))),
    (["--category", "drawer"], (4, ("prismatic",) * 3)),
    (["--category", "drawer", "--parts", "3"], (3, ("revolute",) * 2)),
    (["--parts", "2", "--joint-types", "prismatic"], (2, ("prismatic",))),
    ([], (3, ("revolute",) * 2)),
])
def test_category_setup_follows_the_script(argv, want):
    assert e2e.category_setup(e2e.parse_args(argv)) == want


def test_defaults_follow_the_script():
    a = e2e.parse_args([])
    assert (a.steps, a.steps_per_call, a.test_frames, a.batch, a.points,
            a.noise, a.lr, a.dtype, a.device) == \
        (6000, 25, 64, 32, 1024, 0.005, 1e-3, "float32", "cuda")
    with pytest.raises(ValueError, match="joint types"):
        e2e.category_setup(e2e.parse_args(["--parts", "3", "--joint-types",
                                           "revolute"]))


def test_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tiny_args(tmp_path, "--steps", "1")
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="not available"):
        e2e.run(args, spec=TINY)


def test_sweep_summary_has_the_jax_keys(tmp_path):
    with open(ROOT / "docs" / "e2e_sweep_summary.json") as f:
        ref = json.load(f)
    for cat in ("drawer", "laptop"):
        with open(ROOT / "docs" / f"e2e_{cat}_report.json") as f:
            report = json.load(f)
        with open(tmp_path / f"e2e_{cat}_report.json", "w") as f:
            json.dump(report, f)
    with open(e2e_sweep.write_summary(str(tmp_path))) as f:
        got = json.load(f)
    assert list(got) == ["laptop", "drawer"]          # the table's order
    for cat in got:
        assert got[cat] == ref[cat]
    assert [(c, s, m) for c, s, m in e2e_sweep.SWEEP] == [
        ("eyeglasses", 1, 3), ("laptop", 2, 1), ("oven", 42, 1),
        ("washing_machine", 43, 1), ("drawer", 3, 3)]
