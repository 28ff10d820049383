"""The port's command line (`articulated_pose_tpu_torch.main`) on the CPU,
in-process through `main(argv)` with `--device cpu` at tiny widths, held
against the JAX package's `main.py` where the two must agree: the
offline `eval --from_pred` report on a JAX-written prediction directory
(with JAX's draws), the report keys, and every usage error."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import main as jmain
from articulated_pose_tpu.data.synthetic import \
    SyntheticArticulated as JSynthetic
from articulated_pose_tpu.utils.prediction_io import \
    save_batch_predictions as jsave
from articulated_pose_tpu_torch import main as cli
from articulated_pose_tpu_torch.config import load_config
from articulated_pose_tpu_torch.parallel.mesh import make_mesh
from articulated_pose_tpu_torch.pose.pipeline import PoseFitConfig
from articulated_pose_tpu_torch.registry import get_category
from articulated_pose_tpu_torch.serving import PosePredictor, serve_clouds
from articulated_pose_tpu_torch.utils.prediction_io import load_prediction
from test_torch_pose import jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B = 128, 2
TINY = ["--device", "cpu", "--backbone", "tiny", "--batch_size", str(B),
        "--num_points", str(N)]
REPORT_KEYS = {"per_part", "overall", "per_joint", "n_frames", "n_dropped"}
# the fit's hypothesis counts for the --from_pred comparison (a config
# file, as a user would set them)
FIT_CFG = "ransac_niter_part: 32\nransac_niter_joint: 16\n"
AXIS_TILT = np.array([0.035, -0.02, 0.03], np.float32)


def run(*argv, draws=None):
    cli.main(list(argv), draws=draws)


@pytest.fixture(scope="module")
def demo_work(tmp_path_factory):
    """`demo` for 2 steps: the work dir holds the step-2 checkpoint."""
    work = str(tmp_path_factory.mktemp("demo"))
    run("demo", *TINY, "--max_steps", "2", "--synthetic_frames", "4",
        "--work_dir", work)
    return work


def label_predictions(path, n_frames, seed):
    """A JAX-written prediction dir of eyeglasses frames whose
    predictions are the labels plus noise: the fits land near 1.5° and
    0.5 cm, well clear of the 5°5cm thresholds, so float rounding flips
    no count, and far enough from 0° that the rotation error's arccos,
    whose rounding grows as 1/θ² there, keeps the two packages' float
    rounding in the fourth digit."""
    gen = JSynthetic(n_parts=3, points_per_part=150, seed=seed)
    batch, _ = gen.batch(np.random.RandomState(seed), n_frames, num_points=N)
    pred = predictions_from_labels(batch, 3, seed)
    jsave(pred, batch, [f"frame_{i:02d}" for i in range(n_frames)],
          str(path))
    return str(path)


def predictions_from_labels(batch, K, seed):
    """Every head's prediction: its label plus noise (see
    label_predictions)."""
    n_frames = len(batch["P"])
    rs = np.random.RandomState(seed + 1)
    cls = batch["cls_gt"].astype(int)
    nocs = np.zeros((n_frames, N, 3 * K), np.float32)
    for j in range(K):
        sel = (cls == j)[..., None]
        nocs[..., 3 * j:3 * j + 3] = np.where(sel, batch["nocs_gt"], 0.0)
    noise = lambda *s: 0.03 * rs.randn(*s).astype(np.float32)  # noqa: E731
    pred = {
        "W": np.eye(K, dtype=np.float32)[cls] + noise(n_frames, N, K),
        "nocs_per_point": nocs + noise(n_frames, N, 3 * K),
        "gocs_per_point": (np.tile(batch["nocs_gt_g"], (1, 1, K))
                           + noise(n_frames, N, 3 * K)),
        "confi_per_point": np.ones((n_frames, N, 1), np.float32),
        "heatmap_per_point": batch["heatmap_gt"][..., None]
        + noise(n_frames, N, 1),
        "unitvec_per_point": batch["unitvec_gt"] + noise(n_frames, N, 3),
        # the axes tilted ~2.5° as a whole, for the same reason
        "joint_axis_per_point": batch["orient_gt"] + AXIS_TILT
        + noise(n_frames, N, 3),
        "index_per_point": np.eye(K, dtype=np.float32)[
            batch["joint_cls_gt"].astype(int)],
    }
    return pred


@pytest.fixture(scope="module")
def from_pred(tmp_path_factory):
    """A JAX-written prediction dir, and JAX's `eval --from_pred` report
    on it (two batches of 4 frames)."""
    root = tmp_path_factory.mktemp("from_pred")
    pred_dir = label_predictions(root / "pred", 8, seed=3)
    (root / "fit.yml").write_text(FIT_CFG)
    jwork = str(root / "jax")
    jmain.main(["eval", "--from_pred", pred_dir, "--batch_size", "4",
                "--config", str(root / "fit.yml"), "--work_dir", jwork])
    with open(os.path.join(jwork, "eval_from_pred_all.json")) as f:
        return pred_dir, str(root / "fit.yml"), json.load(f)


def jax_pose_draws(config_path):
    """JAX's draws for every batch: PRNGKey(cfg.seed), as its eval
    reuses one key (main.py:275)."""
    cfg = load_config(config_path, category="eyeglasses", n_max_parts=3)
    pose_cfg = PoseFitConfig(n_parts=3, niter_part=cfg.ransac_niter_part,
                             niter_joint=cfg.ransac_niter_joint)
    return lambda B: jax_draws(jax.random.PRNGKey(cfg.seed), B, pose_cfg)


def assert_reports_close(got, want, where="report"):
    """Same keys and structure; ints equal; every number within 1e-4
    absolute or 1e-3 relative."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_reports_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_reports_close(g, w, f"{where}[{i}]")
    elif isinstance(want, int):
        assert got == want, where
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                                   err_msg=where)


def test_eval_from_pred_reproduces_jax(from_pred, tmp_path):
    pred_dir, fit_cfg, want = from_pred
    work = str(tmp_path / "port")
    run("eval", "--device", "cpu", "--from_pred", pred_dir, "--batch_size",
        "4", "--config", fit_cfg, "--work_dir", work,
        draws=jax_pose_draws(fit_cfg))
    with open(os.path.join(work, "eval_from_pred_all.json")) as f:
        got = json.load(f)
    assert set(got) == REPORT_KEYS
    assert got["n_frames"] == want["n_frames"] == 8
    assert got["n_dropped"] == want["n_dropped"]
    o = got["overall"]
    assert o["acc_5deg5cm"] == 1.0 and o["rot_err_deg_mean"] > 0.1
    assert "joint_axis_err_deg" in o and len(got["per_joint"]) == 2
    assert_reports_close(got, want)


def test_eval_from_pred_bmvc15_denormalizes_as_jax(tmp_path):
    """BMVC15 frames (metric input, P_center / P_scale): the fits and the
    GT poses are mapped back to camera space (main.py:351-366) in both
    packages, on JAX's draws, to the same report.  The prediction files
    are the port's: JAX's writer refuses the scalar P_scale (C7)."""
    from articulated_pose_tpu_torch.data.hdf5_dataset import HDF5Dataset
    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
    from articulated_pose_tpu_torch.utils.prediction_io import \
        save_batch_predictions

    root = str(tmp_path / "data")
    SyntheticArticulated(n_parts=2, points_per_part=150, seed=0,
                         joint_types=["revolute"]).export_hdf5(
        root, "Laptop", frames_per_instance=8, test_fraction=0.5,
        instance_names=("0001", "0006"))
    ds = HDF5Dataset(root, "Laptop", mode="test", domain="unseen",
                     num_points=N, fixed_order=True)
    batch = {k: np.stack([ds.fetch(i)[k] for i in range(len(ds))])
             for k in ds.fetch(0)}
    assert len(ds) == 4 and batch["P_scale"].shape == (4,)
    pred_dir = str(tmp_path / "pred")
    save_batch_predictions(predictions_from_labels(batch, 2, seed=5), batch,
                           ds.basenames, pred_dir)
    fit_cfg = tmp_path / "fit.yml"
    fit_cfg.write_text(FIT_CFG)
    argv = ["eval", "--item", "Laptop", "--from_pred", pred_dir,
            "--batch_size", "4", "--config", str(fit_cfg)]
    jmain.main(argv + ["--work_dir", str(tmp_path / "jax")])
    cfg = load_config(str(fit_cfg), category="Laptop", n_max_parts=2)
    pose_cfg = PoseFitConfig(n_parts=2, niter_part=cfg.ransac_niter_part,
                             niter_joint=cfg.ransac_niter_joint,
                             joint_types=("revolute",))
    run(*argv, "--device", "cpu", "--work_dir", str(tmp_path / "port"),
        draws=lambda B: jax_draws(jax.random.PRNGKey(cfg.seed), B, pose_cfg))
    reports = [json.load(open(tmp_path / w / "eval_from_pred_all.json"))
               for w in ("port", "jax")]
    assert reports[0]["n_frames"] == 4
    assert reports[0]["overall"]["acc_5deg5cm"] == 1.0
    assert_reports_close(*reports)


def test_baseline_pred_paired_with_itself(from_pred, tmp_path):
    """--baseline_pred DIR paired with DIR itself takes the same
    segmentation and NOCS: the report is the plain one, byte for byte."""
    pred_dir, fit_cfg, _ = from_pred
    paths = []
    for extra in ([], ["--baseline_pred", pred_dir]):
        work = str(tmp_path / str(len(extra)))
        run("eval", "--device", "cpu", "--from_pred", pred_dir,
            "--batch_size", "4", "--config", fit_cfg, "--work_dir", work,
            *extra)
        paths.append(os.path.join(work, "eval_from_pred_all.json"))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_demo_then_eval_resumes(demo_work, from_pred, capsys, tmp_path):
    """eval --synthetic restores the demo's checkpoint; its report has
    JAX's keys (those of JAX's eval report), NPCS and NAOCS, with the GT
    joint association from a config file, and the baseline fits."""
    _, _, jax_report = from_pred
    (tmp_path / "gt.yml").write_text("use_gt_joint_association: true\n")
    for extra in ([], ["--nocs", "NAOCS"], ["--config", str(tmp_path / "gt.yml")],
                  ["--baseline_only", "--full_test"]):
        capsys.readouterr()
        run("eval", *TINY, "--synthetic", "--synthetic_frames", "3",
            "--work_dir", demo_work, *extra)
        out = capsys.readouterr().out
        assert "restored checkpoint step 2" in out and "overall:" in out
        with open(os.path.join(demo_work, "eval_all.json")) as f:
            got = json.load(f)
        assert set(got) == REPORT_KEYS and got["n_frames"] == 3
        # the joint errors are there when a joint line was voted, which
        # two steps of training need not give
        joint = {"joint_axis_err_deg", "joint_line_dist"}
        assert (set(jax_report["overall"]) - joint <= set(got["overall"])
                <= set(jax_report["overall"]))
        assert set(got["per_part"][0]) == set(jax_report["per_part"][0])
        assert set(got["per_joint"][0]) == set(jax_report["per_joint"][0])


def test_test_writes_one_file_a_frame(demo_work, tmp_path):
    run("test", *TINY, "--synthetic", "--synthetic_frames", "3",
        "--work_dir", demo_work)
    out = os.path.join(demo_work, "test_pred")
    assert sorted(os.listdir(out)) == [f"synth_test_{i}.h5" for i in range(3)]
    got = load_prediction(os.path.join(out, "synth_test_2.h5"))
    assert {"instance_per_point", "nocs_per_point", "gocs_per_point",
            "P", "cls_gt", "nocs_gt_g", "joint_cls_gt"} <= set(got)
    assert got["instance_per_point"].shape == (N, 3)


def test_hdf5_train_test_eval_from_pred(tmp_path, capsys):
    """The reference-format path: frames exported to HDF5 -> train
    --data_root -> test -> eval --from_pred on what test wrote."""
    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated

    root, work = str(tmp_path / "data"), str(tmp_path / "work")
    SyntheticArticulated(n_parts=3, points_per_part=150, seed=0).export_hdf5(
        root, "eyeglasses", n_instances=2, frames_per_instance=6,
        test_fraction=0.34)
    run("train", *TINY, "--data_root", root, "--max_steps", "3",
        "--work_dir", work)
    run("test", *TINY, "--data_root", root, "--work_dir", work)
    files = sorted(os.listdir(os.path.join(work, "test_pred")))
    assert files == ["0000_0_4.h5", "0000_0_5.h5", "0001_0_4.h5",
                     "0001_0_5.h5"]
    capsys.readouterr()
    run("eval", "--device", "cpu", "--batch_size", str(B), "--from_pred",
        os.path.join(work, "test_pred"), "--work_dir", work)
    assert "overall:" in capsys.readouterr().out
    with open(os.path.join(work, "eval_from_pred_all.json")) as f:
        assert json.load(f)["n_frames"] == 4


def test_serve_input_short_last_batch(demo_work, tmp_path, capsys):
    clouds = np.random.RandomState(0).rand(5, N, 3).astype(np.float32)
    np.save(tmp_path / "clouds.npy", clouds)
    out = str(tmp_path / "poses.npz")
    run("serve", *TINY, "--work_dir", demo_work, "--input",
        str(tmp_path / "clouds.npy"), "--output", out)
    assert "served 5 clouds" in capsys.readouterr().out
    got = np.load(out)
    cfg = load_config(category="eyeglasses", n_max_parts=3, batch_size=B,
                      num_points=N, backbone_preset="tiny")
    want = serve_clouds(PosePredictor(cfg, work_dir=demo_work, device="cpu"),
                        clouds, B)
    assert set(got.files) == set(want) == {"R", "s", "t", "seg",
                                           "part_counts"}
    for k in want:
        assert got[k].shape[0] == 5
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # --synthetic serves the test split's clouds
    run("serve", *TINY, "--work_dir", demo_work, "--synthetic",
        "--synthetic_frames", "3", "--output", out)
    assert np.load(out)["R"].shape == (3, 3, 3, 3)
    # --mesh data=2 on two copies of the CPU: each batch of B splits into
    # two shards, each with its own draws (parallel/mesh.py)
    run("serve", *TINY, "--work_dir", demo_work, "--input",
        str(tmp_path / "clouds.npy"), "--output", out, "--mesh", "data=2")
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert "served 5 clouds" in last and "mesh=data=2" in last
    got = np.load(out)
    mesh = make_mesh("data=2", devices=[torch.device("cpu")] * 2)
    want = serve_clouds(PosePredictor(cfg, work_dir=demo_work, mesh=mesh),
                        clouds, B)
    assert set(got.files) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_joint_baseline_demo_then_eval(tmp_path, capsys):
    work = str(tmp_path / "jb")
    run("demo", "--model", "joint_baseline", "--device", "cpu",
        "--batch_size", str(B), "--num_points", str(N), "--max_steps", "2",
        "--synthetic_frames", "4", "--work_dir", work)
    out = capsys.readouterr().out
    assert "joint_axis_err_deg" in out and '"resumed_step": 0.0' in out
    run("eval", "--model", "joint_baseline", "--device", "cpu", "--synthetic",
        "--batch_size", str(B), "--num_points", str(N),
        "--synthetic_frames", "4", "--work_dir", work)
    assert '"resumed_step": 2.0' in capsys.readouterr().out
    with open(os.path.join(work, "joint_baseline_eval.json")) as f:
        assert set(json.load(f)) == {"joint_axis_err_deg", "joint_offset_err",
                                     "n_joints_evaluated"}


def usage_cases(tmp_path, pred_dir):
    empty = tmp_path / "empty"
    empty.mkdir(exist_ok=True)
    return {
        "baseline_without_from_pred": ["eval", "--baseline_pred", pred_dir],
        "from_pred_with_train": ["train", "--from_pred", pred_dir],
        "serve_joint_baseline": ["serve", "--model", "joint_baseline"],
        "wrong_n_max_parts": ["eval", "--item", "laptop", "--from_pred",
                              pred_dir, "--work_dir", str(tmp_path / "w")],
        "empty_dir": ["eval", "--from_pred", str(empty), "--work_dir",
                      str(tmp_path / "w")],
        "from_pred_and_synthetic": ["eval", "--from_pred", pred_dir,
                                    "--synthetic"],
        "serve_without_input": ["serve", "--work_dir", str(tmp_path / "w")],
    }


@pytest.mark.parametrize("case", ["baseline_without_from_pred",
                                  "from_pred_with_train",
                                  "serve_joint_baseline", "wrong_n_max_parts",
                                  "empty_dir", "from_pred_and_synthetic",
                                  "serve_without_input"])
def test_usage_errors_exit_as_jaxs(case, from_pred, tmp_path):
    argv = usage_cases(tmp_path, from_pred[0])[case]
    with pytest.raises(SystemExit) as want:
        jmain.main(argv)
    with pytest.raises(SystemExit) as got:
        run(*argv, "--device", "cpu")
    assert isinstance(want.value.code, str)
    assert got.value.code == want.value.code


def test_unknown_category_raises_as_jaxs():
    argv = ["eval", "--item", "nonexistent", "--synthetic"]
    with pytest.raises(KeyError) as want:
        jmain.main(argv)
    with pytest.raises(KeyError) as got:
        run(*argv, "--device", "cpu")
    assert str(got.value) == str(want.value)
    assert "unknown category" in str(got.value)


def test_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run("demo", "--backbone", "tiny")


def test_module_entry_point():
    """`python -m articulated_pose_tpu_torch` is the command line."""
    r = subprocess.run([sys.executable, "-m", "articulated_pose_tpu_torch",
                        "serve", "--device", "cpu"], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 1
    assert "serve needs --input or --synthetic" in r.stderr
    assert get_category("eyeglasses").num_parts == 3
