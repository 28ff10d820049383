"""The port's accuracy tools (`articulated_pose_tpu_torch/ab/`) against the
JAX package's scripts, on the CPU, and the JAX package's last functions
in the port.

Each JAX script is imported from `scripts/` through importlib and run as
it is; where a test needs what it hands to a function, the test patches
that function's attribute on the JAX module (nothing under `scripts/`
or `articulated_pose_tpu/` is edited).  Tolerances:

- the noisy-oracle frames and predictions of ab_ransac_strength.py:
  bit-equal to what JAX's `main()` hands to `fit_frame_batch`, and every
  arm's config and tag equal to JAX's, in both modes;
- one arm with JAX's draws imposed: the printed rot, median and trans
  within one unit of their last printed digit and 5°5cm equal; the
  scores of the two fits within 1e-3 degrees and 1e-5 (test_torch_pose's
  fit tolerances, 1e-3 in R, carried through the scorer);
- packed_eval's `run_eval` on converted TINY weights, JAX's frames and
  draws: seg acc, the valid count and the 5° / 5°5cm shares equal, the
  mean rotation error within 0.06° (a fit's R within 1e-3), the mean
  translation error within 1e-4 relative, mIoU within 1e-5 (measured:
  4.4e-3°, 7.8e-7 relative, 1.2e-7);
- bf16_grads: ARMS and the parameter controls equal to the JAX script's
  `arms` and `param_arms` (its own cfg_for, cast_like_bf16 and jitter,
  taken from its source), and each arm's Dense and PointConv dtypes
  equal to JAX's model's of the script's config; module keys equal to
  JAX's `flat_per_module` at depth 2 and 4; the f32 arm with JAX's ReLU
  masks imposed within 1e-4 of each module's largest JAX gradient
  entry; each bf16 arm on JAX's routing (ReLU masks and max selections)
  within ARM_COS in cosine and ARM_NORM in norm of JAX's same arm, per
  module and whole, the pre-batch-norm Dense biases left out (their
  exact gradient is 0, so in bf16 each backend's value is its own
  rounding noise: their cosines are not compared);
- the augmentations bit-equal to JAX's; Kabsch/transform_pts with
  method="svd" within 1e-5 of JAX's; sample_and_group_all and
  sample_and_group(use_xyz=False) equal; render_available as JAX's.
"""

import ast
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import pathlib
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from articulated_pose_tpu import config as jconfig
from articulated_pose_tpu.data import augment as jaugment
from articulated_pose_tpu.data.device_synthetic import \
    DeviceSynthetic as JaxDeviceSynthetic
from articulated_pose_tpu.data.synthetic import \
    SyntheticArticulated as JaxSynthetic
from articulated_pose_tpu.models import pointnet2 as jpointnet2
from articulated_pose_tpu.models.ancsh import build_model as jax_build_model
from articulated_pose_tpu.models.layers import PointConv as JaxPointConv
from articulated_pose_tpu import native as jnative
from articulated_pose_tpu.pose import pipeline as jpipe
from articulated_pose_tpu.pose import umeyama as jum
from articulated_pose_tpu.train import state as jstate
from articulated_pose_tpu_torch import config, native
from articulated_pose_tpu_torch.ab import (bf16_grads, common, eval_scale,
                                           oracle, packed_eval,
                                           pose_knobs_trained,
                                           ransac_strength, restore_eval)
from articulated_pose_tpu_torch.convert import (flax_tree,
                                                state_dict_from_flax)
from articulated_pose_tpu_torch.data import augment
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.data.batcher import BatchIterator
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.layers import PointConv
from articulated_pose_tpu_torch.models.pointnet2 import (
    TINY_WIDTHS, BackboneSpec, sample_and_group, sample_and_group_all)
from articulated_pose_tpu_torch.pose import umeyama
from articulated_pose_tpu_torch.train.routing import impose_routing
from articulated_pose_tpu_torch.train.state import TrainState
from articulated_pose_tpu_torch.train.trainer import Trainer
from test_torch_pose import jax_draws, port_cfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = BackboneSpec(**TINY_WIDTHS)


def script(name):
    """scripts/<name>.py as a module, imported as it stands."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch):
    """mod.main() under argv; returns its stdout."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def ns(parser, argv):
    return parser().parse_args(argv)


# ------------------------------------------------------- ransac_strength
class FitRecorder:
    """Stands in for JAX's fit_frame_batch: records each call's inputs
    and returns identity rotations (or, with `real`, JAX's fit)."""

    def __init__(self, real=None):
        self.calls, self.real = [], real

    def __call__(self, pred, P, key, cfg, **kw):
        rec = {"pred": {k: np.asarray(v) for k, v in pred.items()},
               "P": np.asarray(P), "key": key, "cfg": cfg}
        if self.real is not None:
            rec["out"] = jax.device_get(self.real(pred, P, key, cfg, **kw))
        self.calls.append(rec)
        if "out" in rec:
            return rec["out"]
        B, K = P.shape[0], cfg.n_parts
        return {"nonlinear_R": np.broadcast_to(np.eye(3), (B, K, 3, 3)),
                "nonlinear_t": np.zeros((B, K, 3))}


def tags(stdout):
    return [ln.split(" rot ")[0].rstrip() for ln in stdout.splitlines()
            if " rot " in ln]


@pytest.mark.parametrize("mode,n_arms", [([], 12), (["--r4"], 13),
                                         (["--r4", "--arms", "refit,mean"],
                                          8)], ids=["sweep", "r4", "filter"])
def test_noisy_oracle_and_arms_equal_jax(mode, n_arms, monkeypatch):
    """What JAX's main() hands to fit_frame_batch: the predictions and P
    bit-equal to the port's; each arm's config and tag equal, --arms
    filtering alike."""
    argv = ["--frames", "2", "--points", "128", *mode]
    rec = FitRecorder()
    monkeypatch.setattr(jpipe, "fit_frame_batch", rec)
    out = run_jax_main(script("ab_ransac_strength"), argv, monkeypatch)
    args = ns(ransac_strength.parser, argv + ["--device", "cpu"])
    fr, _, pred = ransac_strength.inputs(args.frames, args.points,
                                         args.nocs_noise, args.seg_flip)
    P = np.stack([s["P"] for s in fr])
    arms = ransac_strength.arms(
        args.r4, args.arms.split(",") if args.arms else None)
    assert len(rec.calls) == len(arms) == n_arms
    for call in rec.calls:
        assert set(call["pred"]) == set(pred)
        for k, v in pred.items():
            assert call["pred"][k].dtype == v.dtype, k
            np.testing.assert_array_equal(call["pred"][k], v, err_msg=k)
        np.testing.assert_array_equal(call["P"], P)
    assert tags(out) == [t for t, _ in arms]
    for call, (_, cfg) in zip(rec.calls, arms):
        assert port_cfg(call["cfg"]) == cfg


def row_numbers(line):
    """(rot, median, trans, 5°5cm) of a printed row."""
    parts = line.split(" rot ", 1)[1].replace("°", " ").split()
    return tuple(float(parts[i]) for i in (0, 2, 4, 7))


def test_control_arm_matches_jax_with_its_draws(monkeypatch, capsys):
    """JAX's real fit of the --r4 control, and the port's with JAX's
    draws: printed rows within a unit of their last digit, scores
    within 1e-3 degrees and 1e-5."""
    argv = ["--frames", "2", "--points", "128", "--r4", "--arms", "none"]
    rec = FitRecorder(real=jpipe.fit_frame_batch)
    monkeypatch.setattr(jpipe, "fit_frame_batch", rec)
    want_out = run_jax_main(script("ab_ransac_strength"), argv, monkeypatch)
    args = ns(ransac_strength.parser, argv + ["--device", "cpu"])
    rows = ransac_strength.run(
        args, draws=lambda cfg: jax_draws(jax.random.PRNGKey(0), 2, cfg))
    got_out = capsys.readouterr().out
    (want_line,) = [ln for ln in want_out.splitlines() if " rot " in ln]
    (got_line,) = [ln for ln in got_out.splitlines() if " rot " in ln]
    assert tags(got_line) == tags(want_line)
    g, w = row_numbers(got_line), row_numbers(want_line)
    for a, b, unit in zip(g, w, (0.01, 0.01, 1e-4, 1e-3)):
        assert abs(a - b) <= unit * 1.001, (got_line, want_line)
    assert g[3] == w[3]
    _, gts, _ = ransac_strength.inputs(2, 128, args.nocs_noise,
                                       args.seg_flip)
    want = oracle.score(rec.calls[0]["out"], gts, oracle.K)
    (tag, got), = rows
    assert tag == "PROD 128/64 refit6 (control)"
    for k in ("rot_mean", "rot_median"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert abs(got["trans_mean"] - want["trans_mean"]) <= 1e-5
    assert got["acc_5deg5cm"] == want["acc_5deg5cm"]
    assert got["n_parts"] == want["n_parts"] == 6


def test_tools_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool, argv in ((ransac_strength, ["--frames", "1"]),
                       (restore_eval, ["--work", "nowhere"]),
                       (pose_knobs_trained, ["--train-steps", "1"]),
                       (packed_eval, []), (bf16_grads, []),
                       (eval_scale, ["--frames", "1"])):
        with pytest.raises(RuntimeError, match="not available"):
            tool.run(ns(tool.parser, argv))


# ---------------------------------------------------------- restore_eval
def eyeglasses_frames(n, num_points, seed=0):
    """n frames of the eyeglasses generator (3 parts, the registry's
    joint types), stacked as BatchIterator samples."""
    from articulated_pose_tpu_torch.registry import get_category
    cat = get_category("eyeglasses")
    gen = SyntheticArticulated(n_parts=cat.n_parts, points_per_part=100,
                               joint_types=list(cat.joint_types), seed=seed)
    return [gen.frame(np.random.RandomState(i), num_points=num_points)[0]
            for i in range(n)]


@pytest.fixture(scope="module")
def trained_work(tmp_path_factory):
    """A 2-step Trainer work dir at the tiny width, B=4, N=256."""
    work = tmp_path_factory.mktemp("restore")
    cfg = config.NetworkConfig(n_max_parts=3, num_points=256, batch_size=4,
                               val_interval=0, snapshot_interval=0)
    model = build_model(cfg, torch.Generator().manual_seed(5), spec=TINY)
    samples = eyeglasses_frames(4, 256)
    data = BatchIterator(4, lambda i: samples[i], batch_size=4, seed=0)
    tr = Trainer(model, cfg, work_dir=str(work), device="cpu")
    tr.fit(data, max_steps=2)
    assert tr.ckpt.latest_step() == 2
    return work, tr.state


def flat_npz(path, trees):
    """np.savez of "/"-joined Flax keys, as export_jax_checkpoint.py
    writes them."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    for name, tree in trees.items():
        walk(tree, name)
    np.savez(path, **flat)
    return flat


def test_restore_eval_on_a_trainer_work_dir(trained_work, capsys):
    work, st = trained_work
    args = ns(restore_eval.parser, ["--work", str(work), "--device", "cpu",
                                    "--batch", "4", "--points", "256"])
    out = restore_eval.run(args, spec=TINY)
    text = capsys.readouterr().out
    assert "restored" in text and "step 2" in text
    assert out["raw_equal"] == {"params": True, "batch_stats": True}
    assert out["params0"] != out["init_params0"]
    assert 0.0 <= out["seg_acc"] <= 1.0
    assert 0.0 <= out["seg_acc_train_bn"] <= 1.0
    assert out["histogram"].sum() == 4 * 256
    # JAX's first leaves by JAX's names: params, then batch_stats
    trees = restore_eval.collections(st.model)
    assert restore_eval.tree_leaves(trees["params"])[0][0] == \
        "backbone/fc1/bn/bias"
    assert restore_eval.tree_leaves(trees["batch_stats"])[0][0] == \
        "backbone/fc1/bn/mean"


@pytest.mark.parametrize("source", ["variables", "train_state"])
def test_restore_state_from_an_exported_npz(trained_work, tmp_path, source):
    """The npz files of scripts/export_jax_checkpoint.py: the variables
    (--out) or the whole train state (--train_state)."""
    _, st = trained_work
    trees = restore_eval.collections(st.model)
    if source == "train_state":
        trees["mu"] = flax_tree(zip(st.names, st.opt.mu))
        trees["nu"] = flax_tree(zip(st.names, st.opt.nu))
    path = str(tmp_path / "state.npz")
    flat = flat_npz(path, trees)
    if source == "train_state":
        flat.update(count=np.int32(st.opt.count), step=np.int32(st.step))
        np.savez(path, **flat)
    cfg = st.config
    fresh = TrainState(build_model(cfg, torch.Generator().manual_seed(9),
                                   spec=TINY), cfg)
    got, src = restore_eval.restore_state(fresh, path)
    assert ("train state" in src) == (source == "train_state")
    want = st.model.state_dict()
    for k, v in got.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    if source == "train_state":
        assert int(got.step) == 2 and int(got.opt.count) == int(st.opt.count)
        for a, b in zip(got.opt.nu, st.opt.nu):
            assert torch.equal(a, b)
    raw = restore_eval.raw_entries(path)
    assert set(raw) == set(want)


def test_restore_state_without_a_checkpoint(tmp_path):
    cfg = config.NetworkConfig(n_max_parts=3, num_points=64, batch_size=2)
    st = TrainState(build_model(cfg, spec=TINY), cfg)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        restore_eval.restore_state(st, str(tmp_path))


def test_seg_guard(capsys):
    assert common.seg_guard([0.5, 0.7]) == pytest.approx(0.6)
    assert "prediction seg acc 0.6000" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="below --min-seg-acc"):
        common.seg_guard([0.3], min_seg_acc=0.5)


# ---------------------------------------------------- pose_knobs_trained
def jax_arm_calls():
    """(tag, knobs) of each arm(...) call in ab_pose_knobs_trained.py."""
    tree = ast.parse((ROOT / "scripts" / "ab_pose_knobs_trained.py")
                     .read_text())
    return [(c.args[0].value,
             {k.arg: ast.literal_eval(k.value) for k in c.keywords})
            for c in ast.walk(tree) if isinstance(c, ast.Call)
            and getattr(c.func, "id", None) == "arm"]


def test_pose_knobs_arms_are_jax_arms():
    want = jax_arm_calls()
    assert len(want) == 8
    assert [(t, dict(k)) for t, k in pose_knobs_trained.ARMS] == want


def knobs_args(*extra):
    return ns(pose_knobs_trained.parser,
              ["--device", "cpu", "--test-frames", "8", "--batch", "4",
               "--points", "256", "--arms", "control,refit=3", *extra])


def test_pose_knobs_trained_in_process_and_restored(tmp_path, capsys):
    """25 fused steps in process, two arms paired on one set of
    predictions, each timed; the same checkpoint restored through --work
    gives the same table; the guard refuses predictions below its
    floor."""
    got = pose_knobs_trained.run(
        knobs_args("--train-steps", "25", "--time-iters", "1"), spec=TINY)
    text = capsys.readouterr().out
    assert "trained 25 steps in-process" in text
    assert "ms/batch (B=4, 1 iters, host clock)" in text
    assert [r["tag"] for r in got["arms"]] == [
        "production control (128/64 refit6)", "refit=3"]
    for r in got["arms"]:
        assert r["ms"] > 0 and np.isfinite([r["rot"], r["trans"]]).all()
    from articulated_pose_tpu_torch.train.trainer import Checkpointer
    Checkpointer(str(tmp_path / "model")).save(25, got["state"])
    again = pose_knobs_trained.run(knobs_args("--work", str(tmp_path)),
                                   spec=TINY)
    assert again["seg_acc"] == got["seg_acc"]
    for a, b in zip(again["arms"], got["arms"]):
        assert (a["rot"], a["trans"], a["acc_5deg5cm"]) == \
            (b["rot"], b["trans"], b["acc_5deg5cm"])
        assert a["ms"] is None
    with pytest.raises(RuntimeError, match="below --min-seg-acc"):
        pose_knobs_trained.run(knobs_args("--work", str(tmp_path),
                                          "--min-seg-acc", "0.99"), spec=TINY)
    with pytest.raises(ValueError, match="--work or --train-steps"):
        pose_knobs_trained.run(knobs_args(), spec=TINY)


# ----------------------------------------------------------- packed_eval
JT = ("revolute", "revolute")
# the ransac test's control fit: its JAX compile serves this test too
CONTROL = dict(n_parts=3, niter_part=128, niter_joint=64, joint_types=JT,
               lm_iters_hypo=8, lm_iters_refit=6, ransac_chunk=None,
               lm_refit_points=512)


def jax_tiny_state(N, B, **kw):
    cfg = jconfig.NetworkConfig(n_max_parts=3, num_points=N, batch_size=B,
                                val_interval=0, snapshot_interval=0,
                                backbone_preset="tiny", **kw)
    model = jax_build_model(cfg)
    return cfg, jstate.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                          np.zeros((1, N, 3), np.float32))


def port_state_of(jstate0, cfg):
    """The port's TrainState holding a JAX state's variables."""
    from flax import traverse_util
    flat = traverse_util.flatten_dict(
        {"params": jstate0.params, "batch_stats": jstate0.batch_stats},
        sep="/")
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(
        {k: np.asarray(v) for k, v in flat.items()}))
    return TrainState(model, cfg)


def test_packed_eval_run_eval_matches_jax(monkeypatch):
    """run_eval on converted TINY weights against JAX's run_eval, the
    frames and fit draws of JAX's keys imposed (PRNGKey(9999) split per
    batch into the frames' and the fit's keys).  The fit is the ransac
    control on both sides; the tool's own fit config is held to JAX's
    field by field."""
    N, B = 128, 2
    jcfg, jst = jax_tiny_state(N, B)
    args = types.SimpleNamespace(points=N, noise=0.005, test_frames=2,
                                 batch=B, min_seg_acc=0.0)
    seen = {}
    control = jpipe.PoseFitConfig(**CONTROL)

    def record(**kw):
        seen.update(kw)
        return control
    monkeypatch.setattr(jpipe, "PoseFitConfig", record)
    want = script("ab_packed_eval").run_eval(jcfg, jst, args, JT)
    monkeypatch.undo()
    assert port_cfg(jpipe.PoseFitConfig(**seen)) == \
        packed_eval.pose_config(3, JT)

    jdg = JaxDeviceSynthetic(JaxSynthetic(n_parts=3, points_per_part=500,
                                          joint_types=JT, seed=0),
                             num_points=N, noise=0.005)
    sample = jax.jit(lambda k, n: jdg.sample_batch(k, n), static_argnums=1)
    pcfg = port_cfg(control)
    key = [jax.random.PRNGKey(9999)]

    def draw_batch(n):
        key[0], k1, k2 = jax.random.split(key[0], 3)
        batch, gt = jax.device_get(sample(k1, n))
        tensors = [{k: torch.tensor(np.asarray(v)) for k, v in d.items()}
                   for d in (batch, gt)]
        return (*tensors, jax_draws(k2, n, pcfg))

    monkeypatch.setattr(packed_eval, "pose_config", lambda K, jt: pcfg)
    cfg = config.NetworkConfig(n_max_parts=3, num_points=N, batch_size=B,
                               val_interval=0, snapshot_interval=0,
                               backbone_preset="tiny")
    got = packed_eval.run_eval(port_state_of(jst, cfg), args, JT, draw_batch)
    assert set(want) <= set(got)
    assert got["seg_acc"] == want["seg_acc"]
    for k in ("n_valid", "acc_5deg", "acc_5deg5cm"):
        assert got[k] == want[k], k
    # one fit's R within 1e-3 (test_torch_pose) is 0.057 degrees
    assert abs(got["rot_err_deg_mean"] - want["rot_err_deg_mean"]) <= 0.06
    np.testing.assert_allclose(got["trans_err_mean"], want["trans_err_mean"],
                               rtol=1e-4)
    assert abs(got["miou_mean"] - want["miou_mean"]) <= 1e-5


# ------------------------------------------------------------ bf16_grads
GRAD_B, GRAD_N = 4, 64
# the f32 control and the bf16 arms whose knobs differ: the trunk, the
# heads, the pre-pool and all activations, a stage pinned to f32
GRAD_ARMS = ("f32", "bf16", "bf16_f32heads", "bf16_f32pool", "bf16_f32act",
             "bf16_f32sa1")
# each bf16 arm's gradient against JAX's same arm, both on JAX's routing,
# the pre-batch-norm Dense biases left out (CPU, tiny widths, B=4, N=64,
# the init; measured at depth 4: cosine >= 0.983, norm within 6.8 %)
ARM_COS = 0.975
ARM_NORM = 0.10
# a pre-batch-norm Dense bias's f32 gradient against its kernel's: the
# norm subtracts the bias out, so the exact gradient is 0 (measured
# 2.1e-5); in bf16 each backend's value is its own rounding noise
# (backbone/sa1/mlp/conv0: JAX 47.7, the port 0.23, f32 2e-4)
PRE_BN_BIAS = 1e-4
POLICY_FIELDS = ("compute_dtype", "head_compute_dtype", "pool_compute_dtype",
                 "act_compute_dtype", "f32_stages")


def no_dropout(next_fun, args, kwargs, context):
    """Flax interceptor: every nn.Dropout is the identity."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def grad_config(arm):
    """The port's config of `arm` (ARMS) at the tests' tiny width,
    dropout off."""
    return config.NetworkConfig(
        n_max_parts=3, num_points=GRAD_N, batch_size=GRAD_B, val_interval=0,
        snapshot_interval=0, backbone_preset="tiny", dropout_rate=0.0,
        **bf16_grads.ARMS[arm])


def jax_script_defs():
    """From diag_bf16_grads.py's main(): the source of cfg_for,
    cast_like_bf16 and jitter, and the `arms` and `param_arms` dict
    expressions."""
    src = (ROOT / "scripts" / "diag_bf16_grads.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")

    def text(node):
        return textwrap.dedent(" " * node.col_offset
                               + ast.get_source_segment(src, node))
    defs = {n.name: text(n) for n in ast.walk(main)
            if isinstance(n, ast.FunctionDef)
            and n.name in ("cfg_for", "cast_like_bf16", "jitter")}
    dicts = {n.targets[0].id: n.value for n in ast.walk(main)
             if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
             and isinstance(n.targets[0], ast.Name)}
    return defs, dicts["arms"], dicts["param_arms"]


@functools.lru_cache(maxsize=None)
def jax_arm_configs():
    """{arm: JAX's NetworkConfig} as the script's main() builds its
    `arms` (cfg_for at K=3, --points GRAD_N, --batch GRAD_B)."""
    defs, arms, _ = jax_script_defs()
    scope = {"NetworkConfig": jconfig.NetworkConfig, "K": 3,
             "args": types.SimpleNamespace(points=GRAD_N, batch=GRAD_B)}
    exec(defs["cfg_for"], scope)
    return eval(compile(ast.Expression(arms), "arms", "eval"), scope)


def jax_grad_config(arm):
    """The script's config of `arm` at the tests' tiny width, dropout
    off."""
    return dataclasses.replace(jax_arm_configs()[arm],
                               backbone_preset="tiny", dropout_rate=0.0)


def test_bf16_grads_arms_are_jax_arms():
    """ARMS holds the JAX script's policy arms, in its order, and each
    arm's config equals the one the script builds, field by field;
    PARAM_ARMS names its parameter controls."""
    want = jax_arm_configs()
    assert list(bf16_grads.ARMS) == list(want)
    args = ns(bf16_grads.parser, ["--points", str(GRAD_N), "--batch",
                                  str(GRAD_B), "--parts", "3"])
    for name, jcfg in want.items():
        got = bf16_grads.config(args, **bf16_grads.ARMS[name])
        for f in dataclasses.fields(got):
            if f.name in config.PORT_FIELDS:    # the port's own keys
                continue
            assert getattr(got, f.name) == getattr(jcfg, f.name), (name,
                                                                   f.name)
    assert set(POLICY_FIELDS) <= {f.name for f in dataclasses.fields(got)}
    _, _, param_arms = jax_script_defs()
    assert tuple(k.value for k in param_arms.keys) == bf16_grads.PARAM_ARMS


def test_bf16_grads_param_controls_as_jax():
    """"f32@bf16params" rounds each parameter to bf16 bit for bit as the
    script's cast_like_bf16 does; "f32@jitterparams" moves each by a
    uniform relative jitter of 2^-9 as the script's jitter does (the two
    draw from their own generators, so their spread is compared)."""
    defs, _, _ = jax_script_defs()
    scope = {"jax": jax, "jnp": jnp}
    exec(defs["cast_like_bf16"] + "\n" + defs["jitter"], scope)
    model = build_model(grad_config("f32"),
                        torch.Generator().manual_seed(0))
    params = [p.detach().numpy() for p in model.parameters()]
    got = bf16_grads.perturbed(model, "f32@bf16params", torch.device("cpu"))
    want = scope["cast_like_bf16"](params)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = bf16_grads.perturbed(model, "f32@jitterparams",
                               torch.device("cpu"))
    want = scope["jitter"](params, jax.random.PRNGKey(3))
    for moved in ([g.numpy() for g in got], [np.asarray(w) for w in want]):
        rel = np.concatenate([(m[p != 0] / p[p != 0] - 1.0).ravel()
                              for m, p in zip(moved, params)])
        assert np.abs(rel).max() <= 2.0 ** -9 * (1 + 1e-3)
        assert np.abs(rel).max() >= 0.99 * 2.0 ** -9
        assert abs(np.abs(rel).mean() / 2.0 ** -10 - 1) <= 0.02


def pointconv_dtypes_jax(arm, P):
    """{port PointConv name: (its Dense's dtype, its output dtype)} of
    JAX's train forward for `arm`, from the traced shapes alone."""
    from flax import traverse_util
    model = jax_build_model(jax_grad_config(arm))
    _, st = jax_tiny_state(GRAD_N, GRAD_B, dropout_rate=0.0)

    def forward(P):
        with fnn.intercept_methods(no_dropout):
            return model.apply(
                {"params": st.params, "batch_stats": st.batch_stats}, P,
                train=True, bn_momentum=0.5,
                capture_intermediates=lambda mdl, method: isinstance(
                    mdl, (JaxPointConv, fnn.Dense)),
                mutable=["intermediates", "batch_stats"])
    flat = traverse_util.flatten_dict(
        jax.eval_shape(forward, P)[1]["intermediates"], sep="/")
    out = {k[:-len("/__call__")].replace("/", "."): str(v[0].dtype)
           for k, v in flat.items()}
    return {n: (out[f"{n}.dense"], out[n]) for n in out
            if f"{n}.dense" in out}


@pytest.mark.parametrize("arm", list(bf16_grads.ARMS))
def test_bf16_grads_arm_dtypes_are_jax_dtypes(arm):
    """Each arm's model computes each PointConv's Dense and emits its
    output in the dtypes JAX's model of the same arm does."""
    P = np.random.RandomState(0).rand(GRAD_B, GRAD_N, 3).astype(np.float32)
    want = pointconv_dtypes_jax(arm, P)
    model = build_model(grad_config(arm),
                        torch.Generator().manual_seed(0))
    got, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, PointConv):
            hooks.append(mod.register_forward_hook(
                lambda m, i, out, name=name: got.__setitem__(
                    name, (str(m.dtype).replace("torch.", ""),
                           str(out.dtype).replace("torch.", "")))))
    model.train()
    model.joint_net.dropout_rate = 0.0
    model(torch.tensor(P), bn_momentum=0.5)
    for h in hooks:
        h.remove()
    assert got == want


@pytest.fixture(scope="module")
def grad_side():
    """JAX's gradients of GRAD_ARMS at one f32 state (dropout off), the
    routing of each arm's JAX forward, and the port's state and batch."""
    gen = JaxSynthetic(n_parts=3, points_per_part=100, seed=0)
    rng = np.random.RandomState(0)
    fs = [gen.frame(rng, num_points=GRAD_N, use_native=False)[0]
          for _ in range(GRAD_B)]
    batch = {k: np.stack([f[k] for f in fs]) for k in fs[0]}
    _, st = jax_tiny_state(GRAD_N, GRAD_B, dropout_rate=0.0)
    grads, routes = {}, {}
    for arm in GRAD_ARMS:
        cfg = jax_grad_config(arm)
        model = jax_build_model(cfg)
        fn = jax.jit(jax.grad(lambda p: jstate._forward_loss(
            p, st.batch_stats, model.apply, batch, cfg, train=True,
            rng=jax.random.PRNGKey(11), step=st.step)[0]))
        with fnn.intercept_methods(no_dropout):
            grads[arm] = jax.device_get(fn(st.params))
            routes[arm] = jax_routing(model, st, batch["P"])
    base = port_state_of(st, grad_config("f32"))
    return dict(grads=grads, routes=routes, base=base,
                batch={k: torch.tensor(v) for k, v in batch.items()})


def jax_routing(model, st, P):
    """The choices of a JAX train forward as `train.routing` records
    them, by the port's names: each PointConv's ReLU mask, and for each
    set abstraction the inputs of its max equal to the max (its MLP's
    last PointConv output)."""
    from flax import traverse_util
    _, out = model.apply(
        {"params": st.params, "batch_stats": st.batch_stats}, P, train=True,
        bn_momentum=0.5, capture_intermediates=lambda mdl, method: isinstance(
            mdl, JaxPointConv), mutable=["intermediates", "batch_stats"])
    flat = traverse_util.flatten_dict(out["intermediates"], sep="/")
    record, pooled = {}, {}
    for k, v in flat.items():
        name = k[:-len("/__call__")].replace("/", ".")
        a = np.asarray(v[0].astype(jnp.float32))
        record[name] = a > 0
        if name.startswith("backbone.sa") and ".mlp.conv" in name:
            pooled[name.split(".mlp.")[0]] = a     # the MLP's last wins
    for sa, a in pooled.items():
        record[sa] = a == a.max(2, keepdims=True)
    return record


def relu_masks(side, arm):
    """The ReLU masks of `arm`'s JAX forward alone."""
    return {k: v for k, v in side["routes"][arm].items() if ".mlp.conv" in k
            or not k.startswith("backbone.sa")}


def port_tree(side, arm, routing=None):
    def prepare(model):
        model.joint_net.dropout_rate = 0.0
        return impose_routing(model, routing) if routing is not None else []
    return bf16_grads.arm_tree(side["base"], grad_config(arm),
                               side["batch"], prepare=prepare)[1]


def port_grads(side, arm, depth, masks=None):
    return bf16_grads.flat_per_module(port_tree(side, arm, masks), depth)


@pytest.mark.parametrize("depth", [2, 4])
def test_bf16_grads_f32_arm_matches_jax(grad_side, depth):
    """Module keys equal JAX's flat_per_module; with JAX's ReLU masks
    imposed the f32 gradients within 1e-4 of each module's largest."""
    want = script("diag_bf16_grads").flat_per_module(
        grad_side["grads"]["f32"], depth)
    got = port_grads(grad_side, "f32", depth, relu_masks(grad_side, "f32"))
    assert set(got) == set(want)
    if depth == 4:
        assert "backbone/sa1/mlp/conv0" in got
    for mod, w in want.items():
        assert got[mod].shape == w.shape, mod
        err = np.abs(got[mod] - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-7, (mod, err)


def pre_bn_biases(tree):
    """Split a params tree: (the tree without the Dense biases that a
    batch norm follows, {path: such a bias with its kernel})."""
    kept, biases = {}, {}

    def walk(node, out, path):
        for k, v in node.items():
            if not isinstance(v, dict):
                out[k] = v
                continue
            sub = out[k] = {}
            if k == "dense" and "bn" in node:
                sub["kernel"] = v["kernel"]
                biases[f"{path}{k}"] = (np.asarray(v["bias"]),
                                        np.asarray(v["kernel"]))
            else:
                walk(v, sub, f"{path}{k}/")
    walk(tree, kept, "")
    return kept, biases


@pytest.mark.parametrize("arm", GRAD_ARMS[1:])
def test_bf16_grads_cosines_beside_jax(grad_side, arm):
    """A bf16 arm's gradient against JAX's same arm, both on the routing
    of JAX's forward of that arm (ReLU masks and max selections): every
    module at depth 4, the pre-batch-norm Dense biases left out, within
    ARM_COS in cosine and ARM_NORM in norm, and the whole likewise.
    Those biases' exact gradient is 0 (their f32 gradients are within
    PRE_BN_BIAS of their kernels'), so in bf16 each backend's value is
    its own rounding noise; the tool's table, as JAX's, counts them in
    their module, where they dominate backbone/sa1/mlp/conv0 in JAX on
    the CPU and not in the port, so those cosines are not compared."""
    jflat = script("diag_bf16_grads").flat_per_module
    want, want_b = pre_bn_biases(grad_side["grads"][arm])
    got, got_b = pre_bn_biases(port_tree(grad_side, arm,
                                         grad_side["routes"][arm]))
    assert got_b.keys() == want_b.keys() and "backbone/sa1/mlp/conv0/dense" \
        in want_b
    _, f32_b = pre_bn_biases(grad_side["grads"]["f32"])
    for path, (bias, kernel) in f32_b.items():
        assert np.abs(bias).max() <= PRE_BN_BIAS * np.abs(kernel).max(), path
    want, got = jflat(want, 4), jflat(got, 4)
    assert set(got) == set(want)
    mods = sorted(want)
    for g, w, mod in [(got[m], want[m], m) for m in mods] + [(
            np.concatenate([got[m] for m in mods]),
            np.concatenate([want[m] for m in mods]), "overall")]:
        if not np.abs(w).max() > 0:
            assert not np.abs(g).max() > 0, (arm, mod)
            continue
        cos = bf16_grads.cosine(g, w)
        norm = np.linalg.norm(g) / np.linalg.norm(w)
        assert cos >= ARM_COS and abs(norm - 1) <= ARM_NORM, (arm, mod, cos,
                                                              norm)


@pytest.mark.parametrize("loss_key", [None, "miou_loss"])
def test_bf16_grads_run_writes_the_report(tmp_path, loss_key, capsys):
    """The tool end to end at the tiny width: two policy arms and both
    parameter controls, JAX's table layout, the --out JSON."""
    path = tmp_path / "grads.json"
    argv = ["--device", "cpu", "--batch", "2", "--points", "128",
            "--depth", "4", "--out", str(path)]
    if loss_key:
        argv += ["--loss-key", loss_key]
    arms = {k: bf16_grads.ARMS[k] for k in ("f32", "bf16_f32sa1")}
    out = bf16_grads.run(ns(bf16_grads.parser, argv), spec=TINY, arms=arms)
    text = capsys.readouterr().out
    assert json.loads(path.read_text())["modules"].keys() == \
        out["modules"].keys()
    assert "backbone/sa1/mlp/conv0" in out["modules"]
    for arm in ("bf16_f32sa1", "f32@bf16params", "f32@jitterparams"):
        assert -1.0 <= out[f"overall_cosine_{arm}"] <= 1.0 + 1e-9
        assert f"overall cosine {arm}: " in text
    assert set(out["modules"]["backbone/sa1/mlp/conv0"]) == {
        "bf16_f32sa1", "f32@bf16params", "f32@jitterparams"}
    assert out["params"] == "init"


# ------------------------------------------------------------ eval_scale
def test_eval_scale_profiles_the_eval_command(tmp_path, capsys):
    pytest.importorskip("h5py")
    args = ns(eval_scale.parser,
              ["--device", "cpu", "--frames", "8", "--num_points", "128",
               "--batch_size", "4", "--backbone", "tiny",
               "--root", str(tmp_path)])
    out = eval_scale.run(args)
    text = capsys.readouterr().out
    assert "fixture: 8 frames" in text and "frames/sec" in text
    assert out["frames_per_s"] > 0
    report = json.loads((tmp_path / "work" / "eval_all.json").read_text())
    assert report["n_frames"] == 8
    names = {f[2] for f in out["stats"].stats}
    assert "cmd_pose_eval" in names


def test_eval_scale_names_h5py_without_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    args = ns(eval_scale.parser, ["--device", "cpu", "--frames", "2",
                                  "--root", str(tmp_path)])
    with pytest.raises(ImportError, match="h5py"):
        eval_scale.run(args)


# ------------------------------------------- the JAX package's last functions
AUGMENTS = {
    "rotate_point_cloud_y": {}, "rotate_point_cloud_y_at": {"angle": 0.7},
    "rotate_perturbation": {}, "shift_point_cloud": {},
    "random_scale_point_cloud": {}, "random_point_dropout": {},
    "jitter_point_cloud": {},
}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_augment_bit_equal_to_jax(name):
    fn = name.replace("_at", "")
    pts = np.random.RandomState(3).randn(200, 3)
    r1, r2 = np.random.RandomState(11), np.random.RandomState(11)
    got = getattr(augment, fn)(pts, r1, **AUGMENTS[name])
    want = getattr(jaugment, fn)(pts, r2, **AUGMENTS[name])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)     # same draws used


def similarity_pairs(rng, B, n):
    src = rng.rand(B, n, 3).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    R = q * np.sign(np.linalg.det(q))
    tgt = (1.3 * src @ R.T + np.array([0.1, -0.2, 0.3])
           + 0.01 * rng.randn(B, n, 3)).astype(np.float32)
    w = (rng.rand(B, n) > 0.2).astype(np.float32)
    return src, tgt, w


@pytest.mark.parametrize("n", [5, 64])
def test_svd_method_matches_jax(n):
    """kabsch_rotation and transform_pts with method="svd": within 1e-5
    of JAX's; "horn" stays the default; other names raise."""
    src, tgt, w = similarity_pairs(np.random.RandomState(n), 4, n)
    want_R = jax.vmap(lambda s, t, ww: jum.kabsch_rotation(
        s, t, ww, method="svd"))(src, tgt, w)
    want = jax.vmap(lambda s, t, ww: jum.transform_pts(
        s, t, ww, method="svd"))(src, tgt, w)
    S, T, W = (torch.tensor(a) for a in (src, tgt, w))
    got_R = umeyama.kabsch_rotation(S, T, W, method="svd")
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), atol=1e-5)
    for g, v in zip(umeyama.transform_pts(S, T, W, method="svd"), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), atol=1e-5)
    assert torch.allclose(got_R.det(), torch.ones(4), atol=1e-5)
    horn = umeyama.kabsch_rotation(S, T, W)
    assert torch.equal(horn, umeyama.kabsch_rotation(S, T, W, method="horn"))
    np.testing.assert_allclose(horn.numpy(), got_R.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="method"):
        umeyama.kabsch_rotation(S, T, W, method="eigh")


@pytest.mark.parametrize("use_xyz", [True, False])
@pytest.mark.parametrize("with_points", [True, False])
def test_sample_and_group_all_equals_jax(use_xyz, with_points):
    rng = np.random.RandomState(4)
    xyz = rng.rand(2, 50, 3).astype(np.float32)
    pts = rng.randn(2, 50, 5).astype(np.float32) if with_points else None
    want = jpointnet2.sample_and_group_all(
        jnp.asarray(xyz), None if pts is None else jnp.asarray(pts), use_xyz)
    got = sample_and_group_all(torch.tensor(xyz),
                               None if pts is None else torch.tensor(pts),
                               use_xyz)
    for g, v in zip(got, want[:2]):
        assert tuple(g.shape) == v.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))


def test_sample_and_group_all_in_a_stage_dtype():
    """With `dtype`, each part is cast before the concat (the backbone's
    bf16 global stage over f32 xyz and bf16 features): equal to JAX's
    promoted concat cast to that dtype."""
    rng = np.random.RandomState(6)
    xyz = rng.rand(2, 50, 3).astype(np.float32)
    pts = rng.randn(2, 50, 5).astype(np.float32)
    want = jpointnet2.sample_and_group_all(jnp.asarray(xyz),
                                           jnp.asarray(pts))
    got = sample_and_group_all(torch.tensor(xyz),
                               torch.tensor(pts).to(torch.bfloat16),
                               dtype=torch.bfloat16)
    assert got[0].dtype == torch.float32
    assert got[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(
        got[1].float().numpy(),
        np.asarray(want[1].astype(jnp.bfloat16).astype(jnp.float32)))


def test_sample_and_group_without_xyz_equals_jax():
    rng = np.random.RandomState(5)
    xyz = rng.rand(2, 128, 3).astype(np.float32)
    pts = rng.randn(2, 128, 6).astype(np.float32)
    want = jpointnet2.sample_and_group(32, 0.3, 8, jnp.asarray(xyz),
                                       jnp.asarray(pts), use_xyz=False)
    got = sample_and_group(32, 0.3, 8, torch.tensor(xyz), torch.tensor(pts),
                           torch.float32, use_xyz=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert tuple(got[1].shape) == (2, 32, 8, 6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    with_xyz = sample_and_group(32, 0.3, 8, torch.tensor(xyz),
                                torch.tensor(pts), torch.float32)[1]
    assert torch.equal(with_xyz[..., 3:], got[1])


def test_render_available_as_jax():
    assert native.render_available() == jnative.render_available()
