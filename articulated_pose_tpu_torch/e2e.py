"""End-to-end learning proof on the card: train ANCSH on synthetic frames
generated on the device, fit poses on held-out frames, evaluate.

    python -m articulated_pose_tpu_torch.e2e [--steps 6000] [--category laptop]

The counterpart of `scripts/train_synthetic_e2e.py`, with its flags and
defaults and `--device` (the card by default; without one it raises):

1. frames come from `data.device_synthetic.DeviceSynthetic` inside the
   fused train step (B=32, N=1024, f32, Adam at 1e-3, no decay);
2. snapshots every 4000 steps through `train.trainer.Checkpointer`, and
   `--resume` continues from the newest; the host reads the device only
   on the 500-step log lines;
3. held-out frames from a generator seeded 9999, the eval forward, then
   `pose.pipeline.fit_frame_batch` at niter 1024/128, 15 LM refit
   iterations, no RANSAC chunking;
4. the NumPy report of `eval.pipeline` (per-part rotation / translation
   errors, 5°5cm, 3D mIoU, relative inter-part errors, joint axis and
   line errors) and the segmentation accuracy, to `<work>/report.json`.

`run(args, spec=None)` takes a backbone `spec` in place of the
reference widths (the CPU tests' tiny backbone).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data.device_synthetic import (
    DeviceSynthetic, make_fused_synthetic_train_step)
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.eval.pipeline import (compute_gt_poses,
                                                      evaluate_fits,
                                                      gt_joint_lines,
                                                      joint_errors,
                                                      pred_joint_lines)
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                      PoseFitConfig,
                                                      fit_frame_batch)
from articulated_pose_tpu_torch.registry import get_category
from articulated_pose_tpu_torch.train.state import TrainState, eval_step
from articulated_pose_tpu_torch.train.trainer import Checkpointer

SNAPSHOT_EVERY = 4000
LOG_EVERY = 500
DATA_KEY = 1            # the batches' stream (JAX's PRNGKey(1))
EVAL_SEED = 9999        # the held-out frames' generator
PRED_KEYS = ("W", "nocs_per_point", "joint_axis_per_point", "index_per_point")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.e2e",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--steps-per-call", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--test-frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--parts", type=int, default=None,
                    help="part count (default: the category's, else 3)")
    ap.add_argument("--joint-types", default=None,
                    help="comma list, e.g. prismatic,prismatic,prismatic")
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=0,
                    help="procedural-generator seed (distinct seeds = "
                         "distinct category instances)")
    ap.add_argument("--category", default=None,
                    help="registry category name recorded in the report "
                         "(and source of parts/joint_types if --parts is "
                         "not given)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-rotation", action="store_true",
                    help="uniform SO(3) cameras (default: the reference "
                         "renderer's yaw/pitch band)")
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                   "ancsh_synth_e2e"))
    ap.add_argument("--lm-refit-points", type=int, default=None,
                    help="cap on the points fed to the joint LM refit")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="backbone compute dtype")
    ap.add_argument("--head-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="output-head dtype override")
    ap.add_argument("--f32-stages", default=None,
                    help="comma-separated backbone stages pinned to f32 "
                         "under a bf16 trunk (e.g. 'sa1')")
    ap.add_argument("--packed-ballq", action="store_true",
                    help="packed ball query (quantised grouped coords)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' for tests)")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return parser().parse_args(argv)


def category_setup(args) -> tuple:
    """(n_parts, joint_types) from --parts / --joint-types / --category,
    as scripts/train_synthetic_e2e.py:79-90 resolves them."""
    K = args.parts
    joint_types = args.joint_types
    if args.category and K is None:
        spec = get_category(args.category)
        K = spec.n_parts
        joint_types = joint_types or ",".join(spec.joint_types)
    K = 3 if K is None else K
    if joint_types:
        joint_types = tuple(joint_types.split(","))
        if len(joint_types) != K - 1:
            raise ValueError(f"need n_parts - 1 = {K - 1} joint types, got "
                             f"{joint_types}")
    else:
        joint_types = ("revolute",) * (K - 1)
    return K, joint_types


def train_config(args, K: int) -> NetworkConfig:
    """The reference recipe (scripts/train_synthetic_e2e.py:96-106)."""
    return NetworkConfig(
        n_max_parts=K, num_points=args.points, batch_size=args.batch,
        init_learning_rate=args.lr, decay_step=10**8, bn_decay_step=10**8,
        val_interval=0, snapshot_interval=0, compute_dtype=args.dtype,
        head_compute_dtype=args.head_dtype,
        f32_stages=(tuple(s.strip() for s in args.f32_stages.split(","))
                    if args.f32_stages else ()),
        ball_query_packed=args.packed_ballq)


def synthetic(args, K: int, joint_types, device) -> DeviceSynthetic:
    """The category's procedural generator (500 points a part) on
    `device`."""
    gen = SyntheticArticulated(n_parts=K, points_per_part=500,
                               joint_types=joint_types, seed=args.seed,
                               full_rotation=args.full_rotation)
    return DeviceSynthetic(gen, num_points=args.points, noise=args.noise,
                           device=device)


def pose_config(args, K: int, joint_types) -> PoseFitConfig:
    """The eval fit (scripts/train_synthetic_e2e.py:155-158)."""
    return PoseFitConfig(n_parts=K, niter_part=1024, niter_joint=128,
                         joint_types=joint_types, lm_iters_hypo=8,
                         lm_iters_refit=15, ransac_chunk=None,
                         lm_refit_points=args.lm_refit_points)


def report_json(args, K: int, joint_types, ev: Dict, train_s: float,
                trained: int, device) -> Dict:
    """report.json's fields: the JAX script's keys (:212-220), then the
    card, the steps this run trained and the eval's seconds."""
    report = ev["report"]
    return {"per_part": report.per_part, "overall": report.overall,
            "per_joint": report.per_joint, "seg_acc": ev["seg_acc"],
            "category": args.category, "seed": args.seed, "n_parts": K,
            "joint_types": list(joint_types), "compute_dtype": args.dtype,
            "train_steps": args.steps, "train_seconds": train_s,
            "train_clouds_per_sec": (trained * args.batch / train_s
                                     if trained else None),
            "device": card_name(device), "steps_this_run": trained,
            "eval_fit_seconds": ev["fit_seconds"],
            "evaluate_fits_seconds": ev["evaluate_fits_seconds"]}


def to_numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def eval_draws(dg: DeviceSynthetic, pose_cfg: PoseFitConfig, device
               ) -> Callable[[int], Tuple]:
    """`draw_batch(n) -> (sample, gt, PoseDraws)` of the held-out frames:
    each batch's frames, then its fit draws, from one device generator
    seeded EVAL_SEED."""
    gen = torch.Generator(device=device).manual_seed(EVAL_SEED)

    def draw_batch(n):
        sample, gt = dg.sample_batch(gen, n)
        return sample, gt, PoseDraws.sample(n, pose_cfg, generator=gen,
                                            device=device)
    return draw_batch


def evaluate(state: TrainState, dg: DeviceSynthetic, pose_cfg: PoseFitConfig,
             test_frames: int, batch: int, device,
             draw_batch: Optional[Callable[[int], Tuple]] = None) -> Dict:
    """Held-out frames from a device generator seeded EVAL_SEED, the eval
    forward, the pose fit on the card and the NumPy report
    (scripts/train_synthetic_e2e.py:151-224).  Returns the report's
    fields, the segmentation accuracy, the joint errors and the seconds
    of each stage.  `draw_batch(n) -> (sample, gt, PoseDraws)` gives each
    batch's frames and fit draws in place of the generator's (the tests
    hand in JAX's)."""
    K = pose_cfg.n_parts
    fits, gts = [], []
    nocs_pred_l, nocs_gt_l, cls_l, seg_acc = [], [], [], []
    gts_global, P_l, cls_pred_l = [], [], []
    joint_errs: List[Dict] = []
    draw_batch = draw_batch or eval_draws(dg, pose_cfg, device)
    t0 = time.perf_counter()
    for lo in range(0, test_frames, batch):
        n = min(batch, test_frames - lo)
        sample, gt, draws = draw_batch(n)
        pred, _ = eval_step(state, sample)
        out = fit_frame_batch({k: pred[k] for k in PRED_KEYS}, sample["P"],
                              draws, pose_cfg)
        sample, gt, pred, out = map(to_numpy, (sample, gt, pred, out))
        seg_acc.append((np.argmax(pred["W"], -1) ==
                        sample["cls_gt"].astype(int)).mean())
        for i in range(n):
            fits.append({"R": out["nonlinear_R"][i],
                         "s": out["nonlinear_s"][i],
                         "t": out["nonlinear_t"][i]})
            gts.append({"R": list(gt["R"][i]), "s": list(gt["s"][i]),
                        "t": list(gt["t"][i])})
            nocs_pred_l.append(pred["nocs_per_point"][i])
            nocs_gt_l.append(sample["nocs_gt"][i])
            cls_l.append(sample["cls_gt"][i].astype(int))
            # GT global-NOCS poses for the relative inter-part metrics
            # (reference eval_pose_err.py:307-335)
            gg = compute_gt_poses(sample["nocs_gt_g"][i], sample["P"][i],
                                  sample["cls_gt"][i].astype(int), K)
            gts_global.append({kk: [None if e is None else e[kk] for e in gg]
                               for kk in ("R", "s", "t")})
            P_l.append(sample["P"][i])
            cls_pred_l.append(np.argmax(pred["W"][i], -1))
            # joint-parameter metrics (eval_joint_params.py protocol)
            if "gocs_per_point" in pred:
                base_fit = {"R": out["nonlinear_R"][i][0],
                            "s": out["nonlinear_s"][i][0],
                            "t": out["nonlinear_t"][i][0]}
                fp = {kk: vv[i] for kk, vv in pred.items()}
                fb = {kk: vv[i] for kk, vv in sample.items()}
                pl = pred_joint_lines(fp, base_fit, K)
                gl = gt_joint_lines(fb, sample["P"][i], K)
                for a, b in zip(pl, gl):
                    if a is not None and b is not None:
                        joint_errs.append(joint_errors(a, b["axis"],
                                                       b["point"]))
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = evaluate_fits(fits, gts, K, nocs_pred=nocs_pred_l,
                           nocs_gt=nocs_gt_l, cls_list=cls_l, miou_nres=30,
                           gts_global=gts_global, P_list=P_l,
                           cls_pred_list=cls_pred_l)
    report_s = time.perf_counter() - t0
    if joint_errs:
        report.overall["joint_axis_err_deg"] = float(
            np.mean([e["axis_err_deg"] for e in joint_errs]))
        report.overall["joint_line_dist"] = float(
            np.mean([e["line_dist"] for e in joint_errs]))
    return {"report": report, "seg_acc": float(np.mean(seg_acc)),
            "n_joint_errs": len(joint_errs), "fit_seconds": fit_s,
            "evaluate_fits_seconds": report_s}


def card_name(device) -> str:
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run(args, spec: Optional[BackboneSpec] = None) -> Dict:
    """Train, fit and evaluate as the flags say; writes
    `<work>/report.json` and returns what it holds."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"e2e: device {device} is not available; pass "
                           "--device cpu to run on the CPU")
    K, joint_types = category_setup(args)
    cfg = train_config(args, K)
    dg = synthetic(args, K, joint_types, device)
    model = build_model(cfg, torch.Generator().manual_seed(0), device=device,
                        spec=spec)
    state = TrainState(model, cfg)
    ck = Checkpointer(os.path.join(args.work, "model"))
    if args.resume and ck.latest_step() is not None:
        state = ck.restore(state)
        print(f"resumed from step {int(state.step)}", flush=True)
    window = max(1, args.steps_per_call)
    fused_step = make_fused_synthetic_train_step(cfg, dg, args.batch,
                                                 steps_per_call=window,
                                                 seed=DATA_KEY)

    print(f"training on {card_name(device)} (data generated on the device, "
          f"{window} steps a call)...", flush=True)
    t0 = time.perf_counter()
    step0 = step = int(state.step)
    # mid-train snapshots: --resume picks up from the newest
    last_snap = step
    while step < args.steps:
        metrics = fused_step(state, step)
        step += window
        if step % LOG_EVERY < window:
            m = {k: round(float(v), 4) for k, v in metrics.items()
                 if k != "grads_finite"}
            print(f"step {step}: {json.dumps(m)}", flush=True)
        if step - last_snap >= SNAPSHOT_EVERY and step < args.steps:
            ck.save(step, state)
            last_snap = step
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    trained = step - step0
    print(f"trained {trained} steps in {train_s:.1f}s "
          f"({trained * args.batch / train_s:.0f} clouds/s)", flush=True)
    ck.save(step, state)
    print("checkpointed to", args.work, flush=True)

    # ---- held-out eval: device-generated frames with exact GT ----------
    ev = evaluate(state, dg, pose_config(args, K, joint_types),
                  args.test_frames, args.batch, device)
    report = ev["report"]
    print(f"seg accuracy: {ev['seg_acc']:.4f}", flush=True)
    print(report.summary(), flush=True)
    if ev["n_joint_errs"]:
        print(f"joints: axis err {report.overall['joint_axis_err_deg']:.2f}° "
              f"line dist {report.overall['joint_line_dist']:.4f} "
              f"({ev['n_joint_errs']} joints)", flush=True)
    for j, stats in enumerate(report.per_joint):
        parts = [f"{kk}={vv:.4f}" for kk, vv in stats.items()
                 if kk.endswith("mean")]
        print(f"joint {j + 1} ({joint_types[j]}): " + " ".join(parts),
              flush=True)
    print(f"eval: forward + fit {ev['fit_seconds']:.2f} s, evaluate_fits "
          f"{ev['evaluate_fits_seconds']:.2f} s ({args.test_frames} frames, "
          f"host clock)", flush=True)
    out = report_json(args, K, joint_types, ev, train_s, trained, device)
    os.makedirs(args.work, exist_ok=True)
    path = os.path.join(args.work, "report.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
