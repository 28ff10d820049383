"""Trained-model A/B of the pose fit's knobs
(`scripts/ab_pose_knobs_trained.py`).

    python -m articulated_pose_tpu_torch.ab.pose_knobs_trained \\
        --train-steps 8000 --category eyeglasses [--time-iters 10]
    python -m articulated_pose_tpu_torch.ab.pose_knobs_trained \\
        --work RUN --category eyeglasses --seed 1

The noisy-oracle sweep (`ab.ransac_strength --r4`) finds knobs that are
accuracy-flat on calibrated noise; this tool holds the same knobs on a
trained model's predictions.  The model is trained in this process
(`--train-steps`, the e2e recipe: the fused synthetic step, 25 steps a
call, batches generated on the device) or restored from `--work` (a
work dir or an exported JAX npz, `restore_eval.restore_state`).  Held-out
frames come from a device generator seeded 9999; the network predicts
them once, `common.seg_guard` checks the predictions, and every
arm fits those same predictions with the same draws (a generator seeded
7), so the arms are paired.  `--time-iters` also times each arm's
`fit_frame_batch` on the first batch: a warm-up call, then that many
calls between two CUDA events (the card's ms a batch; the host clock on
the CPU).  `--arms` keeps the arms whose tag holds one of its
comma-separated substrings.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from articulated_pose_tpu_torch.ab.common import seg_acc, seg_guard
from articulated_pose_tpu_torch.ab.restore_eval import restore_state
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data.device_synthetic import (
    DeviceSynthetic, make_fused_synthetic_train_step)
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.e2e import DATA_KEY, EVAL_SEED, PRED_KEYS
from articulated_pose_tpu_torch.eval.pipeline import evaluate_fits
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                      PoseFitConfig,
                                                      fit_frame_batch)
from articulated_pose_tpu_torch.programs import resolve_device
from articulated_pose_tpu_torch.registry import get_category
from articulated_pose_tpu_torch.train.state import TrainState, eval_step

STEPS_PER_CALL = 25
FIT_SEED = 7            # every arm's fit draws
TIME_SEED = 11          # the timed calls' draws
# (tag, knobs) in the JAX script's order (ab_pose_knobs_trained.py:345-360)
ARMS = (
    ("production control (128/64 refit6)",
     dict(niter_part=128, niter_joint=64)),
    ("refit=3", dict(niter_part=128, niter_joint=64, lm_iters_refit=3)),
    ("niter_part=64", dict(niter_part=64, niter_joint=64)),
    ("score_points=512", dict(niter_part=128, niter_joint=64,
                              ransac_score_points=512)),
    ("axis_agg=mean", dict(niter_part=128, niter_joint=64, axis_agg="mean")),
    ("ALL cheap (64/64 refit3 score512)",
     dict(niter_part=64, niter_joint=64, lm_iters_refit=3,
          ransac_score_points=512)),
    ("ALL cheap + axis mean",
     dict(niter_part=64, niter_joint=64, lm_iters_refit=3,
          ransac_score_points=512, axis_agg="mean")),
    ("STRONG (1024/128 refit15)",
     dict(niter_part=1024, niter_joint=128, lm_iters_hypo=8,
          lm_iters_refit=15)),
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.pose_knobs_trained",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None,
                    help="work dir or exported npz to restore (see "
                         "--train-steps)")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="if >0, train in this process for this many steps "
                         "(the sweep's recipe) instead of restoring --work")
    ap.add_argument("--category", default="eyeglasses")
    ap.add_argument("--seed", type=int, default=1,
                    help="must match the generator seed of the training run")
    ap.add_argument("--test-frames", type=int, default=192)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--time-iters", type=int, default=0,
                    help="if >0, also time each arm's fit_frame_batch over "
                         "this many calls (ms a batch beside the table)")
    ap.add_argument("--arms", default=None,
                    help="comma list of substrings: run only the arms whose "
                         "tag holds one")
    ap.add_argument("--min-seg-acc", type=float, default=0.0,
                    help="raise when the predictions' seg acc is below this")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' for tests)")
    return ap


def train_config(args, K: int) -> NetworkConfig:
    """The sweep's recipe (ab_pose_knobs_trained.py:226-229)."""
    return NetworkConfig(n_max_parts=K, num_points=args.points,
                         batch_size=args.batch, init_learning_rate=1e-3,
                         decay_step=10**8, bn_decay_step=10**8,
                         val_interval=0, snapshot_interval=0)


def train_in_process(state: TrainState, dg: DeviceSynthetic, steps: int,
                     batch: int) -> float:
    """`steps` fused synthetic steps (STEPS_PER_CALL a call) from the
    state's step; returns the seconds, the device synchronised."""
    fused = make_fused_synthetic_train_step(state.config, dg, batch,
                                            steps_per_call=STEPS_PER_CALL,
                                            seed=DATA_KEY)
    t0 = time.perf_counter()
    step = int(state.step)
    while step < steps:
        fused(state, step)
        step += STEPS_PER_CALL
    if dg.device.type == "cuda":
        torch.cuda.synchronize(dg.device)
    return time.perf_counter() - t0


def predict(state: TrainState, dg: DeviceSynthetic, test_frames: int,
            batch: int) -> List[Dict]:
    """The held-out frames (a device generator seeded EVAL_SEED) and the
    eval forward's predictions, once: [{"sample", "gt", "pred"}] a
    batch."""
    gen = torch.Generator(device=dg.device).manual_seed(EVAL_SEED)
    out = []
    for lo in range(0, test_frames, batch):
        n = min(batch, test_frames - lo)
        sample, gt = dg.sample_batch(gen, n)
        pred, _ = eval_step(state, sample)
        out.append({"sample": sample, "gt": gt,
                    "pred": {k: pred[k] for k in PRED_KEYS}})
    return out


def fit_ms(call, iters: int, device: torch.device) -> float:
    """ms a call of `call` over `iters` calls after one warm-up: between
    two CUDA events on the card, on the host clock on the CPU."""
    call()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def arm(tag: str, cfg: PoseFitConfig, batches: List[Dict],
        time_iters: int = 0) -> Dict:
    """One arm on the shared predictions: its fits against the GT poses
    (evaluate_fits), and with `time_iters` its ms a batch; prints the
    JAX script's rows.  Returns {"tag", "rot", "trans", "acc_5deg5cm",
    "ms"}."""
    device = batches[0]["sample"]["P"].device
    ms = None
    if time_iters > 0:
        b0 = batches[0]
        P0 = b0["sample"]["P"]
        gen = torch.Generator(device=device).manual_seed(TIME_SEED)

        def call():
            draws = PoseDraws.sample(P0.shape[0], cfg, generator=gen,
                                     device=device)
            return fit_frame_batch(b0["pred"], P0, draws, cfg)

        ms = fit_ms(call, time_iters, device)
        clock = "CUDA events" if device.type == "cuda" else "host clock"
        print(f"  [{tag}] pose fit {ms:8.3f} ms/batch (B={P0.shape[0]}, "
              f"{time_iters} iters, {clock})", flush=True)
    fits, gts = [], []
    gen = torch.Generator(device=device).manual_seed(FIT_SEED)
    for b in batches:
        n = b["sample"]["P"].shape[0]
        draws = PoseDraws.sample(n, cfg, generator=gen, device=device)
        out = fit_frame_batch(b["pred"], b["sample"]["P"], draws, cfg)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        gt = {k: v.cpu().numpy() for k, v in b["gt"].items()}
        for i in range(n):
            fits.append({"R": out["nonlinear_R"][i],
                         "s": out["nonlinear_s"][i],
                         "t": out["nonlinear_t"][i]})
            gts.append({"R": list(gt["R"][i]), "s": list(gt["s"][i]),
                        "t": list(gt["t"][i])})
    o = evaluate_fits(fits, gts, cfg.n_parts).overall
    print(f"{tag:<40s} rot {o['rot_err_deg_mean']:6.2f}° "
          f"trans {o['trans_err_mean']:7.4f} "
          f"5°5cm {o['acc_5deg5cm']:.3f}", flush=True)
    return {"tag": tag, "rot": o["rot_err_deg_mean"],
            "trans": o["trans_err_mean"], "acc_5deg5cm": o["acc_5deg5cm"],
            "ms": ms}


def run(args, spec: Optional[BackboneSpec] = None) -> Dict:
    """The A/B of the flags; returns {"seg_acc", "arms": [arm rows]}.
    `spec` gives the backbone's widths (the tests' tiny one)."""
    device = resolve_device(args.device, "pose_knobs_trained")
    cat = get_category(args.category)
    K = cat.n_parts
    joint_types = tuple(cat.joint_types)
    cfg = train_config(args, K)
    model = build_model(cfg, torch.Generator().manual_seed(0), device=device,
                        spec=spec)
    state = TrainState(model, cfg)
    gen = SyntheticArticulated(n_parts=K, points_per_part=500,
                               joint_types=joint_types, seed=args.seed)
    dg = DeviceSynthetic(gen, num_points=args.points, noise=args.noise,
                         device=device)
    if args.train_steps > 0:
        secs = train_in_process(state, dg, args.train_steps, args.batch)
        print(f"trained {int(state.step)} steps in-process ({secs:.0f}s)",
              flush=True)
    else:
        if not args.work:
            raise ValueError("need --work or --train-steps")
        state, src = restore_state(state, args.work)
        print(f"restored {src}", flush=True)

    # network predictions once; every arm reuses them (paired frames)
    batches = predict(state, dg, args.test_frames, args.batch)
    seg = seg_guard([seg_acc(b["pred"], b["sample"]) for b in batches],
                    args.min_seg_acc)
    wanted = args.arms.split(",") if args.arms else None
    rows = []
    for tag, knobs in ARMS:
        if wanted is not None and not any(w in tag for w in wanted):
            continue
        pcfg = PoseFitConfig(**dict(dict(n_parts=K, joint_types=joint_types,
                                         ransac_chunk=None), **knobs))
        rows.append(arm(tag, pcfg, batches, args.time_iters))
    return {"seg_acc": seg, "arms": rows, "state": state}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
