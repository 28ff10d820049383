"""Trained-model accuracy A/B of the packed ball query
(`scripts/ab_packed_eval.py`).

    python -m articulated_pose_tpu_torch.ab.packed_eval --work RUN \\
        [--points 1024] [--dtype bfloat16]

Restores one checkpoint (a work dir of `e2e.py` or `Trainer`, or an
exported JAX npz: `restore_eval.restore_state`) and evaluates the same
held-out frames twice: with the exact ball query (`ball_query_group`)
and with `ball_query_packed=True` (`ball_query_group_packed`: the same
neighbours, their coordinates quantised to 10 bits per component over
the cloud's box).  Same state_dict, same frames, same fit draws (the
frames and draws of `e2e.evaluate`: a device generator seeded 9999, the
generator of the category seeded 0, the fit at niter 1024/128 with 15 LM
refit iterations), so any delta is the quantisation's.  Each arm's
first batch of predictions passes `common.seg_guard` before any
fit.  `--dtype` sets both arms' trunk (bfloat16 is the served
configuration).  Prints each arm's metrics and the paired deltas
(packed - exact).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from articulated_pose_tpu_torch import e2e
from articulated_pose_tpu_torch.ab.common import seg_acc, seg_guard
from articulated_pose_tpu_torch.ab.restore_eval import restore_state
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data.device_synthetic import DeviceSynthetic
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.pose.pipeline import PoseFitConfig
from articulated_pose_tpu_torch.programs import resolve_device
from articulated_pose_tpu_torch.train.state import TrainState, eval_step

GEN_SEED = 0            # the frames' generator (ab_packed_eval.py:40-41)
ARMS = (("exact", False), ("packed", True))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.packed_eval",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                   "e2e_2048_24k"))
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--parts", type=int, default=3)
    ap.add_argument("--joint-types", default=None)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--test-frames", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="trunk dtype for both arms (bfloat16 = the served "
                         "configuration)")
    ap.add_argument("--min-seg-acc", type=float, default=0.0,
                    help="raise when the seg acc of an arm's first batch "
                         "is below this")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' for tests)")
    return ap


def pose_config(K: int, joint_types) -> PoseFitConfig:
    """The eval fit (ab_packed_eval.py:44-46)."""
    return PoseFitConfig(n_parts=K, niter_part=1024, niter_joint=128,
                         joint_types=joint_types, lm_iters_hypo=8,
                         lm_iters_refit=15, ransac_chunk=None)


def arm_config(args, packed: bool) -> NetworkConfig:
    return NetworkConfig(n_max_parts=args.parts, num_points=args.points,
                         batch_size=args.batch, val_interval=0,
                         snapshot_interval=0, compute_dtype=args.dtype,
                         ball_query_packed=packed)


def run_eval(state: TrainState, args, joint_types,
             draw_batch: Optional[Callable[[int], Tuple]] = None) -> Dict:
    """One arm (ab_packed_eval.py:26-95): `e2e.evaluate` on the frames of
    a generator seeded GEN_SEED, the fit at niter 1024/128; returns the
    report's overall metrics and the seg acc.  `draw_batch` imposes each
    batch's frames and draws (as in `e2e.evaluate`)."""
    K = state.config.n_max_parts
    gen = SyntheticArticulated(n_parts=K, points_per_part=500,
                               joint_types=joint_types, seed=GEN_SEED)
    dg = DeviceSynthetic(gen, num_points=args.points, noise=args.noise,
                         device=state.device)
    pose_cfg = pose_config(K, joint_types)
    draw = draw_batch or e2e.eval_draws(dg, pose_cfg, state.device)
    checked = []

    def guarded(n):
        # the first batch's predictions checked before any fit
        got = draw(n)
        if not checked:
            pred, _ = eval_step(state, got[0])
            checked.append(seg_guard([seg_acc(pred, got[0])],
                                     args.min_seg_acc))
        return got

    ev = e2e.evaluate(state, dg, pose_cfg, args.test_frames, args.batch,
                      state.device, guarded)
    out = dict(ev["report"].overall)
    out["seg_acc"] = ev["seg_acc"]
    return out


def run(args, spec: Optional[BackboneSpec] = None) -> Dict:
    """Both arms on the flags' checkpoint; prints each arm and the paired
    deltas and returns {arm: metrics}.  `spec` gives the backbone's
    widths (the tests' tiny one)."""
    device = resolve_device(args.device, "packed_eval")
    joint_types = (tuple(args.joint_types.split(",")) if args.joint_types
                   else ("revolute",) * (args.parts - 1))
    results = {}
    for name, packed in ARMS:
        cfg = arm_config(args, packed)
        model = build_model(cfg, torch.Generator().manual_seed(0),
                            device=device, spec=spec)
        state, _ = restore_state(TrainState(model, cfg), args.work)
        t0 = time.perf_counter()
        results[name] = run_eval(state, args, joint_types)
        print(f"[{name}] step={int(state.step)} "
              f"({time.perf_counter() - t0:.0f}s): "
              f"{json.dumps({k: round(v, 4) for k, v in results[name].items()})}",
              flush=True)

    print("\npaired deltas (packed - exact):")
    for k in results["exact"]:
        d = results["packed"][k] - results["exact"][k]
        print(f"  {k}: {results['exact'][k]:.4f} -> "
              f"{results['packed'][k]:.4f}  ({d:+.4f})", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
