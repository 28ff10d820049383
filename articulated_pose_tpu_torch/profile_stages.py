"""Stage-level profile of the flagship forward + pose fit on the card.

    python -m articulated_pose_tpu_torch.profile_stages [--batch 64]
        [--points 2048] [--iters 16] [--stages forward,fps1,bq1,...]

Counterpart of scripts/profile_stages.py, with its stage names and
shapes: the full model (`forward`), its point-cloud ops at the first two
SA levels (`fps1`, `fps2`: single-level FPS N -> 512 -> 128; `bq1`,
`bq2`: the first-S ball query, idx and cnt; `group`: a 128-channel
feature gather; `threenn`: 3-NN N <- 512), the whole pose fit (`pose`)
and the pose fit's sub-stages at the shapes they take inside it
(`partition`, `ransac1`, `jhypo`, `jrefit`, `pscale`, `median`).

The model is the flagship one (K=3, mixed, joint heads, bf16 trunk,
kernel ball query) with weights drawn from a seed.  Every stage runs the
card's kernels: `fps1`/`fps2` launch the single-level FPS kernel (B2),
`bq1`/`bq2` the first-S ball query (B5), `threenn` the exact 3-NN (K3),
`forward` the kernels of the backbone.  So there is no `--impl`: the
JAX script's choice between Pallas and XLA has no counterpart where
every wrapper launches its kernel on a CUDA tensor.

Per stage it prints:
- wall ms/iter: the host clock over `iters` calls, ending in a
  synchronise (one call before, as a warm-up);
- device ms/iter and device ops/iter: the summed durations and the count
  of the events torch.profiler records on the card over `iters` more
  calls (`timing.device_profile`, which runs one uncounted call first);
- idle share: 1 - device ms / wall ms, the share of the wall time in
  which the card had nothing of this stage to run;
- clouds/s: the batch over the wall time;
- the port's kernels each call launched.

JAX's scan-fused, carry-perturbed window amortised TPU dispatch and kept
XLA from hoisting the body out of the loop; eager PyTorch needs neither,
so each call here is one eager call.

It runs on the card.  `--device cpu` runs every stage through the plain
versions and prints host-clock times only (device columns "not
measured"); it exists for the tests.  Without a card, and unless
`--device cpu` is given, it exits non-zero and prints no table.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from articulated_pose_tpu_torch import timing
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
from articulated_pose_tpu_torch.models.layers import init_weights
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels import (ball_query, fps,
                                                    launch_counts, three_nn)
from articulated_pose_tpu_torch.pose import umeyama
from articulated_pose_tpu_torch.pose.lm import joint_transformation_estimate
from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                      PoseFitConfig,
                                                      fit_frame_batch,
                                                      joint_hypotheses,
                                                      masked_median,
                                                      partition_by_class)
from articulated_pose_tpu_torch.pose.ransac import ransac_similarity
from articulated_pose_tpu_torch.serving import POSE_KEYS

STAGES = ("forward", "fps1", "fps2", "bq1", "bq2", "group", "threenn", "pose",
          "partition", "ransac1", "jhypo", "jrefit", "pscale", "median")
N_PARTS = 3


def stage_fns(B: int, N: int, spec: BackboneSpec, want: Sequence[str],
               dev: torch.device) -> Dict[str, tuple]:
    """stage -> (label, fn) for the stages in `want`; the inputs come from
    numpy seed 0 in the JAX script's order."""
    K = N_PARTS
    rng = np.random.RandomState(0)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev, dtype)

    P = t(rng.rand(B, N, 3))
    (n1, n2), (r1, r2), (s1, s2) = (spec.sa_npoints[:2], spec.sa_radii[:2],
                                    spec.sa_nsamples[:2])
    pose_cfg = PoseFitConfig(n_parts=K, joint_types=("revolute", "revolute"),
                             ransac_chunk=None)
    draws = PoseDraws.sample(B, pose_cfg,
                             torch.Generator(device=dev).manual_seed(1), dev)
    fns = {}
    if {"forward", "pose"} & set(want):
        model = ANCSHModel(n_max_parts=K, mixed=True, pred_joint=True,
                           dtype=torch.bfloat16,
                           backbone_spec=dataclasses.replace(
                               spec, ball_query_impl="pallas"))
        model = init_weights(model, torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
        pred = model(P)
        pose_pred = {k: pred[k] for k in POSE_KEYS}
        fns["forward"] = ("forward (full model)", lambda: model(P))
        fns["pose"] = ("pose fit (full)", lambda: fit_frame_batch(
            pose_pred, P, draws, pose_cfg))

    Q1 = t(rng.rand(B, n1, 3))
    Q2 = t(rng.rand(B, n2, 3))
    C = spec.sa_mlps[0][-1]
    feats = t(rng.rand(B, N, C), torch.bfloat16)
    fns["fps1"] = (f"fps {N}->{n1}", lambda: fps.fps(P, n1))
    fns["fps2"] = (f"fps {n1}->{n2}", lambda: fps.fps(Q1, n2))
    fns["bq1"] = (f"ball query L1 ({n1}q, {N})",
                  lambda: ball_query.ball_query_point(r1, s1, P, Q1))
    fns["bq2"] = (f"ball query L2 ({n2}q, {n1})",
                  lambda: ball_query.ball_query_point(r2, s2, Q1, Q2))
    if "group" in want:
        idx1 = ball_query.ball_query_point(r1, s1, P, Q1)[0]
        fns["group"] = (f"group {C}ch feats",
                        lambda: core.group_point(feats, idx1))
    fns["threenn"] = (f"three_nn {N}<-{n1}", lambda: three_nn.three_nn(P, Q1))

    # pose sub-stages: the per-part buffers run at the part_points cap
    Np = min(N, pose_cfg.part_points or N)
    W = t(rng.rand(B, N, K))
    src = t(rng.rand(B, Np, 3))
    tgt = t(rng.rand(B, Np, 3))
    mask = t(rng.rand(B, Np) < 0.5)
    axis = torch.zeros((B, 3), device=dev)
    axis[:, 2] = 1.0
    u0, u1 = draws.joint[:, 0, 0], draws.joint[:, 0, 1]
    fns["partition"] = ("pose: partition_by_class",
                        lambda: partition_by_class(W.argmax(-1), K))
    fns["ransac1"] = ("pose: 1-part RANSAC", lambda: ransac_similarity(
        draws.part[:, 0], src, tgt, mask, inlier_th=pose_cfg.inlier_th,
        chunk=pose_cfg.ransac_chunk))
    fns["jhypo"] = ("pose: joint RANSAC (hypo+score)",
                    lambda: joint_hypotheses(u0, u1, src, tgt, mask, tgt, src,
                                             mask, axis, pose_cfg, False))
    fns["jrefit"] = ("pose: joint LM refit (full pts)",
                     lambda: joint_transformation_estimate(
                         src, tgt, mask, tgt, src, mask, axis,
                         lm_iters=pose_cfg.lm_iters_refit))
    fns["pscale"] = ("pose: pairwise_scale (full pts)",
                     lambda: umeyama.pairwise_scale(src, tgt, mask))
    fns["median"] = ("pose: masked_median axis",
                     lambda: masked_median(src, mask))
    return {s: fns[s] for s in want}


def _measure(fn: Callable[[], object], iters: int, dev: torch.device):
    """(wall ms, device ms or None, device ops or None, the port's kernel
    launches) per call; the launches are counted over the wall clock's
    calls, one warm-up and `iters` timed."""
    before = launch_counts()
    if dev.type == "cuda":
        wall = timing.wall_ms(fn, iters)
    else:
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    after = launch_counts()
    launches = {k: (after[k] - before[k]) / (1 + iters) for k in after
                if after[k] != before[k]}
    if dev.type != "cuda":
        return wall, None, None, launches
    busy, ops = timing.device_profile(fn, iters)
    return wall, busy, ops, launches


def run(batch: int = 64, points: int = 2048, iters: int = 16,
        stages: Optional[Sequence[str]] = None, device: str = "cuda",
        spec: Optional[BackboneSpec] = None) -> List[dict]:
    """Profile `stages` (all by default) with the backbone `spec` (the
    reference widths by default); print the table and return its rows.
    Raises if `device` is a CUDA device that is not available."""
    stages = list(STAGES if stages is None else stages)
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; known: "
                         f"{', '.join(STAGES)}")
    dev = torch.device(device)
    if dev.type != "cpu":
        dev = timing.require_card(device)
    spec = spec or BackboneSpec()
    print(f"{'stage':<34s} {'wall ms':>10s} {'device ms':>10s} "
          f"{'dev ops':>8s} {'idle':>6s} {'clouds/s':>10s}  launches/iter",
          flush=True)
    rows = []
    with torch.inference_mode():
        fns = stage_fns(batch, points, spec, stages, dev)
        for name in stages:
            label, fn = fns[name]
            rows.append(measure_row(name, label, fn, iters, batch, dev))
    return rows


def measure_row(stage: str, label: str, fn: Callable[[], object],
                iters: int, batch: int, dev: torch.device,
                width: int = 34) -> dict:
    """Measure one stage (`_measure`), print its row of the table, and
    return the row."""
    wall, busy, ops, launches = _measure(fn, iters, dev)
    idle = None if busy is None else max(0.0, 1.0 - busy / wall)
    dev_cols = ("not measured".rjust(26) if busy is None else
                f"{busy:10.4f} {ops:8d} {idle:6.3f}")
    print(f"{label:<{width}s} {wall:10.4f} {dev_cols} "
          f"{batch / wall * 1e3:10.1f}  "
          + (", ".join(f"{k} {v:g}" for k, v in launches.items()) or "-"),
          flush=True)
    return dict(stage=stage, label=label, wall_ms=wall, device_ms=busy,
                device_ops=ops, idle_share=idle,
                clouds_per_s=batch / wall * 1e3, launches=launches)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--stages", default=None,
                    help="comma list to restrict to: " + ",".join(STAGES))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the tests")
    args = ap.parse_args(argv)
    if torch.device(args.device).type != "cpu" and \
            not torch.cuda.is_available():
        print(f"profile_stages: device {args.device} is not available (no "
              "CUDA device); --device cpu is for the tests", file=sys.stderr)
        return 2
    run(args.batch, args.points, args.iters,
        args.stages.split(",") if args.stages else None, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
