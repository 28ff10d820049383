"""Accuracy A/B: pose-fit quality against RANSAC strength, on noisy-oracle
predictions (`scripts/ab_ransac_strength.py`).

    python -m articulated_pose_tpu_torch.ab.ransac_strength --frames 64 \\
        [--nocs_noise 0.02] [--seg_flip 0.05] [--r4 [--arms refit,score]]

Frames of a three-part, two-revolute object with exact GT poses, and
predictions built from their labels with calibrated noise (`ab.oracle`,
NumPy, bit-equal to the JAX script's).  Each arm fits them with one
`PoseFitConfig` through `pose.pipeline.fit_frame_batch` on `--device`
(the card by default) and prints rot / trans / 5°5cm.  Without `--r4`:
five hypothesis counts, three refit lengths, the strongest fit without
the part-buffer cap and the production fit at three caps; with `--r4`:
the production control and twelve cheaper knobs (`--arms` keeps those
whose tag holds one of its comma-separated substrings).  Every arm draws
its RANSAC samples from a torch generator seeded 0 on the device, as the
JAX script reuses PRNGKey(0); `run(draws=)` imposes other draws.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from articulated_pose_tpu_torch.ab import oracle
from articulated_pose_tpu_torch.programs import resolve_device
from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                      PoseFitConfig,
                                                      fit_frame_batch)

BASE = dict(n_parts=oracle.K, joint_types=oracle.JOINT_TYPES,
            lm_iters_hypo=8, lm_iters_refit=15, ransac_chunk=None,
            lm_refit_points=512)
DRAW_SEED = 0
# the --r4 arms below the production defaults (ab_ransac_strength.py:107-123)
R4_KNOBS = (
    (dict(lm_iters_refit=4), "refit=4"),
    (dict(lm_iters_refit=3), "refit=3"),
    (dict(lm_iters_refit=2), "refit=2"),
    (dict(niter_part=64), "niter_part=64"),
    (dict(niter_joint=32), "niter_joint=32"),
    (dict(niter_part=64, niter_joint=32, lm_iters_refit=3),
     "64/32 refit=3 (all cheap)"),
    (dict(ransac_score_points=512), "score_points=512"),
    (dict(ransac_score_points=256), "score_points=256"),
    (dict(lm_refit_points=256), "lm_refit_points=256"),
    (dict(part_points=512), "part_points=512"),
    (dict(axis_agg="mean"), "axis_agg=mean"),
    (dict(niter_part=64, niter_joint=32, lm_iters_refit=3,
          ransac_score_points=512, axis_agg="mean"),
     "64/32 refit3 score512 mean (all cheap+mean)"),
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.ransac_strength",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--nocs_noise", type=float, default=0.02)
    ap.add_argument("--seg_flip", type=float, default=0.05)
    ap.add_argument("--r4", action="store_true",
                    help="round-4 arms: probe knobs below the production "
                         "defaults (refit 3, 64/32 hypotheses, smaller "
                         "scoring/refit prefixes)")
    ap.add_argument("--arms", default=None,
                    help="comma list of substrings: run only the --r4 arms "
                         "whose tag holds one (plus the control)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' for tests)")
    return ap


def arms(r4: bool, wanted: Optional[Sequence[str]] = None
         ) -> List[Tuple[str, PoseFitConfig]]:
    """(tag, config) of each arm, in the JAX script's order
    (ab_ransac_strength.py:98-153)."""
    out = []
    if r4:
        prod = dict(BASE, lm_iters_refit=6)
        out.append(("PROD 128/64 refit6 (control)",
                    PoseFitConfig(niter_part=128, niter_joint=64, **prod)))
        for kw, tag in R4_KNOBS:
            if wanted is not None and not any(w in tag for w in wanted):
                continue
            knobs = dict(prod, niter_part=128, niter_joint=64)
            knobs.update(kw)
            out.append((f"R4 {tag}", PoseFitConfig(**knobs)))
        return out
    for niter_part, niter_joint in ((2048, 256), (1024, 128), (512, 128),
                                    (256, 64), (128, 64)):
        out.append((f"niter_part={niter_part} niter_joint={niter_joint}",
                    PoseFitConfig(niter_part=niter_part,
                                  niter_joint=niter_joint, **BASE)))
    for refit in (15, 10, 6):
        out.append((f"lm_iters_refit={refit} (512/128)",
                    PoseFitConfig(niter_part=512, niter_joint=128,
                                  **dict(BASE, lm_iters_refit=refit))))
    # the strongest fit with no part-buffer cap, then the production fit
    # (128/64, refit 6) at three caps
    out.append(("STRONG 2048/256 refit15 no-cap",
                PoseFitConfig(niter_part=2048, niter_joint=256,
                              **dict(BASE, part_points=None))))
    for cap in (None, 1024, 768):
        out.append((f"PROD 128/64 refit6 part_points={cap}",
                    PoseFitConfig(niter_part=128, niter_joint=64,
                                  **dict(BASE, lm_iters_refit=6,
                                         part_points=cap))))
    return out


def inputs(frames: int, points: int, nocs_noise: float, seg_flip: float):
    """(frames, gts, predictions) as the JAX script builds them: one
    RandomState seeded 1 draws the frames, then the noise."""
    rng = np.random.RandomState(1)
    fr, gts = oracle.make_frames(frames, points, rng)
    pred = oracle.noisy_oracle(fr, rng, oracle.K, nocs_noise, seg_flip)
    return fr, gts, pred


def fit(pred: Dict[str, torch.Tensor], P: torch.Tensor, cfg: PoseFitConfig,
        draws: Optional[PoseDraws] = None) -> Dict[str, np.ndarray]:
    """One arm's fit on the tensors' device; without `draws`, a device
    generator seeded DRAW_SEED draws them."""
    if draws is None:
        gen = torch.Generator(device=P.device).manual_seed(DRAW_SEED)
        draws = PoseDraws.sample(P.shape[0], cfg, generator=gen,
                                 device=P.device)
    out = fit_frame_batch(pred, P, draws, cfg)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run(args, draws: Optional[Callable[[PoseFitConfig], PoseDraws]] = None
        ) -> List[Tuple[str, Dict[str, float]]]:
    """Every arm of the flags, each row printed as it ends; returns
    (tag, scores).  `draws(cfg)` gives an arm's draws in place of the
    seeded generator's (the tests hand in JAX's)."""
    device = resolve_device(args.device, "ransac_strength")
    fr, gts, pred = inputs(args.frames, args.points, args.nocs_noise,
                           args.seg_flip)
    pred_t = {k: torch.as_tensor(v, device=device) for k, v in pred.items()}
    P = torch.as_tensor(np.stack([s["P"] for s in fr]), device=device)
    wanted = args.arms.split(",") if args.arms else None
    rows = []
    for tag, cfg in arms(args.r4, wanted):
        d = None if draws is None else draws(cfg).to(device)
        s = oracle.score(fit(pred_t, P, cfg, d), gts, oracle.K)
        print(oracle.row(tag, s), flush=True)
        rows.append((tag, s))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
