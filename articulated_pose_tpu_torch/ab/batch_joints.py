"""The per-joint loop against `batch_joints=True`
(`scripts/ab_batch_joints.py`).

    python -m articulated_pose_tpu_torch.ab.batch_joints [--batch 64]
        [--points 2048] [--iters 32] [--parts 3]

The fit at the flagship shape on ground-truth predictions: B frames of
a K-part object with K - 1 revolute joints (`SyntheticArticulated`, seed
0; frames from numpy seed 0, as the JAX script draws them), W and the
joint index one-hot from the labels, NOCS tiled over the parts, the
axis from the GT orientation.  Two arms, production knobs (niter
128/64, ransac_chunk=None): the sequential joint loop, and
`batch_joints=True`, which solves the joints of one type in one batched
call.  Both fit the same draws (each iteration its own, from a generator
seeded 1), and the arms are timed in turns, loop, batched, batched,
loop, each window `iters` fits between two synchronises on the host
clock; an arm's ms is the mean of its two windows.  Their fits on the
first draws are held to ROADMAP C7: bit for bit on the CPU, within
`CARD_BOUND` on the card, whose batched products may take other kernels
at another batch count.

`--device cpu` is for the tests (host-clock times).  Without a card,
and unless `--device cpu` is given, it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from articulated_pose_tpu_torch import timing
from articulated_pose_tpu_torch.programs import (bench_pose_config,
                                                 resolve_device)
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws,
                                                      fit_frame_batch)

ARMS = ("sequential joints", "batch_joints=True")
ORDER = (0, 1, 1, 0)
# chip_smoke.py phase 12(e)'s bound on batch_joints against the loop
# (an H100 read 2.4e-7 there, and 0 at this tool's shape)
CARD_BOUND = 1e-5


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.batch_joints",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--parts", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the tests")
    return ap


def gt_predictions(batch: int, points: int, K: int, dev: torch.device):
    """(P, pred) of the JAX script's frames: one-hot W and joint index,
    NOCS tiled K times, the GT axis."""
    jt = tuple(["revolute"] * (K - 1))
    gen = SyntheticArticulated(n_parts=K, points_per_part=500,
                               joint_types=jt, seed=0)
    rs = np.random.RandomState(0)
    frames = [gen.frame(rs, num_points=points)[0] for _ in range(batch)]
    eye = np.eye(K, dtype=np.float32)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    P = t(np.stack([f["P"] for f in frames]))
    pred = {"W": t(np.stack([eye[f["cls_gt"].astype(int)] for f in frames])),
            "nocs_per_point": t(np.stack([np.tile(f["nocs_gt"], (1, K))
                                          for f in frames])),
            "joint_axis_per_point": t(np.stack([f["orient_gt"]
                                                for f in frames])),
            "index_per_point": t(np.stack([
                eye[f["joint_cls_gt"].astype(int) % K] for f in frames]))}
    return P, pred


def run(args) -> Dict:
    """Both arms in turns; prints each window, the speedup and one JSON
    line; raises unless the arms' fits agree (see the docstring)."""
    dev = resolve_device(args.device, "ab.batch_joints")
    K = args.parts
    base = bench_pose_config(n_parts=K,
                             joint_types=tuple(["revolute"] * (K - 1)))
    cfgs = (base, dataclasses.replace(base, batch_joints=True))
    with torch.inference_mode():
        P, pred = gt_predictions(args.batch, args.points, K, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        draws = [PoseDraws.sample(args.batch, base, gen, dev)
                 for _ in range(args.iters)]
        fits = [fit_frame_batch(pred, P, draws[0], cfg) for cfg in cfgs]
        windows = {a: [] for a in ARMS}
        for arm in ORDER:
            timing.synchronize(dev)
            t0 = time.perf_counter()
            for d in draws:
                fit_frame_batch(pred, P, d, cfgs[arm])
            timing.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3 / args.iters
            windows[ARMS[arm]].append(ms)
            print(f"{ARMS[arm]:<28s} {ms:9.3f} ms/iter "
                  f"({args.batch / ms * 1e3:8.0f} clouds/s)", flush=True)
    dev_max = max(float((fits[0][k] - fits[1][k]).abs().max())
                  for k in fits[0])
    bound = 0.0 if dev.type == "cpu" else CARD_BOUND
    if dev_max > bound:
        raise AssertionError(f"ab.batch_joints: the arms' fits differ by "
                             f"{dev_max:.3g} (bound {bound:g} on {dev})")
    ms = {a: float(np.mean(w)) for a, w in windows.items()}
    speedup = ms[ARMS[0]] / ms[ARMS[1]]
    print(f"speedup: {speedup:.3f}x; the arms' fits differ by {dev_max:.3g} "
          f"at most (bound {bound:g})", flush=True)
    result = dict(tool="ab.batch_joints", card=timing.card_or_none(dev),
                  device=str(dev), batch=args.batch, points=args.points,
                  iters=args.iters, parts=K, windows=windows, ms=ms,
                  speedup=speedup, max_fit_difference=dev_max)
    print(json.dumps(result), flush=True)
    return dict(result, fits=fits)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
