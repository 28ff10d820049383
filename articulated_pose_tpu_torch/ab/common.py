"""What the tools share: the segmentation check that the tools which
fit a trained model's predictions make before they fit, and bench.py's
program, forward + fit, which the timing A/Bs run (its model and fit
from `programs`)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def seg_acc(pred: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
            ) -> float:
    """Share of the batch's points whose argmax W is their GT part."""
    hit = pred["W"].argmax(-1) == batch["cls_gt"].long()
    return float(hit.float().mean())


def seg_guard(accs: Sequence[float], min_seg_acc: float = 0.0) -> float:
    """The check before a fit (ab_pose_knobs_trained.py:274-283): print
    the mean seg acc of the predictions; raise below `min_seg_acc`, where
    every arm would measure nothing (what caught the round-5 restore
    fault: every arm sat at ~117° because the restored net segmented at
    0.68)."""
    seg = float(np.mean(accs))
    print(f"prediction seg acc {seg:.4f} (expect ~the training run's eval; "
          "if far below, the checkpoint does not match this generator/seed)",
          flush=True)
    if seg < min_seg_acc:
        raise RuntimeError(f"prediction seg acc {seg:.4f} is below "
                           f"--min-seg-acc {min_seg_acc}: the predictions "
                           "are not the trained model's")
    return seg


class BenchProgram:
    """bench.py's program, forward + fit, on `iters` fresh clouds: the
    cloud `P` of numpy seed 0 plus 0.01 N(0, 1) noise each iteration
    (bench.py:157), and each iteration's fit draws, all made up front on
    the device from a generator seeded 1."""

    def __init__(self, batch: int, points: int, iters: int,
                 device: torch.device, spec=None, **pose_knobs):
        from articulated_pose_tpu_torch.pose.pipeline import PoseDraws
        from articulated_pose_tpu_torch.programs import (bench_model,
                                                         bench_pose_config)

        self.model = bench_model(device, spec)
        self.cfg = bench_pose_config(**pose_knobs)
        self.P = P = torch.from_numpy(np.random.RandomState(0).rand(
            batch, points, 3).astype(np.float32)).to(device)
        gen = torch.Generator(device=device).manual_seed(1)
        self.clouds = [P + 0.01 * torch.randn(P.shape, generator=gen,
                                              device=device)
                       for _ in range(iters)]
        self.draws = [PoseDraws.sample(batch, self.cfg, gen, device)
                      for _ in range(iters)]

    def forward(self, i: int) -> Dict[str, torch.Tensor]:
        """The pose heads of the forward on cloud i."""
        from articulated_pose_tpu_torch.serving import POSE_KEYS

        pred = self.model(self.clouds[i])
        return {k: pred[k] for k in POSE_KEYS}

    def fit(self, pred: Dict[str, torch.Tensor], i: int
            ) -> Dict[str, torch.Tensor]:
        """The fit of `pred` on cloud i with draws i."""
        from articulated_pose_tpu_torch.pose.pipeline import fit_frame_batch

        return fit_frame_batch(pred, self.clouds[i], self.draws[i], self.cfg)

    def step(self, i: int) -> Dict[str, torch.Tensor]:
        return self.fit(self.forward(i), i)


def fits_equal(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
               ) -> bool:
    """Whether two fits are equal, key by key, bit for bit."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
