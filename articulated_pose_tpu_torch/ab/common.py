"""What every accuracy tool shares: the `--device` rule, and the
segmentation check that the tools which fit a trained model's
predictions make before they fit."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def resolve_device(name: str, tool: str) -> torch.device:
    """`--device` as a torch.device; a card that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: device {device} is not available; pass "
                           "--device cpu to run on the CPU")
    return device


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
