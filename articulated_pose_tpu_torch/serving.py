"""Serving API: clouds in, part poses out.  Counterpart of
`articulated_pose_tpu/serving.py` and of `main.py::cmd_serve`'s batch loop.

`PosePredictor` holds the model on one device and runs the forward and
the pose fit for a batch of clouds; `serve_clouds` pads a stream of
clouds to the predictor's batch and trims the answers.  The RANSAC draws
come from a torch.Generator on the device, reseeded from `config.seed`
on every call, so the same cloud always gets the same poses (the JAX
server likewise reuses one key for every call).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.pose.pipeline import (PoseDraws, PoseFitConfig,
                                                      fit_frame_batch)
from articulated_pose_tpu_torch.train.trainer import (checkpoint_path,
                                                      checkpoint_steps)

POSE_KEYS = ("W", "nocs_per_point", "joint_axis_per_point", "index_per_point")


@dataclasses.dataclass
class PoseResult:
    """Per-batch pose outputs (host numpy)."""

    R: np.ndarray              # (B, K, 3, 3) part rotations
    scale: np.ndarray          # (B, K)
    t: np.ndarray              # (B, K, 3)
    segmentation: np.ndarray   # (B, N) argmax part labels
    part_counts: np.ndarray    # (B, K)
    raw: Dict[str, np.ndarray]  # full prediction dict (NOCS, heatmaps, ...)


class PosePredictor:
    """ANCSH forward + pose fit on one device.

    >>> pred = PosePredictor(cfg, work_dir="results/ancsh")   # on the card
    >>> out = pred(clouds)          # (B, N, 3) float32
    >>> out.R[b, j], out.scale[b, j], out.t[b, j]

    Weights come from exactly one of `state_dict`, `ckpt_path` (a
    `torch.save`d state dict; `convert.load_flax_npz` turns a JAX
    checkpoint into one) and `work_dir`, whose newest trainer checkpoint
    (`<work_dir>/model/`) it serves, as the JAX server restores the
    newest Orbax step (serving.py:51-70); FileNotFoundError when there is
    none.
    It serves on the card unless `device` names another one; without a
    card the default raises rather than serving on the CPU.
    """

    def __init__(self, config: NetworkConfig,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 ckpt_path: Optional[str] = None,
                 pose_cfg: Optional[PoseFitConfig] = None,
                 use_nonlinear: bool = True, device="cuda",
                 work_dir: Optional[str] = None):
        if sum(x is not None for x in (state_dict, ckpt_path, work_dir)) != 1:
            raise ValueError("PosePredictor needs exactly one of state_dict, "
                             "ckpt_path and work_dir")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"PosePredictor: device {device} is not "
                               "available; pass device='cpu' to serve on "
                               "the CPU")
        if work_dir is not None:
            model_dir = os.path.join(work_dir, "model")
            steps = checkpoint_steps(model_dir)
            if not steps:
                raise FileNotFoundError(f"no trainer checkpoint in "
                                        f"{model_dir}")
            state_dict = torch.load(checkpoint_path(model_dir, steps[-1]),
                                    map_location="cpu",
                                    weights_only=True)["model"]
        if ckpt_path is not None:
            state_dict = torch.load(ckpt_path, map_location="cpu",
                                    weights_only=True)
        self.config = config
        self.device = device
        self.model = build_model(config, device=self.device)
        self.model.load_state_dict(state_dict)
        spec = config.category_spec
        self.pose_cfg = pose_cfg or PoseFitConfig(
            n_parts=config.n_max_parts,
            niter_part=config.ransac_niter_part,
            niter_joint=config.ransac_niter_joint,
            inlier_th=config.ransac_inlier_th,
            joint_types=tuple(spec.joint_types))
        self.use_nonlinear = use_nonlinear and config.pred_joint
        self._generator = torch.Generator(device=self.device)

    def draws(self, batch: int) -> PoseDraws:
        """The RANSAC draws of one call: the same for every call."""
        self._generator.manual_seed(self.config.seed)
        return PoseDraws.sample(batch, self.pose_cfg, self._generator,
                                self.device)

    @torch.no_grad()
    def __call__(self, clouds, draws: Optional[PoseDraws] = None
                 ) -> PoseResult:
        P = torch.as_tensor(np.asarray(clouds, np.float32), device=self.device)
        pred = self.model(P)
        draws = draws if draws is not None else self.draws(P.shape[0])
        fits = fit_frame_batch({k: pred[k] for k in POSE_KEYS if k in pred},
                               P, draws, self.pose_cfg)
        prefix = "nonlinear" if (self.use_nonlinear
                                 and "nonlinear_R" in fits) else "baseline"
        host = {k: v.cpu().numpy() for k, v in fits.items()}
        return PoseResult(
            R=host[f"{prefix}_R"], scale=host[f"{prefix}_s"],
            t=host[f"{prefix}_t"],
            segmentation=pred["W"].argmax(dim=-1).cpu().numpy(),
            part_counts=host["part_counts"],
            raw={k: v.cpu().numpy() for k, v in pred.items()})


def serve_clouds(predictor: PosePredictor, clouds: np.ndarray,
                 batch_size: int) -> Dict[str, np.ndarray]:
    """Serve (C, N, 3) clouds in batches of `batch_size`; a short last
    batch is padded with copies of its last cloud and trimmed after
    (main.py:475-491).  Returns R, s, t, seg, part_counts for the C
    clouds."""
    clouds = np.asarray(clouds, np.float32)
    if clouds.ndim != 3 or clouds.shape[-1] != 3 or len(clouds) == 0:
        raise ValueError(f"expected (C, N, 3) clouds with C > 0, got "
                         f"{clouds.shape}")
    outs = []
    for s in range(0, len(clouds), batch_size):
        chunk = clouds[s:s + batch_size]
        n = len(chunk)
        if n < batch_size:
            pad = np.repeat(chunk[-1:], batch_size - n, axis=0)
            chunk = np.concatenate([chunk, pad])
        res = predictor(chunk)
        outs.append({"R": res.R[:n], "s": res.scale[:n], "t": res.t[:n],
                     "seg": res.segmentation[:n],
                     "part_counts": res.part_counts[:n]})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
