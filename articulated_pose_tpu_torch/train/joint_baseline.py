"""Train and eval loop of the direct joint-regression baseline: counterpart
of `articulated_pose_tpu/train/joint_baseline.py`.

Makes the reference's third experiment family CLI-drivable
(reference: lib/architecture.py:163-192 builds the model behind the
`joint_baseline` experiment ids of global_info.py, trained by the same
main.py loop; evaluation compares regressed joint parameters against the
7-dof GT): `python -m articulated_pose_tpu_torch train/eval --model
joint_baseline`.

The model regresses, per joint, (axis, orthogonal offset direction,
line distance) globally from the whole cloud — no per-point voting, no
pose fit.  Eval reports the sign-invariant axis angle error and the
offset-vector error against joint_params_gt (labeling.py:136-147).

The step is the ANCSH trainer's: the port's Adam (`state.make_optimizer`,
with its finite guard), train-mode batch norm at the scheduled momentum,
dropout from a generator reseeded from (config.seed + 1, step) before
each step (C6).  The checkpoint is a `torch.save` file in the work
directory holding the model and the step; a restore takes both and
starts Adam afresh, as JAX's does (joint_baseline.py:73-90).  It runs on
the card unless `device` names another one; without a card the default
raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from articulated_pose_tpu_torch.config import (NetworkConfig,
                                               bn_momentum_schedule)
from articulated_pose_tpu_torch.data.batcher import device_prefetch
from articulated_pose_tpu_torch.models.joint_regression import (
    build_joint_regression, direct_joint_loss)
from articulated_pose_tpu_torch.train.state import (dropout_generator,
                                                    make_optimizer, to_device)


class JointBaselineTrainer:
    """Minimal train/eval engine for DirectJointRegression."""

    def __init__(self, cfg: NetworkConfig, work_dir: str, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"JointBaselineTrainer: device {device} is not "
                               "available; pass device='cpu' to train on the "
                               "CPU")
        self.cfg = cfg
        self.work_dir = work_dir
        self.device = device
        self.model = build_joint_regression(
            cfg.n_max_parts, torch.Generator().manual_seed(cfg.seed)).to(device)
        self.tx = make_optimizer(cfg)
        self.params = list(self.model.parameters())
        self.opt = self.tx.init(self.params)
        self.step = 0
        self.generator = torch.Generator(device=device)

    # -------------------------------------------------------------- state
    def _ckpt_path(self) -> str:
        return os.path.join(self.work_dir, "joint_baseline.pt")

    def save(self) -> None:
        os.makedirs(self.work_dir, exist_ok=True)
        payload = {"model": {k: v.detach().cpu()
                             for k, v in self.model.state_dict().items()},
                   "step": self.step}
        tmp = self._ckpt_path() + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._ckpt_path())

    def maybe_restore(self) -> int:
        """Load the work directory's checkpoint, if there is one: the
        model and the step; Adam starts afresh.  Returns the step."""
        path = self._ckpt_path()
        if not os.path.exists(path):
            return 0
        payload = torch.load(path, map_location=self.device,
                             weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.step = int(payload["step"])
        self.opt = self.tx.init(self.params)
        return self.step

    # -------------------------------------------------------------- steps
    def loss_and_grads(self, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None):
        """The training forward at `self.step`'s batch-norm momentum: the
        total loss (the sum of the per-term means), the per-term means,
        and the gradient of every parameter (zeros where the loss does
        not reach one)."""
        cfg = self.cfg
        self.model.train()
        momentum = bn_momentum_schedule(self.step, cfg.batch_size,
                                        cfg.bn_decay_step)
        out = self.model(batch["P"], bn_momentum=momentum,
                         generator=generator)
        parts = direct_joint_loss(out, batch["joint_params_gt"])
        means = {k: v.mean() for k, v in parts.items()}
        total = sum(means.values())
        grads = torch.autograd.grad(total, self.params, allow_unused=True,
                                    materialize_grads=True)
        return total, means, list(grads)

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One step in place (joint_baseline.py:94-113); returns
        total_loss and the per-term means as 0-d device tensors."""
        batch = to_device(batch, self.device)
        dropout_generator(self.generator, self.cfg.seed + 1, self.step)
        total, means, grads = self.loss_and_grads(batch, self.generator)
        self.tx.apply(self.params, grads, self.opt)
        self.step += 1
        return {"total_loss": total.detach(),
                **{k: v.detach() for k, v in means.items()}}

    @torch.no_grad()
    def forward(self, P) -> Dict:
        """The eval-mode prediction of a batch of clouds."""
        self.model.eval()
        return self.model(torch.as_tensor(np.asarray(P, np.float32),
                                          device=self.device))

    # ---------------------------------------------------------------- fit
    def fit(self, train_it, max_steps: Optional[int] = None,
            n_epochs: Optional[int] = None) -> Dict[str, float]:
        """Train until the step count reaches `max_steps` (a resumed run
        counts its restored steps; at least one step is taken), by
        default `n_epochs` (1) epochs of `train_it`, its batches copied
        to the device ahead (`device_prefetch`); then save.  Returns the
        last step's metrics (joint_baseline.py:120-141)."""
        max_steps = max_steps or (len(train_it) * (n_epochs or 1))
        logs = {}
        done = False
        while not done:
            for batch in device_prefetch(train_it, size=2,
                                         device=self.device):
                logs = self.train_step(batch)
                if self.step >= max_steps:
                    done = True
                    break
        self.save()
        return {k: float(v) for k, v in logs.items()}

    # --------------------------------------------------------------- eval
    def evaluate(self, test_it) -> Dict[str, float]:
        """Mean joint-parameter errors over a split (joint_baseline.py:
        144-177).

        axis_err_deg: sign-invariant angle between predicted and GT axis
        (eval_joint_params.py semantics); offset_err: |p̂ − p| of the
        orthogonal offset vector (orth_unit · dist, labeling.py:144-147).
        """
        axis_errs, offset_errs = [], []
        for batch in test_it:
            pred = self.forward(batch["P"])
            gt = np.asarray(batch["joint_params_gt"])     # (B, K, 7)
            for j, jp in enumerate(pred["joint_params"]):
                jp = [x.cpu().numpy() for x in jp]
                a_hat = jp[0] / np.maximum(
                    np.linalg.norm(jp[0], axis=1, keepdims=True), 1e-9)
                a_gt = gt[:, j + 1, 0:3]
                valid = np.linalg.norm(a_gt, axis=1) > 1e-6
                cosang = np.abs(np.sum(a_hat * a_gt, axis=1)
                                / np.maximum(np.linalg.norm(a_gt, axis=1),
                                             1e-9))
                axis_errs.extend(
                    np.degrees(np.arccos(np.clip(cosang, -1, 1)))[valid])
                p_hat = jp[1] * jp[2]
                p_gt = gt[:, j + 1, 3:6] * gt[:, j + 1, 6:7]
                offset_errs.extend(
                    np.linalg.norm(p_hat - p_gt, axis=1)[valid])
        return {"joint_axis_err_deg": float(np.mean(axis_errs)),
                "joint_offset_err": float(np.mean(offset_errs)),
                "n_joints_evaluated": len(axis_errs)}


def run_joint_baseline(cfg: NetworkConfig, work_dir: str, train_it=None,
                       test_it=None, max_steps: Optional[int] = None,
                       n_epochs: Optional[int] = None,
                       device="cuda") -> Dict[str, float]:
    """Train (if train_it) then evaluate (if test_it) and write
    joint_baseline_eval.json; returns the metrics
    (joint_baseline.py:180-195)."""
    tr = JointBaselineTrainer(cfg, work_dir, device=device)
    # JAX's run_joint_baseline reads one batch to initialise its model,
    # which draws one epoch order of a shuffled iterator; so does this
    # one, so that the two see their batches in the same order
    for _ in train_it or test_it:
        break
    out: Dict[str, float] = {"resumed_step": tr.maybe_restore()}
    if train_it is not None:
        out.update(tr.fit(train_it, max_steps=max_steps, n_epochs=n_epochs))
    if test_it is not None:
        metrics = tr.evaluate(test_it)
        out.update(metrics)
        os.makedirs(work_dir, exist_ok=True)
        with open(os.path.join(work_dir, "joint_baseline_eval.json"),
                  "w") as f:
            json.dump(metrics, f, indent=1)
    return out
