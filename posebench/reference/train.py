"""The float32 train step of the benchmark's reference: a frozen copy of
the port's `train/state.py` (Adam under the finite guard, the schedules,
the loss-side labels, the step's gradient) and of the seeds its fused
synthetic step draws each step's batch and dropout masks from
(`data/device_synthetic.py::make_fused_synthetic_train_step`), over the
reference's own model, losses and generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from posebench.reference import losses as losses_lib
from posebench.reference.model import ANCSH
from posebench.reference.synthetic import DeviceSynthetic, data_seed


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The settings the losses, the schedules and the seeds read, with
    the port's NetworkConfig defaults."""

    n_max_parts: int = 3
    batch_size: int = 32
    init_learning_rate: float = 1e-3
    decay_step: int = 200_000
    decay_rate: float = 0.7
    bn_decay_step: int = 200_000
    seed: int = 0
    miou_loss_multiplier: float = 1.0
    nocs_loss_multiplier: float = 10.0
    gocs_loss_multiplier: float = 1.0
    offset_loss_multiplier: float = 5.0
    orient_loss_multiplier: float = 0.2
    index_loss_multiplier: float = 1.0
    total_loss_multiplier: float = 1.0
    coord_regress_loss: str = "L2"
    is_mixed: bool = True
    pred_joint: bool = True
    pred_joint_ind: bool = True


def bn_momentum_schedule(step, batch_size: int, bn_decay_step: int):
    samples = torch.as_tensor(step) * batch_size
    bn_momentum = 0.5 * torch.pow(0.5, torch.floor(samples / bn_decay_step))
    return torch.clamp_max(1.0 - bn_momentum, 0.99)


def lr_schedule(step, batch_size: int, init_lr: float, decay_step: int,
                decay_rate: float):
    samples = torch.as_tensor(step) * batch_size
    return init_lr * torch.pow(decay_rate, torch.floor(samples / decay_step))


def dropout_seed(seed: int, step: int) -> int:
    """The dropout masks' seed of train step `step` (data shard 0)."""
    return (seed << 32) + step


def gt_from_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {
        "nocs_per_point": batch["nocs_gt"],
        "cls_per_point": batch["cls_gt"].to(torch.int32),
        "mask_array_per_point": batch["mask_array"],
        "heatmap_per_point": batch["heatmap_gt"],
        "unitvec_per_point": batch["unitvec_gt"],
        "orient_per_point": batch["orient_gt"],
        "index_per_point": batch["joint_cls_gt"].to(torch.int32),
        "joint_cls_mask": batch["joint_cls_mask"],
        "joint_params_gt": batch["joint_params_gt"],
        "gocs_per_point": batch["nocs_gt_g"],
    }


class Trainer:
    """The model, its Adam state (optax's adam, b1 0.9, b2 0.999, eps
    1e-8 outside the root, under apply_if_finite) and the step count."""

    def __init__(self, model: ANCSH, cfg: TrainConfig, dg: DeviceSynthetic,
                 data_stream: int):
        self.model = model
        self.cfg = cfg
        self.dg = dg
        self.data_stream = data_stream
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device)
        self.step_no = 0
        dev = self.params[0].device
        self.data_gen = torch.Generator(device=dev)
        self.dropout_gen = torch.Generator(device=dev)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        self.data_gen.manual_seed(data_seed(self.data_stream, step))
        return self.dg.sample_batch(self.data_gen, self.cfg.batch_size)[0]

    def _loss(self, step: int) -> torch.Tensor:
        """The total loss of train step `step` at the current parameters,
        with that step's batch and dropout masks."""
        cfg = self.cfg
        batch = self.batch(step)
        self.dropout_gen.manual_seed(dropout_seed(cfg.seed, step))
        self.model.train(True)
        momentum = bn_momentum_schedule(
            torch.tensor(step, dtype=torch.int32, device=self.count.device),
            cfg.batch_size, cfg.bn_decay_step)
        pred = self.model(batch["P"], bn_momentum=momentum,
                          generator=self.dropout_gen)
        total, _ = losses_lib.collect_losses(
            losses_lib.compute_all_losses(pred, gt_from_batch(batch), cfg),
            cfg)
        return total

    @torch.no_grad()
    def loss_at(self, step: int,
                params: Sequence[torch.Tensor]) -> torch.Tensor:
        """The total loss of train step `step` with the parameters set to
        `params`, and no update."""
        for p, v in zip(self.params, params):
            p.copy_(v)
        return self._loss(step)

    def step(self) -> Dict[str, torch.Tensor]:
        """One train step in place; returns the total loss and the
        gradients as Adam got them."""
        total = self._loss(self.step_no)
        grads = list(torch.autograd.grad(total, self.params,
                                         allow_unused=True,
                                         materialize_grads=True))
        self._adam(grads)
        self.step_no += 1
        return {"loss": total.detach(), "grads": grads}

    @torch.no_grad()
    def _adam(self, grads: Sequence[torch.Tensor]) -> None:
        cfg = self.cfg
        params: List[torch.Tensor] = self.params
        flat = torch.cat([g.reshape(-1) for g in grads])
        finite = torch.isfinite(flat).all()
        flat = torch.where(finite, flat, 0.0)
        g = [x.view_as(p) for x, p in
             zip(flat.split([p.numel() for p in params]), params)]
        b1, b2, eps = 0.9, 0.999, 1e-8
        lr = lr_schedule(self.count, cfg.batch_size, cfg.init_learning_rate,
                         cfg.decay_step, cfg.decay_rate)
        gm = torch._foreach_mul(g, torch.where(finite, 1.0 - b1, 0.0))
        torch._foreach_mul_(self.mu, torch.where(finite, b1, 1.0))
        torch._foreach_add_(self.mu, gm)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, torch.where(finite, 1.0 - b2, 0.0))
        torch._foreach_mul_(self.nu, torch.where(finite, b2, 1.0))
        torch._foreach_add_(self.nu, g2)
        self.count.add_(finite.to(torch.int32))
        c = torch.clamp_min(self.count, 1)
        mu_hat = torch._foreach_div(self.mu, 1.0 - torch.pow(b1, c))
        nu_hat = torch._foreach_div(self.nu, 1.0 - torch.pow(b2, c))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(upd, torch.where(finite, -lr, 0.0))
        torch._foreach_add_(list(params), upd)
