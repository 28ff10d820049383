"""Train state and the train / eval steps: counterpart of
`articulated_pose_tpu/train/state.py`.

- `Adam`: optax's `apply_if_finite(adam(lr_schedule))` (state.py:38-46)
  as one in-place update of the parameters, with no host sync: when any
  gradient is non-finite, the parameters, both moments and Adam's count
  stay as they were, decided on the device.
- `TrainState`: the model, the step (a device int32 tensor), the Adam
  moments and count; `state_dict` / `load_state_dict` are what the
  checkpoints hold.
- `train_step` / `eval_step`: the loss of `losses.py` on the model's
  predictions; the train step moves the batch-norm statistics by the
  scheduled momentum, differentiates the loss with respect to the
  parameters only and applies Adam (state.py:102-140).
- `make_train_step` / `make_eval_step`: JAX's builders of the compiled
  steps; `jit=True` captures the step once a batch shape on the card
  and replays it (`compiled.py`), `jit=False` is the eager step.  The
  step updates the state in place, which is what JAX's `donate`
  achieves.

The dropout masks come from a torch.Generator that `dropout_generator`
reseeds from (config.seed, step) before each step, the counterpart of
`jax.random.fold_in(rng, step)`; its streams are not JAX's.  A captured
step registers the generator with its graph, so a replay draws the
masks of the generator's seed and offset at that moment, as the eager
step would.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from articulated_pose_tpu_torch import losses as losses_lib
from articulated_pose_tpu_torch.compiled import compiled
from articulated_pose_tpu_torch.config import (NetworkConfig,
                                               bn_momentum_schedule,
                                               lr_schedule)


@dataclasses.dataclass
class AdamState:
    """First and second moments (one per parameter) and the count of
    accepted updates (0-d int32), which the learning rate is read at."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam (b1, b2, eps added outside the square root, bias
    correction) under optax.apply_if_finite.

    `lr(count)` is evaluated at the count of updates accepted so far, as
    optax's schedule is: after a skipped step the learning rate stays
    where it was, though the train step's `step` moves on.
    """

    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        dev = params[0].device
        return AdamState(mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params],
                         count=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: AdamState,
              finite: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Update `params` and `state` in place from `grads`; returns the
        device flag of whether every gradient was finite.  A sharded step
        passes `finite`, the flag over every rank's gradients, so that all
        ranks accept or skip the update together.

        The guard is arithmetic, so the host never waits on the flag: a
        rejected step zeroes the gradients and runs with the moment
        coefficients (1, 0) and a step size of 0, which leave the moments
        and the parameters bit for bit as they were.
        """
        flat = torch.cat([g.reshape(-1) for g in grads])
        if finite is None:
            finite = torch.isfinite(flat).all()
        flat = torch.where(finite, flat, 0.0)
        g = [x.view_as(p) for x, p in
             zip(flat.split([p.numel() for p in params]), params)]
        b1, b2 = self.b1, self.b2
        lr = self.lr(state.count)                 # before the increment
        # optax: mu = (1 - b1) * g + b1 * mu, nu = (1 - b2) * g² + b2 * nu
        gm = torch._foreach_mul(g, torch.where(finite, 1.0 - b1, 0.0))
        torch._foreach_mul_(state.mu, torch.where(finite, b1, 1.0))
        torch._foreach_add_(state.mu, gm)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, torch.where(finite, 1.0 - b2, 0.0))
        torch._foreach_mul_(state.nu, torch.where(finite, b2, 1.0))
        torch._foreach_add_(state.nu, g2)
        state.count.add_(finite.to(torch.int32))
        # bias correction at the new count; at least 1, so that a
        # rejected first step divides by no zero before its step size 0
        c = torch.clamp_min(state.count, 1)
        mu_hat = torch._foreach_div(state.mu, 1.0 - torch.pow(b1, c))
        nu_hat = torch._foreach_div(state.nu, 1.0 - torch.pow(b2, c))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(upd, torch.where(finite, -lr, 0.0))
        torch._foreach_add_(list(params), upd)
        return finite


def make_optimizer(config: NetworkConfig) -> Adam:
    """Adam with the staircase learning rate counted in samples
    (state.py:38-46)."""
    return Adam(lr=lambda count: lr_schedule(
        count, config.batch_size, config.init_learning_rate,
        config.decay_step, config.decay_rate))


class TrainState:
    """The model (trained in place), its Adam state and the step.

    `step` counts train steps, a skipped one too; it sets the batch-norm
    momentum.  `opt.count` counts accepted updates; it sets the learning
    rate.
    """

    def __init__(self, model: torch.nn.Module, config: NetworkConfig):
        self.model = model
        self.config = config
        self.tx = make_optimizer(config)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.device = self.params[0].device
        self.opt = self.tx.init(self.params)
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(),
                "mu": dict(zip(self.names, self.opt.mu)),
                "nu": dict(zip(self.names, self.opt.nu)),
                "count": self.opt.count, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> "TrainState":
        self.model.load_state_dict(sd["model"])
        for moments, key in ((self.opt.mu, "mu"), (self.opt.nu, "nu")):
            missing = set(self.names) ^ set(sd[key])
            if missing:
                raise KeyError(f"{key}: parameters {sorted(missing)} do not "
                               "match the model's")
            for name, t in zip(self.names, moments):
                t.copy_(sd[key][name])
        self.opt.count.copy_(torch.as_tensor(sd["count"]))
        self.step.copy_(torch.as_tensor(sd["step"]))
        return self


# an odd 64-bit constant (2^64 over the golden ratio): multiples of it
# differ in their low 32 bits as well, which is all a CPU generator keeps
_SHARD_MIX = 0x9E3779B97F4A7C15


def shard_seed(seed: int, shard: int) -> int:
    """The seed of data shard `shard` of a sharded call from the
    unsharded call's `seed`: `seed` itself for shard 0, and apart from it
    in the low 32 bits (a CPU generator's) and in all 64 (a card's)."""
    return seed ^ ((shard * _SHARD_MIX) & 0xFFFF_FFFF_FFFF_FFFF)


def dropout_generator(generator: torch.Generator, seed: int, step: int,
                      shard: int = 0) -> torch.Generator:
    """Reseed `generator` for the dropout masks of train step `step`:
    the masks are a function of (seed, step), as `fold_in(rng, step)`
    makes JAX's (state.py:107), so a resumed run draws what an
    uninterrupted one would; and of the data shard of a sharded step,
    whose shard 0 draws the unsharded step's masks.  A host-side reseed:
    no sync."""
    return generator.manual_seed(shard_seed((seed << 32) + step, shard))


def gt_from_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The loss-side labels of a batch (state.py:81-99)."""
    gt = {
        "nocs_per_point": batch["nocs_gt"],
        "cls_per_point": batch["cls_gt"].to(torch.int32),
        "mask_array_per_point": batch["mask_array"],
    }
    if "heatmap_gt" in batch:
        gt.update({
            "heatmap_per_point": batch["heatmap_gt"],
            "unitvec_per_point": batch["unitvec_gt"],
            "orient_per_point": batch["orient_gt"],
            "index_per_point": batch["joint_cls_gt"].to(torch.int32),
            "joint_cls_mask": batch["joint_cls_mask"],
            "joint_params_gt": batch["joint_params_gt"],
        })
    if "nocs_gt_g" in batch:
        gt["gocs_per_point"] = batch["nocs_gt_g"]
    return gt


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on `device` (a
    no-op for what `data.batcher.device_prefetch` yields)."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               device=device) for k, v in batch.items()}


def forward_loss(state: TrainState, batch: Dict[str, torch.Tensor], *,
                 train: bool, generator: Optional[torch.Generator] = None):
    """(total, summaries, pred) of the model on a device batch; in
    training mode batch norm moves by the momentum scheduled at
    `state.step` (state.py:64-78)."""
    cfg = state.config
    state.model.train(train)
    momentum = bn_momentum_schedule(state.step, cfg.batch_size,
                                    cfg.bn_decay_step)
    pred = state.model(batch["P"], bn_momentum=momentum, generator=generator)
    loss_dict = losses_lib.compute_all_losses(pred, gt_from_batch(batch), cfg)
    total, summaries = losses_lib.collect_losses(loss_dict, cfg)
    return total, summaries, pred


def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
    """The training forward and the loss's gradient with respect to every
    parameter (zeros for one the loss does not reach, as JAX gives)."""
    total, summaries, _ = forward_loss(state, batch, train=True,
                                       generator=generator)
    grads = torch.autograd.grad(total, state.params, allow_unused=True,
                                materialize_grads=True)
    return total, summaries, list(grads)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the l2 norm of every gradient together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def train_step(state: TrainState, batch: Dict,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One train step in place (state.py:102-128); returns the metrics as
    0-d device tensors: the `total_*` losses, `grads_finite` and
    `grad_norm`.  The batch-norm statistics of the forward are kept and
    `step` advances even when the update is skipped."""
    batch = to_device(batch, state.device)
    _, summaries, grads = loss_and_grads(state, batch, generator)
    finite = state.tx.apply(state.params, grads, state.opt)
    state.step.add_(1)
    metrics = {k: v.detach() for k, v in summaries.items()}
    metrics["grads_finite"] = finite
    metrics["grad_norm"] = global_norm(grads)
    return metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(pred, metrics) in eval mode; nothing of the state changes
    (state.py:131-140)."""
    batch = to_device(batch, state.device)
    _, summaries, pred = forward_loss(state, batch, train=False)
    return pred, summaries


def make_train_step(config: NetworkConfig, *, jit: bool = True
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The train step as JAX builds it (state.py:102-128):
    `step(state, batch, generator=None) -> metrics`, `train_step`'s
    arguments and metrics.  With `jit` it is captured once a batch
    signature on the card and replayed (`compiled.py`; the batch is
    copied into the graph's buffers, the state is read and updated in
    place); on the CPU, and with `jit=False`, it is `train_step`.
    `config` is the states' (JAX's signature): the step reads
    `state.config`.  The captured step's `program` is its
    `compiled.Program`."""
    if not jit:
        return train_step
    program = compiled(train_step)

    def step(state: TrainState, batch: Dict,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        return program(state, to_device(batch, state.device), generator)

    step.program = program
    return step


def make_eval_step(config: NetworkConfig, *, jit: bool = True):
    """The eval step as JAX builds it (state.py:131-140):
    `step(state, batch) -> (pred, metrics)`, captured once a batch
    signature on the card with `jit`, else `eval_step`; `config` as in
    `make_train_step`."""
    if not jit:
        return eval_step
    program = compiled(eval_step)

    def step(state: TrainState, batch: Dict):
        return program(state, to_device(batch, state.device))

    step.program = program
    return step
