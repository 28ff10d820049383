"""Stage-level profile of the train step on the card.

    python -m articulated_pose_tpu_torch.profile_train_stages [--batch 32]
        [--points 1024] [--iters 32] [--category eyeglasses]

Counterpart of scripts/profile_train_stages.py, with its five stages in
its order, under its labels, at its defaults (the e2e recipe: B=32,
N=1024, f32, reference widths, the category's on-card generator):

- `data gen`: one batch of `DeviceSynthetic` draws and frames, the
  generator reseeded from the call's count as the fused step reseeds it;
- `fwd+loss (no grad)`: `train.state.forward_loss` in training mode on a
  fixed batch, no gradient;
- `grad`: `loss_and_grads` on that batch;
- `grad+update (fixed batch)`: `train_step` on that batch;
- `fused step (e2e program)`: `make_fused_synthetic_train_step`, one
  step a call (generate, differentiate, update), run eagerly
  (`jit=False`) so that the profiler sees its ops.

The dropout masks of call i come from `dropout_generator(seed, i)`, as
the trainer's step i.  JAX perturbed its inputs through a scan carry so
that XLA could not hoist them out of the window; eager PyTorch hoists
nothing, so the batch stays fixed.  Each stage is measured as
`profile_stages` measures one (`profile_stages.measure_row`): wall ms
on the host clock around a synchronised window, device ms and device
ops from torch.profiler, the idle share, clouds/s and the port's kernel
launches a call.  The stages train the one state on: the measurement
does not depend on its weights.

`--device cpu` (with `run(spec=...)` at tiny widths) is for the tests:
host-clock times only, the device columns "not measured".  Without a
card, and unless `--device cpu` is given, it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from articulated_pose_tpu_torch import profile_stages, timing
from articulated_pose_tpu_torch.data.device_synthetic import (
    DeviceSynthetic, data_seed, make_fused_synthetic_train_step)
from articulated_pose_tpu_torch.programs import resolve_device, train_setup
from articulated_pose_tpu_torch.train.state import (TrainState,
                                                    dropout_generator,
                                                    forward_loss,
                                                    loss_and_grads,
                                                    train_step)

STAGES = ("data gen", "fwd+loss (no grad)", "grad",
          "grad+update (fixed batch)", "fused step (e2e program)")
DATA_SEED = 2           # the data-gen stage's stream, apart from the fused


def stage_fns(state: TrainState, batch: Dict[str, torch.Tensor],
              dg: Optional[DeviceSynthetic] = None
              ) -> Dict[str, Callable[[], object]]:
    """label -> fn of the five stages on `state`, the fixed `batch`, and
    `dg` (the generator of `data gen` and the fused step; without it
    those two are left out).  Each fn counts its calls: call i draws
    dropout masks i (and, for the generator, batch i)."""
    cfg = state.config
    B = batch["P"].shape[0]
    drop = torch.Generator(device=state.device)
    calls = dict.fromkeys(STAGES, 0)

    def counted(label: str, fn: Callable[[int], object]):
        def call():
            i = calls[label]
            calls[label] = i + 1
            return fn(i)
        return call

    fns = {}
    if dg is not None:
        data = torch.Generator(device=dg.device)
        fns[STAGES[0]] = counted(STAGES[0], lambda i: dg.sample_batch(
            data.manual_seed(data_seed(DATA_SEED, i)), B))

    def fwd_loss(i):
        with torch.no_grad():
            return forward_loss(state, batch, train=True,
                                generator=dropout_generator(
                                    drop, cfg.seed, i))[0]

    fns[STAGES[1]] = counted(STAGES[1], fwd_loss)
    fns[STAGES[2]] = counted(STAGES[2], lambda i: loss_and_grads(
        state, batch, dropout_generator(drop, cfg.seed, i)))
    fns[STAGES[3]] = counted(STAGES[3], lambda i: train_step(
        state, batch, dropout_generator(drop, cfg.seed, i)))
    if dg is not None:
        fused = make_fused_synthetic_train_step(cfg, dg, B, jit=False)
        fns[STAGES[4]] = counted(STAGES[4], lambda i: fused(state, i))
    return fns


def run(batch: int = 32, points: int = 1024, iters: int = 32,
        category: str = "eyeglasses", device: str = "cuda",
        spec=None) -> List[dict]:
    """Profile the five stages with the backbone `spec` (the reference
    widths by default); print the table and one JSON line; return the
    rows."""
    dev = resolve_device(device, "profile_train_stages")
    state, batch0, dg = train_setup(batch, points, dev, spec, category)
    fns = stage_fns(state, batch0, dg)
    print(f"{'stage':<28s} {'wall ms':>10s} {'device ms':>10s} "
          f"{'dev ops':>8s} {'idle':>6s} {'clouds/s':>10s}  launches/iter",
          flush=True)
    rows = []
    for label in STAGES:
        rows.append(profile_stages.measure_row(label, label, fns[label],
                                               iters, batch, dev, width=28))
    print(json.dumps(dict(tool="profile_train_stages",
                          card=timing.card_or_none(dev), device=str(dev),
                          batch=batch, points=points, iters=iters,
                          category=category, rows=rows)), flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--category", default="eyeglasses")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the tests")
    args = ap.parse_args(argv)
    run(args.batch, args.points, args.iters, args.category, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
