"""Training on the card's own data: the port's fused synthetic step
(`data/device_synthetic.py::make_fused_synthetic_train_step`, each
step's batch drawn on the card and the step replayed as one captured
program) called as `e2e.py::run` calls it, from step 0 for the window,
the loss read on the host every `log_every` steps.

The fused step is built one step a call, and the window calls it
`steps_per_call` times between looks at the clock: a fused call of k
steps is k replays of the same program, each after the host reseeds the
generators, so the work on the card and on the host is e2e's, and the
first three steps can be read one by one.

End to end: `train_clouds_per_s`, steps × B over the window.  Traced:
the replayed steps with a host read (step device ms, idle share, MFU)
and the generator's draw called eagerly (datagen device ms).
`correct`: set-up drives the state through its first three steps by the
window's own call and keeps the first step's Adam moment, each step's
loss and the parameters after the third; after the window the
reference follows the same three steps from the same state dict, and
the losses, the first gradient's leaf norms and the three steps' change
of each leaf are compared.  The window's steps are held by the step
after it, made by the window's own call: the reference computes that
step's loss from the parameters the program reached (the card's steps
do not repeat bit for bit, so no reference follows 450 of them), and
every loss the window read has to be finite.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from posebench import compare, harness, tracing
from posebench.metrics import flops
from posebench.reference import precision
from posebench.reference import synthetic as ref_synthetic
from posebench.reference.model import ANCSH
from posebench.reference.train import TrainConfig, Trainer

CHECKED_STEPS = 3
B1 = 0.9


def seeds(seed: int) -> Dict[str, int]:
    return {"dropout": harness.sub_seed(seed, "dropout"),
            "category": harness.sub_seed(seed, "category"),
            "data": harness.sub_seed(seed, "data"),
            "weights": harness.sub_seed(seed, "weights")}


def reference_model(config: Dict, device) -> ANCSH:
    net = config["network"]
    return ANCSH(net["n_max_parts"], config["backbone"],
                 packed=net.get("ball_query_packed", False),
                 dropout_rate=net.get("dropout_rate", 0.5)).to(device)


def state_dict(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        template = reference_model(config, "meta")
    return harness.weights_from_seed(template, seeds(seed)["weights"],
                                     config["init"], device)


def program(config: Dict, seed: int, sd, device):
    """(TrainState, fused step, on-card generator) of the port."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.data.device_synthetic import (
        DeviceSynthetic, make_fused_synthetic_train_step)
    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.train.state import TrainState

    s = seeds(seed)
    gen = config["generator"]
    cfg = NetworkConfig(**config["network"], seed=s["dropout"])
    dg = DeviceSynthetic(SyntheticArticulated(
        n_parts=cfg.n_max_parts, points_per_part=gen["points_per_part"],
        joint_types=tuple(gen["joint_types"]), seed=s["category"],
        full_rotation=gen["full_rotation"]),
        num_points=cfg.num_points, noise=gen["noise"], device=device)
    model = build_model(cfg, device=device)
    model.load_state_dict(sd)
    state = TrainState(model, cfg)
    fused = make_fused_synthetic_train_step(cfg, dg, cfg.batch_size,
                                            steps_per_call=1, seed=s["data"])
    return state, fused, dg


def reference_trainer(config: Dict, seed: int, sd, device,
                      trainer=Trainer) -> Trainer:
    s = seeds(seed)
    net, gen = config["network"], config["generator"]
    dg = ref_synthetic.DeviceSynthetic(ref_synthetic.SyntheticArticulated(
        n_parts=net["n_max_parts"], points_per_part=gen["points_per_part"],
        joint_types=tuple(gen["joint_types"]), seed=s["category"],
        full_rotation=gen["full_rotation"]),
        num_points=net["num_points"], noise=gen["noise"], device=device)
    model = reference_model(config, device)
    model.load_state_dict(sd)
    keys = TrainConfig.__dataclass_fields__
    cfg = TrainConfig(**{k: v for k, v in net.items() if k in keys},
                      seed=s["dropout"])
    return trainer(model, cfg, dg, s["data"])


def reference_steps(trainer: Trainer, tf32: bool = False) -> Dict:
    """The reference's first three steps: each loss, the first step's
    gradient as Adam's first moment gives it, the parameters after."""
    losses = []
    with precision(tf32):
        for i in range(CHECKED_STEPS):
            losses.append(float(trainer.step()["loss"]))
            if i == 0:
                grads = [m / (1.0 - B1) for m in trainer.mu]
    return {"losses": losses, "grads": [g.cpu().clone() for g in grads],
            "params": [p.detach().cpu().clone() for p in trainer.params]}


def late_step(state, fused, step: int, window_losses: List[float]) -> Dict:
    """The step after the window, through the window's own call: its
    index, the parameters it starts from and its loss, and whether
    every loss the window read was finite."""
    params = [p.detach().clone() for p in state.params]
    loss = float(fused(state, step)["total_loss"])
    return {"step": step, "params": params, "loss": loss,
            "window_finite": all(math.isfinite(x) for x in window_losses)}


def late_reference(trainer: Trainer, late: Dict, tf32: bool = False
                   ) -> float:
    """The reference's loss of the late step from the program's
    parameters at that step (a state only the program has reached)."""
    with precision(tf32):
        return float(trainer.loss_at(late["step"], late["params"]))


def numbers(prog: Dict, ref: Dict, params0: List) -> Dict[str, float]:
    """The train numbers: the first three steps' losses, the first
    gradient, the three steps' change of each kept leaf and, where the
    program ran a window, the late step's loss (inf when a loss the
    window read was not finite)."""
    kept = compare.kept_leaves(ref["grads"])
    out = {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
           "grad_gap": compare.leaf_gap(prog["grads"], ref["grads"], kept),
           "update_gap": compare.leaf_gap(
               [p - q for p, q in zip(prog["params"], params0)],
               [p - q for p, q in zip(ref["params"], params0)], kept)}
    if "late" in prog:
        late = prog["late"]
        out["late_loss_gap"] = (
            compare.loss_gap([late["loss"]], [ref["late_loss"]])
            if late["window_finite"] else math.inf)
    return out


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> harness.Outcome:
    config, mix, plan = cell.config, cell.traffic, cell.workload["run"]
    device = harness.card(device)
    clock = harness.SetupClock(t_start, device)
    clock.mark("imports", wait=False)
    clock.mark("context")                     # the card's, made by a sync
    sd = state_dict(config, seed, device)
    clock.mark("weights")
    state, fused, dg = program(config, seed, sd, device)
    B = state.config.batch_size
    params0 = [p.detach().cpu().clone() for p in state.params]
    clock.mark("program")

    # set-up: the first steps by the window's own call (the first runs
    # eagerly and captures, the others replay), each read on the host
    losses = []
    for step in range(CHECKED_STEPS):
        losses.append(float(fused(state, step)["total_loss"]))
        if step == 0:
            grads = [m.cpu() / (1.0 - B1) for m in state.opt.mu]
            clock.mark("first_step")          # eager, then the capture
    prog = {"losses": losses, "grads": grads,
            "params": [p.detach().cpu().clone() for p in state.params]}
    setup_s = clock.mark("replays") - t_start

    step = CHECKED_STEPS
    read = []
    ends = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(mix["steps_per_call"]):
            metrics = fused(state, step)
            step += 1
            if step % mix["log_every"] == 0:
                read.append(float(metrics["total_loss"]))
        ends.append(time.perf_counter())
    read.append(float(metrics["total_loss"]))
    wall = time.perf_counter() - t0
    notes = [harness.spread_note(
        f"window calls of {mix['steps_per_call']} steps",
        np.diff([t0] + ends))]
    trained = step - CHECKED_STEPS
    e2e = {"train_clouds_per_s": trained * B / wall}
    prog["late"] = late_step(state, fused, step, read)

    trace_data = None
    if trace:
        trace_data = _trace(config, mix, plan, state, fused, dg, step + 1)
    peak = harness.memory_peak(device)
    del state, fused, dg
    harness.free(device)

    trainer = reference_trainer(config, seed, sd, device)
    ref = reference_steps(trainer)
    ref["late_loss"] = late_reference(trainer, prog["late"])
    return harness.Outcome(
        setup_s=setup_s, e2e=e2e, attempted=trained, failed=0,
        checks=harness.checks_of(numbers(prog, ref, params0), cell.limits),
        memory_peak_bytes=peak, trace=trace_data,
        setup_parts=clock.parts, notes=notes)


def _trace(config, mix, plan, state, fused, dg, step0: int) -> Dict:
    B, N = state.config.batch_size, state.config.num_points
    step = iter(range(step0, 10 ** 9))

    def call():
        for _ in range(mix["steps_per_call"]):
            with torch.profiler.record_function("bench.step"):
                metrics = fused(state, next(step))
        with torch.profiler.record_function("bench.read"):
            float(metrics["total_loss"])

    window = tracing.profile(call, plan["trace_calls"])
    steps = window["iters"] * mix["steps_per_call"]
    g = torch.Generator(device=dg.device).manual_seed(0)
    datagen = tracing.profile(lambda: dg.sample_batch(g, B), 3)
    return {"kind": "train", "window": window, "datagen": datagen,
            "steps": steps, "clouds_per_s": steps * B / window["wall_s"],
            "train_flops_per_cloud": 3 * flops.forward_flops(
                config["backbone"], state.config.n_max_parts, 1, N),
            "peak_flops": flops.F32_PEAK_FLOPS,
            "breakdown": tracing.breakdown(window),
            **tracing.summary(window)}
