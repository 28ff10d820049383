"""The readings that a cell's limits are set from, at the cell's own
size, on the card: for each seed, the program's numbers and the
control's, and for a training cell the planted faults'.

    python3 posebench/control.py --workload <cell> --seeds 1 2 3 ...

The control is the reference put in the program's place and computed
in the nearest precision below the configuration's: for the bf16
served configuration, float8 (e4m3) products in the forward and TF32
in the fit (which the configuration runs in float32 with TF32 off);
for the float32 training configuration, TF32.  The planted faults of a
served cell are one cloud of the batch answered with another's heads
and a fifth of the points of every cloud answered so (`--arrays DIR`
keeps each side's per-cloud readings); that of a training cell is half
of the batch left out, the mean taken over the rest; a state left
unchanged reads 1 by the training measure and needs no run.  Each seed
prints one JSON line; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from posebench import compare, harness, served  # noqa: E402
from posebench.drivers import train_fused  # noqa: E402
from posebench.reference.train import Trainer  # noqa: E402
from posebench.traffic import generator  # noqa: E402


def one_cloud_wrong(heads: dict) -> dict:
    """A planted fault: the batch's first cloud answered with the
    second's heads."""
    out = {k: v.copy() for k, v in heads.items()}
    for v in out.values():
        v[0] = v[1]
    return out


def points_wrong(heads: dict, every: int = 5) -> dict:
    """A planted fault: every `every`-th point of each cloud answered
    with the same point of the next cloud (a fifth of every cloud)."""
    out = {k: v.copy() for k, v in heads.items()}
    for k, v in out.items():
        v[:, ::every] = np.roll(heads[k], 1, axis=0)[:, ::every]
    return out


# the percentiles whose per-cloud readings `--arrays` keeps
ARRAY_PERCENTILES = (50.0, 75.0, 90.0, 95.0, 99.0, 100.0)


def serve_readings(cell: harness.Cell, seed: int, device,
                   arrays: Optional[pathlib.Path] = None) -> dict:
    """An offline served cell's first batch of its ring, with the
    harness's draws, as a run makes them; with `arrays`, each side's
    `compare.cloud_gaps` at `ARRAY_PERCENTILES` go to
    `<arrays>/<cell>_<seed>.npz`."""
    config, mix, plan = cell.config, cell.traffic, cell.workload["run"]
    B = mix["batch"]
    clouds = generator.batches(harness.sub_seed(seed, "clouds"),
                               dict(mix, ring=1))[0]
    d = served.draws(config, B, harness.sub_seed(seed, "draws", 63), device)
    sd = served.state_dict(config, seed, device)
    models = served.judges(config, sd, device)
    predictor = served.program(config, sd, device)
    predictor(clouds, draws=served.port_draws(d))        # eager, capture
    res = predictor(clouds, draws=served.port_draws(d))  # replayed
    del predictor
    harness.free(device)
    heads, fits = served.result_arrays(res)
    block = plan["check_block"]
    out = {"program": served.judge(config, models, clouds, d, heads, fits,
                                   device, block)}
    ctl = served.reference_model(config, device, matmul="fp8")
    ctl.load_state_dict(sd)
    ctl_heads = served.reference_heads(ctl, clouds, device, block)
    fit = served.reference_fit(config, ctl_heads, clouds, d, device, B,
                               tf32=True)
    out["control"] = served.judge(config, models, clouds, d, ctl_heads, fit,
                                  device, block)
    ref = served.reference_heads(models[0], clouds, device, block)
    lower = served.reference_heads(models[1], clouds, device, block)
    sides = {"program": heads, "lower": lower, "control": ctl_heads,
             "one_cloud": one_cloud_wrong(heads),
             "points": points_wrong(heads)}
    for name in ("one_cloud", "points"):
        out[name] = {"heads_ratio": compare.heads_ratio(sides[name], ref,
                                                        lower)}
    if arrays is not None:
        arrays.mkdir(parents=True, exist_ok=True)
        np.savez(arrays / f"{cell.name}_{seed}.npz", **{
            f"{side}_q{q:g}": compare.cloud_gaps(h, ref, q)
            for side, h in sides.items() for q in ARRAY_PERCENTILES})
    return out


class HalfBatch(Trainer):
    """The reference with half of each batch left out: the forward, the
    batch statistics and the loss's mean over the rest."""

    def batch(self, step):
        full = super().batch(step)
        return {k: v[:len(v) // 2] for k, v in full.items()}


def train_readings(cell: harness.Cell, seed: int, device,
                   window_steps: int = 450) -> dict:
    """A training cell's numbers as a run makes them, the window
    `window_steps` steps long (a 20 s window holds ~450), and the
    control's and the half-batch fault's from the same states."""
    config = cell.config
    sd = train_fused.state_dict(config, seed, device)
    ref_trainer = train_fused.reference_trainer(config, seed, sd, device)
    names = ref_trainer.names
    params0 = [sd[n].detach().cpu().clone() for n in names]
    ref = train_fused.reference_steps(ref_trainer)
    state, fused, _ = train_fused.program(config, seed, sd, device)
    losses = []
    for step in range(train_fused.CHECKED_STEPS):
        losses.append(float(fused(state, step)["total_loss"]))
        if step == 0:
            grads = [m.cpu() / (1.0 - train_fused.B1) for m in state.opt.mu]
    prog = {"losses": losses, "grads": grads,
            "params": [p.detach().cpu() for p in state.params]}
    step = train_fused.CHECKED_STEPS
    for _ in range(window_steps):
        metrics = fused(state, step)
        step += 1
    late = train_fused.late_step(state, fused, step,
                                 [float(metrics["total_loss"])])
    prog["late"] = late
    del state, fused
    harness.free(device)
    ref["late_loss"] = train_fused.late_reference(ref_trainer, late)
    out = {"program": train_fused.numbers(prog, ref, params0)}
    ctl_trainer = train_fused.reference_trainer(config, seed, sd, device)
    ctl = train_fused.reference_steps(ctl_trainer, tf32=True)
    ctl["late"] = dict(late, loss=train_fused.late_reference(
        ctl_trainer, late, tf32=True))
    out["control"] = train_fused.numbers(ctl, ref, params0)
    half_trainer = train_fused.reference_trainer(config, seed, sd, device,
                                                 trainer=HalfBatch)
    half = train_fused.reference_steps(half_trainer)
    half["late"] = dict(late, loss=train_fused.late_reference(half_trainer,
                                                              late))
    out["half_batch"] = train_fused.numbers(half, ref, params0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="posebench/control.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--arrays", type=pathlib.Path, default=None,
                   help="a served cell's per-cloud readings go here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("posebench/control.py: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(args.workload)
    device = harness.card()
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.driver.startswith("serve"):
            out = serve_readings(cell, seed, device, args.arrays)
        else:
            out = train_readings(cell, seed, device)
        harness.free(device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
