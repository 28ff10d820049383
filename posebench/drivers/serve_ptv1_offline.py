"""Offline serving of ANCSH on the Point Transformer backbone: one caller
in a closed loop calls `PosePredictor.__call__` back to back on full
batches from a ring of distinct batches, each with its own RANSAC
draws, for the window, as `serve_offline` does for the PointNet++
configuration.

Its own here, where `served.py` is bound to the PointNet++ reference:
the state dict (`state_dict`: drawn from the seed, then every batch
norm's running statistics set to its input's over `run.bn_clouds`
clouds of the cell's traffic, as a trained model's track its data),
the reference models (`judges`, `reference/point_transformer.py`) and
the trace.  The rest is `served.py`'s, `compare.py`'s and the traffic
generator's.

`setup_s` leaves out the batch-norm calibration: it is the reference's
work, standing in for loading trained weights, and no deployment runs
it.  Its seconds are reported as the set-up part `bn_calibration`.

End to end: `clouds_per_s`.  Traced: the replayed calls (idle share,
the `knn` kernel's roofline, the FPS and 3-NN kernels' roofline, the
step's MFU), the stage marks of
`trace_calls` replayed calls (the attention's device ms), the
backbone's `grouped_bytes` counter, the model called eagerly (forward
device ms) and the fit called eagerly on its outputs (fit device ms and
ops).  `correct`: a sample of the window's calls, drawn from the seed,
judged by `served.judge` against the reference run `check_block` clouds
at a time.

`readings(cell, seed, device)` gives the numbers the cell's limits are
set from: the program's, the float8 control's, a TF32 fit's and two
planted faults' (`posebench/control_ptv1.py` prints them).
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from posebench import compare, harness, served, tracing
from posebench.metrics import flops, flops_ptv1, work_knn
from posebench.reference import precision
from posebench.reference.point_transformer import ANCSHPointTransformer
from posebench.traffic import generator


def reference_model(config: Dict, device, matmul: str = "f32"
                    ) -> ANCSHPointTransformer:
    return ANCSHPointTransformer(
        config["network"]["n_max_parts"], config["point_transformer"],
        dropout_rate=config["network"].get("dropout_rate", 0.5),
        matmul=matmul).to(device)


@torch.no_grad()
def state_dict(config: Dict, mix: Dict, plan: Dict, seed: int, device,
               clock: harness.SetupClock = None) -> Dict[str, torch.Tensor]:
    """The weights of this run: drawn on the device from the seed
    (`harness.weights_from_seed` under the configuration's `init`),
    then each batch norm's running statistics set to the batch
    statistics of its input over `plan["bn_clouds"]` clouds of the
    traffic's distribution, drawn from the seed: one float32 forward of
    the reference in training mode at momentum 0, dropout off.  `clock`
    marks `weights` after the draw and `bn_calibration` after the
    calibration."""
    with torch.device("meta"):
        template = reference_model(config, "meta")
    sd = harness.weights_from_seed(template, harness.sub_seed(seed, "weights"),
                                   config["init"], device)
    if clock is not None:
        clock.mark("weights")
    model = reference_model(config, device)
    model.load_state_dict(sd)
    clouds = generator.batches(harness.sub_seed(seed, "bn"), dict(
        mix, ring=1, batch=plan["bn_clouds"]))[0]
    model.train()
    # dropout follows these two modules' own flags; batch norm its own
    model.backbone.training = False
    model.joint_net.training = False
    with precision(False):
        model(torch.as_tensor(clouds, device=device), bn_momentum=0.0)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if clock is not None:
        # the peak is the program's: the calibration over bn_clouds
        # clouds is no part of what a deployment holds
        del model
        harness.free(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        clock.mark("bn_calibration")
    return sd


def judges(config: Dict, sd: Dict[str, torch.Tensor], device
           ) -> Tuple[ANCSHPointTransformer, ANCSHPointTransformer]:
    """The reference in float32 and in bf16 rounding, holding `sd`."""
    out = []
    for matmul in ("f32", "bf16"):
        m = reference_model(config, device, matmul)
        m.load_state_dict(sd)
        out.append(m)
    return tuple(out)


def port_config(config: Dict):
    """The port's NetworkConfig of the configuration: a port that lacks
    one of its keys raises here, before the weights are drawn."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    return NetworkConfig(**config["network"])


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> harness.Outcome:
    """One run of the cell; `device` is the card but for the CPU tests,
    which run it untraced at tiny widths."""
    config, mix, plan = cell.config, cell.traffic, cell.workload["run"]
    device = harness.card(device)
    clock = harness.SetupClock(t_start, device)
    port_config(config)
    clock.mark("imports", wait=False)
    clock.mark("context")
    B = mix["batch"]
    sd = state_dict(config, mix, plan, seed, device, clock)
    predictor = served.program(config, sd, device)
    clock.mark("program")
    ring = generator.batches(harness.sub_seed(seed, "clouds"), mix)
    draw_seed = harness.sub_seed(seed, "draws", 63)
    ring_draws = [served.draws(config, B, draw_seed + i, device)
                  for i in range(len(ring))]
    port_draws = [served.port_draws(d) for d in ring_draws]
    clock.mark("traffic")

    def call(i: int):
        return predictor(ring[i], draws=port_draws[i])

    call(0)                                   # eager, then the capture
    clock.mark("first_call")
    for i in range(1, plan["warm_calls"]):    # replays
        call(i % len(ring))
    setup_s = (clock.mark("replays") - t_start
               - clock.parts["bn_calibration"])

    sample = served.Reservoir(plan["checked_calls"], np.random.default_rng(
        harness.sub_seed(seed, "sample")))
    n = 0
    ends = []
    t0 = time.perf_counter()
    while True:
        i = n % len(ring)
        sample.offer(n, (i, call(i)))
        n += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    wall = ends[-1] - t0
    e2e = {"clouds_per_s": n * B / wall}
    notes = [harness.spread_note("window calls", np.diff([t0] + ends)),
             "setup_s leaves out bn_calibration (the reference's work): "
             f"{clock.parts['bn_calibration']:.3f} s"]

    trace_data = None
    if trace:
        trace_data = _trace(config, mix, plan, predictor, ring, port_draws,
                            call, device)
        notes.append("stage ms of the last replayed call: " + ", ".join(
            f"{k} {v:.4f}" for k, v in trace_data["stage_ms"][-1].items()))
    peak = harness.memory_peak(device)
    del predictor, port_draws, call
    harness.free(device)

    models = judges(config, sd, device)
    numbers = []
    for _, (i, res) in sorted(sample.items, key=lambda x: x[0]):
        heads, fits = served.result_arrays(res)
        numbers.append(served.judge(config, models, ring[i], ring_draws[i],
                                    heads, fits, device, plan["check_block"]))
    return harness.Outcome(
        setup_s=setup_s, e2e=e2e, attempted=n * B, failed=0,
        checks=harness.checks_of(served.worst(numbers), cell.limits),
        memory_peak_bytes=peak, trace=trace_data,
        setup_parts=clock.parts, notes=notes)


def _trace(config, mix, plan, predictor, ring, port_draws, call, device
           ) -> Dict:
    from articulated_pose_tpu_torch.pose.pipeline import fit_frame_batch

    B, N = mix["batch"], mix["points"]
    widths = config["point_transformer"]
    slot = iter(range(10 ** 9))

    def replayed():
        with torch.profiler.record_function("bench.call"):
            call(next(slot) % len(ring))

    window = tracing.profile(replayed, plan["trace_calls"])
    stage_ms = []
    for i in range(plan["trace_calls"]):
        call(i % len(ring))
        stage_ms.append(predictor.stage_ms())
    grouped = getattr(predictor.model.backbone, "grouped_bytes", None)
    P = torch.as_tensor(ring[0], device=device)
    with torch.no_grad():
        fwd = tracing.profile(lambda: predictor.model(P), 2)
        pred = predictor.model(P)
        heads = {k: pred[k] for k in served.POSE_KEYS}
        fit = tracing.profile(lambda: fit_frame_batch(
            heads, P, port_draws[0], predictor.pose_cfg), 2)
    calls = window["iters"]
    return {"kind": "serve", "window": window, "forward": fwd, "fit": fit,
            "clouds_per_s": calls * B / window["wall_s"],
            "forward_flops_per_cloud": flops_ptv1.forward_flops(
                widths, config["network"]["n_max_parts"], 1, N),
            "peak_flops": flops.BF16_PEAK_FLOPS,
            "knn_floor_us": calls * work_knn.forward_floor_us(widths, B, N),
            "kernel_floor_us": calls * work_knn.point_kernels_floor_us(
                widths, B, N),
            "stage_ms": stage_ms, "grouped_bytes": grouped, "batch": B,
            "breakdown": tracing.breakdown(window),
            **tracing.summary(window)}


def readings(cell: harness.Cell, seed: int, device) -> Dict:
    """The first batch of the cell's ring with the harness's draws, as a
    run makes them: the program's numbers, the control's (the reference
    with float8 products in the forward and TF32 in the fit), a TF32
    fit's (the reference's fit in TF32 on the program's heads, the fit
    one precision below the float32 the configuration states) and two
    planted faults' (`control.py`'s: one cloud answered with another's
    heads, a fifth of every cloud's points so answered); and each head's
    5th, 50th and 95th percentiles over the program's batch."""
    from posebench.control import one_cloud_wrong, points_wrong

    config, mix, plan = cell.config, cell.traffic, cell.workload["run"]
    B = mix["batch"]
    clouds = generator.batches(harness.sub_seed(seed, "clouds"),
                               dict(mix, ring=1))[0]
    d = served.draws(config, B, harness.sub_seed(seed, "draws", 63), device)
    sd = state_dict(config, mix, plan, seed, device)
    models = judges(config, sd, device)
    predictor = served.program(config, sd, device)
    predictor(clouds, draws=served.port_draws(d))        # eager, capture
    res = predictor(clouds, draws=served.port_draws(d))  # replayed
    del predictor
    harness.free(device)
    heads, fits = served.result_arrays(res)
    block = plan["check_block"]
    out = {"program": served.judge(config, models, clouds, d, heads, fits,
                                   device, block)}
    ctl = reference_model(config, device, matmul="fp8")
    ctl.load_state_dict(sd)
    ctl_heads = served.reference_heads(ctl, clouds, device, block)
    fit = served.reference_fit(config, ctl_heads, clouds, d, device, B,
                               tf32=True)
    out["control"] = served.judge(config, models, clouds, d, ctl_heads, fit,
                                  device, block)
    fit = served.reference_fit(config, heads, clouds, d, device, B,
                               tf32=True)
    out["tf32_fit"] = served.judge(config, models, clouds, d, heads, fit,
                                   device, block)
    ref = served.reference_heads(models[0], clouds, device, block)
    lower = served.reference_heads(models[1], clouds, device, block)
    for name, fault in (("one_cloud", one_cloud_wrong),
                        ("points", points_wrong)):
        out[name] = {"heads_ratio": compare.heads_ratio(fault(heads), ref,
                                                        lower)}
    out["head_percentiles"] = {
        k: np.percentile(heads[k], [5, 50, 95]).round(4).tolist()
        for k in compare.HEADS}
    return out
