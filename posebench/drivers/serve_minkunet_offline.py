"""Offline serving of ANCSH on the MinkUNet34C backbone: one caller in a
closed loop calls `PosePredictor.__call__` back to back on full batches
from a ring of distinct batches, each with its own RANSAC draws, for
the window, as `serve_ptv3_offline` does for Point Transformer V3.  The
predictor runs this backbone's forward eagerly and replays the fit
(`serving.fit_heads`).

Its own here: the state dict (`state_dict`: drawn from the seed, then
every batch norm's running statistics set to its input's over
`run.bn_clouds` clouds of the cell's traffic), the reference models
(`judges`, `reference/minkunet.py`), the structure's judgement
(`structure_gap`: each stride's per-cloud counts and its 3³ map's pairs,
exact) and the trace.  The window's loop, the draws, the heads' and the
fit's judgement are `served.py`'s and `compare.py`'s; `setup_s` leaves
out the batch-norm calibration, the reference's work, as
`serve_ptv3_offline` does.

End to end: `clouds_per_s`.  Traced: the served calls (idle share, the
step's MFU from the FLOPs of what the traced forward held,
`flops_minkunet.py`), the device time of the spans of `trace_calls`
calls profiled one at a time with each call's convolution floors
(`work_minkunet.py`), the backbone's `host_syncs`, the model called
eagerly (forward device ms) and the fit called eagerly on its outputs
(fit device ms and ops).  `correct`: a sample of the window's calls,
drawn from the seed, judged by `served.judge` against the reference
run `check_block` clouds at a time, and the structure each of them
planned against the reference's (`structure_gap`).

`readings(cell, seed, device)` gives the numbers the cell's limits are
set from (`posebench/control_minkunet.py` prints them).
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

from posebench import compare, harness, served, tracing
from posebench.drivers.serve_ptv1_offline import port_config
from posebench.drivers.serve_ptv3_offline import _differ, _grouped
from posebench.metrics import flops, flops_minkunet, work_minkunet
from posebench.reference import minkunet as ref
from posebench.reference import precision
from posebench.traffic import generator

COUNTERS = ("level_points", "conv_pairs", "stem_pairs", "host_syncs")


def reference_model(config: Dict, device, matmul: str = "f32"
                    ) -> ref.ANCSHMinkUNet:
    return ref.ANCSHMinkUNet(
        config["network"]["n_max_parts"], config["minkunet"],
        dropout_rate=config["network"].get("dropout_rate", 0.5),
        matmul=matmul).to(device)


@torch.no_grad()
def state_dict(config: Dict, mix: Dict, plan: Dict, seed: int, device,
               clock: harness.SetupClock = None) -> Dict[str, torch.Tensor]:
    """The weights of this run: drawn on the device from the seed, then
    each batch norm's running statistics set to the batch statistics of
    its input over `plan["bn_clouds"]` clouds of the traffic's
    distribution drawn from the seed: one float32 forward of the
    reference in training mode at momentum 0, dropout off.  `clock`
    marks `weights` and `bn_calibration`."""
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
        del model
        harness.free(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        clock.mark("bn_calibration")
    return sd


def judges(config: Dict, sd: Dict[str, torch.Tensor], device):
    """The reference in float32 and in bf16 rounding, holding `sd`."""
    out = []
    for matmul in ("f32", "bf16"):
        m = reference_model(config, device, matmul)
        m.load_state_dict(sd)
        out.append(m)
    return tuple(out)


def structure_gap(program: Sequence[Dict], reference: Sequence) -> int:
    """Per-cloud counts and 3³ map pairs in which the program's strides
    (the backbone's `structure`) and the reference's
    (`reference.minkunet.structure`) differ; a stride one side lacks
    counts its every entry."""
    gap = 0
    for p, r in zip(program, reference):
        gap += _differ(p["counts"], r.counts) + int(int(p["pairs"])
                                                    != r.pairs(3))
    gap += sum(len(p["counts"]) + 1 for p in program[len(reference):])
    gap += sum(len(r.counts) + 1 for r in reference[len(program):])
    return gap


def judge(config: Dict, models, clouds: np.ndarray, d, heads, fits,
          program_structure, device, block: int) -> Dict:
    """`served.judge`'s numbers and the structure's gap."""
    out = served.judge(config, models, clouds, d, heads, fits, device, block)
    strides, _, _ = ref.structure(torch.as_tensor(clouds, device=device),
                                  config["minkunet"])
    out["structure_gap"] = structure_gap(program_structure, strides)
    return out


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
    backbone = predictor.model.backbone
    clock.mark("program")
    ring = generator.batches(harness.sub_seed(seed, "clouds"), mix)
    draw_seed = harness.sub_seed(seed, "draws", 63)
    ring_draws = [served.draws(config, B, draw_seed + i, device)
                  for i in range(len(ring))]
    port_draws = [served.port_draws(d) for d in ring_draws]
    clock.mark("traffic")

    def call(i: int):
        res = predictor(ring[i], draws=port_draws[i])
        return res, backbone.structure

    call(0)                              # the fit's eager run and capture
    clock.mark("first_call")
    for i in range(1, plan["warm_calls"]):
        call(i % len(ring))
    captures = predictor._programs[0].captures
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
             f"{clock.parts['bn_calibration']:.3f} s",
             f"captures in the window: "
             f"{predictor._programs[0].captures - captures}",
             "voxels of the last call: "
             f"{backbone.level_points}, host reads {backbone.host_syncs}"]

    trace_data = None
    if trace:
        trace_data = _trace(config, mix, plan, predictor, ring, port_draws,
                            call, device)
        notes.append("span ms of the last profiled call: " + ", ".join(
            f"{k} {v:.4f}" for k, v in _grouped(
                trace_data["minkunet_span_ms"][-1]).items()))
    peak = harness.memory_peak(device)
    del predictor, backbone, port_draws, call
    harness.free(device)

    models = judges(config, sd, device)
    numbers = []
    for _, (i, (res, structure)) in sorted(sample.items, key=lambda x: x[0]):
        heads, fits = served.result_arrays(res)
        numbers.append(judge(config, models, ring[i], ring_draws[i], heads,
                             fits, structure, device, plan["check_block"]))
    return harness.Outcome(
        setup_s=setup_s, e2e=e2e, attempted=n * B, failed=0,
        checks=harness.checks_of(served.worst(numbers), cell.limits),
        memory_peak_bytes=peak, trace=trace_data,
        setup_parts=clock.parts, notes=notes)


def span_device_ms(fn) -> Dict[str, float]:
    """{span name: device ms} of one call of fn under torch.profiler: the
    device time of the kernels launched inside each "minkunet.*" span
    (torch.profiler links each kernel to the operator that launched
    it), summed over the spans of one name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(tracing.PAD_OPS):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(tracing.SETTLE_S)
        fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("minkunet."):
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / 1e3
    return out


def _trace(config, mix, plan, predictor, ring, port_draws, call, device
           ) -> Dict:
    from articulated_pose_tpu_torch.pose.pipeline import fit_frame_batch

    B, N = mix["batch"], mix["points"]
    widths = config["minkunet"]
    backbone = predictor.model.backbone
    slot = iter(range(10 ** 9))

    def served_call():
        with torch.profiler.record_function("bench.call"):
            call(next(slot) % len(ring))

    window = tracing.profile(served_call, plan["trace_calls"])
    calls = window["iters"]
    spans, floors = [], []
    for i in range(plan["trace_calls"]):
        spans.append(span_device_ms(lambda i=i: call(i % len(ring))))
        floors.append(work_minkunet.forward_floor_us(
            widths, {k: getattr(backbone, k) for k in COUNTERS}))
    counters = {k: getattr(backbone, k) for k in COUNTERS}
    P = torch.as_tensor(ring[0], device=device)
    with torch.no_grad():
        fwd = tracing.profile(lambda: predictor.model(P), 2)
        pred = predictor.model(P)
        heads = {k: pred[k] for k in served.POSE_KEYS}
        fit = tracing.profile(lambda: fit_frame_batch(
            heads, P, port_draws[0], predictor.pose_cfg), 2)
    return {"kind": "serve", "window": window, "forward": fwd, "fit": fit,
            "clouds_per_s": calls * B / window["wall_s"],
            "forward_flops_per_cloud": flops_minkunet.forward_flops(
                widths, config["network"]["n_max_parts"], counters,
                B * N) / B,
            "peak_flops": flops.BF16_PEAK_FLOPS,
            "minkunet_span_ms": spans, "minkunet_conv_floor_us": floors,
            "minkunet_host_syncs": counters["host_syncs"],
            "counters": counters, "batch": B,
            "breakdown": tracing.breakdown(window),
            **tracing.summary(window)}


def readings(cell: harness.Cell, seed: int, device) -> Dict:
    """The first batch of the cell's ring with the harness's draws, as a
    run makes them: the program's numbers, the control's (the reference
    with float8 products in the forward and TF32 in the fit), a TF32
    fit's (the reference's fit in TF32 on the program's heads) and one
    planted fault's (one cloud answered with another's heads and
    structure); each head's 5th, 50th and 95th percentiles over the
    program's batch, and the strides' voxel counts."""
    from posebench.control import one_cloud_wrong

    config, mix, plan = cell.config, cell.traffic, cell.workload["run"]
    B = mix["batch"]
    clouds = generator.batches(harness.sub_seed(seed, "clouds"),
                               dict(mix, ring=1))[0]
    d = served.draws(config, B, harness.sub_seed(seed, "draws", 63), device)
    sd = state_dict(config, mix, plan, seed, device)
    predictor = served.program(config, sd, device)
    predictor(clouds, draws=served.port_draws(d))        # eager, capture
    res = predictor(clouds, draws=served.port_draws(d))  # the fit replayed
    structure = predictor.model.backbone.structure
    level_points = predictor.model.backbone.level_points
    del predictor
    harness.free(device)
    models = judges(config, sd, device)
    heads, fits = served.result_arrays(res)
    block = plan["check_block"]
    out = {"program": judge(config, models, clouds, d, heads, fits,
                            structure, device, block)}
    ctl = reference_model(config, device, "fp8")
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
    ref_heads = served.reference_heads(models[0], clouds, device, block)
    lower = served.reference_heads(models[1], clouds, device, block)
    wrong = clouds.copy()
    wrong[0] = clouds[1]
    strides, _, _ = ref.structure(torch.as_tensor(wrong, device=device),
                                  config["minkunet"])
    out["one_cloud"] = {
        "heads_ratio": compare.heads_ratio(one_cloud_wrong(heads), ref_heads,
                                           lower),
        "structure_gap": structure_gap(structure, strides)}
    out["head_percentiles"] = {
        k: np.percentile(heads[k], [5, 50, 95]).round(4).tolist()
        for k in compare.HEADS}
    out["level_points"] = level_points
    return out
