"""Offline serving: one caller in a closed loop calls
`PosePredictor.__call__` back to back on full batches from a ring of
distinct batches, each with its own RANSAC draws, for the window.

End to end: `clouds_per_s`, every cloud answered on the host (a
`PoseResult` returned) over the window.  Traced: the replayed calls
(idle share, the kernels' roofline, the step's MFU), the predictor's
model called eagerly on the window's batch shape (forward device ms)
and the fit called eagerly on its outputs (fit device ms and ops).
`correct`: a sample of the window's calls, drawn from the seed, judged
by `served.judge`.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from posebench import harness, served, tracing
from posebench.metrics import flops, work
from posebench.reference import ops as ref_ops
from posebench.traffic import generator


def _scanned(config: Dict, clouds: np.ndarray, device) -> Dict[str, int]:
    """The (query, point) pairs the two first-S ball queries examine for
    these clouds, from the reference's plain FPS and ball query."""
    b = config["backbone"]
    xyz = torch.as_tensor(clouds, device=device)
    _, x1, _, x2 = ref_ops.fps2(xyz, *b["sa_npoints"])
    out = {}
    for name, (pts, q, r, S) in {
            "sa1": (xyz, x1, b["sa_radii"][0], b["sa_nsamples"][0]),
            "sa2": (x1, x2, b["sa_radii"][1], b["sa_nsamples"][1])}.items():
        idx, cnt = ref_ops.query_ball_point(r, S, pts, q)
        out[name] = work.scanned_points(idx, cnt, pts.shape[1])[0]
    return out


def kernel_work(config: Dict, B: int, N: int, scanned: Dict[str, int]
                ) -> work.Work:
    """The work of one call's FPS, ball-query and 3-NN kernels."""
    b = config["backbone"]
    n1, n2 = b["sa_npoints"]
    packed = config["network"]["ball_query_packed"]
    return (work.fps2_work(B, N, n1, n2)
            + work.ball_query_work(packed, B, N, n1, b["sa_nsamples"][0],
                                   False, scanned["sa1"])
            + work.ball_query_work(packed, B, n1, n2, b["sa_nsamples"][1],
                                   True, scanned["sa2"])
            + work.three_nn_work(B, n1, n2) + work.three_nn_work(B, N, n1))


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> harness.Outcome:
    """One run of the cell; `device` is the card but for the CPU tests,
    which run it untraced at tiny widths."""
    config, mix, plan = cell.config, cell.traffic, cell.workload["run"]
    device = harness.card(device)
    clock = harness.SetupClock(t_start, device)
    clock.mark("imports", wait=False)
    clock.mark("context")                     # the card's, made by a sync
    B, N = mix["batch"], mix["points"]
    sd = served.state_dict(config, seed, device)
    clock.mark("weights")
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
    setup_s = clock.mark("replays") - t_start

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
    notes = [harness.spread_note("window calls", np.diff([t0] + ends))]

    trace_data = None
    if trace:
        trace_data = _trace(config, mix, plan, predictor, ring, port_draws,
                            call, device)
    peak = harness.memory_peak(device)
    del predictor, port_draws, call
    harness.free(device)

    models = served.judges(config, sd, device)
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
    slot = iter(range(10 ** 9))

    def replayed():
        with torch.profiler.record_function("bench.call"):
            call(next(slot) % len(ring))

    window = tracing.profile(replayed, plan["trace_calls"])
    P = torch.as_tensor(ring[0], device=device)
    with torch.no_grad():
        fwd = tracing.profile(lambda: predictor.model(P), 2)
        pred = predictor.model(P)
        heads = {k: pred[k] for k in served.POSE_KEYS}
        fit = tracing.profile(lambda: fit_frame_batch(
            heads, P, port_draws[0], predictor.pose_cfg), 2)
    calls = window["iters"]
    # the counted calls are slots 1..calls (the trace's first is not)
    floor_us = sum(kernel_work(config, B, N, _scanned(
        config, ring[s % len(ring)], device)).floor_us()
        for s in range(1, calls + 1))
    return {"kind": "serve", "window": window, "forward": fwd, "fit": fit,
            "clouds_per_s": calls * B / window["wall_s"],
            "forward_flops_per_cloud": flops.forward_flops(
                config["backbone"], config["network"]["n_max_parts"], 1, N),
            "peak_flops": flops.BF16_PEAK_FLOPS,
            "kernel_floor_us": floor_us,
            "breakdown": tracing.breakdown(window),
            **tracing.summary(window)}
