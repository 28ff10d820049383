"""Device timing on the card: spin-queued CUDA events, the profiler's
device time and op count, the roofline bound of a kernel's work, the
card's name and power limit, and the command line of the sweep scripts
(`fps_sweep.py`, `bq_sweep.py`, `nn_sweep.py`) with its A/B runner,
which times several checkouts in turns.

Every function here needs a CUDA device and none falls back to the
host, but `synchronize` and `card_or_none`, which a timing tool run on
the CPU (`--device cpu`, the tests) calls, and which then measure
nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings
from typing import Callable, Optional, Tuple

import torch

MAX_SPIN_CYCLES = 1 << 28           # ~0.15-0.25 s of spin at H100 clocks
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# float32 outside the tensor cores, bf16 / fp16 on them, HBM3 bandwidth
F32_PEAK_FLOPS = 67e12
TENSOR_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# device_profile: the uncounted kernels and the pause between a trace's
# start and its counted calls, the spin kernels marking them (~0.5 us each
# at H100 clocks), and the retakes of a trace that lost a mark
PROFILE_PAD_OPS = 8
PROFILE_SETTLE_S = 0.05
PROFILE_MARK_CYCLES = 1000
PROFILE_RETAKES = 4


def cuda_time_ms(fn: Callable[[], object], reps: int = 20):
    """Time of one call of fn: (median ms over `reps` calls, each timed
    with CUDA events; True when that is device time only).

    Each call is queued behind a spin kernel, so the card opens the
    interval only after the host has enqueued all of fn: the host's
    launch cost (ctypes, allocation, Python) stays out of the reading.
    The spin doubles until the start event is still pending once fn is
    enqueued, i.e. until the host really stayed ahead.  A function of
    thousands of launches fills the card's launch queue, so the host
    waits on the card and cannot stay ahead whatever the spin: its
    calls are then timed without the spin, and the reading includes
    the host's launch time (second value False).
    """
    fn()
    torch.cuda.synchronize()
    times = []
    cycles = 1 << 20
    device_only = True
    for _ in range(reps):
        while True:
            if device_only:
                torch.cuda._sleep(cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            host_ahead = not start.query()
            end.synchronize()
            if host_ahead or not device_only:
                break
            if cycles < MAX_SPIN_CYCLES:
                cycles *= 2
            else:
                device_only = False
                times.clear()       # one kind of reading in the median
        times.append(start.elapsed_time(end))
    return statistics.median(times), device_only


def timing_note(device_only: bool) -> str:
    return "" if device_only else " (host-bound: includes launch time)"


def wall_ms(fn: Callable[[], object], iters: int) -> float:
    """Host-clock ms per call over `iters` calls, ending in a
    synchronise (fn is called once before, as a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_profile(fn: Callable[[], object], iters: int) -> Tuple[float, int]:
    """(device-busy ms, device ops) per call of fn, from torch.profiler
    over `iters` calls: the summed durations and the count of the
    events it records on the card (kernels, copies, memsets;
    `device_events`), the count rounded down, so an event the trace
    lost lowers it.

    Traces on an H100 have lost the kernels launched in their first
    moments (the first one or two, or all of a short trace), and put
    the card's events milliseconds off the host's.  So a trace opens
    with one uncounted call of fn and `PROFILE_PAD_OPS` small kernels, a
    synchronise and a pause of `PROFILE_SETTLE_S`; spin kernels
    (`torch.cuda._sleep`, which fn must not launch) then mark, on the
    card's own clock, where the counted calls begin and end, and only
    the events between the marks count.
    A trace that lost a mark is retaken, at most `PROFILE_RETAKES`
    times; then, as when nothing lies between the marks, it raises, so
    a trace that misses the card reads as a fault."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    for _ in range(1 + PROFILE_RETAKES):
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            # one profiling window: the warning about clearing events at
            # the end of each scheduled cycle does not apply
            warnings.filterwarnings("ignore",
                                    "Warning: Profiler clears events")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                for _ in range(PROFILE_PAD_OPS):
                    pad.add_(1)
                torch.cuda.synchronize()
                time.sleep(PROFILE_SETTLE_S)
                torch.cuda._sleep(PROFILE_MARK_CYCLES)
                for _ in range(iters):
                    fn()
                torch.cuda._sleep(PROFILE_MARK_CYCLES)
                torch.cuda.synchronize()
        dev = device_events(prof.events())
        marks = [i for i, e in enumerate(dev) if "spin" in e.name]
        if len(marks) == 2:
            break
        print(f"device_profile: the trace kept {len(marks)} of its 2 marks "
              f"({len(dev)} device events); retaking it", file=sys.stderr,
              flush=True)
    ops = dev[marks[0] + 1:marks[1]] if len(marks) == 2 else []
    if not ops:
        raise RuntimeError("torch.profiler recorded no device activity "
                           "between its marks")
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    return busy_us / 1e3 / iters, len(ops) // iters


def device_events(events) -> list:
    """The events of a trace that ran on the card (kernels, copies,
    memsets) in the order they started.  The ranges of user annotations
    (`CudaKernel.scope()`'s "kernel:<entry>", `record_function`) that
    the trace also places on the card's timeline are left out: each
    spans work that is counted already."""
    from torch.autograd import DeviceType

    return sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("kernel:")),
                  key=lambda e: e.time_range.start)


def roofline_ms(flops: float, nbytes: float) -> Tuple[float, float]:
    """(ms for `flops` float32 operations, ms for moving `nbytes` bytes)
    at the published peaks above; the larger is the least time the card
    could take for the work."""
    return flops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def require_card(device: Optional[str] = None) -> torch.device:
    """The CUDA device to measure on; raises when there is none."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} is not an available CUDA device")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queue; nothing on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_or_none(dev: torch.device) -> Optional[str]:
    """`card_line()` on a card; None for a CPU run, which measures none."""
    return card_line() if dev.type == "cuda" else None


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def run_arms(script: str, roots) -> list:
    """An A/B of several checkouts on one card: `python script --arm ROOT`
    once per root, in the order given (e.g. parent, new, new, parent).
    Each process imports ROOT's own package and prints its times as one
    JSON object on its last line; returns [{"root", "times"}] in order."""
    runs = []
    for root in roots:
        root = str(pathlib.Path(root).resolve())
        out = subprocess.run([sys.executable, script, "--arm", root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"arm {root} failed (rc {out.returncode}):\n"
                               f"{out.stderr}")
        times = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(dict(root=root, times=times))
        print(f"[ab] {root}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                           times.items()), flush=True)
    return runs


def sweep_main(argv, script: str, doc: str, sweep: Callable[[], list],
               arm: Callable[[], dict]) -> int:
    """The command line of a sweep script: the sweep (`sweep()`'s rows),
    `--ab ROOT ...` (`arm()` in one process per ROOT, `run_arms`), and
    `--out FILE` for the readings as JSON.  `--arm ROOT` is one such
    process: it drops this package from the module cache and puts ROOT
    first on sys.path, so that `arm()`'s imports load ROOT's package and
    build ROOT's kernels.  Without a CUDA device it exits 2."""
    name = pathlib.Path(script).stem
    p = argparse.ArgumentParser(prog=name, description=doc.split("\n\n")[0])
    p.add_argument("--ab", nargs="+", metavar="ROOT",
                   help="time the entries of each checkout, in order")
    p.add_argument("--arm", metavar="ROOT", help=argparse.SUPPRESS)
    p.add_argument("--out", help="write the readings here as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device", file=sys.stderr)
        return 2
    if args.arm:
        package = __name__.split(".")[0]
        for mod in [m for m in sys.modules if m.split(".")[0] == package]:
            del sys.modules[mod]
        sys.path.insert(0, str(pathlib.Path(args.arm).resolve()))
        print(json.dumps(arm()), flush=True)
        return 0
    result = {"card": card_line()}
    print(f"[card] {result['card']}", flush=True)
    if args.ab:
        result["ab"] = run_arms(script, args.ab)
    else:
        result["sweep"] = sweep()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    return 0
