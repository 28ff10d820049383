"""The benchmark's reading of torch.profiler traces: a frozen copy of the
arithmetic of the port's `timing.py` (`device_profile`,
`device_events`), with the union of device intervals for busy and idle
time and the breakdown of a traced window.

A trace opens with one uncounted call, a few small kernels, a
synchronise and a pause (traces on an H100 have lost the kernels of
their first moments), then spin kernels mark on the card's own clock
where the counted calls begin and end; only the events between the
marks count, and the window is the time from the end of the first mark
to the start of the second.  A trace that lost a mark is retaken; one
that keeps nothing between its marks raises.
"""

from __future__ import annotations

import sys
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

PAD_OPS = 8
SETTLE_S = 0.05
MARK_CYCLES = 1000
RETAKES = 4
TOP = 10


def device_events(events) -> list:
    """The events of a trace that ran on the card, in start order; the
    ranges of user annotations are left out."""
    from torch.autograd import DeviceType
    return sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("kernel:")),
                  key=lambda e: e.time_range.start)


def host_spans(events) -> list:
    """The benchmark's own spans (record_function names "bench.*") that
    the trace recorded on the host: (name, start_us, end_us)."""
    from torch.autograd import DeviceType
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith("bench.")), key=lambda s: s[1])


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile(fn: Callable[[], object], iters: int) -> Dict:
    """Trace `iters` calls of fn between marks; returns {"events": the
    device events between the marks as (name, start_us, end_us),
    "spans": the benchmark's host spans inside the window, "window_us",
    "busy_us" (the union of the events), "iters", "wall_s" (host clock
    over the counted calls)}."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    pad = torch.zeros(1, device="cuda")
    for _ in range(1 + RETAKES):
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore",
                                    "Warning: Profiler clears events")
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                fn()
                for _ in range(PAD_OPS):
                    pad.add_(1)
                torch.cuda.synchronize()
                time.sleep(SETTLE_S)
                torch.cuda._sleep(MARK_CYCLES)
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                torch.cuda._sleep(MARK_CYCLES)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        events = prof.events()
        dev = device_events(events)
        marks = [i for i, e in enumerate(dev) if "spin" in e.name]
        if len(marks) == 2:
            break
        print(f"posebench: the trace kept {len(marks)} of its 2 marks; "
              "retaking it", file=sys.stderr, flush=True)
    if len(marks) != 2 or marks[1] == marks[0] + 1:
        raise RuntimeError("torch.profiler recorded no device activity "
                           "between its marks")
    lo = dev[marks[0]].time_range.end
    hi = dev[marks[1]].time_range.start
    ops = [(e.name, e.time_range.start, e.time_range.end)
           for e in dev[marks[0] + 1:marks[1]]]
    spans = [s for s in host_spans(events) if s[2] > lo and s[1] < hi]
    return {"events": ops, "spans": spans, "window_us": hi - lo,
            "busy_us": union_us([(s, e) for _, s, e in ops]),
            "iters": iters, "wall_s": wall, "lo_us": lo, "hi_us": hi}


def breakdown(window: Dict) -> Dict[str, list]:
    """The device operations that took most time in the window, and its
    longest idle gaps, each named by the benchmark span the host was in
    at the gap's middle (the innermost one; "no span" where none)."""
    by_name: Dict[str, float] = {}
    for name, s, e in window["events"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    cur = window["lo_us"]
    for s, e in sorted((s, e) for _, s, e in window["events"]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if window["hi_us"] > cur:
        gaps.append((cur, window["hi_us"]))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:TOP]:
        mid = (s + e) / 2
        inside = [sp for sp in window["spans"] if sp[1] <= mid <= sp[2]]
        name = (min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside
                else "no span")
        named.append([name, (e - s) / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": named}


def summary(window: Dict) -> Dict[str, float]:
    return {"busy_s": window["busy_us"] / 1e6,
            "window_s": window["window_us"] / 1e6}


def kernel_time_us(window: Dict, symbols) -> float:
    """Summed device time of the events whose name holds one of
    `symbols`."""
    return sum(e - s for name, s, e in window["events"]
               if any(sym in name for sym in symbols))


def busy_per_iter_ms(window: Optional[Dict]) -> Optional[float]:
    if window is None:
        return None
    return sum(e - s for _, s, e in window["events"]) / 1e3 / window["iters"]
