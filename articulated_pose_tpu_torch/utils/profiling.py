"""Profiling / tracing utilities: counterpart of
`articulated_pose_tpu/utils/profiling.py`.

`trace` records a block with torch.profiler (host ops and, on the card,
its kernels and copies) and writes a Chrome trace into `log_dir`.  The
program names its host work there with `span` ranges: each hand-written
kernel's launch ("kernel:<entry>", `ops/kernels/build.py`), the served
call's parts ("predictor.*", `serving.py`), a compiled program's capture
and replay ("program.*", `compiled.py`) and the fused train step's
reseed ("fused.reseed").  A replay runs no Python, so the stages inside
a captured program are marked by `stage` instead: timing events recorded
into its graph, read back by `compiled.Program.stage_ms`.  `StepTimer`
records per-stage wall-clock percentiles, synchronising only where the
caller asks.  `device_memory_stats` reads the CUDA caching allocator.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"
_NO_SPAN = contextlib.nullcontext()
# each thread's stage recorders of the captures in progress, innermost
# last, so a capture takes only its own thread's marks; a stage mark
# costs one attribute read while none is
_STAGING = threading.local()


def span(name: str, **ids):
    """A range of the program's host work, named `name` and, after a
    space, each `key=value` of `ids` (the call's or step's index, so
    that every span of one request carries one identifier; a nested
    span is known by its parent).  While torch.profiler records it is a
    `record_function` range, on the profiler's clock, which the card's
    kernels share; otherwise one shared null context, at the cost of
    one check of the profiler."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    if ids:
        name = " ".join([name] + [f"{k}={v}" for k, v in ids.items()])
    return torch.profiler.record_function(name)


def stage(name: str) -> None:
    """Marks the end of stage `name` inside a program being captured on
    the card (`compiled.Program`): the capture records a timing event
    there, which its graph records on every replay.  Eager calls and the
    CPU record nothing, nor does another thread than the capture's."""
    stack = getattr(_STAGING, "stack", None)
    if stack:
        stack[-1](name)


@contextlib.contextmanager
def staging(record: Callable[[str], None]):
    """`record(name)` takes the stage marks of the block, made in this
    thread."""
    stack = _STAGING.__dict__.setdefault("stack", [])
    stack.append(record)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block, written to
    `<log_dir>/trace.json` when it ends (view it with Perfetto or
    chrome://tracing).  Yields the profiler: its `key_averages()` and
    `events()` are read after the block."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        # one window, no schedule: the warning about events cleared at
        # the end of each scheduled cycle does not apply
        warnings.filterwarnings("ignore", "Warning: Profiler clears events")
        with profile(activities=activities) as prof:
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Named-stage wall-clock accumulator.

    with timer.stage("data"): ...
    with timer.stage("step", sync=out): ...
    print(timer.summary())

    `sync` (a tensor, or anything else that is true) waits for the card
    before the stage's clock stops.
    """

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.records.items():
            a = np.asarray(vals[1:] if len(vals) > 3 else vals)  # drop warm-up
            out[name] = {
                "mean_ms": float(a.mean() * 1000),
                "p50_ms": float(np.percentile(a, 50) * 1000),
                "p95_ms": float(np.percentile(a, 95) * 1000),
                "count": int(len(vals)),
            }
        return out


def device_memory_stats() -> Optional[Dict]:
    """{device: torch.cuda.memory_stats()} for each card, or None
    without one."""
    if not torch.cuda.is_available():
        return None
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
