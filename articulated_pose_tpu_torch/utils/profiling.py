"""Profiling / tracing utilities: counterpart of
`articulated_pose_tpu/utils/profiling.py`.

`trace` records a block with torch.profiler (host ops and, on the card,
its kernels and copies) and writes a Chrome trace into `log_dir`; each
hand-written kernel's launch shows there as a "kernel:<entry>" range
(`ops/kernels/build.py::CudaKernel.scope`).  `StepTimer` records
per-stage wall-clock percentiles, synchronising only where the caller
asks.  `device_memory_stats` reads the CUDA caching allocator.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


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

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)


def device_memory_stats() -> Optional[Dict]:
    """{device: torch.cuda.memory_stats()} for each card, or None
    without one."""
    if not torch.cuda.is_available():
        return None
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
