"""What every cell shares: finding a cell's files by name, the result
line, the numbers that decide `correct`, the import guard and the
weights made from the seed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import math
import pathlib
import sys
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names no process that prints a result may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "articulated_pose_tpu")


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's `workloads`, with its files."""

    name: str
    entry: Dict
    workload: Dict          # workloads/<cell>.json
    config: Dict            # configs/<config>.json
    traffic: Dict           # traffic/<traffic>.json
    end_to_end: List[Dict]  # the end-to-end metrics the cell reports
    per_layer: List[Dict]   # the per-layer metrics read in the cell

    @property
    def driver(self) -> str:
        return self.workload["driver"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def find_cell(name: str, benchmark: Optional[Dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json (read from the checkout's root
    unless given) and its configuration, traffic and workload files;
    KeyError when BENCHMARK.json has no such cell."""
    bench = benchmark if benchmark is not None else load_json(
        ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    # an end-to-end metric without `workloads` is every cell's (setup_s);
    # a per-layer metric names its cells
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, entry=entry,
                workload=load_json(BENCH_DIR / "workloads" / f"{name}.json"),
                config=config,
                traffic=load_json(BENCH_DIR / "traffic"
                                  / f"{entry['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_driver(name: str):
    return importlib.import_module(f"posebench.drivers.{name}")


def load_metric(name: str):
    """The reader module of per-layer metric `name`
    (metrics/<name>.py): `read(trace) -> float | None`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_name = "posebench.metrics._" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sub_seed(seed: int, tag: str, bits: int = 31) -> int:
    """A seed of `bits` bits for the stream `tag` of run seed `seed`."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % (1 << bits)


@dataclasses.dataclass
class Check:
    """One number that decides `correct`: it passes at or under its
    limit; a NaN never passes."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


def checks_of(numbers: Dict[str, float], limits: Dict[str, float]
              ) -> List[Check]:
    return [Check(k, float(numbers[k]), float(limits[k])) for k in limits]


class SetupClock:
    """Set-up's parts: each mark records the seconds since the previous
    one (the first, since the process started), after the device has
    finished its work."""

    def __init__(self, t_start: float, device):
        self.last = t_start
        self.device = device
        self.parts: Dict[str, float] = {}

    def mark(self, name: str, wait: bool = True) -> float:
        """`wait=False` before the device is first touched (a sync
        would create its context)."""
        import time
        if wait:
            sync(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now
        return now


def spread_note(what: str, seconds: List[float]) -> str:
    """One line on the host times of the window's calls."""
    import numpy as np
    ms = np.asarray(seconds) * 1e3
    q = np.percentile(ms, [10, 50, 90]) if len(ms) else [math.nan] * 3
    top = ms.max() if len(ms) else math.nan
    return (f"{what}: {len(ms)}, host ms p10 {q[0]:.3f} p50 {q[1]:.3f} "
            f"p90 {q[2]:.3f} max {top:.3f}")


@dataclasses.dataclass
class Outcome:
    """What a driver's run gives back to `run.py`."""

    setup_s: float
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional[Dict] = None      # what the metric readers read
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)  # stderr


def forbidden_modules() -> List[str]:
    """The modules held whose top-level name is JAX's or the JAX
    package's, compared whole (the port's name only begins with it)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def result_line(cell: Cell, outcome: Outcome, trace: bool, device: Dict,
                metrics: Dict[str, Dict]) -> str:
    out = {"correct": all(c.ok for c in outcome.checks),
           "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": device}
    if trace and outcome.trace and outcome.trace.get("breakdown"):
        out["breakdown"] = outcome.trace["breakdown"]
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return json.dumps(out)


def e2e_metrics(cell: Cell, outcome: Outcome) -> Dict[str, Dict]:
    """The cell's end-to-end metrics, each as BENCHMARK.json names it."""
    values = dict(outcome.e2e, setup_s=outcome.setup_s)
    return {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer_metrics(cell: Cell, trace: Dict,
                      load: Callable[[str], Any] = load_metric
                      ) -> Dict[str, Dict]:
    """Each per-layer metric whose reader found something to read."""
    out = {}
    for m in cell.per_layer:
        value = load(m["name"]).read(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card(device="cuda"):
    """The device a run measures on: the card, or the CPU for the tests
    that drive a run untraced at tiny widths."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Let the program's graphs and buffers go before the reference
    runs (a process's peak never falls again)."""
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    """The process's peak of device memory; 0 off the card."""
    import torch
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


# ------------------------------------------------ weights from the seed
def weights_from_seed(template, seed: int, init: str, device
                      ) -> Dict[str, "torch.Tensor"]:
    """A state dict of `template`'s names and shapes, drawn on `device`
    from one torch.Generator seeded `seed` in one call: pointwise
    weights uniform in ±sqrt(6 / fan_in) under "he" (activations keep
    their scale through the ReLU layers, so the served heads are not
    flat) or ±sqrt(6 / (fan_in + fan_out)) under "xavier" (the
    reference's initialisation); under "he" biases and batch-norm
    shifts uniform in ±0.1, under "xavier" zero; batch-norm scales 1,
    running means 0 and variances 1."""
    import torch

    sd = template.state_dict()
    names = [k for k, v in sd.items() if v.is_floating_point()]
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(sd[k].numel() for k in names)
    flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = v.to(device)
            continue
        u = flat[at:at + v.numel()].view(v.shape)
        at += v.numel()
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "weight" and v.dim() == 2:
            fan_out, fan_in = v.shape
            bound = math.sqrt(6.0 / (fan_in if init == "he"
                                     else fan_in + fan_out))
            out[k] = u * bound
        elif leaf == "bias":
            out[k] = u * 0.1 if init == "he" else torch.zeros_like(u)
        elif leaf in ("weight", "running_var"):
            out[k] = torch.ones_like(u)
        else:                                   # running_mean
            out[k] = torch.zeros_like(u)
    return out
