"""Paired batch-size sweep of forward + fit (`scripts/ab_batch.py`).

    python -m articulated_pose_tpu_torch.ab.batch [--iters 48]
        [--batches 64,128]

For each B, in one process: bench.py's program (`common.BenchProgram`:
N=2048, bf16 trunk, packed ball query, niter 128/64) over `iters` fresh
clouds, a warm-up iteration, then two timed runs of `iters` iterations
each (host clock around a synchronised window), as the JAX script's two
windows, printed as clouds/s and ms an iteration.  The port's fit is
launch-bound (a fixed count of launches whatever B), so B is what moves
its clouds/s: each B also prints its device ms, device ops and idle
share over one more iteration (torch.profiler, `timing.device_profile`).

`--device cpu` (with `run(spec=...)` at tiny widths) is for the tests:
host-clock times, the device columns "not measured".  Without a card,
and unless `--device cpu` is given, it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from articulated_pose_tpu_torch import timing
from articulated_pose_tpu_torch.ab.common import BenchProgram
from articulated_pose_tpu_torch.programs import resolve_device

RUNS = 2
POINTS = 2048                       # the JAX script's N


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.batch",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--batches", default="64,128")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the tests")
    return ap


def one_batch(B: int, args, dev: torch.device, spec=None,
              points: int = POINTS) -> Dict:
    """The readings of batch size B; `fits` holds iteration 0's fit."""
    prog = BenchProgram(B, points, args.iters, dev, spec)
    fits = prog.step(0)                     # warm-up
    runs = []
    for r in range(1, RUNS + 1):
        timing.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(args.iters):
            prog.step(i)
        timing.synchronize(dev)
        dt = time.perf_counter() - t0
        runs.append(dict(ms=dt / args.iters * 1e3,
                         clouds_per_s=B * args.iters / dt))
        print(f"B={B:<4d} run{r}: {runs[-1]['clouds_per_s']:8.1f} clouds/s"
              f"  ({runs[-1]['ms']:6.2f} ms/iter)", flush=True)
    row = dict(batch=B, runs=runs, device_ms=None, device_ops=None,
               idle_share=None)
    if dev.type == "cuda":
        busy, ops = timing.device_profile(lambda: prog.step(0), 1)
        wall = min(r["ms"] for r in runs)
        row.update(device_ms=busy, device_ops=ops,
                   idle_share=max(0.0, 1.0 - busy / wall))
        print(f"B={B:<4d} device {busy:.4f} ms, {ops} ops an iteration, "
              f"idle {row['idle_share']:.3f}", flush=True)
    else:
        print(f"B={B:<4d} device ms, ops and idle: not measured", flush=True)
    return dict(row, fits=fits)


def run(args, spec=None, points: int = POINTS) -> Dict:
    """Every B of `--batches` at `points` points (`spec` and `points`: the
    tests' tiny sizes); prints one JSON line; returns the readings and
    each B's first fit."""
    dev = resolve_device(args.device, "ab.batch")
    rows = []
    with torch.inference_mode():
        for B in (int(x) for x in args.batches.split(",")):
            rows.append(one_batch(B, args, dev, spec, points))
    result = dict(tool="ab.batch", card=timing.card_or_none(dev),
                  device=str(dev), points=points, iters=args.iters,
                  rows=[{k: v for k, v in r.items() if k != "fits"}
                        for r in rows])
    print(json.dumps(result), flush=True)
    return dict(result, fits={r["batch"]: r["fits"] for r in rows})


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
