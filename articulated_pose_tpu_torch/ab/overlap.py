"""Forward / pose-fit overlap A/B (`scripts/ab_overlap.py`).

    python -m articulated_pose_tpu_torch.ab.overlap [--iters 64]
        [--batch 64] [--points 2048] [--cheap-knobs]

The forward of batch i and the fit of batch i - 1 share no data, so the
card may run one while the host queues the other: the program then
costs max(floors) a batch rather than their sum.  Four arms at bench.py's
program (`common.BenchProgram`: B=64, N=2048, bf16 trunk, packed ball
query, niter 128/64; `--cheap-knobs`: 64/64, refit 3, 512 scoring points,
the JAX flag's arms), each over `iters` fresh clouds:

- `fwd-only`: iters forwards;
- `pose-only`: iters fits of one fixed random prediction (numpy seed 1)
  on the fixed cloud, with each iteration's draws;
- `serial (fwd->pose)`: forward(i), then fit(i), as bench.py runs them;
- `pipelined (fwd || pose-1)`: forward(i) queued on one CUDA stream and
  fit(i - 1) on a second, which waits on an event recorded after
  forward(i - 1), all from the one host thread; a forward before the
  loop and a fit after it, so the work is the serial arm's.

Each arm runs once as a warm-up and is timed once, on the host clock
around a synchronised window; ms an iteration and clouds/s as JAX
prints them, then its summary: the sum and max of the fwd-only and
pose-only floors, serial against the sum, pipelined against serial, and
the share of the ideal overlap achieved.  The pipelined fits must equal
the serial fits bit for bit (same clouds, same draws), or it raises.

`--device cpu` (with `run(spec=...)` at tiny widths) is for the tests:
no streams, the same order of calls, host-clock times.  Without a card,
and unless `--device cpu` is given, it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from articulated_pose_tpu_torch import timing
from articulated_pose_tpu_torch.ab.common import BenchProgram, fits_equal
from articulated_pose_tpu_torch.programs import (random_predictions,
                                                 resolve_device)
from articulated_pose_tpu_torch.pose.pipeline import fit_frame_batch

ARMS = ("fwd-only", "pose-only", "serial (fwd->pose)",
        "pipelined (fwd || pose-1)")
PROD_KNOBS = dict(niter_part=128, lm_iters_refit=6, ransac_score_points=1024)
CHEAP_KNOBS = dict(niter_part=64, lm_iters_refit=3, ransac_score_points=512)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.overlap",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--cheap-knobs", action="store_true",
                    help="pose knobs 64/64 refit3 score512 (the arms the "
                         "noise sweep measured flat) instead of production "
                         "128/64 refit6 score1024")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the tests")
    return ap


class Arms:
    """The four arms over one `BenchProgram`; each returns its fits (the
    fwd-only arm its predictions)."""

    def __init__(self, prog: BenchProgram, iters: int):
        self.prog, self.iters = prog, iters
        dev = prog.P.device
        B, N, _ = prog.P.shape
        self.pred0 = random_predictions(np.random.RandomState(1), B, N,
                                        prog.cfg.n_parts, dev)
        self.streams = ((torch.cuda.Stream(dev), torch.cuda.Stream(dev))
                        if dev.type == "cuda" else None)

    def fwd_only(self) -> List:
        return [self.prog.forward(i) for i in range(self.iters)]

    def pose_only(self) -> List:
        prog = self.prog
        return [fit_frame_batch(self.pred0, prog.P, prog.draws[i], prog.cfg)
                for i in range(self.iters)]

    def serial(self) -> List:
        return [self.prog.step(i) for i in range(self.iters)]

    def pipelined(self) -> List:
        prog, n = self.prog, self.iters
        if self.streams is None:
            fits, prev = [], prog.forward(0)
            for i in range(1, n + 1):
                cur = prog.forward(i) if i < n else None
                fits.append(prog.fit(prev, i - 1))
                prev = cur
            return fits
        s_fwd, s_fit = self.streams
        main = torch.cuda.current_stream(s_fwd.device)
        s_fwd.wait_stream(main)
        s_fit.wait_stream(main)
        fits = []

        def forward(i):
            with torch.cuda.stream(s_fwd):
                pred = prog.forward(i)
                done = torch.cuda.Event()
                done.record(s_fwd)
            return pred, done

        prev, prev_done = forward(0)
        for i in range(1, n + 1):
            cur = forward(i) if i < n else (None, None)
            with torch.cuda.stream(s_fit):
                s_fit.wait_event(prev_done)
                # the forward's stream made them; the fit's reads them
                for t in prev.values():
                    t.record_stream(s_fit)
                fits.append(prog.fit(prev, i - 1))
            prev, prev_done = cur
        main.wait_stream(s_fit)
        main.wait_stream(s_fwd)
        return fits


def timed(fn, dev: torch.device, iters: int):
    """(ms an iteration on the host clock, fn's result) over one call of
    fn after a warm-up call."""
    fn()
    timing.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    timing.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / iters, out


def run(args, spec=None) -> Dict:
    """The four arms, their summary and one JSON line; raises unless the
    pipelined fits equal the serial ones."""
    dev = resolve_device(args.device, "ab.overlap")
    if args.iters < 2:
        raise ValueError("ab.overlap: --iters must be at least 2")
    knobs = CHEAP_KNOBS if args.cheap_knobs else PROD_KNOBS
    with torch.inference_mode():
        prog = BenchProgram(args.batch, args.points, args.iters, dev, spec,
                            **knobs)
        arms = Arms(prog, args.iters)
        ms, fits = {}, {}
        for name, fn in zip(ARMS, (arms.fwd_only, arms.pose_only,
                                   arms.serial, arms.pipelined)):
            ms[name], fits[name] = timed(fn, dev, args.iters)
            print(f"{name:<28s} {ms[name]:9.3f} ms/iter "
                  f"({args.batch / ms[name] * 1e3:8.0f} clouds/s)",
                  flush=True)
    serial, piped = fits[ARMS[2]], fits[ARMS[3]]
    if not all(fits_equal(a, b) for a, b in zip(serial, piped)):
        raise AssertionError("ab.overlap: the pipelined fits differ from "
                             "the serial fits")
    t_f, t_p, t_s, t_o = (ms[a] for a in ARMS)
    ideal = max(t_f, t_p)
    summary = dict(sum_floors_ms=t_f + t_p, max_floors_ms=ideal,
                   serial_vs_sum=t_s / (t_f + t_p),
                   pipelined_speedup=t_s / t_o,
                   saved_share=1 - t_o / t_s,
                   overlap_of_ideal=(t_f + t_p - t_o)
                   / max(t_f + t_p - ideal, 1e-9))
    print(f"\nsum(floors) fwd+pose     {summary['sum_floors_ms']:9.3f} "
          "ms/iter")
    print(f"max(floors)              {ideal:9.3f} ms/iter")
    print(f"serial vs sum            {summary['serial_vs_sum']:9.3f}x")
    print(f"pipelined vs serial      {summary['pipelined_speedup']:9.3f}x "
          f"speedup ({100 * summary['saved_share']:.1f}% saved)")
    print(f"overlap achieved         {summary['overlap_of_ideal']:9.3f} of "
          "ideal")
    print("pipelined fits equal to the serial fits, bit for bit", flush=True)
    result = dict(tool="ab.overlap", card=timing.card_or_none(dev),
                  device=str(dev), batch=args.batch, points=args.points,
                  iters=args.iters, cheap_knobs=args.cheap_knobs, ms=ms,
                  **summary)
    print(json.dumps(result), flush=True)
    return dict(result, fits=fits)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
