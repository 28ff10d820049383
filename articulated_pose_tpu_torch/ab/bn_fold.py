"""The eval batch-norm fold of `models/layers.py::PointConv`: its own
device cost, the forward with and without it, and where it moves the
heads' rounding.

    python -m articulated_pose_tpu_torch.ab.bn_fold [--batch 64]
        [--points 2048] [--reps 20]

On bench.py's model (`programs.bench_model`: bf16 trunk, the packed
ball query, weights from seed 0) and the cloud of numpy seed 0:

- `fold_ms`: the folds of every layer that folds (`PointConv.fold` and
  the casts of W' and b' to the compute dtype) alone, replayed from a
  CUDA graph as the served program's graph runs them, and eager; each
  `timing.cuda_time_ms`;
- `forward`: the eager forward, folded and with every norm apart
  (`fold_bn` off): device-busy ms and ops a call (`timing.device_profile`,
  the measure of the benchmark's `serve.forward_device_ms`) and the peak
  device memory of one call;
- `rounding`: for each cloud and head, the 95th percentile over the
  cloud's values of |heads − heads_f32| over the head's RMS in the cloud
  (the benchmark's `heads_ratio` measure), heads_f32 the forward in f32
  with every norm apart; `ratio` is the worst (head, cloud) of the folded
  bf16 network's gap in units of the unfolded bf16 network's, `reverse`
  the unfolded's in units of the folded's, `median` the median over
  (head, cloud) of the first, `worst_head` where `ratio` was read.  Two
  states: the weights as built (running statistics 0 and 1, as the
  benchmark's served weights) and "calibrated", every running statistic
  set to the cloud's own batch statistics (a trained network's norms
  subtract means that are large against their deviations).  A fold that
  only moves the rounding reads `ratio` and `reverse` alike and `median`
  near 1 or below; a lower precision reads `ratio` far above `reverse`
  and `median` above 1.

`--device cpu` (with `run(spec=...)` at tiny widths) is for the tests:
the rounding readings only.  Without a card, and unless `--device cpu`
is given, it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from articulated_pose_tpu_torch import timing
from articulated_pose_tpu_torch.models.layers import PointConv
from articulated_pose_tpu_torch.programs import bench_model, resolve_device

HEADS = ("W", "nocs_per_point", "confi_per_point", "gocs_per_point",
         "heatmap_per_point", "unitvec_per_point", "joint_axis_per_point",
         "index_per_point")
PERCENTILE = 95.0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.bn_fold",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=20,
                    help="calls a timing takes the median or mean of")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the tests")
    return ap


@contextlib.contextmanager
def norms_apart(model: torch.nn.Module):
    """Every PointConv of `model` runs its norm apart in the block."""
    convs = [m for m in model.modules() if isinstance(m, PointConv)]
    kept = [m.fold_bn for m in convs]
    for m in convs:
        m.fold_bn = False
    try:
        yield
    finally:
        for m, k in zip(convs, kept):
            m.fold_bn = k


def cloud_gaps(heads: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor]) -> np.ndarray:
    """(heads, clouds): the `PERCENTILE`-th percentile over a cloud's
    values of |heads − ref| over the head's RMS in the cloud."""
    out = []
    for k in HEADS:
        p = heads[k].double().cpu().flatten(1).numpy()
        r = ref[k].double().cpu().flatten(1).numpy()
        rms = np.sqrt((r ** 2).mean(axis=1, keepdims=True))
        out.append(np.percentile(np.abs(p - r) / np.maximum(rms, 1e-30),
                                 PERCENTILE, axis=1))
    return np.stack(out)


def readings(folded: np.ndarray, apart: np.ndarray) -> Dict:
    """`ratio`, `reverse`, `median` and `worst_head` of two gap arrays,
    each read against the other with a tenth of its head's median as
    the floor of a cloud's unit (as the benchmark's `heads_ratio`)."""
    def units(g):
        return np.maximum(g, 0.1 * np.median(g, axis=1, keepdims=True))

    r = folded / np.maximum(units(apart), 1e-30)
    return dict(ratio=float(r.max()),
                reverse=float((apart / np.maximum(units(folded),
                                                  1e-30)).max()),
                median=float(np.median(r)),
                worst_head=HEADS[int(np.unravel_index(r.argmax(),
                                                      r.shape)[0])])


@torch.no_grad()
def rounding(model, ref, P: torch.Tensor) -> Dict:
    """The readings of the folded bf16 network against the unfolded one,
    both against the f32 network `ref` with every norm apart."""
    with norms_apart(ref):
        want = ref(P)
    got = model(P)
    with norms_apart(model):
        apart = model(P)
    return readings(cloud_gaps(got, want), cloud_gaps(apart, want))


@torch.no_grad()
def calibrate(model, P: torch.Tensor) -> None:
    """Every running statistic set to the batch statistics of `P`."""
    model.train()
    model(P, bn_momentum=0.0, generator=torch.Generator(
        P.device).manual_seed(0))
    model.eval()


def fold_ms(model, reps: int) -> Dict[str, float]:
    """The folds alone: replayed from a CUDA graph and eager."""
    convs = [m for m in model.modules()
             if isinstance(m, PointConv) and m.folded]

    def folds():
        return [[t.to(m.dtype) for t in m.fold()] for m in convs]

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            folds()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            folds()
        replayed, r_dev = timing.cuda_time_ms(graph.replay, reps)
        eager, e_dev = timing.cuda_time_ms(folds, reps)
    return dict(replayed=replayed, eager=eager,
                device_only=bool(r_dev and e_dev))


def forward(model, P: torch.Tensor, reps: int) -> Dict:
    """Device-busy ms, ops and peak bytes of one eager forward."""
    def call():
        with torch.no_grad():
            model(P)

    ms, ops = timing.device_profile(call, reps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return dict(device_ms=ms, ops=ops,
                peak_bytes=torch.cuda.max_memory_allocated())


def run(args, spec=None) -> Dict:
    dev = resolve_device(args.device, "ab.bn_fold")
    model = bench_model(dev, spec)
    ref = bench_model(dev, spec, torch.float32)
    ref.load_state_dict(model.state_dict())
    P = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch, args.points, 3).astype(np.float32)).to(dev)
    out = dict(tool="ab.bn_fold", card=timing.card_or_none(dev),
               device=str(dev), batch=args.batch, points=args.points,
               layers=model.folded_bn_layers)
    if dev.type == "cuda":
        out["fold_ms"] = fold_ms(model, args.reps)
        out["forward"] = {"folded": forward(model, P, args.reps)}
        with norms_apart(model):
            out["forward"]["apart"] = forward(model, P, args.reps)
    out["rounding"] = {"as_built": rounding(model, ref, P)}
    calibrate(model, P)
    ref.load_state_dict(model.state_dict())
    out["rounding"]["calibrated"] = rounding(model, ref, P)
    print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
