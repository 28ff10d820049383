"""The card's practical ceilings: HBM stream and gather, elementwise FMA
throughput, sort, and the host's cost of one launch.

    python -m articulated_pose_tpu_torch.probe_card [--iters 32]

Counterpart of scripts/probe_chip_limits.py, with its four readings at
its sizes, plus the cost a launch:

- HBM stream: y = x·c + c on 256 and 512 MiB, one elementwise pass a
  call (`torch.addcmul`), reading 4 B and writing 4 B an element;
- HBM gather: 8M f32 rows at random of a 64 MiB table
  (`torch.index_select`), the index set rotated each call; its rate is
  the gathered bytes over the time ("effective", as the JAX probe's);
- elementwise FMA: a chain of 64 dependent FMAs an element on an 8 MiB
  block (`csrc/probe.cu`, `ops/kernels/probe.fma_chain`: eager PyTorch
  would launch 64 passes and measure memory), held within 1e-5 relative
  to the same chain in float64 NumPy;
- sort: `torch.sort` of (64, 2048) rows;
- the host's µs a launch, of the empty kernel of `csrc/probe.cu`
  through ctypes and of a one-element `add_`, 10,000 launches each on
  the host clock; the card finishes each long before the host queues
  the next, so the queue never fills and the time is the host's.

Each device time is the median of `iters` calls, each timed with CUDA
events behind a spin kernel (`timing.cuda_time_ms`).  Each ceiling is
printed beside the published peak it stands against (`timing`'s:
3.35 TB/s, 67 TFLOP/s f32) with its share of it; sort and launches have
none.  The JSON line's `ceilings` are what `roofline_session` divides
by.  There is no CPU path: without a card it raises, naming the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from articulated_pose_tpu_torch import timing
from articulated_pose_tpu_torch.ops.kernels import probe

STREAM_MIB = (256, 512)
GATHER_TABLE_MIB = 64
GATHER_ROWS = 8 * 1024 * 1024
GATHER_ROTATIONS = 4
FMA_ELEMENTS = 2 * 1024 * 1024          # 8 MiB of f32
FMA_CALLS = 16                          # launches a timed call
FMA_REL_BOUND = 1e-5
SORT_SHAPE = (64, 2048)
LAUNCHES = 10_000


def _line(name: str, ms: float, rate: float, unit: str,
          peak: Optional[float] = None) -> str:
    share = f" ({rate / peak:.3f} of the published {peak:g})" if peak else ""
    return f"{name:<34s} {ms:9.4f} ms -> {rate:10.1f} {unit}{share}"


def host_us(launch, dev: torch.device) -> Dict[str, float]:
    """The host's µs a call of `launch` over LAUNCHES calls, and the ms
    the card took to drain its queue after the last one was queued."""
    launch()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(LAUNCHES):
        launch()
    t1 = time.perf_counter()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    return dict(us=(t1 - t0) * 1e6 / LAUNCHES, drain_ms=(t2 - t1) * 1e3)


def run(iters: int = 32, device: str = "cuda") -> Dict:
    """Measure, print each reading and one JSON line; return the
    readings."""
    dev = timing.require_card(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = dict(tool="probe_card", card=timing.card_line(), iters=iters)
    print(f"[card] {out['card']}", flush=True)
    peak_gbps = timing.HBM_BYTES_PER_S / 1e9
    peak_tflops = timing.F32_PEAK_FLOPS / 1e12

    stream = {}
    for mib in STREAM_MIB:
        n = mib * 1024 * 1024 // 4
        x = torch.rand(n, generator=gen, device=dev)
        y = torch.empty_like(x)
        c = torch.full((), 1.000001, device=dev)
        ms, _ = timing.cuda_time_ms(lambda: torch.addcmul(c, x, c, out=y),
                                    iters)
        stream[mib] = dict(ms=ms, gbps=2 * n * 4 / ms / 1e6)
        print(_line(f"HBM stream {mib} MiB", ms, stream[mib]["gbps"], "GB/s",
                    peak_gbps), flush=True)
        del x, y
    out["stream"] = stream

    n = GATHER_TABLE_MIB * 1024 * 1024 // 4
    tbl = torch.rand(n, generator=gen, device=dev)
    idx = torch.randint(0, n, (GATHER_ROWS,), generator=gen, device=dev)
    rotated = [(idx + k * (n // GATHER_ROTATIONS)) % n
               for k in range(GATHER_ROTATIONS)]
    calls = [0]

    def gather():
        calls[0] += 1
        return torch.index_select(tbl, 0, rotated[calls[0] % len(rotated)])

    ms, _ = timing.cuda_time_ms(gather, iters)
    out["gather"] = dict(ms=ms, gbps=GATHER_ROWS * 4 / ms / 1e6)
    print(_line(f"HBM gather {GATHER_ROWS / 1e6:.0f}M f32 rows", ms,
                out["gather"]["gbps"], "GB/s effective", peak_gbps),
          flush=True)
    del tbl, idx, rotated

    x = torch.rand(FMA_ELEMENTS, generator=gen, device=dev) + 0.5
    y = probe.fma_chain(x)
    torch.cuda.synchronize(dev)
    want = probe.fma_chain_plain(x.cpu().numpy())
    rel = float(np.max(np.abs(y.cpu().numpy().astype(np.float64) - want)
                       / np.abs(want)))
    if not rel <= FMA_REL_BOUND:
        raise AssertionError(f"fma_chain is {rel:.3g} relative off its "
                             f"float64 plain version (bound {FMA_REL_BOUND})")
    ms, _ = timing.cuda_time_ms(
        lambda: [probe.fma_chain(x) for _ in range(FMA_CALLS)], iters)
    ms /= FMA_CALLS
    flops = 2 * probe.DEPTH * FMA_ELEMENTS
    out["fma"] = dict(ms=ms, tflops=flops / ms / 1e9, max_rel_err=rel)
    print(_line(f"FMA chain (8 MiB, {probe.DEPTH} deep)", ms,
                out["fma"]["tflops"], "TFLOP/s f32", peak_tflops)
          + f"; {rel:.3g} relative to float64", flush=True)

    xs = torch.rand(SORT_SHAPE, generator=gen, device=dev)
    ms, _ = timing.cuda_time_ms(lambda: torch.sort(xs, dim=-1), iters)
    out["sort"] = dict(ms=ms, melem_s=xs.numel() / ms / 1e3)
    print(_line(f"sort {SORT_SHAPE} rows", ms, out["sort"]["melem_s"],
                "Melem/s"), flush=True)

    one = torch.zeros(1, device=dev)
    out["launch"] = {"ctypes empty kernel": host_us(
        lambda: probe.empty_launch(dev), dev),
        "torch add_ (1 element)": host_us(lambda: one.add_(1.0), dev)}
    for name, r in out["launch"].items():
        print(f"launch, {name:<27s} {r['us']:9.3f} us a launch on the host "
              f"(the card drained its queue {r['drain_ms']:.3f} ms after "
              "the last)", flush=True)

    out["ceilings"] = dict(
        hbm_bytes_per_s=max(s["gbps"] for s in stream.values()) * 1e9,
        f32_flops=out["fma"]["tflops"] * 1e12)
    out["published"] = dict(hbm_bytes_per_s=timing.HBM_BYTES_PER_S,
                            f32_flops=timing.F32_PEAK_FLOPS,
                            tensor_flops=timing.TENSOR_PEAK_FLOPS)
    print(json.dumps(out), flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device; the probe has no CPU path")
    args = ap.parse_args(argv)
    run(args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
