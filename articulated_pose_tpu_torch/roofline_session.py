"""The roofline session: the card's ceilings, the stage profile and the
stages' roofline counts in one process, so that their ratios compare.

    python -m articulated_pose_tpu_torch.roofline_session [--batch 64]
        [--points 2048] [--iters 16]

Counterpart of scripts/roofline_r4_run.py, which ran the limits probe,
the stage profile and a knob ablation in one process.  Here:

1. `probe_card.run`: HBM stream and gather, the FMA chain, sort, the
   launch cost;
2. `profile_stages.run` at B=64 over its 14 stages: device ms per stage;
3. `roofline.count` of the same 14 stages (`profile_stages.stage_fns`,
   the same callables on the same inputs).

Then one table: for each stage its device ms, its floor at the published
peaks and at the measured ceilings (bf16 GEMMs stay at the published
tensor-core peak, which the probe does not measure; every other FLOP at
the FMA chain's rate, the bytes at the faster stream reading), which of
the two binds, and each floor's share of the device ms.  For the forward
and the fit it also gives the launched bytes over the measured stream
rate, against the device ms: what eager PyTorch's unfused traffic alone
would take.  The JAX session's third part, ab_pose_r4.py, stays out:
`ab.pose_knobs_trained --time-iters` times each knob on the card.

It needs the card (the probe has none other).  `run(device="cpu",
spec=...)` is for the tests: no probe, host-clock profile, every device
column and share "not measured"; the counts are the same.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

import torch

from articulated_pose_tpu_torch import (probe_card, profile_stages, roofline,
                                        timing)
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.programs import resolve_device

LAUNCHED_STAGES = ("forward", "pose")


def count_stages(batch: int, points: int, dev: torch.device, spec=None
                 ) -> Dict[str, roofline.Count]:
    """stage -> the roofline count of `profile_stages`' stage."""
    with torch.inference_mode():
        fns = profile_stages.stage_fns(batch, points, spec or BackboneSpec(),
                                       profile_stages.STAGES, dev)
        return {s: roofline.count(fn) for s, (_, fn) in fns.items()}


def _share(floor: float, device_ms: Optional[float]):
    return None if device_ms is None else floor / device_ms


def table(profile_rows: List[dict], counts: Dict[str, roofline.Count],
          ceilings: Optional[Dict[str, float]]) -> List[dict]:
    """Join each profiled stage with its count's floors: at the published
    peaks, and at `ceilings` (`probe_card`'s; None: not measured)."""
    rows = []
    for p in profile_rows:
        c = counts[p["stage"]]
        pub = c.floors()
        row = dict(stage=p["stage"], label=p["label"],
                   device_ms=p["device_ms"], **c.row(),
                   share_published=_share(pub["floor_ms"], p["device_ms"]))
        if ceilings is not None:
            meas = c.floors(f32_flops=ceilings["f32_flops"],
                            hbm=ceilings["hbm_bytes_per_s"])
            row.update(measured_floor_ms=meas["floor_ms"],
                       measured_bound_by=meas["bound_by"],
                       measured_launched_ms=meas["launched_ms"],
                       share_measured=_share(meas["floor_ms"],
                                             p["device_ms"]))
        rows.append(row)
    return rows


def _f(x, fmt: str = "9.4f") -> str:
    return "not measured".rjust(len(format(0.0, fmt))) if x is None \
        else format(x, fmt)


def print_table(rows: List[dict]) -> None:
    print(f"{'stage':<34s} {'device ms':>12s} {'floor pub':>9s} "
          f"{'share':>12s} {'floor meas':>12s} {'share':>12s} "
          f"{'bound (meas)':>12s}", flush=True)
    for r in rows:
        print(f"{r['label']:<34s} {_f(r['device_ms'], '12.4f')} "
              f"{r['floor_ms']:9.4f} {_f(r['share_published'], '12.4f')} "
              f"{_f(r.get('measured_floor_ms'), '12.4f')} "
              f"{_f(r.get('share_measured'), '12.4f')} "
              f"{r.get('measured_bound_by') or r['bound_by']:>12s}",
              flush=True)
    for r in rows:
        if r["stage"] in LAUNCHED_STAGES:
            print(f"{r['label']}: {r['launched_mb']:.1f} MB launched, "
                  f"{_f(r.get('measured_launched_ms'), '.4f').strip()} ms "
                  f"at the measured stream rate, against "
                  f"{_f(r['device_ms'], '.4f').strip()} ms on the device",
                  flush=True)


def run(batch: int = 64, points: int = 2048, iters: int = 16,
        device: str = "cuda", spec=None, profile_rows=None,
        probe: Optional[Dict] = None) -> Dict:
    """The session; `profile_rows` and `probe` take readings already made
    in this process (chip_smoke.py's) in place of running them again."""
    dev = resolve_device(device, "roofline_session")
    if dev.type == "cuda" and probe is None:
        print("===== probe_card =====", flush=True)
        probe = probe_card.run(device=str(dev))
    if profile_rows is None:
        print(f"===== profile_stages B={batch} =====", flush=True)
        profile_rows = profile_stages.run(batch, points, iters,
                                          device=str(dev), spec=spec)
    print("===== roofline counts of the same stages =====", flush=True)
    rows = table(profile_rows, count_stages(batch, points, dev, spec),
                 None if probe is None else probe["ceilings"])
    print_table(rows)
    result = dict(tool="roofline_session", card=timing.card_or_none(dev),
                  device=str(dev), batch=batch, points=points,
                  ceilings=None if probe is None else probe["ceilings"],
                  rows=rows)
    print(json.dumps(result), flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the tests")
    args = ap.parse_args(argv)
    run(args.batch, args.points, args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
