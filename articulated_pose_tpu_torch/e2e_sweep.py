"""The five-category end-to-end sweep on the card: counterpart of
`scripts/run_category_sweep.sh`.

    python -m articulated_pose_tpu_torch.e2e_sweep [STEPS] [OUTDIR] \\
        [--categories laptop,oven] [--device cuda]

Each category trains the flagship ANCSH recipe (`e2e.run`) on the
procedural generator seeded per category, fits poses and writes
OUTDIR/e2e_<category>_report.json; the 3-part and drawer categories
train 3 × STEPS.  Each run resumes from its work directory's newest
snapshot (`--resume`), so a cut sweep picks up where it stopped.  Then
OUTDIR/e2e_sweep_summary.json is written from every category report in
OUTDIR, in the table's order, with the keys of the JAX sweep's summary.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Dict, Optional, Sequence

from articulated_pose_tpu_torch import e2e

# category, generator seed, multiple of STEPS (run_category_sweep.sh:27-33)
SWEEP = (("eyeglasses", 1, 3), ("laptop", 2, 1), ("oven", 42, 1),
         ("washing_machine", 43, 1), ("drawer", 3, 3))
SUMMARY_KEYS = ("rot_err_deg_mean", "trans_err_mean", "acc_5deg5cm",
                "miou_mean", "joint_axis_err_deg", "joint_line_dist")
DEFAULT_OUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "e2e_reports")


def summary_entry(report: Dict) -> Dict:
    """A category's line of the summary (run_category_sweep.sh:52-62)."""
    o = report["overall"]
    keep = {k: o[k] for k in SUMMARY_KEYS if k in o}
    for k in ("seg_acc", "seed", "train_steps"):
        keep[k] = report.get(k)
    return keep


def write_summary(outdir: str) -> str:
    summary = {}
    for cat, _, _ in SWEEP:
        path = os.path.join(outdir, f"e2e_{cat}_report.json")
        if os.path.exists(path):
            with open(path) as f:
                summary[cat] = summary_entry(json.load(f))
    out = os.path.join(outdir, "e2e_sweep_summary.json")
    with open(out, "w") as f:
        f.write("{\n" + ",\n".join(f" {json.dumps(c)}: {json.dumps(v)}"
                                   for c, v in summary.items()) + "\n}\n")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "articulated_pose_tpu_torch.e2e_sweep")
    ap.add_argument("steps", nargs="?", type=int, default=8000)
    ap.add_argument("outdir", nargs="?", default=DEFAULT_OUTDIR)
    ap.add_argument("--categories", default=None,
                    help="comma list, a subset of the table (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-root", default=tempfile.gettempdir(),
                    help="parent of each category's work directory")
    args = ap.parse_args(argv)
    known = [c for c, _, _ in SWEEP]
    chosen = args.categories.split(",") if args.categories else known
    unknown = sorted(set(chosen) - set(known))
    if unknown:
        raise SystemExit(f"unknown categories {unknown}; the table has "
                         f"{known}")
    os.makedirs(args.outdir, exist_ok=True)
    for cat, seed, mult in SWEEP:
        if cat not in chosen:
            continue
        steps = mult * args.steps
        work = os.path.join(args.work_root, f"e2e_sweep_{cat}")
        print(f"=== {cat} (seed {seed}, {steps} steps) ===", flush=True)
        e2e.run(e2e.parse_args(["--category", cat, "--seed", str(seed),
                                "--steps", str(steps), "--work", work,
                                "--resume", "--device", args.device]))
        shutil.copy(os.path.join(work, "report.json"),
                    os.path.join(args.outdir, f"e2e_{cat}_report.json"))
    print("sweep complete ->", write_summary(args.outdir), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
