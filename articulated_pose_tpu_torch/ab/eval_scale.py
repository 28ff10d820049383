"""Profile the `eval` command at dataset scale
(`scripts/profile_eval_scale.py`).

    python -m articulated_pose_tpu_torch.ab.eval_scale --device cpu \\
        [--frames 512] [--num_points 512] [--batch_size 16]

Writes an N-frame synthetic HDF5 fixture (one test instance holding
every frame), runs `python -m articulated_pose_tpu_torch eval --full_test`
on it in this process under cProfile, and prints frames/s and the top
hotspots of the package, so per-frame Python work that would make a
5k-frame split take hours shows up by name.

The fixture needs h5py, and the card's host has none: there this tool
raises ImportError naming h5py, as `test --data_root` does, so it runs
on the CPU (`--device cpu`).  `--backbone tiny` takes the narrow widths.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

from articulated_pose_tpu_torch import main as cli
from articulated_pose_tpu_torch.programs import resolve_device
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated

TOP = 25                # hotspots printed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m articulated_pose_tpu_torch.ab.eval_scale",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=512,
                    help="total frames (the test split holds them all)")
    ap.add_argument("--num_points", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--root", default=None)
    ap.add_argument("--backbone", default="reference",
                    choices=["reference", "tiny"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' where "
                         "h5py is, since the fixture needs it)")
    return ap


def run(args) -> Dict:
    """Fixture, profiled eval, report; returns {"wall", "frames_per_s",
    "root", "stats"}."""
    resolve_device(args.device, "eval_scale")
    root = args.root or tempfile.mkdtemp(prefix="eval_scale_")
    gen = SyntheticArticulated(n_parts=3, points_per_part=300, seed=0)
    t0 = time.perf_counter()
    # every frame in one test instance, so the test split holds them all
    gen.export_hdf5(root, "eyeglasses", n_instances=1,
                    frames_per_instance=args.frames, test_fraction=1.0)
    print(f"fixture: {args.frames} frames in {time.perf_counter() - t0:.1f}s "
          f"at {root}", flush=True)

    argv = ["eval", "--item", "eyeglasses", "--data_root", root,
            "--num_points", str(args.num_points),
            "--batch_size", str(args.batch_size),
            "--work_dir", os.path.join(root, "work"), "--full_test",
            "--backbone", args.backbone, "--device", args.device]
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(cli.main, argv)
    wall = time.perf_counter() - t0
    print(f"\neval wall: {wall:.1f}s -> {args.frames / wall:.1f} frames/sec",
          flush=True)
    stats = pstats.Stats(prof, stream=sys.stdout)
    stats.sort_stats("cumulative")
    print("\n== top cumulative ==")
    stats.print_stats(r"articulated_pose_tpu_torch", TOP)
    return {"wall": wall, "frames_per_s": args.frames / wall, "root": root,
            "stats": stats}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
