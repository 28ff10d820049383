"""The readings the MinkUNet cell's limits are set from, at the cell's own
size, on the card: for each seed, the program's numbers, the float8
control's, a TF32 fit's and one planted fault's, the heads' percentiles
and the strides' voxel counts (`drivers/serve_minkunet_offline.
readings`), as `control.py` reads the PointNet++ cells.

    python3 posebench/control_minkunet.py --seeds 1 2 3 ...

Each seed prints one JSON line; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from posebench import harness  # noqa: E402
from posebench.drivers import serve_minkunet_offline  # noqa: E402

CELL = "serve_minkunet_b16_n8192"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="posebench/control_minkunet.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("posebench/control_minkunet.py: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(CELL)
    device = harness.card()
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = serve_minkunet_offline.readings(cell, seed, device)
        harness.free(device)
        print(json.dumps({"workload": CELL, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
