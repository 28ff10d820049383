"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 posebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  With `--trace 0` the result line holds
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics,
read from a profiled stretch after the window.  Standard error ends
with each number that decides `correct` beside its limit; standard
output ends with the JSON result line.  Without a CUDA device, or with
fewer than the cell asks for, it exits 3 and prints no result; when a
module of JAX or of the JAX package is loaded once the window has
closed, it exits 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every cache a run writes lies at a fixed path inside the checkout
CACHE = ROOT / ".posebench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="posebench/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from posebench import harness

    cell = harness.find_cell(args.workload)
    chips = int(cell.entry["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"posebench: cell {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    driver = harness.load_driver(cell.driver)
    outcome = driver.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), t_start=T_START)
    held = harness.forbidden_modules()
    if held:
        print(f"posebench: modules of JAX or the JAX package are loaded: "
              f"{held}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    if args.trace:
        device["busy_s"] = outcome.trace["busy_s"]
        device["window_s"] = outcome.trace["window_s"]
        metrics = harness.per_layer_metrics(cell, outcome.trace)
    else:
        metrics = harness.e2e_metrics(cell, outcome)
    print("setup_s parts: " + ", ".join(
        f"{k} {v:.3f}" for k, v in outcome.setup_parts.items()),
        file=sys.stderr)
    for note in outcome.notes:
        print(note, file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(cell, outcome, bool(args.trace), device,
                              metrics), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
