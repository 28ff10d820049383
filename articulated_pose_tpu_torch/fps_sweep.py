"""Sweep the FPS kernel's cluster sizes and variants on the card, and
time the FPS entries of several trees in turns.

    python -m articulated_pose_tpu_torch.fps_sweep [--out FILE]
    python articulated_pose_tpu_torch/fps_sweep.py --ab ROOT [ROOT ...]

The sweep runs `csrc/fps.cu` at every (variant, cluster) that holds the
cloud, at each FPS shape of the port's paths (SHAPES): device ms (median
of 20 spin-queued CUDA-event calls, `timing.cuda_time_ms`), µs per pick
(ms over the picks of both levels), and whether the output equals the
plain version's; then, for the fastest configuration and the one
`fps.fps_plan` picks, the step floor (`fps.step_floor`: the same launch
on a cloud of one point per thread).  `fps_plan`'s rule is read off
this table.

`--ab` times the public entries (`fps.fps2`, `fps.fps`) at the same
shapes in one process per ROOT, in the order given (e.g. parent, new,
new, parent), each ROOT a checkout whose own package is imported and
built; so two designs compare on one card in one call.  Every reading
needs a CUDA device; without one the script exits 2.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
# (entry, B, N, np1, np2 (0: single level), path)
SHAPES = (
    ("fps2", 16, 2048, 512, 128, "serving forward"),
    ("fps2", 64, 2048, 512, 128, "packed / bucket forward, bench batch"),
    ("fps2", 4, 32768, 512, 128, "large-cloud forward"),
    ("fps", 16, 2048, 512, 0, "serving cloud, one level"),
    ("fps", 8, 8192, 1024, 0, "N-level SA1"),
    ("fps", 8, 1024, 256, 0, "N-level SA2"),
    ("fps", 8, 256, 64, 0, "N-level SA3"),
    ("fps", 8, 64, 16, 0, "N-level SA4"),
    ("fps", 64, 2048, 512, 0, "profiler fps1"),
    ("fps", 64, 512, 128, 0, "profiler fps2"),
)


def label(entry, B, N, np1, np2) -> str:
    return (f"{entry} B{B} N{N}->{np1}" + (f"->{np2}" if np2 else ""))


def cloud(B: int, N: int, seed: int = 0):
    import torch

    return torch.from_numpy(np.random.RandomState(seed).rand(B, N, 3).astype(
        np.float32)).cuda()


def sweep() -> list:
    import torch

    from articulated_pose_tpu_torch.ops.kernels import fps
    from articulated_pose_tpu_torch.timing import cuda_time_ms

    rows = []
    for entry, B, N, np1, np2, path in SHAPES:
        xyz = cloud(B, N)
        want = (fps.fps2_plain(xyz, np1, np2) if np2
                else fps.fps_plain(xyz, np1))
        kernel = fps.KERNEL if np2 else fps.SINGLE_KERNEL
        picks = np1 + np2
        configs = []
        for cluster in fps.CLUSTERS:
            for variant in fps.VARIANTS:
                if not fps.fits(variant, N, cluster):
                    continue

                def call(variant=variant, cluster=cluster):
                    return fps.launch(kernel, xyz, np1, np2, variant, cluster)

                try:
                    got = [t for t in call() if t is not None]
                    torch.cuda.synchronize()
                    equal = all(torch.equal(g, w) for g, w in zip(got, want))
                    ms, device_only = cuda_time_ms(call)
                except RuntimeError as e:   # a launch the card refuses
                    configs.append(dict(variant=variant, cluster=cluster,
                                        refused=str(e)))
                    continue
                configs.append(dict(variant=variant, cluster=cluster, ms=ms,
                                    us_per_pick=ms * 1e3 / picks,
                                    equal=equal, device_only=device_only))
        timed = [c for c in configs if "ms" in c]
        best = min(timed, key=lambda c: c["ms"])
        plan = fps.fps_plan(B, N, np1)
        for c in timed:
            if (c["variant"], c["cluster"]) in (plan, (best["variant"],
                                                       best["cluster"])):
                c["floor_us_per_pick"] = fps.step_floor(B, c["variant"],
                                                        c["cluster"])
        rows.append(dict(shape=label(entry, B, N, np1, np2), path=path,
                         plan=list(plan), best=[best["variant"],
                                                best["cluster"]],
                         configs=configs))
        print(f"[sweep] {rows[-1]['shape']} ({path}): best {best['variant']}"
              f" C={best['cluster']} {best['ms']:.4f} ms; plan {plan[0]} "
              f"C={plan[1]}", flush=True)
        for c in configs:
            if "ms" not in c:
                print(f"    {c['variant']:>7} C={c['cluster']:<2} refused: "
                      f"{c['refused']}")
                continue
            floor = c.get("floor_us_per_pick")
            print(f"    {c['variant']:>7} C={c['cluster']:<2} {c['ms']:.4f} ms "
                  f"{c['us_per_pick']:.4f} us/pick"
                  + (f" floor {floor:.4f} us/pick" if floor is not None
                     else "")
                  + ("" if c["equal"] else " NOT EQUAL")
                  + ("" if c["device_only"] else " (host-bound)"), flush=True)
    return rows


def arm() -> dict:
    """Device ms of the public entries at SHAPES, in this process's
    package (the first entry of sys.path)."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import fps
    from articulated_pose_tpu_torch.timing import cuda_time_ms

    times = {}
    for entry, B, N, np1, np2, _ in SHAPES:
        xyz = cloud(B, N)
        if np2:
            ms, _ = cuda_time_ms(lambda: fps.fps2(xyz, np1, np2))
        else:
            ms, _ = cuda_time_ms(lambda: fps.fps(xyz, np1))
        times[label(entry, B, N, np1, np2)] = ms
    torch.cuda.synchronize()
    return times


def main(argv=None) -> int:
    from articulated_pose_tpu_torch.timing import sweep_main

    return sweep_main(argv, __file__, __doc__, sweep, arm)


if __name__ == "__main__":
    if not __package__:
        # run as a file: its directory is the package's, not an import
        # root; the checkout's root is (an --arm puts its ROOT before it)
        sys.path[0] = str(REPO)
    sys.exit(main())
