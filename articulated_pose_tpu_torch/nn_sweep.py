"""Sweep the 3-NN kernel's launch plans on the card, and time the three
`csrc/three_nn.cu` entries of several trees in turns.

    python -m articulated_pose_tpu_torch.nn_sweep [--out FILE]
    python articulated_pose_tpu_torch/nn_sweep.py --ab ROOT [ROOT ...]

The sweep runs `csrc/three_nn.cu` at every plan (variant (G, C), staged
or streamed) whose shared memory fits, at each 3-NN shape of the port's
paths and at the B7 and B9 entries' shapes (SHAPES): device ms (median
of 20 spin-queued CUDA-event calls, `timing.cuda_time_ms`) and whether
the outputs equal the plain version's (B9's distances: equal, or one
key quantum off); then the best plan and `nn_plan`'s.  `nn_plan`'s rule
is read off this table.

`--ab` times the public entries at the same shapes in one process per
ROOT, in the order given (e.g. parent, new, new, parent), each ROOT a
checkout whose own package is imported and built; so two designs
compare on one card in one call.  Every reading needs a CUDA device;
without one the script exits 2.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
# (entry, B, N, M, candidates, path): the candidates are the queries'
# FPS picks, as the FP stages get them (the coarser level's points), or
# uniform points of the cube (the entries' inputs)
SHAPES = (
    ("three_nn", 16, 512, 128, "fps", "serving FP2"),
    ("three_nn", 16, 2048, 512, "fps", "serving FP3"),
    ("three_nn", 64, 512, 128, "fps", "bench FP2"),
    ("three_nn", 64, 2048, 512, "fps", "bench FP3, profiler threenn"),
    ("three_nn", 4, 512, 128, "fps", "large-cloud FP2"),
    ("three_nn", 4, 32768, 512, "fps", "large-cloud FP3"),
    ("three_nn", 8, 64, 16, "fps", "N-level FP 64<-16"),
    ("three_nn", 8, 256, 64, "fps", "N-level FP 256<-64"),
    ("three_nn", 8, 1024, 256, "fps", "N-level FP 1024<-256"),
    ("three_nn", 8, 8192, 1024, "fps", "N-level FP 8192<-1024"),
    ("stream", 4, 2048, 16384, "uniform", "B7 entry"),
    ("stream", 4, 2048, 3000, "uniform", "B7 entry"),
    ("packed", 64, 2048, 512, "uniform", "B9 entry"),
)


def label(entry, B, N, M) -> str:
    return f"{entry} B{B} N{N}<-{M}"


def inputs(B: int, N: int, M: int, candidates: str, seed: int = 0):
    """(queries, candidates) on the card, from `seed`."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import fps

    rng = np.random.RandomState(seed)
    xyz1 = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32)).cuda()
    if candidates == "fps":
        return xyz1, fps.fps(xyz1, M)[1]
    return xyz1, torch.from_numpy(rng.rand(B, M, 3).astype(np.float32)).cuda()


def public_entry(entry: str):
    from articulated_pose_tpu_torch.ops.kernels import three_nn

    return {"three_nn": three_nn.three_nn,
            "stream": three_nn.three_nn_stream,
            "packed": three_nn.three_nn_packed}[entry]


def plans():
    from articulated_pose_tpu_torch.ops.kernels import three_nn

    for staged in (True, False):
        for variant in three_nn.VARIANTS:
            yield three_nn.Plan(variant, staged)


def same(entry: str, got, want) -> bool:
    """Indices equal; distances equal (B9: or one key quantum off)."""
    import torch

    (d, i), (dp, ip) = got, want
    if entry != "packed":
        return torch.equal(i, ip) and torch.equal(d, dp)
    bits = (d.view(torch.int32) - dp.view(torch.int32)).abs()
    return torch.equal(i, ip) and bool(((bits == 0)
                                        | (bits == 1 << 16)).all())


def sweep() -> list:
    import torch

    from articulated_pose_tpu_torch.ops.kernels import three_nn as nn
    from articulated_pose_tpu_torch.timing import cuda_time_ms

    kernels = {"three_nn": nn.KERNEL, "stream": nn.STREAM_KERNEL,
               "packed": nn.PACKED_KERNEL}
    rows = []
    for entry, B, N, M, candidates, path in SHAPES:
        xyz1, xyz2 = inputs(B, N, M, candidates)
        plain = (nn.three_nn_packed_plain if entry == "packed"
                 else nn.three_nn_plain)
        want = plain(xyz1, xyz2)
        kernel = kernels[entry]
        configs = []
        for plan in plans():
            if nn.smem_bytes(plan, M) > nn.SMEM_BYTES:
                continue

            def call(plan=plan):
                return nn.launch(kernel, xyz1, xyz2, plan)

            try:
                got = call()
                torch.cuda.synchronize()
                equal = same(entry, got, want)
                ms, device_only = cuda_time_ms(call)
            except RuntimeError as e:       # a launch the card refuses
                configs.append(dict(plan=list(plan), refused=str(e)))
                continue
            configs.append(dict(plan=list(plan), ms=ms, equal=equal,
                                device_only=device_only))
        timed = [c for c in configs if "ms" in c]
        best = min(timed, key=lambda c: c["ms"])
        plan = list(nn.nn_plan(B, N, M, entry == "packed"))
        planned = next(c["ms"] for c in timed if c["plan"] == plan)
        rows.append(dict(shape=label(entry, B, N, M), path=path, plan=plan,
                         plan_ms=planned, best=best["plan"],
                         best_ms=best["ms"], configs=configs))
        print(f"[sweep] {rows[-1]['shape']} ({path}): best {best['plan']} "
              f"{best['ms']:.4f} ms; plan {plan} {planned:.4f} ms",
              flush=True)
        for c in sorted(configs, key=lambda c: c.get("ms", 1e9)):
            if "ms" not in c:
                print(f"    {c['plan']} refused: {c['refused']}")
                continue
            print(f"    {c['plan']} {c['ms']:.4f} ms"
                  + ("" if c["equal"] else " NOT EQUAL")
                  + ("" if c["device_only"] else " (host-bound)"), flush=True)
    return rows


def arm() -> dict:
    """Device ms of the public entries at SHAPES, in this process's
    package (the first entry of sys.path)."""
    import torch

    from articulated_pose_tpu_torch.timing import cuda_time_ms

    times = {}
    for entry, B, N, M, candidates, _ in SHAPES:
        xyz1, xyz2 = inputs(B, N, M, candidates)
        fn = public_entry(entry)
        times[label(entry, B, N, M)], _ = cuda_time_ms(
            lambda: fn(xyz1, xyz2))
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
