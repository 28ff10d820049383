"""Sweep the ball query's launch plans on the card, and time the six
`csrc/ball_query.cu` entries of several trees in turns.

    python -m articulated_pose_tpu_torch.bq_sweep [--out FILE]
    python articulated_pose_tpu_torch/bq_sweep.py --ab ROOT [ROOT ...]

The sweep runs `csrc/ball_query.cu` at every plan (variant (G, U),
staged or streamed) whose shared memory fits, at each
ball-query shape of the port's paths (SHAPES): device ms (median of 20
spin-queued CUDA-event calls, `timing.cuda_time_ms`) and whether every
output equals the plain version's; then the best plan and `bq_plan`'s.
`bq_plan`'s rule is read off this table.  Each shape also prints the
mean and the maximum points a query examines (a first-S query: its
cloud up to its nsample-th hit, all of it with fewer hits; a bucket
query: all of it).

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
# (entry, B, N, M, nsample, radius, emit_idx, queries, path): the queries
# are the cloud's FPS picks, as the backbone gives them (for the bucket
# tier with four a cloud moved out of it), or uniform points of the cube
# (the stage profiler's and the entries' inputs, with four queries a
# cloud moved out of it for B5g)
SHAPES = (
    ("bucket", 16, 2048, 512, 64, 0.2, False, "fps_far", "bucket B16 SA1"),
    ("bucket", 16, 512, 128, 64, 0.4, True, "fps_far", "bucket B16 SA2"),
    ("bucket", 64, 2048, 512, 64, 0.2, False, "fps_far", "bucket path SA1"),
    ("bucket", 64, 512, 128, 64, 0.4, True, "fps_far", "bucket path SA2"),
    ("group", 16, 2048, 512, 64, 0.2, False, "fps", "serving SA1"),
    ("group", 16, 512, 128, 64, 0.4, True, "fps", "serving SA2"),
    ("packed", 16, 2048, 512, 64, 0.2, False, "fps", "packed serving SA1"),
    ("packed", 16, 512, 128, 64, 0.4, True, "fps", "packed serving SA2"),
    ("packed", 64, 2048, 512, 64, 0.2, False, "fps", "bench SA1 (packed)"),
    ("packed", 64, 512, 128, 64, 0.4, True, "fps", "bench SA2 (packed)"),
    ("group", 64, 2048, 512, 64, 0.2, False, "fps", "bench SA1, exact"),
    ("group", 64, 512, 128, 64, 0.4, True, "fps", "bench SA2, exact"),
    ("idx", 4, 32768, 512, 64, 0.2, True, "fps", "large-cloud SA1"),
    ("idx", 4, 512, 128, 64, 0.4, True, "fps", "large-cloud SA2"),
    ("point", 64, 2048, 512, 64, 0.2, True, "uniform", "profiler bq1"),
    ("point", 64, 512, 128, 64, 0.4, True, "uniform", "profiler bq2"),
    ("point_grouped", 64, 2048, 512, 64, 0.2, True, "far", "B5g entry"),
    ("point_grouped", 64, 512, 128, 64, 0.4, True, "far", "B5g entry"),
    ("group", 8, 8192, 1024, 32, 0.1, False, "fps", "N-level SA1"),
    ("group", 8, 1024, 256, 32, 0.2, True, "fps", "N-level SA2"),
    ("group", 8, 256, 64, 32, 0.4, True, "fps", "N-level SA3"),
    ("group", 8, 64, 16, 32, 0.8, True, "fps", "N-level SA4"),
)


def label(entry, B, N, M, nsample, radius) -> str:
    return f"{entry} B{B} N{N} M{M} S{nsample} r{radius}"


def inputs(B: int, N: int, M: int, queries: str, seed: int = 0):
    """(cloud, queries) on the card, from `seed`."""
    import torch

    from articulated_pose_tpu_torch.ops.kernels import fps

    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32)).cuda()
    if queries.startswith("fps"):
        q = fps.fps(xyz, M)[1]
    else:
        q = torch.from_numpy(rng.rand(B, M, 3).astype(np.float32)).cuda()
    if queries.endswith("far"):
        q[:, :4] += 10.0
    return xyz, q


def public_entry(entry: str):
    """The public entry's call, as (radius, nsample, xyz, q, emit_idx) ->
    its outputs."""
    from articulated_pose_tpu_torch.ops.kernels import ball_query as bq

    return {
        "group": lambda r, s, x, q, e: bq.ball_query_group(r, s, x, q, e),
        "packed": lambda r, s, x, q, e: bq.ball_query_group_packed(
            r, s, x, q, e),
        "bucket": lambda r, s, x, q, e: bq.ball_query_group_bucket(
            r, s, x, q, e),
        "idx": lambda r, s, x, q, e: bq.ball_query_idx(r, s, x, q),
        "point": lambda r, s, x, q, e: bq.ball_query_point(r, s, x, q),
        "point_grouped": lambda r, s, x, q, e: bq.ball_query_point_grouped(
            r, s, x, q),
    }[entry]


def examined(idx, cnt, N: int):
    """(mean, max) points a first-S query examines for these outputs."""
    import torch

    S = idx.shape[-1]
    n = torch.where(cnt >= S, idx[..., -1].long() + 1, N).float()
    return n.mean().item(), int(n.max().item())


def plans():
    from articulated_pose_tpu_torch.ops.kernels import ball_query as bq

    for staged in (True, False):
        for variant in bq.VARIANTS:
            yield bq.Plan(variant, staged)


def sweep() -> list:
    import torch

    from articulated_pose_tpu_torch.ops.kernels import ball_query as bq
    from articulated_pose_tpu_torch.timing import cuda_time_ms

    kernels = {"group": bq.KERNEL, "packed": bq.PACKED_KERNEL,
               "idx": bq.IDX_KERNEL, "point": bq.POINT_KERNEL,
               "point_grouped": bq.POINT_GROUPED_KERNEL,
               "bucket": bq.BUCKET_KERNEL}
    plains = {"packed": bq.ball_query_group_packed_plain,
              "bucket": bq.ball_query_group_bucket_plain}
    rows = []
    for entry, B, N, M, S, r, emit, queries, path in SHAPES:
        xyz, q = inputs(B, N, M, queries)
        bucket = entry == "bucket"
        gp, cntp, idxp = plains.get(entry, bq.ball_query_group_plain)(
            r, S, xyz, q)
        mean, most = (N, N) if bucket else examined(idxp, cntp, N)
        kernel = kernels[entry]
        configs = []
        for plan in plans():
            if bq.smem_bytes(plan, N, S, bucket) > bq.SMEM_BYTES:
                continue

            def call(plan=plan):
                return bq.launch(kernel, r, S, xyz, q, emit, plan)

            try:
                g, cnt, idx = call()
                torch.cuda.synchronize()
                equal = (torch.equal(cnt, cntp)
                         and (idx is None or torch.equal(idx, idxp))
                         and (g is None or torch.equal(g, gp)))
                ms, device_only = cuda_time_ms(call)
            except RuntimeError as e:       # a launch the card refuses
                configs.append(dict(plan=list(plan), refused=str(e)))
                continue
            configs.append(dict(plan=list(plan), ms=ms, equal=equal,
                                device_only=device_only))
        timed = [c for c in configs if "ms" in c]
        best = min(timed, key=lambda c: c["ms"])
        plan = list(bq.bq_plan(B, N, M, S, bucket))
        planned = next(c["ms"] for c in timed if c["plan"] == plan)
        rows.append(dict(shape=label(entry, B, N, M, S, r), path=path,
                         examined_mean=mean, examined_max=most, plan=plan,
                         plan_ms=planned, best=best["plan"],
                         best_ms=best["ms"], configs=configs))
        print(f"[sweep] {rows[-1]['shape']} ({path}; examined mean "
              f"{mean:.1f}, max {most}): best {best['plan']} "
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
    for entry, B, N, M, S, r, emit, queries, _ in SHAPES:
        xyz, q = inputs(B, N, M, queries)
        fn = public_entry(entry)
        times[label(entry, B, N, M, S, r)], _ = cuda_time_ms(
            lambda: fn(r, S, xyz, q, emit))
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
