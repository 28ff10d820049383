"""The ball query's launch plan, on the CPU.

`ball_query.bq_plan` decides from the shapes alone how `csrc/
ball_query.cu` runs, for the first-S tiers and the bucket tier: the
variant (G queries a warp, U points a lane a step) and whether the
cloud is staged whole in shared memory or streamed through it.  It
needs no library, so it is held here to its choices at the port's path
shapes (the sweep on the card that set them is in PERF.md section 6),
to a plan the card can hold for every cloud up to 2^24 points, and to
the source's own variant table.  The kernel itself is held against the
plain versions on the card by tests/test_torch_kernels_cuda.py.
"""

import re

import pytest
import torch

from articulated_pose_tpu_torch.ops.kernels import KERNELS, ball_query as bq
from articulated_pose_tpu_torch.ops.kernels.build import CSRC


# (B, N, M, nsample) of each path that launches the scan, and its plan
@pytest.mark.parametrize("B,N,M,S,plan", [
    (16, 2048, 512, 64, ("g4u4", True)),     # serving SA1 (exact, packed)
    (16, 512, 128, 64, ("g1u4", True)),      # serving SA2
    (64, 2048, 512, 64, ("g4u4", True)),     # bench SA1, profiler bq1, B5g
    (64, 512, 128, 64, ("g4u4", True)),      # bench SA2, profiler bq2, B5g
    (4, 32768, 512, 64, ("g1u8", False)),    # large-cloud SA1
    (4, 512, 128, 64, ("g1u4", True)),       # large-cloud SA2
    (1, 32768, 512, 64, ("g1u8", False)),
    (8, 8192, 1024, 32, ("g4u8", False)),    # N-level SA1
    (8, 1024, 256, 32, ("g1u4", True)),      # N-level SA2
    (8, 256, 64, 32, ("g1u4", True)),        # N-level SA3
    (8, 64, 16, 32, ("g1u4", True)),         # N-level SA4
    (16, 2048, 512, 1500, ("g1u8", False)),  # slots crowd the cloud out
])
def test_plan_at_path_shapes(B, N, M, S, plan):
    assert bq.bq_plan(B, N, M, S) == plan
    # decided without building or loading the library
    assert all(KERNELS[k]._lib is None for k in
               ("ball_query_group", "ball_query_group_packed",
                "ball_query_idx", "ball_query_point",
                "ball_query_point_grouped"))


# the bucket tier takes its plan from the same rule: (B, N, M, nsample)
# of the bucket path at the serving batch and at B = 64
@pytest.mark.parametrize("B,N,M,S,plan", [
    (16, 2048, 512, 64, ("g4u8", True)),     # bucket SA1, W = 32
    (16, 512, 128, 64, ("g1u4", True)),      # bucket SA2, W = 8
    (64, 2048, 512, 64, ("g4u8", True)),     # bucket path SA1
    (64, 512, 128, 64, ("g4u8", True)),      # bucket path SA2
    (2, 8192, 40, 2, ("g1u8", False)),       # W = 4096 > a streamed tile
    (16, 2048, 512, 2048, ("g1u8", False)),  # W = 1: slots crowd it out
])
def test_bucket_plan_at_path_shapes(B, N, M, S, plan):
    assert bq.bq_plan(B, N, M, S, bucket=True) == plan
    assert KERNELS["ball_query_group_bucket"]._lib is None


@pytest.mark.parametrize("N", [100, 2000, 2048, 3001, 32768, 100003,
                               1 << 20])
def test_bucket_plan_holds_every_cloud(N):
    n_pad = -(-N // 128) * 128
    for S in (1, 8, 64, 128):
        if n_pad % S or (n_pad // S) & (n_pad // S - 1):
            continue                        # no power-of-two bucket
        for B, M in ((1, 1), (16, 512), (64, 512)):
            plan = bq.bq_plan(B, N, M, S, bucket=True)
            assert bq.smem_bytes(plan, N, S, bucket=True) <= bq.SMEM_BYTES
            assert not plan.staged or N <= bq.STAGE_POINTS


def test_variants_match_the_source():
    # the wrapper passes a variant as its index in csrc/ball_query.cu's
    # BQ_VARIANTS; the streamed tile is the source's too
    src = (CSRC / "ball_query.cu").read_text()
    table = src[src.index("#define BQ_VARIANTS"):]
    table = table[:table.index("\n")]
    pairs = [tuple(map(int, p))
             for p in re.findall(r"X\((\d+), (\d+)\)", table)]
    assert pairs == list(bq.VARIANTS.values())
    assert f"kTile = {bq.TILE_POINTS};" in src


@pytest.mark.parametrize("N", [1, 31, 32, 33, 100, 127, 128, 129, 2047, 2048,
                               2049, 8192, 32768, 100003, 1 << 20,
                               (1 << 24) - 1, 1 << 24, (1 << 24) + 1000])
def test_plan_holds_every_cloud(N):
    for B, M in ((1, 1), (4, 512), (64, 512), (2, 100000)):
        for S in (1, 32, 64, 1500):
            plan = bq.bq_plan(B, N, M, S)
            assert plan.variant in bq.VARIANTS
            assert bq.smem_bytes(plan, N, S) <= bq.SMEM_BYTES
            # staged only where the sweep staged; a streamed tile holds
            # TILE_POINTS whatever N
            assert not plan.staged or N <= bq.STAGE_POINTS
            assert plan.staged or bq.smem_bytes(plan, N, S) == \
                bq.smem_bytes(plan, bq.TILE_POINTS, S)


def test_shared_memory_layout():
    # tile of float4, bitmaps (a word per 32 points), slots, queries, box
    plan = bq.Plan("g4u4", True)
    assert bq.queries_per_cta(plan) == 32
    assert bq.smem_bytes(plan, 2000, 64) == (
        16 * 2048 + 4 * 32 * (2048 // 32) + 4 * 32 * 64 + 4 * 32 * 3 + 36)
    assert bq.smem_bytes(bq.Plan("g1u8", False), 10 ** 6, 64) == (
        16 * 2048 + 4 * 8 * (64 + 64 + 3) + 36)
    # the bucket tier adds a hit flag a query
    assert bq.smem_bytes(plan, 2000, 64, bucket=True) == (
        bq.smem_bytes(plan, 2000, 64) + 4 * 32)


@pytest.mark.parametrize("B,N,M,S", [(0, 2048, 512, 64), (2, 0, 512, 64),
                                     (2, 2048, 0, 64), (2, 2048, 512, 0),
                                     (2, 2048, 512, 10 ** 5)])
def test_plan_rejects_what_no_launch_holds(B, N, M, S):
    with pytest.raises(ValueError):
        bq.bq_plan(B, N, M, S)


def test_sweep_needs_a_card():
    from articulated_pose_tpu_torch import bq_sweep

    if torch.cuda.is_available():
        pytest.skip("the sweep runs on a card that is present")
    assert bq_sweep.main([]) == 2
    assert bq_sweep.main(["--ab", "."]) == 2
    # every shape the sweep times has a plan, and every plan it tries is
    # one the kernel has
    for _, B, N, M, S, *_ in bq_sweep.SHAPES:
        assert bq.bq_plan(B, N, M, S).variant in bq.VARIANTS
    assert {p.variant for p in bq_sweep.plans()} == set(bq.VARIANTS)
