"""The 3-NN kernel's launch plan, on the CPU.

`three_nn.nn_plan` decides from the shapes alone how `csrc/three_nn.cu`
runs: the variant (G queries a thread, C lanes splitting the candidates
of a query group) and whether the candidate set is staged whole in
shared memory or streamed through it in tiles.  It needs no library, so
it is held here to its choices at the port's path shapes (the sweep on
the card that set them is in PERF.md section 6), to a plan the card can
hold for every candidate set up to B7's and the packed key's 65536, and
to the source's own variant table.  The kernel itself is held against
the plain versions on the card by tests/test_torch_kernels_cuda.py.
"""

import itertools
import re

import pytest
import torch

from articulated_pose_tpu_torch.ops.kernels import KERNELS, three_nn as nn
from articulated_pose_tpu_torch.ops.kernels.build import CSRC

NN_KERNELS = ("three_nn", "three_nn_stream", "three_nn_packed")


# (B, N, M) of each path that launches the kernel, and its plan
@pytest.mark.parametrize("B,N,M,plan", [
    (16, 512, 128, ("g1c8", True)),      # serving FP2
    (16, 2048, 512, ("g1c2", True)),      # serving FP3
    (64, 512, 128, ("g1c2", True)),       # bench / bucket FP2
    (64, 2048, 512, ("g2c1", True)),      # bench FP3, profiler threenn
    (4, 512, 128, ("g1c16", True)),       # large-cloud FP2
    (4, 32768, 512, ("g2c1", True)),      # large-cloud FP3
    (8, 64, 16, ("g1c2", True)),          # N-level FP 64 <- 16
    (8, 256, 64, ("g1c8", True)),         # N-level FP 256 <- 64
    (8, 1024, 256, ("g1c8", True)),      # N-level FP 1024 <- 256
    (8, 8192, 1024, ("g1c1", True)),      # N-level FP 8192 <- 1024
    (4, 2048, 16384, ("g2c16", False)),   # B7 entry
    (4, 2048, 3000, ("g1c8", True)),     # B7 entry, M off the tile
])
def test_plan_at_path_shapes(B, N, M, plan):
    assert nn.nn_plan(B, N, M) == plan
    # decided without building or loading the library
    assert all(KERNELS[k]._lib is None for k in NN_KERNELS)


def test_packed_plan():
    # the packed keys take eight queries a thread (B9's entry shape)
    assert nn.nn_plan(64, 2048, 512, packed=True) == ("g8c4", True)
    assert nn.nn_plan(4, 2048, 16384, packed=True) == ("g8c32", False)


@pytest.mark.parametrize("M", [1, 2, 3, 16, 31, 128, 512, 1024, 3000, 4096,
                               4097, 16384, 65536, 1 << 20])
def test_plan_holds_every_candidate_set(M):
    for (B, N), packed in itertools.product(
            ((1, 1), (4, 2048), (64, 2048), (4, 32768), (2, 100000)),
            (False, True)):
        plan = nn.nn_plan(B, N, M, packed)
        G, C = nn.VARIANTS[plan.variant]
        assert nn.smem_bytes(plan, M) <= nn.SMEM_BYTES
        # staged where the sweep staged; a streamed launch holds two
        # tiles whatever M
        assert plan.staged == (M <= nn.STAGE_CANDIDATES)
        assert plan.staged or nn.smem_bytes(plan, M) == \
            32 * nn.TILE_CANDIDATES
        # a grid the card launches, and a slice of candidates for every
        # lane where M has them
        assert B * -(-N // nn.queries_per_cta(plan)) < 2 ** 31
        assert C == 1 or M // C >= nn.MIN_SLICE


def test_shared_memory_layout():
    # float4 a candidate, staged; two tiles of them, streamed
    assert nn.smem_bytes(nn.Plan("g2c8", True), 512) == 16 * 512
    assert nn.smem_bytes(nn.Plan("g1c32", False), 10 ** 6) == 16 * 4096
    assert nn.queries_per_cta(nn.Plan("g8c4", True)) == 256 // 4 * 8
    assert nn.queries_per_cta(nn.Plan("g1c1", False)) == 256


def test_variants_match_the_source():
    # the wrapper passes a variant as its index in csrc/three_nn.cu's
    # NN_VARIANTS; the tile and CTA sizes are the source's too
    src = (CSRC / "three_nn.cu").read_text()
    table = src[src.index("#define NN_VARIANTS"):src.index("struct Args")]
    pairs = [tuple(map(int, p))
             for p in re.findall(r"X\((\d+), (\d+)\)", table)]
    assert pairs == list(nn.VARIANTS.values())
    assert f"kTile = {nn.TILE_CANDIDATES};" in src
    assert f"kThreads = {nn.CTA_THREADS};" in src


@pytest.mark.parametrize("B,N,M", [(0, 2048, 512), (2, 0, 512), (2, 2048, 0)])
def test_plan_rejects_empty_problems(B, N, M):
    with pytest.raises(ValueError):
        nn.nn_plan(B, N, M)


def test_sweep_needs_a_card():
    from articulated_pose_tpu_torch import nn_sweep

    if torch.cuda.is_available():
        pytest.skip("the sweep runs on a card that is present")
    assert nn_sweep.main([]) == 2
    assert nn_sweep.main(["--ab", "."]) == 2
    # every shape the sweep times has a plan, and every plan it tries is
    # one the kernel has
    for _, B, N, M, *_ in nn_sweep.SHAPES:
        assert nn.nn_plan(B, N, M).variant in nn.VARIANTS
    assert {p.variant for p in nn_sweep.plans()} == set(nn.VARIANTS)
    assert {p.staged for p in nn_sweep.plans()} == {True, False}
