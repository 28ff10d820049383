"""CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernels are built at
first use) and skips without one.  Run them on a GPU host with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(`--noconftest` because tests/conftest.py imports jax, which a GPU host
need not have.)

The kernels repeat the plain versions' arithmetic operation for
operation with round-to-nearest intrinsics, so indices and counts must
be equal, not just close.  Shapes are the serving path's at B=16 and
the large-cloud path's (N=32768) at B=1-4; FPS also at every cluster
size, on tie-heavy grid clouds, ragged slices and at each variant's
boundary (N up to 100003); the first-S ball query at every launch plan
(`ball_query.bq_plan`'s branches and each (variant, staged) the
kernel has) on ragged, boundary-heavy, all-hit, zero-hit and duplicate-
point clouds up to N = 100003; the bucket tier at every plan, bucket
widths 1 to 4096 (wider than a streamed tile), zero-hit queries and
first hits late in the cloud, N up to 100003, and at the bucket path's
B=64; the rank-select ball query and the packed 3-NN at the stage
profiler's B=64; the 3-NN kernel at every (G, C), staged and streamed,
with ties across the lanes' slices and tiles, M = 1, 2, 3 and 33, at
every path shape and at (4, 2048 <- 16384); the k-NN kernel at the
Point Transformer cell's nine searches (B=16) and at k = 1, 3, 8, 16 on
every lane count with planted ties, and the Point Transformer predictor
replayed against eager.  The joint_fit kernel picks the plain joint
stage's hypotheses and inlier sets in every problem, and its poses
within 1e-5, eagerly and replayed, at the served shapes (B=64, N=2048;
B=16, N=8192; B=256), with K=2, K=4 and a prismatic joint (grouped by
type or not), the eval knobs (H=128) and parts of 2 or 0 points.  The served bf16 program's replay folds the
batch-norm state it finds: after new statistics are loaded in place it
equals a fresh eager call.  One train step at the
reference widths is held against the same step on the CPU.  A captured
program's stage mark times a known spin of the card within 5 % of
eager events, and the replayed predictor reads its four stages; its
results own page-locked host blocks that later calls reuse once
dropped and never overwrite while held; a capture runs with the garbage
collector off.  The vector_attention kernel holds the plain Point
Transformer layer's output (within f32 sum orders, and a bf16 rounding
flipped in at most a few per cent of outputs) at the cell's five levels
in bf16 and f32, at any k up to 16, with planted ties, and refuses what
it does not take; the published-width predictor launches it in all 18
layers.  The MinkUNet predictor replays its fit alone, and its forward
on the card equals the CPU's at tiny widths.
"""

import numpy as np
import pytest
import torch

from articulated_pose_tpu_torch.ops.kernels import (KERNELS, ball_query, fps,
                                                    knn, three_nn)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(seed, B, N, dev):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(B, N, 3).astype(np.float32)).to(dev)


def test_fps2_matches_plain(dev):
    xyz = _cloud(0, 16, 2048, dev)
    before = KERNELS["fps2"].launches
    got = fps.fps2(xyz, 512, 128)
    torch.cuda.synchronize()
    assert KERNELS["fps2"].launches == before + 1
    want = fps.fps2_plain(xyz, 512, 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the plan splits a large cloud over a cluster; N = 100003 streams over
# 16 CTAs
@pytest.mark.parametrize("N,plan", [(20000, ("w4p16", 16)),
                                    (32768, ("w4p16", 16)),
                                    (100003, ("stream", 16))])
def test_fps2_large_clouds_match_plain(dev, N, plan):
    xyz = _cloud(7, 2, N, dev)
    assert fps.fps_plan(2, N, 512) == plan
    got = fps.fps2(xyz, 512, 128)
    torch.cuda.synchronize()
    want = fps.fps2_plain(xyz, 512, 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("N,M,r", [(2048, 512, 0.2), (512, 128, 0.4)])
@pytest.mark.parametrize("emit_idx", [True, False])
def test_ball_query_group_packed_matches_plain(dev, N, M, r, emit_idx):
    xyz = _cloud(8, 16, N, dev)
    q = xyz[:, :M].contiguous()
    before = KERNELS["ball_query_group_packed"].launches
    g, cnt, idx = ball_query.ball_query_group_packed(r, 64, xyz, q, emit_idx)
    torch.cuda.synchronize()
    assert KERNELS["ball_query_group_packed"].launches == before + 1
    gp, cntp, idxp = ball_query.ball_query_group_packed_plain(r, 64, xyz, q)
    assert torch.equal(cnt, cntp)
    assert torch.equal(g, gp)
    if emit_idx:
        assert torch.equal(idx, idxp)
    else:
        assert idx is None


def test_ball_query_group_packed_zero_hits(dev):
    xyz = _cloud(9, 2, 100, dev)
    far = torch.full((2, 3, 3), 10.0, device=dev)
    g, cnt, idx = ball_query.ball_query_group_packed(0.1, 8, xyz, far)
    gp, _, _ = ball_query.ball_query_group_packed_plain(0.1, 8, xyz, far)
    assert (cnt == 0).all() and (idx == 0).all()
    assert torch.equal(g, gp)


@pytest.mark.parametrize("B,N,M,r", [(4, 32768, 512, 0.2), (4, 512, 128, 0.4),
                                     (2, 700, 1100, 0.3)])
def test_ball_query_idx_matches_plain(dev, B, N, M, r):
    xyz = _cloud(10, B, N, dev)
    q = _cloud(11, B, M, dev)
    before = KERNELS["ball_query_idx"].launches
    idx, cnt = ball_query.ball_query_idx(r, 64, xyz, q)
    torch.cuda.synchronize()
    assert KERNELS["ball_query_idx"].launches == before + 1
    idxp, cntp = ball_query.ball_query_idx_plain(r, 64, xyz, q)
    assert torch.equal(cnt, cntp)
    assert torch.equal(idx, idxp)


@pytest.mark.parametrize("N,M,r", [(2048, 512, 0.2), (512, 128, 0.4)])
@pytest.mark.parametrize("emit_idx", [True, False])
def test_ball_query_group_matches_plain(dev, N, M, r, emit_idx):
    xyz = _cloud(1, 16, N, dev)
    q = xyz[:, :M].contiguous()
    g, cnt, idx = ball_query.ball_query_group(r, 64, xyz, q, emit_idx)
    torch.cuda.synchronize()
    gp, cntp, idxp = ball_query.ball_query_group_plain(r, 64, xyz, q)
    assert torch.equal(cnt, cntp)
    # the kernel and the plain version compute the same f32 subtraction
    assert torch.equal(g, gp)
    if emit_idx:
        assert torch.equal(idx, idxp)
    else:
        assert idx is None


def test_ball_query_group_edge_cases(dev):
    xyz = _cloud(2, 2, 100, dev)                # N not a multiple of 32
    far = torch.full((2, 3, 3), 10.0, device=dev)
    g, cnt, idx = ball_query.ball_query_group(0.1, 8, xyz, far)
    assert (cnt == 0).all() and (idx == 0).all()
    assert torch.equal(g, xyz[:, :1, None, :].expand(2, 3, 8, 3)
                       - far[:, :, None, :])
    centre = torch.full((2, 1, 3), 0.5, device=dev)
    _, cnt, idx = ball_query.ball_query_group(5.0, 40, xyz, centre)
    assert (cnt == 40).all()
    assert torch.equal(idx[0, 0].cpu(), torch.arange(40, dtype=torch.int32))


@pytest.mark.parametrize("N,M", [(512, 128), (2048, 512), (700, 1100), (64, 2)])
def test_three_nn_matches_plain(dev, N, M):
    xyz1 = _cloud(3, 16, N, dev)
    xyz2 = _cloud(4, 16, M, dev)
    xyz2[:, 1] = xyz2[:, 0]                     # an exact tie: lowest index
    d, i = three_nn.three_nn(xyz1, xyz2)
    torch.cuda.synchronize()
    dp, ip = three_nn.three_nn_plain(xyz1, xyz2)
    assert torch.equal(i, ip)
    assert torch.equal(d, dp)


# single-level FPS (B2) at the plan's choice for the path shapes and
# for N = 100003
@pytest.mark.parametrize("N,plan", [(2048, ("w4p16", 1)),
                                    (20000, ("w4p16", 16)),
                                    (100003, ("stream", 16))])
def test_fps_matches_plain(dev, N, plan):
    B = 2 if N > 2048 else 16
    xyz = _cloud(12, B, N, dev)
    assert fps.fps_plan(B, N, 512) == plan
    before = KERNELS["fps"].launches
    got = fps.fps(xyz, 512)
    torch.cuda.synchronize()
    assert KERNELS["fps"].launches == before + 1
    want = fps.fps_plain(xyz, 512)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _grid_cloud(seed, B, N, side, dev):
    """Points on a coarse integer grid (exact duplicates, exactly equal
    distances), scaled by a power of two so the arithmetic stays exact."""
    g = np.random.RandomState(seed).randint(0, side, (B, N, 3))
    return torch.from_numpy((g * 0.125).astype(np.float32)).to(dev)


# the register variants, smallest first
BY_CAPACITY = sorted((v for v in fps.VARIANTS if fps.capacity(v)),
                     key=fps.capacity)


def _fitting(N, cluster):
    """The smallest register variant that holds N points at `cluster`."""
    return next((v for v in BY_CAPACITY if fps.fits(v, N, cluster)),
                "stream")


def _check_launch(xyz, np1, np2, variant, cluster):
    kernel = fps.KERNEL if np2 else fps.SINGLE_KERNEL
    before = kernel.launches
    got = fps.launch(kernel, xyz, np1, np2, variant, cluster)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if np2:
        want = fps.fps2_plain(xyz, np1, np2)
    else:
        got, want = got[:2], fps.fps_plain(xyz, np1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# every cluster size, forced: N = 3001 is ragged at every C (no multiple
# of C x threads), and the register variant and the streamed one both
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("streamed", [False, True])
def test_fps_every_cluster_size(dev, cluster, streamed):
    xyz = _cloud(30, 3, 3001, dev)
    variant = "stream" if streamed else _fitting(3001, cluster)
    _check_launch(xyz, 512, 128, variant, cluster)
    _check_launch(xyz, 700, 0, variant, cluster)


# ties: a coarse grid puts equal distances in different warps and CTAs;
# side 4 leaves 64 positions, so most picks are ties at distance 0
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("side", [4, 16])
def test_fps_tie_heavy_grid(dev, cluster, side):
    xyz = _grid_cloud(31, 4, 4096, side, dev)
    _check_launch(xyz, 512, 128, _fitting(4096, cluster), cluster)
    _check_launch(xyz, 300, 0, "stream", cluster)


# fewer points than C x threads: whole CTAs and warps hold nothing
@pytest.mark.parametrize("N,variant,cluster", [(100, "w4p8", 16),
                                               (40, "w4p16", 4),
                                               (33, "w1p4", 2),
                                               (5, "stream", 16)])
def test_fps_ragged_small_clouds(dev, N, variant, cluster):
    xyz = _cloud(32, 3, N, dev)
    _check_launch(xyz, N, min(N, 7), variant, cluster)
    _check_launch(xyz, N // 2 + 1, 0, variant, cluster)


def test_fps_edge_pick_counts(dev):
    xyz = _cloud(33, 2, 2048, dev)
    for fn, args in ((fps.fps, (1,)), (fps.fps2, (1, 1)),
                     (fps.fps2, (2048, 128)), (fps.fps, (2048,))):
        got = fn(xyz, *args)
        plain = fps.fps_plain if fn is fps.fps else fps.fps2_plain
        for g, w in zip(got, plain(xyz, *args)):
            assert torch.equal(g, w)
    # np1 = N at 16 CTAs: level 2 holds more than its registers, streams
    assert fps.streams("w1p4", 2048, 128)
    _check_launch(xyz, 2048, 128, "w1p4", 16)


# more picks than points (R6): past the cloud's last distinct point every
# pick is index 0, and no step runs; at every cluster size, so that CTAs
# holding no point leave the loop with the others
@pytest.mark.parametrize("N", [1, 100, 511])
@pytest.mark.parametrize("cluster", [1, 2, 16])
@pytest.mark.parametrize("streamed", [False, True])
def test_fps_more_picks_than_points(dev, N, cluster, streamed):
    xyz = _cloud(36, 3, N, dev)
    variant = "stream" if streamed else _fitting(N, cluster)
    _check_launch(xyz, 512, 0, variant, cluster)
    _check_launch(xyz, 512, 128, variant, cluster)
    _check_launch(xyz, 64, 96, variant, cluster)


@pytest.mark.parametrize("N", [1, 100, 511])
def test_fps_wrappers_more_picks_than_points(dev, N):
    xyz = _cloud(37, 4, N, dev)
    for fn, plain, args in ((fps.fps, fps.fps_plain, (512,)),
                            (fps.fps2, fps.fps2_plain, (512, 128))):
        got = fn(xyz, *args)
        torch.cuda.synchronize()
        for g, w in zip(got, plain(xyz, *args)):
            assert torch.equal(g, w)
        assert (got[0][:, N:] == 0).all()


def test_fps2_one_large_cloud(dev):
    xyz = _cloud(34, 1, 32768, dev)
    assert fps.fps_plan(1, 32768, 512)[1] == 16
    got = fps.fps2(xyz, 512, 128)
    torch.cuda.synchronize()
    for g, w in zip(got, fps.fps2_plain(xyz, 512, 128)):
        assert torch.equal(g, w)


# each register variant at exactly its capacity a CTA, and one point
# past it, which the wrapper refuses
@pytest.mark.parametrize("variant", [v for v in fps.VARIANTS
                                     if v != "stream"])
def test_fps_variant_boundaries(dev, variant):
    cap = fps.capacity(variant)
    xyz = _cloud(35, 2, 2 * cap + 1, dev)
    _check_launch(xyz[:, :cap].contiguous(), min(cap, 256), 0, variant, 1)
    _check_launch(xyz[:, :2 * cap].contiguous(), 256, 64, variant, 2)
    with pytest.raises(ValueError, match="holds"):
        fps.launch(fps.SINGLE_KERNEL, xyz, 8, 0, variant, 2)


# the bucket tier (B8) at the serving shapes: SA1 2048 -> 512 (W = 32),
# SA2 512 -> 128 (W = 8), and a cloud that pads (2000 -> 2048)
@pytest.mark.parametrize("N,M,r", [(2048, 512, 0.2), (512, 128, 0.4),
                                   (2000, 300, 0.3)])
@pytest.mark.parametrize("emit_idx", [True, False])
def test_ball_query_group_bucket_matches_plain(dev, N, M, r, emit_idx):
    xyz = _cloud(13, 16, N, dev)
    q = xyz[:, :M].clone()
    q[:, :3] += 5.0                             # queries with no hit
    before = KERNELS["ball_query_group_bucket"].launches
    g, cnt, idx = ball_query.ball_query_group_bucket(r, 64, xyz, q, emit_idx)
    torch.cuda.synchronize()
    assert KERNELS["ball_query_group_bucket"].launches == before + 1
    gp, cntp, idxp = ball_query.ball_query_group_bucket_plain(r, 64, xyz, q)
    assert (cntp[:, :3] == 0).all() and (cntp[:, 3:] > 0).all()
    assert torch.equal(cnt, cntp)
    assert torch.equal(g, gp)
    if emit_idx:
        assert torch.equal(idx, idxp)
    else:
        assert idx is None


@pytest.mark.parametrize("N,S", [(100, 128), (77, 1), (1000, 8)])
def test_ball_query_group_bucket_bucket_widths(dev, N, S):
    # W = 1: every point its own slot, slots 100..127 past the cloud;
    # W = 128 over 77 points: one slot; W = 128 over 1000 points: a
    # bucket spans four warp steps, the last one ends at the cloud's end
    xyz = _cloud(14, 2, N, dev)
    q = _cloud(15, 2, 40, dev)
    got = ball_query.ball_query_group_bucket(0.4, S, xyz, q)
    torch.cuda.synchronize()
    for g, w in zip(got, ball_query.ball_query_group_bucket_plain(0.4, S, xyz,
                                                                  q)):
        assert torch.equal(g, w)


# B5: the idx-only scan under its own entry, at the stage profiler's
# bq1 / bq2 shapes and a ragged one with more queries than points
@pytest.mark.parametrize("B,N,M,r", [(64, 2048, 512, 0.2), (64, 512, 128, 0.4),
                                     (2, 700, 1100, 0.3)])
def test_ball_query_point_matches_plain(dev, B, N, M, r):
    xyz = _cloud(16, B, N, dev)
    q = _cloud(17, B, M, dev)
    before = KERNELS["ball_query_point"].launches
    idx, cnt = ball_query.ball_query_point(r, 64, xyz, q)
    torch.cuda.synchronize()
    assert KERNELS["ball_query_point"].launches == before + 1
    idxp, cntp = ball_query.ball_query_point_plain(r, 64, xyz, q)
    assert torch.equal(cnt, cntp)
    assert torch.equal(idx, idxp)


def test_ball_query_point_takes_clouds_past_2_24(dev):
    # ball_query_idx refuses N >= 2^24 (the stream tier's f32 index); B5
    # has no such limit, and the scan's offsets are 64-bit
    # points past 2^24 sit apart, so the queries among them hit only there
    N = (1 << 24) + 1000
    xyz = _cloud(18, 1, N, dev)
    xyz[:, 1 << 24:] += 2.0
    q = torch.cat([xyz[:, -3:], xyz[:, :2]], 1).contiguous()
    idx, cnt = ball_query.ball_query_point(0.2, 16, xyz, q)
    torch.cuda.synchronize()
    idxp, cntp = ball_query.ball_query_point_plain(0.2, 16, xyz, q)
    assert torch.equal(cnt, cntp) and torch.equal(idx, idxp)
    assert (idx[0, :3] >= 1 << 24).all() and (cnt[0, :3] > 1).all()


@pytest.mark.parametrize("N,M,r", [(2048, 512, 0.2), (512, 128, 0.4),
                                   (700, 1100, 0.3)])
def test_ball_query_point_grouped_matches_plain(dev, N, M, r):
    xyz = _cloud(19, 8, N, dev)
    q = _cloud(20, 8, M, dev)
    q[:, :3] += 5.0                             # queries with no hit
    before = KERNELS["ball_query_point_grouped"].launches
    idx, cnt, g = ball_query.ball_query_point_grouped(r, 64, xyz, q)
    torch.cuda.synchronize()
    assert KERNELS["ball_query_point_grouped"].launches == before + 1
    idxp, cntp, gp = ball_query.ball_query_point_grouped_plain(r, 64, xyz, q)
    assert (cnt[:, :3] == 0).all() and (idx[:, :3] == 0).all()
    assert torch.equal(cnt, cntp)
    assert torch.equal(idx, idxp)
    assert torch.equal(g, gp)


# B7: K3 under its own entry, at tests/test_pallas_tpu.py:248's shape and
# at Ms off the 512-candidate tile, with an exact tie across tiles
@pytest.mark.parametrize("B,N,M", [(4, 2048, 16384), (2, 300, 1100),
                                   (2, 100, 513)])
def test_three_nn_stream_matches_plain(dev, B, N, M):
    xyz1 = _cloud(21, B, N, dev)
    xyz2 = _cloud(22, B, M, dev)
    xyz2[:, 512] = xyz2[:, 7]
    xyz1[:, 0] = xyz2[:, 7]
    before = KERNELS["three_nn_stream"].launches
    d, i = three_nn.three_nn_stream(xyz1, xyz2)
    torch.cuda.synchronize()
    assert KERNELS["three_nn_stream"].launches == before + 1
    dp, ip = three_nn.three_nn_stream_plain(xyz1, xyz2)
    assert torch.equal(i, ip)
    assert torch.equal(d, dp)
    assert (i[:, 0, :2] == torch.tensor([7, 512], device=dev)).all()


@pytest.mark.parametrize("M", [1, 2])
def test_three_nn_spare_slots(dev, M):
    xyz1 = _cloud(23, 2, 40, dev)
    xyz2 = _cloud(24, 2, M, dev)
    d, i = three_nn.three_nn_stream(xyz1, xyz2)
    dp, ip = three_nn.three_nn_stream_plain(xyz1, xyz2)
    assert torch.equal(i, ip) and torch.equal(d, dp)
    assert torch.isinf(d[..., M:]).all() and (i[..., M:] == 0).all()
    d, i = three_nn.three_nn_packed(xyz1, xyz2)
    dp, ip = three_nn.three_nn_packed_plain(xyz1, xyz2)
    assert torch.equal(i, ip)
    assert torch.equal(d.view(torch.int32), dp.view(torch.int32))
    assert (i[..., M:] == 65535).all()
    assert (d[..., M:].view(torch.int32) == 0x7FFF0000).all()


# B9 at ab_threenn_packed.py's shape, a ragged one and a duplicate point
@pytest.mark.parametrize("B,N,M", [(64, 2048, 512), (2, 300, 1100),
                                   (2, 100, 40)])
def test_three_nn_packed_matches_plain(dev, B, N, M):
    xyz1 = _cloud(25, B, N, dev)
    xyz2 = _cloud(26, B, M, dev)
    xyz2[:, 17] = xyz2[:, 3]
    xyz1[:, 0] = xyz2[:, 3]
    before = KERNELS["three_nn_packed"].launches
    d, i = three_nn.three_nn_packed(xyz1, xyz2)
    torch.cuda.synchronize()
    assert KERNELS["three_nn_packed"].launches == before + 1
    dp, ip = three_nn.three_nn_packed_plain(xyz1, xyz2)
    assert torch.equal(i, ip)
    # the kernel repeats the plain d² operation for operation, so the
    # truncated keys agree; one key quantum is the most a last-bit
    # difference of d² could move them
    bits = (d.view(torch.int32) - dp.view(torch.int32)).abs()
    assert ((bits == 0) | (bits == 1 << 16)).all()
    assert (i[:, 0, :2] == torch.tensor([3, 17], device=dev)).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    xyz = _cloud(5, 2, 64, dev)
    with pytest.raises(ValueError, match="float32"):
        fps.fps2(xyz.double(), 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        three_nn.three_nn(xyz[:, ::2], xyz)
    # more picks than points is a shape the kernels take (R6); no pick is not
    with pytest.raises(ValueError, match="np1 and np2 > 0"):
        fps.fps2(xyz, 128, 0)
    with pytest.raises(ValueError, match="empty"):
        ball_query.ball_query_idx(0.1, 0, xyz, xyz)
    with pytest.raises(ValueError, match="npoint > 0"):
        fps.fps(xyz, 0)
    with pytest.raises(ValueError, match="power-of-two bucket"):
        ball_query.ball_query_group_bucket(0.1, 24, xyz, xyz)
    with pytest.raises(ValueError, match="contiguous"):
        ball_query.ball_query_point(0.1, 4, xyz, xyz[:, ::2])
    with pytest.raises(ValueError, match="empty"):
        ball_query.ball_query_point_grouped(0.1, 0, xyz, xyz)
    with pytest.raises(ValueError, match="float32"):
        three_nn.three_nn_stream(xyz, xyz.double())
    with pytest.raises(ValueError, match="65536"):
        three_nn.three_nn_packed(xyz, _cloud(5, 2, 65537, dev))


# ---- the first-S scan (csrc/ball_query.cu) at every launch plan ----------

BQ_ENTRIES = ("ball_query_group", "ball_query_group_packed",
              "ball_query_idx", "ball_query_point",
              "ball_query_point_grouped")


def _bq_plain(name, r, S, xyz, q):
    """(grouped or None, cnt, idx) of the plain version of entry `name`."""
    if name == "ball_query_group_packed":
        return ball_query.ball_query_group_packed_plain(r, S, xyz, q)
    g, cnt, idx = ball_query.ball_query_group_plain(r, S, xyz, q)
    return (None if name in ("ball_query_idx", "ball_query_point") else g,
            cnt, idx)


def _bq_check(name, r, S, xyz, q, plan=None, emit_idx=True):
    """One launch of entry `name` (at `plan`, else the entry's own call)
    against the plain version: every output equal."""
    kernel = KERNELS[name]
    before = kernel.launches
    if plan is None:
        fn = getattr(ball_query, name)
        if name in ("ball_query_group", "ball_query_group_packed"):
            g, cnt, idx = fn(r, S, xyz, q, emit_idx)
        elif name == "ball_query_point_grouped":
            idx, cnt, g = fn(r, S, xyz, q)
        else:
            (idx, cnt), g = fn(r, S, xyz, q), None
    else:
        g, cnt, idx = ball_query.launch(kernel, r, S, xyz, q, emit_idx, plan)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    gp, cntp, idxp = _bq_plain(name, r, S, xyz, q)
    assert torch.equal(cnt, cntp)
    if idx is not None:
        assert torch.equal(idx, idxp)
    if gp is not None:
        assert torch.equal(g, gp)
    return cntp


def _all_plans(N, S, bucket=False):
    return [ball_query.Plan(v, st) for st in (True, False)
            for v in ball_query.VARIANTS
            if ball_query.smem_bytes(ball_query.Plan(v, st), N, S,
                                     bucket) <= ball_query.SMEM_BYTES]


# every plan the kernel has, each entry: a ragged cloud (no multiple of
# a step or a tile), a query count no CTA tile divides, queries with no
# hit and queries that fill all S slots
@pytest.mark.parametrize("name", BQ_ENTRIES)
def test_ball_query_every_plan_matches_plain(dev, name):
    xyz = _cloud(40, 2, 2047, dev)
    q = _cloud(41, 2, 37, dev)
    q[:, :3] += 5.0
    for plan in _all_plans(2047, 40):
        cnt = _bq_check(name, 0.3, 40, xyz, q, plan, emit_idx=plan.staged)
    assert (cnt[:, :3] == 0).all() and (cnt[:, 3:] == 40).any()


# the plan's own choice at ragged N (100, 2047, 100003: the last streams)
# and S of 1, 40 and 64
@pytest.mark.parametrize("name", BQ_ENTRIES)
@pytest.mark.parametrize("N", [100, 2047, 100003])
@pytest.mark.parametrize("S", [1, 40, 64])
def test_ball_query_plan_at_ragged_shapes(dev, name, N, S):
    xyz = _cloud(42, 2, N, dev)
    q = torch.cat([_cloud(43, 2, 70, dev), xyz[:, :30]], 1).contiguous()
    _bq_check(name, 0.15, S, xyz, q)


# the large cloud's queries at the cube's corners and edges hold an
# eighth or a quarter of their ball: the longest scans, across tiles
@pytest.mark.parametrize("plan", [None, ("g1u4", False), ("g4u8", False),
                                  ("g4u4", False)])
def test_ball_query_boundary_heavy_large_cloud(dev, plan):
    xyz = _cloud(44, 2, 32768, dev)
    corners = torch.tensor([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0)
                            for z in (0.0, 1.0)], device=dev)
    edges = torch.rand((2, 40, 3), generator=torch.Generator(
        device=dev).manual_seed(45), device=dev)
    edges[..., :2] = edges[..., :2].round()
    q = torch.cat([corners.expand(2, 8, 3), edges, xyz[:, :80]],
                  1).contiguous()
    plan = plan and ball_query.Plan(*plan)
    cnt = _bq_check("ball_query_idx", 0.2, 64, xyz, q, plan)
    assert (cnt[:, :8] == 64).all()
    _bq_check("ball_query_point_grouped", 0.2, 64, xyz, q, plan)


# every point a hit (radius 5), none (queries far away), and a cloud of
# duplicates (a 4-wide grid: 64 positions, equal distances everywhere)
@pytest.mark.parametrize("name", BQ_ENTRIES)
@pytest.mark.parametrize("case", ["all", "none", "duplicates"])
def test_ball_query_degenerate_clouds(dev, name, case):
    if case == "duplicates":
        xyz = _grid_cloud(46, 2, 3000, 4, dev)
        q, r = xyz[:, :50].contiguous(), 0.2
    else:
        xyz = _cloud(47, 2, 3000, dev)
        q = _cloud(48, 2, 50, dev) + (10.0 if case == "none" else 0.0)
        r = 5.0 if case == "all" else 0.3
    for plan in (None, ball_query.Plan("g4u4", True)):
        cnt = _bq_check(name, r, 64, xyz, q, plan)
    assert (cnt == {"all": 64, "none": 0}.get(case, cnt)).all()


# the packed tier where the plan streams the cloud: the prologue's
# dequantised plane, then the scan
@pytest.mark.parametrize("N", [32768, 100003])
def test_ball_query_packed_streamed(dev, N):
    assert not ball_query.bq_plan(2, N, 64, 64).staged
    xyz = _cloud(49, 2, N, dev)
    q = xyz[:, ::N // 64][:, :64].contiguous()
    for emit_idx in (True, False):
        _bq_check("ball_query_group_packed", 0.2, 64, xyz, q,
                  emit_idx=emit_idx)


def test_ball_query_refuses_a_plan_the_card_cannot_hold(dev):
    # staged at N = 100003 needs 1.6 MB of shared memory: the launch is
    # refused with the card's error, not run on another plan
    xyz = _cloud(50, 1, 100003, dev)
    q = xyz[:, :8].contiguous()
    with pytest.raises(RuntimeError, match="launch failed"):
        ball_query.launch(ball_query.KERNEL, 0.2, 16, xyz, q,
                          True, ball_query.Plan("g1u4", True))
    # the refusal is not left behind for the next launch to report
    got = ball_query.launch(ball_query.KERNEL, 0.2, 16, xyz, q, True)
    want = ball_query.ball_query_group_plain(0.2, 16, xyz, q, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# where nsample's slots crowd the staged cloud out of shared memory
# (S = 1500 at the serving shape), the plan streams it, one query a warp
def test_ball_query_plan_for_many_slots(dev):
    assert ball_query.bq_plan(16, 2048, 512, 1500) == ("g1u8", False)
    xyz = _cloud(51, 16, 2048, dev)
    q = xyz[:, :512].contiguous()
    _bq_check("ball_query_group", 0.8, 1500, xyz, q)
    _bq_check("ball_query_group_packed", 0.8, 1500, xyz, q)


# ---- the bucket tier (B8) on the scan, at every launch plan ---------------

def _bucket_check(xyz, q, r, S, plan=None, emit_idx=True):
    """One bucket launch (at `plan`, else the entry's own call) against
    the plain version: every output equal."""
    kernel = KERNELS["ball_query_group_bucket"]
    before = kernel.launches
    if plan is None:
        g, cnt, idx = ball_query.ball_query_group_bucket(r, S, xyz, q,
                                                         emit_idx)
    else:
        g, cnt, idx = ball_query.launch(kernel, r, S, xyz, q, emit_idx, plan)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    gp, cntp, idxp = ball_query.ball_query_group_bucket_plain(r, S, xyz, q)
    assert torch.equal(cnt, cntp)
    assert torch.equal(g, gp)
    if emit_idx:
        assert torch.equal(idx, idxp)
    else:
        assert idx is None
    return cntp


def _x_sorted_cloud(seed, B, N, dev):
    """A cloud in index order along x: a query at large x has its first
    hit in the cloud's last tile, after many empty buckets."""
    xyz = _cloud(seed, B, N, dev)
    order = xyz[..., 0].argsort(dim=1)
    return xyz.gather(1, order[..., None].expand(-1, -1, 3)).contiguous()


def _bucket_queries(xyz, M, seed):
    """M queries: three with no hit, the cloud's last points (first hits
    late in index order), then uniform ones."""
    B, N, _ = xyz.shape
    q = torch.cat([_cloud(seed, B, 3, xyz.device) + 5.0, xyz[:, -5:],
                   _cloud(seed + 1, B, M - 8, xyz.device)], 1)
    return q.contiguous()


# every plan the kernel has, at bucket widths W = 1, 8, 32, 128 and
# W = 4096 > a streamed tile (N = 4096, S = 1; N = 8192, S = 2), on ragged
# clouds (N = 100, 1000, 2000) and past STAGE_POINTS (streamed)
@pytest.mark.parametrize("N,S,W", [(100, 128, 1), (512, 64, 8), (2000, 64, 32),
                                   (1000, 8, 128), (4096, 1, 4096),
                                   (8192, 2, 4096), (6144, 3, 2048)])
def test_ball_query_bucket_every_plan_matches_plain(dev, N, S, W):
    assert ball_query.core.bucket_width(N, S) == W
    xyz = _x_sorted_cloud(70, 2, N, dev)
    q = _bucket_queries(xyz, 37, 71)
    plans = _all_plans(N, S, bucket=True)
    assert any(not p.staged for p in plans)
    for plan in plans:
        cnt = _bucket_check(xyz, q, 0.3, S, plan, emit_idx=plan.staged)
    assert (cnt[:, :3] == 0).all() and (cnt[:, 3:8] > 0).all()


# the plan's own choice where the cloud streams: a ragged last tile
# (N = 3001), W = 32 over two tiles, and N = 100003 (49 tiles, W = 128)
@pytest.mark.parametrize("N,S", [(3001, 96), (100003, 782)])
def test_ball_query_bucket_streamed_clouds(dev, N, S):
    assert not ball_query.bq_plan(2, N, 40, S, bucket=True).staged
    xyz = _x_sorted_cloud(72, 2, N, dev)
    q = _bucket_queries(xyz, 40, 73)
    for emit_idx in (True, False):
        _bucket_check(xyz, q, 0.05, S, emit_idx=emit_idx)


# the bucket path's shapes at B = 64 on FPS picks, at the plan's choice
@pytest.mark.parametrize("N,M,r", [(2048, 512, 0.2), (512, 128, 0.4)])
def test_ball_query_bucket_path_shapes(dev, N, M, r):
    xyz = _cloud(74, 64, N, dev)
    q = fps.fps(xyz, M)[1].clone()
    q[:, :4] += 10.0
    cnt = _bucket_check(xyz, q, r, 64, emit_idx=r > 0.3)
    assert (cnt[:, :4] == 0).all() and (cnt[:, 4:] > 0).all()


# ---- the 3-NN kernel (csrc/three_nn.cu) at every launch plan --------------

NN_ENTRIES = ("three_nn", "three_nn_stream", "three_nn_packed")


def _nn_check(name, xyz1, xyz2, plan=None):
    """One launch of 3-NN entry `name` (at `plan`, else the entry's own
    call) against the plain version: idx equal, distances equal (B9:
    or one key quantum off)."""
    kernel = KERNELS[name]
    before = kernel.launches
    if plan is None:
        d, i = getattr(three_nn, name)(xyz1, xyz2)
    else:
        d, i = three_nn.launch(kernel, xyz1, xyz2, plan)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    packed = name == "three_nn_packed"
    dp, ip = (three_nn.three_nn_packed_plain if packed
              else three_nn.three_nn_plain)(xyz1, xyz2)
    assert torch.equal(i, ip)
    if packed:
        bits = (d.view(torch.int32) - dp.view(torch.int32)).abs()
        assert ((bits == 0) | (bits == 1 << 16)).all()
    else:
        assert torch.equal(d, dp)
    return i


def _nn_plans(M):
    return [three_nn.Plan(v, st) for st in (True, False)
            for v in three_nn.VARIANTS
            if three_nn.smem_bytes(three_nn.Plan(v, st), M)
            <= three_nn.SMEM_BYTES]


# every (G, C), staged and streamed, every entry: a query count no CTA
# divides, M = 2100 (a full streamed tile and 52 more), and query 0 on
# three copies of one candidate (5, 6 and 2054: different slices at
# every C, and, streamed, different tiles)
@pytest.mark.parametrize("variant", list(three_nn.VARIANTS))
def test_three_nn_every_plan_matches_plain(dev, variant):
    xyz1 = _cloud(80, 3, 301, dev)
    xyz2 = _cloud(81, 3, 2100, dev)
    xyz2[:, 6] = xyz2[:, 5]
    xyz2[:, 2054] = xyz2[:, 5]
    xyz1[:, 0] = xyz2[:, 5]
    for staged in (True, False):
        for name in NN_ENTRIES:
            i = _nn_check(name, xyz1, xyz2, three_nn.Plan(variant, staged))
            assert (i[:, 0] == torch.tensor([5, 6, 2054], device=dev)).all()


# fewer candidates than lanes, slots or a step: M = 1 and 2 leave spare
# slots, which the merge must keep at (inf, 0) / the spare key
@pytest.mark.parametrize("M", [1, 2, 3, 33])
def test_three_nn_few_candidates_every_plan(dev, M):
    xyz1 = _cloud(82, 2, 70, dev)
    xyz2 = _cloud(83, 2, M, dev)
    for plan in _nn_plans(M):
        for name in NN_ENTRIES:
            _nn_check(name, xyz1, xyz2, plan)


# the plan's own choice at every path shape of K3 (nn_sweep.SHAPES) and
# at B7's and B9's entry shapes, on FPS-picked candidates
@pytest.mark.parametrize("B,N,M", [(16, 512, 128), (16, 2048, 512),
                                   (64, 512, 128), (64, 2048, 512),
                                   (4, 512, 128), (4, 32768, 512),
                                   (8, 64, 16), (8, 256, 64), (8, 1024, 256),
                                   (8, 8192, 1024)])
def test_three_nn_path_shapes(dev, B, N, M):
    xyz1 = _cloud(84, B, N, dev)
    xyz2 = fps.fps(xyz1, M)[1]
    _nn_check("three_nn", xyz1, xyz2)


def test_three_nn_stream_plan_streams_large_sets(dev):
    assert not three_nn.nn_plan(4, 2048, 16384).staged
    xyz1 = _cloud(85, 4, 2048, dev)
    xyz2 = _cloud(86, 4, 16384, dev)
    xyz2[:, 9001] = xyz2[:, 3]
    xyz1[:, 0] = xyz2[:, 3]
    i = _nn_check("three_nn_stream", xyz1, xyz2)
    assert (i[:, 0, :2] == torch.tensor([3, 9001], device=dev)).all()
    _nn_check("three_nn_packed", xyz1, xyz2)


def test_three_nn_refuses_a_plan_the_card_cannot_hold(dev):
    # staged at M = 16384 needs 256 KB of shared memory: the launch is
    # refused with the card's error, not run on another plan
    xyz1 = _cloud(87, 1, 64, dev)
    xyz2 = _cloud(88, 1, 16384, dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        three_nn.launch(three_nn.KERNEL, xyz1, xyz2,
                        three_nn.Plan("g1c1", True))
    # the refusal is not left behind for the next launch to report
    got = three_nn.launch(three_nn.KERNEL, xyz1, xyz2)
    want = three_nn.three_nn_plain(xyz1, xyz2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def chip_smoke():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_device_prefetch_on_the_card(dev):
    """device_prefetch's batches equal the host batches bit for bit and in
    order, with its copy stream started late and the consuming stream
    reading each batch twice, the second time behind a spin (chip_smoke.py
    phase 10(a)'s `prefetch_check`)."""
    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated

    gen = SyntheticArticulated(n_parts=3, points_per_part=400, seed=0)
    rng = np.random.RandomState(3)
    frames = [gen.frame(rng, num_points=1024)[0] for _ in range(12)]
    assert chip_smoke().prefetch_check(frames, dev) == 6


def test_train_step_gradients_match_the_cpu(dev, monkeypatch):
    """One train step at the reference widths (eyeglasses, K=3, B=2,
    N=1024, f32, dropout off) on the card and on the CPU, from the same
    weights and batch, by chip_smoke.py phase 10(b)'s rule (its
    `train_card_vs_cpu`: the kernels' outputs equal, the losses within
    rtol 1e-5; with the CPU's ReLU masks and max-pool selections imposed,
    each gradient within 1e-3 of its leaf's largest entry, plus 1e-7 of
    the model's largest; on the card's own routing, at most 1e-4 of
    those choices differ and each gradient is within 0.1 of the leaf's
    largest entry); the path's kernel outputs carry no gradient."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
    from articulated_pose_tpu_torch.models import pointnet2
    from articulated_pose_tpu_torch.models.ancsh import build_model

    outputs = []
    for name in ("fps2", "ball_query_group", "three_nn"):
        def record(*args, _fn=getattr(pointnet2, name), **kw):
            out = _fn(*args, **kw)
            outputs.extend(t for t in out if t is not None and t.is_cuda)
            return out
        monkeypatch.setattr(pointnet2, name, record)

    cfg = NetworkConfig(batch_size=2)
    gen = SyntheticArticulated(n_parts=3, points_per_part=400, seed=0)
    rng = np.random.RandomState(0)
    frames = [gen.frame(rng, num_points=cfg.num_points)[0] for _ in range(2)]
    batch = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    state = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    chip_smoke().train_card_vs_cpu(cfg, state, batch, dev)     # raises
    # two forwards on the card, each: fps2's 4 tensors; ball_query_group's
    # grouped and cnt (SA1) and grouped, cnt and idx (SA2); three_nn's
    # dist and idx, twice
    assert len(outputs) == 2 * (4 + 5 + 4)
    assert not any(t.requires_grad for t in outputs)


def test_probe_fma_chain_matches_float64(dev):
    """csrc/probe.cu's FMA chain (the card-limits probe, not an entry of
    KERNELS) at probe_card's 8 MiB block and at a ragged size, within
    1e-5 relative of the same chain in float64."""
    from articulated_pose_tpu_torch.ops.kernels import probe

    assert probe.FMA_KERNEL.name not in KERNELS
    for n in (2 * 1024 * 1024, 100003):
        x = torch.from_numpy(np.random.RandomState(3).rand(n).astype(
            np.float32) + 0.5).to(dev)
        before = probe.FMA_KERNEL.launches
        y = probe.fma_chain(x)
        torch.cuda.synchronize()
        assert probe.FMA_KERNEL.launches == before + 1
        want = probe.fma_chain_plain(x.cpu().numpy())
        rel = np.abs(y.cpu().numpy().astype(np.float64) - want) / want
        assert rel.max() <= 1e-5
    probe.empty_launch(dev)
    torch.cuda.synchronize()


def test_device_profile_reads_one_op_for_one_kernel(dev):
    """A stage of one kernel launch reads one device op a call in
    `timing.device_profile` (the entry's "kernel:<entry>" range on the
    card's timeline is no op), and its device ms stay within its wall
    ms."""
    from articulated_pose_tpu_torch import timing

    P = _cloud(1, 64, 2048, dev)
    fn = lambda: fps.fps(P, 512)                           # noqa: E731
    busy, ops = timing.device_profile(fn, 16)
    wall = timing.wall_ms(fn, 16)
    assert ops == 1
    assert 0 < busy <= wall


def _tiny_cfg(**kw):
    from articulated_pose_tpu_torch.config import NetworkConfig

    return NetworkConfig(category="eyeglasses", n_max_parts=3,
                         num_points=512, backbone_preset="tiny", **kw)


def test_replayed_predictor_equals_eager(dev):
    """PosePredictor's captured forward + fit (compiled.py) at a small
    width: the first call captures, the next three replay, each output
    torch.equal to the eager `forward_fit` on the same clouds and draws,
    and each replay counts its kernels' launches."""
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.ops.kernels import launch_counts
    from articulated_pose_tpu_torch.serving import PosePredictor, forward_fit

    cfg = _tiny_cfg(batch_size=4)
    pred = PosePredictor(cfg, state_dict=build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device=dev)
    clouds = np.random.RandomState(5).rand(4, 4, 512, 3).astype(np.float32)
    d = pred.draws(4)
    for i, c in enumerate(clouds):
        before = launch_counts()
        got = pred._run(c)[0]
        after = launch_counts()
        assert (after["fps2"] - before["fps2"],
                after["three_nn"] - before["three_nn"]) == (1, 2)
        with torch.no_grad():
            want = forward_fit(pred.model, torch.from_numpy(c).to(dev),
                               d.part, d.joint, pred.pose_cfg)
        leaves = torch.utils._pytree.tree_leaves
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)
    entry, = pred._programs[0].captured.values()
    assert entry.replays == 3


def test_replay_folds_the_batch_norm_state_it_finds(dev):
    """The served bf16 program folds its PointConvs' batch norms inside
    the captured graph: a replay equals an eager call of the same model,
    and after new batch-norm statistics are loaded in place (the
    predictor's model.load_state_dict) the next replay, with no new
    capture, equals a fresh eager call on them."""
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.models.layers import PointConv
    from articulated_pose_tpu_torch.serving import PosePredictor, forward_fit

    def with_stats(model, seed):
        g = torch.Generator().manual_seed(seed)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        for k, v in sd.items():
            if k.endswith("bn.running_mean"):
                sd[k] = torch.rand(v.shape, generator=g) * 0.4 - 0.2
            elif k.endswith("bn.running_var"):
                sd[k] = torch.rand(v.shape, generator=g) * 1.5 + 0.5
            elif k.endswith("bn.weight"):
                sd[k] = torch.rand(v.shape, generator=g) + 0.5
        return sd

    cfg = _tiny_cfg(batch_size=4, compute_dtype="bfloat16",
                    ball_query_packed=True)
    model = build_model(cfg, torch.Generator().manual_seed(0))
    pred = PosePredictor(cfg, state_dict=with_stats(model, 1), device=dev)
    clouds = np.random.RandomState(8).rand(4, 512, 3).astype(np.float32)
    P = torch.from_numpy(clouds).to(dev)
    d = pred.draws(4)
    leaves = torch.utils._pytree.tree_leaves

    def eager():
        with torch.no_grad():
            return forward_fit(pred.model, P, d.part, d.joint, pred.pose_cfg)

    pred._run(clouds)                       # eager, then the capture
    assert pred.model.folded_bn_layers == sum(
        isinstance(m, PointConv) and m.bn is not None and m.fold_bn
        for m in pred.model.modules()) > 0
    first = pred._run(clouds)[0]
    for a, b in zip(leaves(first), leaves(eager())):
        assert torch.equal(a, b)
    pred.model.load_state_dict(with_stats(model, 2))
    second = pred._run(clouds)[0]
    want = eager()
    for a, b in zip(leaves(second), leaves(want)):
        assert torch.equal(a, b)
    assert not torch.equal(first["pred"]["W"], second["pred"]["W"])
    program = pred._programs[0]
    entry, = program.captured.values()
    assert program.captures == 1 and entry.replays == 2


def test_a_capture_runs_no_garbage_collection(dev):
    """A dropped program's graph, freed by a collection in the middle of
    another program's capture, would void that capture: the capture
    runs with the collector off, and leaves it on after, also when its
    body raises."""
    import gc

    from articulated_pose_tpu_torch.compiled import compiled

    seen = []

    def body(x):
        seen.append(gc.isenabled())
        return x * 2

    prog = compiled(body)
    x = torch.ones(4, device=dev)
    assert gc.isenabled()
    prog(x)                                 # eager, then the capture
    assert seen == [True, False] and gc.isenabled()

    def broken(x):
        if not gc.isenabled():
            raise ValueError("raised inside the capture")
        return x + 1

    with pytest.raises(ValueError, match="inside the capture"):
        compiled(broken)(x)
    assert gc.isenabled()


def test_a_replayed_stage_mark_times_the_card(dev):
    """A stage mark inside a captured program (utils/profiling.stage) is
    an event-record node of its graph: a replay's reading of a known
    spin of the card lies within 5 % of two eager events' around the
    same spin."""
    from articulated_pose_tpu_torch.compiled import compiled
    from articulated_pose_tpu_torch.utils.profiling import stage

    cycles = 20_000_000                     # ~10 ms at the card's clock

    def body(x):
        torch.cuda._sleep(cycles)
        stage("spin")
        return x + 1

    prog = compiled(body)
    x = torch.zeros(4, device=dev)
    prog(x)                                 # eager, then the capture
    assert prog.stage_ms() == {}
    eager, replayed = [], []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        eager.append(a.elapsed_time(b))
        prog(x)
        replayed.append(prog.stage_ms()["spin"])
    e, r = float(np.median(eager)), float(np.median(replayed))
    assert abs(r - e) <= 0.05 * e, (eager, replayed)
    assert prog.captures == 1


def test_the_replayed_predictor_reads_its_stages_and_counts_its_copies(dev):
    """After a replayed call PosePredictor.stage_ms() holds the forward
    and the fit's three stages, each a positive device time, and
    d2h_bytes grows by the bytes of the arrays it returned."""
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import PosePredictor

    cfg = _tiny_cfg(batch_size=4)
    pred = PosePredictor(cfg, state_dict=build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device=dev)
    clouds = np.random.RandomState(6).rand(4, 512, 3).astype(np.float32)
    pred(clouds)
    before = pred.d2h_bytes
    out = pred(clouds)
    ms = pred.stage_ms()
    assert list(ms) == ["forward", "fit.partition", "fit.ransac", "fit.joint"]
    assert all(v > 0 for v in ms.values()), ms
    arrays = [out.R, out.scale, out.t, out.segmentation, out.part_counts,
              *out.raw.values()]
    assert pred.d2h_bytes - before == sum(a.nbytes for a in arrays)
    assert pred.calls == 2


def test_served_results_own_reused_page_locked_blocks(dev):
    """Each field of a served result is page-locked host memory of
    torch's caching host allocator, owned by the result: a held result
    keeps its values while later calls on other clouds run, and once
    the process has warmed up with results dropped, every field's copy
    reuses a cached block (pinned_allocs stays while pinned_fields
    counts every field)."""
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import PosePredictor

    def arrays(res):
        return {"R": res.R, "scale": res.scale, "t": res.t,
                "segmentation": res.segmentation,
                "part_counts": res.part_counts,
                **{f"raw.{k}": v for k, v in res.raw.items()}}

    cfg = _tiny_cfg(batch_size=4)
    pred = PosePredictor(cfg, state_dict=build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device=dev)
    clouds = np.random.RandomState(7).rand(6, 4, 512, 3).astype(np.float32)
    held = arrays(pred(clouds[0]))
    kept = {k: a.copy() for k, a in held.items()}
    for k, a in held.items():
        assert torch.from_numpy(a).is_pinned(), k
    for c in clouds[1:]:
        pred(c)
    for k, a in held.items():
        np.testing.assert_array_equal(a, kept[k], err_msg=k)
    for i in range(3):
        pred(clouds[i])
    fields, allocs = pred.pinned_fields, pred.pinned_allocs
    for i in range(10):
        pred(clouds[i % 6])
    assert pred.pinned_fields - fields == 10 * len(held)
    assert pred.pinned_allocs == allocs


def test_replayed_train_step_equals_eager(dev):
    """make_train_step(jit=True) at a small width, dropout on: three steps,
    each replayed and eager from a common state.  The forward is
    deterministic, so every loss and batch statistic is torch.equal; the
    gradient's sums run in another order (atomic adds in the gathers'
    backward), so the grad norm is held to rtol 1e-5 and the first moment
    to 1e-4 of each leaf's largest entry (pre-batch-norm biases, whose
    gradient is rounding, left out)."""
    import copy

    from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.train.routing import pre_bn_biases
    from articulated_pose_tpu_torch.train.state import (TrainState,
                                                        dropout_generator,
                                                        make_train_step,
                                                        train_step)

    cfg = _tiny_cfg(batch_size=4)
    gen = SyntheticArticulated(n_parts=3, points_per_part=200, seed=0)
    data, _ = gen.batch(np.random.RandomState(0), 4, num_points=512)
    model = build_model(cfg, torch.Generator().manual_seed(0), device=dev)
    assert model.joint_net.dropout_rate > 0
    jit, eager = TrainState(model, cfg), TrainState(copy.deepcopy(model), cfg)
    step = make_train_step(cfg)
    gens = [torch.Generator(device=dev) for _ in range(2)]
    zero = pre_bn_biases(model)
    for s in range(3):
        eager.load_state_dict(jit.state_dict())
        got = step(jit, data, dropout_generator(gens[0], cfg.seed, s))
        want = train_step(eager, data, dropout_generator(gens[1], cfg.seed, s))
        for k in want:
            if k != "grad_norm":
                assert torch.equal(got[k], want[k]), (s, k)
        torch.testing.assert_close(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5, atol=0)
        g, w = jit.state_dict(), eager.state_dict()
        for k, v in w["model"].items():
            if "running" in k:
                assert torch.equal(g["model"][k], v), (s, k)
        assert int(g["step"]) == int(w["step"]) == s + 1
        for name, v in w["mu"].items():
            if name not in zero:
                err = (g["mu"][name] - v).abs().max().item()
                assert err <= 1e-4 * v.abs().max().item() + 1e-12, (s, name)
    entry, = step.program.captured.values()
    assert entry.replays == 2


# ---- the k-NN kernel (csrc/knn.cu) ----------------------------------------
# the Point Transformer cell's nine searches at B=16, (M queries, N
# points, k): the five levels' self searches and the four transitions
# down's
KNN_CELL_SHAPES = [(8192, 8192, 8), (2048, 8192, 16), (2048, 2048, 16),
                   (512, 2048, 16), (512, 512, 16), (128, 512, 16),
                   (128, 128, 16), (32, 128, 16), (32, 32, 16)]


def _knn_plain(k, xyz, q):
    """The plain version one cloud at a time (its distance matrix for
    the whole batch would take 4.3 GB at 16 x 8192 x 8192)."""
    out = [knn.knn_plain(k, xyz[b:b + 1], q[b:b + 1])
           for b in range(len(xyz))]
    return torch.cat([d for d, _ in out]), torch.cat([i for _, i in out])


@pytest.mark.parametrize("M,N,k", KNN_CELL_SHAPES)
def test_knn_matches_plain_at_the_cell_shapes(dev, M, N, k):
    """The queries are points of the cloud, as the backbone's are (FPS
    picks or the level itself): each finds itself at distance 0."""
    xyz = _cloud(M + N, 16, N, dev)
    q = xyz[:, ::N // M].contiguous()
    before = KERNELS["knn"].launches
    d, i = knn.knn(k, xyz, q)
    torch.cuda.synchronize()
    assert KERNELS["knn"].launches == before + 1
    dp, ip = _knn_plain(k, xyz, q)
    assert torch.equal(i, ip)
    assert torch.equal(d, dp)


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_knn_planted_ties_every_lane_count(dev, k, lanes):
    """A grid with every point three times in a shuffled order: each
    query's distances tie in threes, spread over the lanes' slices and
    over the 1024-point tiles; the lowest index wins."""
    g = np.stack(np.meshgrid(*[np.arange(8.0)] * 3), -1).reshape(-1, 3)
    pts = np.concatenate([g, g, g]) * 0.125
    order = np.random.RandomState(k + lanes).permutation(len(pts))
    xyz = torch.from_numpy(pts[order][None].astype(np.float32)).to(dev)
    xyz = xyz.expand(2, -1, -1).contiguous()
    q = xyz[:, ::7].contiguous()
    d, i = knn.launch(k, xyz, q, lanes)
    dp, ip = knn.knn_plain(k, xyz, q)
    assert torch.equal(i, ip)
    assert torch.equal(d, dp)


def test_knn_wrapper_refuses_what_the_kernel_does_not_take(dev):
    xyz = _cloud(3, 2, 64, dev)
    with pytest.raises(ValueError, match="outside"):
        knn.knn(17, xyz, xyz)
    with pytest.raises(ValueError, match="exceeds"):
        knn.knn(8, xyz[:, :4].contiguous(), xyz)
    with pytest.raises(ValueError, match="contiguous"):
        knn.knn(4, xyz[:, ::2], xyz)


def test_point_transformer_predictor_replays_the_eager_program(dev):
    """Tiny widths on the card: the first call captures, the next two
    replay, each output torch.equal to the eager `forward_fit`; the
    replayed stages carry the backbone's marks, each name once."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import PosePredictor, forward_fit

    cfg = NetworkConfig(backbone="point_transformer", backbone_preset="tiny",
                        compute_dtype="bfloat16")
    pred = PosePredictor(cfg, state_dict=build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device=dev)
    clouds = np.random.RandomState(5).rand(3, 4, 512, 3).astype(np.float32)
    d = pred.draws(4)
    leaves = torch.utils._pytree.tree_leaves
    for c in clouds:
        got = pred._run(c)[0]
        with torch.no_grad():
            want = forward_fit(pred.model, torch.from_numpy(c).to(dev),
                               d.part, d.joint, pred.pose_cfg)
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)
    names = list(pred.stage_ms())
    assert len(names) == len(set(names))
    assert {"ptv1.e1.knn", "ptv1.e2.td.knn", "ptv1.e1.b1.attn",
            "ptv1.d1.b1.attn", "ptv1.out", "forward"} <= set(names)


def test_point_transformer_v3_predictor_replays_the_fit_alone(dev):
    """Tiny widths on the card: the forward runs eagerly each call and
    the fit is captured once and replayed, every output torch.equal to
    the eager model (under the predictor's order shuffle) and
    `fit_heads`; the replayed stages are the fit's; the structure the
    card planned equals the plain reference's."""
    import dataclasses

    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import (POSE_KEYS,
                                                    PosePredictor, fit_heads)
    from posebench.drivers.serve_ptv3_offline import structure_gap
    from posebench.reference import point_transformer_v3 as ref

    cfg = NetworkConfig(backbone="point_transformer_v3",
                        backbone_preset="tiny", compute_dtype="bfloat16")
    pred = PosePredictor(cfg, state_dict=build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device=dev)
    clouds = np.random.RandomState(5).rand(3, 4, 512, 3).astype(
        np.float32) - 0.5
    d = pred.draws(4)
    leaves = torch.utils._pytree.tree_leaves
    shuffle = pred.shuffles[0]
    for c in clouds:
        got = pred._run(c)[0]
        P = torch.from_numpy(c).to(dev)
        with torch.no_grad():
            heads = pred.model(P, shuffle=shuffle)
            want = fit_heads({k: heads[k] for k in POSE_KEYS}, P, d.part,
                             d.joint, pred.pose_cfg)
        for a, b in zip(leaves(got["fits"]), leaves(want["fits"])):
            assert torch.equal(a, b)
        assert torch.equal(got["segmentation"], want["segmentation"])
        for k, v in heads.items():
            assert torch.equal(got["pred"][k], v)
    assert pred._programs[0].captures == 1
    assert {"fit.partition", "fit.ransac", "fit.joint"} <= set(
        pred.stage_ms())
    spec = pred.model.backbone.spec
    widths = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    levels, _, _ = ref.structure(P, widths, shuffle)
    assert structure_gap(pred.model.backbone.structure, levels) == 0


def test_minkunet_predictor_replays_the_fit_alone(dev):
    """Tiny widths on the card: the MinkUNet forward runs eagerly each
    call and the fit is captured once and replayed, every output
    torch.equal to the eager model and `fit_heads`; the strides and maps
    the card planned equal the plain reference's."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import (POSE_KEYS,
                                                    PosePredictor, fit_heads)
    from posebench.drivers.serve_minkunet_offline import structure_gap
    from posebench.reference import minkunet as ref

    cfg = NetworkConfig(backbone="minkunet", backbone_preset="tiny",
                        compute_dtype="bfloat16")
    pred = PosePredictor(cfg, state_dict=build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device=dev)
    clouds = np.random.RandomState(7).rand(3, 4, 512, 3).astype(
        np.float32) - 0.5
    d = pred.draws(4)
    leaves = torch.utils._pytree.tree_leaves
    for c in clouds:
        got = pred._run(c)[0]
        P = torch.from_numpy(c).to(dev)
        with torch.no_grad():
            heads = pred.model(P)
            want = fit_heads({k: heads[k] for k in POSE_KEYS}, P, d.part,
                             d.joint, pred.pose_cfg)
        for a, b in zip(leaves(got["fits"]), leaves(want["fits"])):
            assert torch.equal(a, b)
        assert torch.equal(got["segmentation"], want["segmentation"])
        for k, v in heads.items():
            assert torch.equal(got["pred"][k], v)
    assert pred._programs[0].captures == 1
    assert pred.model.backbone.host_syncs == 2
    spec = pred.model.backbone.spec
    widths = dict(planes=spec.planes, layers=spec.layers,
                  init_dim=spec.init_dim, grid_size=spec.grid_size)
    strides, _, _ = ref.structure(P, widths)
    assert structure_gap(pred.model.backbone.structure, strides) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_minkunet_forward_on_the_card_equals_the_cpus(dev, dtype):
    """The served MinkUNet forward at tiny widths, card against CPU on
    one state dict: f32 within the sum orders of other GEMM kernels
    (rtol 1e-4 / atol 5e-5, as the CPU tests hold it to the reference;
    TF32 stays off), bf16 within the cell's heads_ratio limit against
    the CPU's f32 forward in units of the bf16 CPU forward's own gap;
    the structure and the counters exact."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from posebench import compare

    cfg = NetworkConfig(backbone="minkunet", backbone_preset="tiny",
                        compute_dtype=dtype)
    sd = build_model(cfg, torch.Generator().manual_seed(1)).state_dict()
    X = torch.from_numpy(np.random.RandomState(8).rand(3, 1024, 3).astype(
        np.float32) - 0.5)
    outs, counters = {}, {}
    for where in ("cpu", "cuda", "cpu_f32"):
        c = cfg.replace(compute_dtype="float32") if where == "cpu_f32" else cfg
        m = build_model(c)
        m.load_state_dict(sd)
        m = m.to("cpu" if where != "cuda" else dev).eval()
        with torch.no_grad():
            out = m(X.to("cpu" if where != "cuda" else dev))
        outs[where] = {k: v.float().cpu().numpy() for k, v in out.items()}
        bb = m.backbone
        counters[where] = (bb.level_points, bb.conv_pairs, bb.stem_pairs,
                           [s["counts"] for s in bb.structure])
    assert counters["cuda"] == counters["cpu"]
    if dtype == "float32":
        for k, v in outs["cpu"].items():
            np.testing.assert_allclose(outs["cuda"][k], v, rtol=1e-4,
                                       atol=5e-5)
    else:
        assert compare.heads_ratio(outs["cuda"], outs["cpu_f32"],
                                   outs["cpu"]) <= 3.0


# ------------------------------------------------------------- joint_fit
def _joint_inputs(dev, B, N, K, seed, **knobs):
    """The joint stage's inputs as fit_frame_batch builds them from random
    heads (what the served cells' random weights give): part buffers,
    voted axes and the draws."""
    from articulated_pose_tpu_torch.pose import pipeline as pp
    from articulated_pose_tpu_torch.programs import random_predictions

    cfg = pp.PoseFitConfig(n_parts=K, ransac_chunk=None, **knobs)
    rng = np.random.RandomState(seed)
    pred = random_predictions(rng, B, N, K, dev)
    P = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32) * 2 - 1).to(dev)
    src, tgt, mask, _ = pp.build_part_buffers_sorted(
        pred["nocs_per_point"], P, pred["W"].argmax(-1), K,
        min(cfg.part_points, N))
    assocs = (pred["index_per_point"].argmax(-1).unsqueeze(1)
              == torch.arange(1, K, device=dev)[:, None]).float()
    axes = pp.vote_joint_axes(pred["joint_axis_per_point"], assocs)
    draws = pp.PoseDraws.sample(
        B, cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return cfg, src, tgt, mask, axes, draws


def _tiny_parts(src, tgt, mask):
    """Frames 0-3 keep 2 points of part 1, frames 4-7 none of part 2 and
    frame 8 none of part 0 (valid rows first, as the buffers come)."""
    for b, k, n in ([(b, 1, 2) for b in range(4)]
                    + [(b, 2, 0) for b in range(4, 8)] + [(8, 0, 0)]):
        for t in (src, tgt, mask):
            t[b, k, n:] = 0


JOINT_CASES = {
    # name: (B, N, K, knobs)
    "served_b64": (64, 2048, 3, {}),
    "ptv1_b16_n8192": (16, 8192, 3, {}),
    "served_b256": (256, 2048, 3, {}),
    "k2": (32, 2048, 2, {"joint_types": ("revolute",)}),
    "k4_prismatic": (32, 2048, 4, {
        "joint_types": ("revolute", "prismatic", "revolute")}),
    "k4_prismatic_batch_joints": (32, 2048, 4, {
        "joint_types": ("revolute", "prismatic", "revolute"),
        "batch_joints": True}),
    "eval_h128": (32, 2048, 3, {"niter_part": 1024, "niter_joint": 128,
                                "lm_iters_refit": 15}),
    "tiny_parts": (16, 2048, 3, {}),
}


@pytest.mark.parametrize("name", list(JOINT_CASES))
def test_joint_fit_matches_the_plain_joint_stage(dev, name):
    """The kernel picks the plain path's hypothesis and inlier sets in
    every problem and its poses within 1e-5 (bit for bit where the
    product orders are known), inside a captured program as eagerly, and
    fit_frame_batch's joint stage (with the configured grouping) equals
    the plain one's."""
    from articulated_pose_tpu_torch.ops.kernels import joint_fit as jf
    from articulated_pose_tpu_torch.pose import pipeline as pp

    B, N, K, knobs = JOINT_CASES[name]
    cfg, src, tgt, mask, axes, draws = _joint_inputs(dev, B, N, K, 7, **knobs)
    if name == "tiny_parts":
        _tiny_parts(src, tgt, mask)
    before = KERNELS["joint_fit"].launches
    got = jf.joint_fit(src, tgt, mask, axes, draws.joint, cfg,
                       diagnostics=True)
    torch.cuda.synchronize()
    assert KERNELS["joint_fit"].launches == before + 1
    want = pp.joint_fit_plain(src, tgt, mask, axes, draws.joint, cfg,
                              diagnostics=True)
    assert torch.equal(got.best, want.best)
    assert torch.equal(got.scores, want.scores)
    assert torch.equal(got.inliers, want.inliers)
    assert torch.equal(got.hypotheses, want.hypotheses)
    for f in ("R0", "s0", "t0", "R1", "s1", "t1"):
        g, w = getattr(got, f), getattr(want, f)
        assert torch.isfinite(g).all(), f
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5, msg=f)

    # the kernel captured into a program, replayed
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        jf.joint_fit(src, tgt, mask, axes, draws.joint, cfg)   # warm
        with torch.cuda.graph(graph, stream=side):
            cap = jf.joint_fit(src, tgt, mask, axes, draws.joint, cfg)
    graph.replay()
    torch.cuda.synchronize()
    for f in ("R0", "s0", "t0", "R1", "s1", "t1", "best", "scores",
              "inliers"):
        assert torch.equal(getattr(cap, f), getattr(got, f)), f

    pp.JOINT_PROBLEMS.reset()
    R, s, t = pp.joint_stage(src, tgt, mask, axes, draws, cfg)
    assert (pp.JOINT_PROBLEMS.kernel, pp.JOINT_PROBLEMS.plain) == (
        B * (K - 1), 0)
    Rp, sp, tp = pp.part_poses(want)
    for g, w in ((R, Rp), (s, sp), (t, tp)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_fit_frame_batch_takes_the_kernel_on_the_card(dev):
    """A fit of CUDA float32 heads launches joint_fit once and counts its
    problems as the kernel's; "lm" hypotheses take the plain path."""
    from articulated_pose_tpu_torch.pose import pipeline as pp
    from articulated_pose_tpu_torch.programs import random_predictions

    rng = np.random.RandomState(3)
    pred = random_predictions(rng, 8, 1024, 3, dev)
    P = torch.from_numpy(rng.rand(8, 1024, 3).astype(np.float32)).to(dev)
    for estimator, kernel, launched in (("alternating", 16, 1), ("lm", 0, 0)):
        cfg = pp.PoseFitConfig(hypo_estimator=estimator, niter_joint=16,
                               lm_iters_hypo=2)
        draws = pp.PoseDraws.sample(8, cfg, device=dev)
        pp.JOINT_PROBLEMS.reset()
        before = KERNELS["joint_fit"].launches
        out = pp.fit_frame_batch(pred, P, draws, cfg)
        torch.cuda.synchronize()
        assert KERNELS["joint_fit"].launches - before == launched
        assert (pp.JOINT_PROBLEMS.kernel,
                pp.JOINT_PROBLEMS.plain) == (kernel, 16 - kernel)
        assert torch.isfinite(out["nonlinear_R"]).all()


def test_joint_stage_refuses_other_dtypes_on_the_card(dev):
    """CUDA buffers of another dtype than float32 go to the kernel, which
    raises, and never fall back to the plain path unseen."""
    from articulated_pose_tpu_torch.pose import pipeline as pp

    cfg, src, tgt, mask, axes, draws = _joint_inputs(dev, 4, 256, 3, 5)
    pp.JOINT_PROBLEMS.reset()
    with pytest.raises(ValueError, match="float32"):
        pp.joint_stage(src.bfloat16(), tgt.bfloat16(), mask.bfloat16(),
                       axes.bfloat16(), draws, cfg)
    assert pp.JOINT_PROBLEMS.plain == 0


def test_joint_fit_orders_were_read_on_this_toolkit(dev):
    """The product tables of ops/kernels/joint_fit.py hold for the torch
    and CUDA they were read on; on another, re-read them with
    `python3 chip_smoke.py --joint-orders` and record the toolkit."""
    from articulated_pose_tpu_torch.ops.kernels import joint_fit as jf

    assert jf.toolkit_of(torch.__version__, torch.version.cuda) \
        == jf.ORDERS_TOOLKIT
    assert jf.check_toolkit(torch.__version__, torch.version.cuda)


# the fits' batch counts of the tiny products: B x H for the hypotheses
# (A v and its row form), B for the refit (A v, A^T v)
FIT_COUNTS = {"mv": (8, 16, 32, 64, 256, 16 * 64, 32 * 128, 64 * 64,
                     256 * 64),
              "row": (16 * 64, 32 * 128, 64 * 64, 256 * 64),
              "mvt": (8, 16, 32, 64, 256)}


@pytest.mark.parametrize("form", list(FIT_COUNTS))
def test_dot3_orders_hold_at_the_fits_counts(dev, form):
    """At every batch count the served and eval fits take, the order the
    tables name gives torch's product of the plain path bit for bit."""
    from articulated_pose_tpu_torch.ops.kernels import joint_fit as jf

    for n in FIT_COUNTS[form]:
        order = jf.dot_order(n, form == "mvt")
        assert order in jf.dot3_orders(n, form, dev, seed=n), (n, order)


# ------------------------------------------------------ vector_attention
# the Point Transformer cell's five levels at B=16: (n points, C, k)
VA_LEVELS = [(8192, 32, 8), (2048, 64, 16), (512, 128, 16), (128, 256, 16),
             (32, 512, 16)]
VA_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _va_layer(C, dt, dev, seed=0, share=8):
    """A PointTransformerLayer in eval mode on the card: Linear weights
    at their default initialisation from the seed, each batch norm's
    affine and running statistics drawn, so none is an identity."""
    from articulated_pose_tpu_torch.models import point_transformer as pt

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        layer = pt.PointTransformerLayer(C, share, dt)
        with torch.no_grad():
            for bn in (layer.pos.bn, layer.w_bn, layer.w.bn):
                bn.weight.copy_(1 + 0.2 * torch.randn(bn.weight.shape))
                bn.bias.copy_(0.1 * torch.randn(bn.bias.shape))
                bn.running_mean.copy_(0.1 * torch.randn(bn.bias.shape))
                bn.running_var.copy_(0.5 + torch.rand(bn.bias.shape))
    return layer.to(dev).eval()


def _va_inputs(layer, B, n, k, dev, seed=0, nbr=None):
    """The layer's inputs as the backbone forms them: a level's cloud,
    its k nearest (the `knn` kernel) and q, key, v of a random feature."""
    from articulated_pose_tpu_torch.models import point_transformer as pt

    rng = np.random.RandomState(seed)
    p = torch.from_numpy(rng.rand(B, n, 3).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.randn(B, n, layer.q.in_features).astype(
        np.float32)).to(dev)
    if nbr is None:
        nbr = knn.knn(k, p, p)[1]
    q, key, v = (pt._linear(lin, x, layer.dtype)
                 for lin in (layer.q, layer.k, layer.v))
    return p, q, key, v, nbr


def _va_held(got, want, dt):
    """The kernel's y against the plain layer's.  Only the order of f32
    sums differs (the products over C and G, the sum over k), which moves
    y by a few f32 ulps of its terms: each element within 1e-4 of y's
    largest.  In bf16 such a sum may also round a value to the
    neighbouring bf16 at one of the layer's rounding points (a flip of one
    ulp); the row's later values follow it, so a few per cent of the
    outputs may move further, each within 2^-6 of y's largest."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    scale = want.abs().max().item()
    diff = (got - want).abs()
    near = (diff <= 1e-4 * scale).float().mean().item()
    worst = diff.max().item()
    print(f"vector_attention {tuple(got.shape)} {dt}: near share "
          f"{near:.5f}, exact share {(got == want).float().mean().item():.5f}"
          f", max |diff| {worst:.3e} of {scale:.3e}")
    assert near >= (1.0 if dt == torch.float32 else 0.97), near
    assert worst <= 2 ** -6 * scale, (worst, scale)


@pytest.mark.parametrize("dt", list(VA_DTYPES))
@pytest.mark.parametrize("n,C,k", VA_LEVELS)
def test_vector_attention_matches_the_plain_layer(dev, n, C, k, dt):
    """Each level's layer at the cell's shapes (B=16): one launch, y held
    to the plain layer's (`_va_held`)."""
    from articulated_pose_tpu_torch.ops.kernels import vector_attention as va

    dt = VA_DTYPES[dt]
    layer = _va_layer(C, dt, dev, seed=C)
    args = _va_inputs(layer, 16, n, k, dev, seed=n)
    with torch.no_grad():
        before = KERNELS["vector_attention"].launches
        got = va.vector_attention(layer, *args)
        torch.cuda.synchronize()
        assert KERNELS["vector_attention"].launches == before + 1
        want = layer.plain(*args)
    _va_held(got, want, dt)


@pytest.mark.parametrize("dt", list(VA_DTYPES))
@pytest.mark.parametrize("C,k,B,n", [(16, 8, 2, 200), (32, 1, 3, 77),
                                     (32, 5, 1, 100), (64, 12, 2, 45),
                                     (256, 3, 1, 7), (512, 9, 2, 21)])
def test_vector_attention_takes_any_k_and_a_ragged_last_tile(dev, C, k, B,
                                                             n, dt):
    """The tiny widths (C=16, 32), k below the kernel's 8 or 16 row slots
    a query, and query counts that leave the last CTA part empty."""
    from articulated_pose_tpu_torch.ops.kernels import vector_attention as va

    dt = VA_DTYPES[dt]
    layer = _va_layer(C, dt, dev, seed=k)
    args = _va_inputs(layer, B, n, k, dev, seed=n)
    with torch.no_grad():
        _va_held(va.vector_attention(layer, *args), layer.plain(*args), dt)


@pytest.mark.parametrize("dt", list(VA_DTYPES))
def test_vector_attention_planted_ties_one_cloud(dev, dt):
    """B=1 with duplicate neighbour indices: every query's k=16 rows name
    8 points twice, and query 0 names one point 16 times, so rows and
    logits tie across j."""
    from articulated_pose_tpu_torch.ops.kernels import vector_attention as va

    dt = VA_DTYPES[dt]
    n = 512
    layer = _va_layer(128, dt, dev, seed=3)
    rng = np.random.RandomState(4)
    half = rng.randint(0, n, size=(1, n, 8))
    nbr = np.concatenate([half, half], axis=-1)
    nbr[0, 0] = 7
    nbr = torch.from_numpy(nbr.astype(np.int32)).to(dev)
    args = _va_inputs(layer, 1, n, 16, dev, seed=5, nbr=nbr)
    with torch.no_grad():
        got = va.vector_attention(layer, *args)
        _va_held(got, layer.plain(*args), dt)


def test_vector_attention_refuses_what_the_kernel_does_not_take(dev):
    from articulated_pose_tpu_torch.ops.kernels import vector_attention as va

    layer = _va_layer(64, torch.bfloat16, dev)
    p, q, key, v, nbr = _va_inputs(layer, 2, 64, 16, dev)
    with torch.no_grad():
        with pytest.raises(ValueError, match="outside"):
            va.vector_attention(layer, p, q, key, v,
                                torch.cat([nbr, nbr[..., :1]], -1))
        with pytest.raises(ValueError, match="int32"):
            va.vector_attention(layer, p, q, key, v, nbr.long())
        with pytest.raises(ValueError, match="layer's dtype"):
            va.vector_attention(layer, p, q.float(), key, v, nbr)
        odd = _va_layer(20, torch.bfloat16, dev)
        with pytest.raises(ValueError, match="not divisible"):
            va.vector_attention(odd, *_va_inputs(odd, 2, 64, 8, dev))
        wide = _va_layer(1024, torch.bfloat16, dev)
        with pytest.raises(ValueError, match="above 512"):
            va.vector_attention(wide, *_va_inputs(wide, 1, 16, 8, dev))
        other = _va_layer(48, torch.bfloat16, dev)
        with pytest.raises(ValueError, match="takes C in"):
            va.vector_attention(other, *_va_inputs(other, 1, 16, 8, dev))
        layer.train()
        with pytest.raises(ValueError, match="training mode"):
            va.vector_attention(layer, p, q, key, v, nbr)
        layer.eval()
    with pytest.raises(ValueError, match="gradient"):
        va.vector_attention(layer, p, q, key, v, nbr)


def test_vector_attention_bn_scale_is_torchs(dev):
    """The kernel's batch-norm scale, rsqrt(var + eps) * weight, equals
    torch's bit for bit (ScheduledBatchNorm's eval path), also at tiny,
    huge and zero variances."""
    from articulated_pose_tpu_torch.ops.kernels import vector_attention as va

    rng = np.random.RandomState(0)
    var = np.concatenate([rng.rand(4000), 10.0 ** rng.uniform(-12, 12, 4000),
                          [0.0, 1e-5, 1.0, 3e38]]).astype(np.float32)
    var = torch.from_numpy(var).to(dev)
    weight = torch.from_numpy(rng.randn(var.numel()).astype(np.float32)
                              ).to(dev)
    for eps in (1e-5, 1e-3):
        assert torch.equal(va.bn_scale(var, weight, eps),
                           torch.rsqrt(var + eps) * weight)


def _transitions_grouped_bytes(spec, B, N, esize):
    """Bytes of the (n, k, .) tensors the transitions down materialise in
    one forward: for each level past the first, the grouped xyz and its
    difference (f32), the grouped feature, the concatenation and the
    Linear's, batch norm's and ReLU's outputs (the compute dtype)."""
    sizes = spec.level_points(N)
    total = 0
    for i in range(1, len(spec.planes)):
        cin, cout = spec.planes[i - 1], spec.planes[i]
        total += B * sizes[i] * spec.nsample[i] * (
            2 * 4 * 3 + esize * (cin + 3 + cin + 3 * cout))
    return total


def test_point_transformer_predictor_launches_the_attention_kernel(dev):
    """The published widths (B=2, N=4096): the served program's forward
    takes the kernel in all 18 attention layers and the plain path in
    none, a replay launches it 18 times, every output equals the eager
    `forward_fit`, and the forward materialises the transitions' (n, k,
    .) tensors alone."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.serving import PosePredictor, forward_fit

    cfg = NetworkConfig(backbone="point_transformer",
                        compute_dtype="bfloat16")
    pred = PosePredictor(cfg, state_dict=build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device=dev)
    bb = pred.model.backbone
    B, N = 2, 4096
    clouds = np.random.RandomState(6).rand(3, B, N, 3).astype(np.float32)
    d = pred.draws(B)
    leaves = torch.utils._pytree.tree_leaves
    for c in clouds:
        before = KERNELS["vector_attention"].launches
        got = pred._run(c)[0]
        torch.cuda.synchronize()
        launched = KERNELS["vector_attention"].launches - before
        # the counters of the last forward Python ran: the eager call's,
        # then the capture's
        assert (bb.attention_kernel_layers, bb.attention_plain_layers) \
            == (18, 0)
        assert bb.grouped_bytes == _transitions_grouped_bytes(
            bb.spec, B, N, 2)
        with torch.no_grad():
            want = forward_fit(pred.model, torch.from_numpy(c).to(dev),
                               d.part, d.joint, pred.pose_cfg)
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)
    # the last call replayed the captured graph
    assert launched == 18
