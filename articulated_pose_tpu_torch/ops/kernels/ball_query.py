"""Ball query: six kernel entries over one source, with their plain versions.

- `ball_query_group` (K2) replaces `articulated_pose_tpu/ops/pallas/
  ball_query_butterfly.py::query_ball_group_pallas` (exact transposed body
  `_ballq_butterfly_kernel_t`): first-S-in-radius hits, centred grouped
  coordinates, cnt, optional idx.
- `ball_query_group_packed` replaces the same wrapper with `packed=True`
  (`_ballq_butterfly_packed_kernel_t` and its prologue
  `_quantize_pack_coords`): the same hits, but the grouped coordinates
  are the cloud's 10-bit-quantised ones (`core.quantize_coords`).
- `ball_query_idx` replaces `ball_query_stream.py::query_ball_point_stream`
  (the large-cloud tier): idx and cnt only; N < 2^24 as there.
- `ball_query_point` (B5) replaces `ball_query.py::query_ball_point_pallas`
  (rank-select body `_ballq_kernel`): idx and cnt of the exact query,
  for any int32 N.  It launches the idx-only scan of `ball_query_idx`.
- `ball_query_point_grouped` (B5g) replaces `ball_query.py::
  query_ball_point_grouped_pallas` (`_ballq_grouped_kernel`): idx, cnt
  and centred coordinates, in that order.  It launches K2 with idx.

- `ball_query_group_bucket` (B8) replaces `ball_query_bucket.py::
  query_ball_group_bucket` (the "bucket" tier): slot j holds the first
  hit of the j-th of S equal buckets of the padded cloud, its offset
  rounded to bf16; cnt counts every hit.

All six run `csrc/ball_query.cu`: a CTA of eight warps answers 8 G
queries of one cloud, staged whole in shared memory (or streamed through
it in 2048-point tiles); each warp scans in index order for its G
queries, U points a lane a step, and keeps the ballots as hit bitmaps.
The first-S tiers stop once every query has nsample hits and rank the
bitmaps' first nsample hits into the slots; the bucket tier scans the
whole cloud and takes the lowest set bit of each bucket.  `bq_plan`
picks the launch (variant (G, U), staged or streamed) from the shapes
alone.  The source says what bounds them.  A CPU tensor takes the
`*_plain` version; a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          counted, ptr,
                                                          require_cuda,
                                                          stream_of)

# the streaming tier carries indices as f32 (ball_query_stream.py:156-163)
STREAM_MAX_POINTS = 1 << 24
# csrc/ball_query.cu's variants, in its BQ_VARIANTS order: name -> (G
# queries a warp, U points a lane a step)
VARIANTS = {f"g{g}u{u}": (g, u) for g in (1, 4) for u in (4, 8)}
CTA_WARPS = 8
TILE_POINTS = 2048                  # a streamed tile
# shared memory a CTA may take on the H100 (232,448 bytes), less room for
# the kernel's static part
SMEM_BYTES = 232448 - 1024
# bq_plan's rule, read off the sweep of every plan at the paths' shapes on
# the card (python -m articulated_pose_tpu_torch.bq_sweep; PERF.md section
# 6): stage the cloud up to STAGE_POINTS (at 8192 points streaming won);
# four queries a warp from MANY_QUERIES queries a launch, one below it
# (where four a warp leave too few CTAs to fill the card); four points a
# lane a step where the cloud is staged, eight where it streams, and
# eight for the bucket tier's four queries a warp, which scan their whole
# cloud (2-3 % faster at its SA1)
STAGE_POINTS = 2048
MANY_QUERIES = 8192


class Plan(NamedTuple):
    variant: str                    # a key of VARIANTS
    staged: bool                    # the whole cloud in shared memory


def queries_per_cta(plan: Plan) -> int:
    return CTA_WARPS * VARIANTS[plan.variant][0]


def smem_bytes(plan: Plan, N: int, nsample: int, bucket: bool = False) -> int:
    """The launch's dynamic shared memory, as csrc/ball_query.cu sizes it:
    the tile, the hit bitmaps, the slots, the queries, the box and, for
    the bucket tier, a hit flag a query."""
    step = 32 * VARIANTS[plan.variant][1]
    tile = -(-N // step) * step if plan.staged else TILE_POINTS
    qc = queries_per_cta(plan)
    return (16 * tile + 4 * qc * (tile // 32 + nsample + 3 + int(bucket))
            + 4 * 9)


def bq_plan(B: int, N: int, M: int, nsample: int,
            bucket: bool = False) -> Plan:
    """The launch for B clouds of N points, M queries each, nsample slots
    (`bucket`: of the bucket tier), by the rule above.  Needs no library,
    so the CPU tests reach it.  Raises ValueError where no launch holds
    nsample slots."""
    if min(B, N, M, nsample) < 1:
        raise ValueError(f"bq_plan: need B, N, M, nsample > 0, got B={B}, "
                         f"N={N}, M={M}, nsample={nsample}")
    G = 4 if B * M >= MANY_QUERIES else 1
    U = 8 if bucket and G == 4 else 4
    # where nsample's slots crowd the staged cloud out of shared memory,
    # stream it, with one query a warp if need be
    for plan in ((Plan(f"g{G}u{U}", True),) if N <= STAGE_POINTS else ()) + (
            Plan(f"g{G}u8", False), Plan("g1u8", False)):
        if smem_bytes(plan, N, nsample, bucket) <= SMEM_BYTES:
            return plan
    raise ValueError(f"bq_plan: nsample={nsample} slots do not fit a CTA's "
                     "shared memory")


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan = [I, I]
    lib.ball_query_group_launch.argtypes = plan + [P, P, I, I, I, I, F, P, P,
                                                   P, P]
    lib.ball_query_group_packed_launch.argtypes = plan + [
        P, P, I, I, I, I, F, P, P, P, P, P]
    lib.ball_query_idx_launch.argtypes = plan + [P, P, I, I, I, I, F, P, P,
                                                 P]
    lib.ball_query_bucket_launch.argtypes = plan + [P, P, I, I, I, I, I, F,
                                                    P, P, P, P]
    for fn in (lib.ball_query_group_launch, lib.ball_query_group_packed_launch,
               lib.ball_query_idx_launch, lib.ball_query_bucket_launch):
        fn.restype = I
    lib.ball_query_error_string.argtypes = [I]
    lib.ball_query_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel(
    "ball_query_group", "ball_query.cu",
    "articulated_pose_tpu/ops/pallas/ball_query_butterfly.py:422", _bind)
PACKED_KERNEL = CudaKernel(
    "ball_query_group_packed", "ball_query.cu",
    "articulated_pose_tpu/ops/pallas/ball_query_butterfly.py:269", _bind)
IDX_KERNEL = CudaKernel(
    "ball_query_idx", "ball_query.cu",
    "articulated_pose_tpu/ops/pallas/ball_query_stream.py:142", _bind)
POINT_KERNEL = CudaKernel(
    "ball_query_point", "ball_query.cu",
    "articulated_pose_tpu/ops/pallas/ball_query.py:251", _bind)
POINT_GROUPED_KERNEL = CudaKernel(
    "ball_query_point_grouped", "ball_query.cu",
    "articulated_pose_tpu/ops/pallas/ball_query.py:194", _bind)
BUCKET_KERNEL = CudaKernel(
    "ball_query_group_bucket", "ball_query.cu",
    "articulated_pose_tpu/ops/pallas/ball_query_bucket.py:146", _bind)
# which of the source's entries each kernel launches
_TIER = {KERNEL.name: "group", POINT_GROUPED_KERNEL.name: "group",
         PACKED_KERNEL.name: "packed", IDX_KERNEL.name: "idx",
         POINT_KERNEL.name: "idx", BUCKET_KERNEL.name: "bucket"}


def _r2(radius: float) -> float:
    # r² rounded to f32 once, as the plain versions and the reference do
    return float(np.float32(radius * radius))


def _check(name: str, xyz: torch.Tensor, new_xyz: torch.Tensor,
           nsample: int):
    require_cuda(name, xyz)
    require_cuda(name, new_xyz)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device:
        raise ValueError(f"{name}: xyz and new_xyz must share batch size "
                         "and device")
    if B * M == 0 or N == 0 or nsample < 1:
        raise ValueError(f"{name}: empty problem (B={B}, N={N}, M={M}, "
                         f"nsample={nsample})")
    return B, N, M


def launch(kernel: CudaKernel, radius: float, nsample: int,
           xyz: torch.Tensor, new_xyz: torch.Tensor, emit_idx: bool = True,
           plan: Plan = None):
    """One launch of csrc/ball_query.cu's entry for `kernel` (grouped,
    packed, idx only or bucket) at `plan` (bq_plan's when None), counted
    on `kernel`: (grouped or None, cnt, idx or None).  A launch the card
    refuses raises with its error text."""
    tier = _TIER[kernel.name]
    if tier == "bucket":
        W = core.bucket_width(xyz.shape[1], nsample)
    B, N, M = _check(kernel.name, xyz, new_xyz, nsample)
    plan = plan or bq_plan(B, N, M, nsample, tier == "bucket")
    if plan.variant not in VARIANTS:
        raise ValueError(f"{kernel.name}: unknown plan {plan}")
    lib = kernel.lib()
    dev = xyz.device
    cnt = torch.empty((B, M), dtype=torch.int32, device=dev)
    idx = (torch.empty((B, M, nsample), dtype=torch.int32, device=dev)
           if emit_idx or tier == "idx" else None)
    grouped = (None if tier == "idx" else
               torch.empty((B, M, nsample, 3), dtype=torch.float32,
                           device=dev))
    args = (list(VARIANTS).index(plan.variant), int(plan.staged),
            ptr(xyz), ptr(new_xyz), B, N, M, nsample, _r2(radius))
    out = (ptr(cnt), None if idx is None else ptr(idx), stream_of(xyz))
    with torch.cuda.device(dev), kernel.scope():
        if tier == "idx":
            rc = lib.ball_query_idx_launch(*args, *out)
        elif tier == "group":
            rc = lib.ball_query_group_launch(*args, ptr(grouped), *out)
        elif tier == "bucket":
            rc = lib.ball_query_bucket_launch(*args[:-1], W.bit_length() - 1,
                                              args[-1], ptr(grouped), *out)
        else:
            # the dequantised plane, only where the cloud streams
            deq = (None if plan.staged else
                   torch.empty((B, N, 3), dtype=torch.float32, device=dev))
            rc = lib.ball_query_group_packed_launch(
                *args, None if deq is None else ptr(deq), ptr(grouped), *out)
    check_rc(kernel, rc, lib.ball_query_error_string)
    kernel.launches += 1
    return grouped, cnt, idx


def ball_query_group_plain(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor, emit_idx: bool = True):
    """query_ball_point + group_point − centre: the kernel's semantics."""
    idx, cnt = core.query_ball_point(radius, nsample, xyz, new_xyz)
    grouped = core.group_point(xyz.float(), idx) - new_xyz.float()[:, :, None]
    return grouped, cnt, (idx if emit_idx else None)


@counted("ball_query_group")
def ball_query_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, emit_idx: bool = True):
    """xyz (B, N, 3), new_xyz (B, M, 3) f32 -> (grouped_xyz (B, M, S, 3)
    = point − query, cnt (B, M) i32 capped at S, idx (B, M, S) i32 or
    None when not emit_idx)."""
    if xyz.device.type == "cpu":
        return ball_query_group_plain(radius, nsample, xyz, new_xyz, emit_idx)
    return launch(KERNEL, radius, nsample, xyz, new_xyz, emit_idx)


def ball_query_point_grouped_plain(radius: float, nsample: int,
                                   xyz: torch.Tensor, new_xyz: torch.Tensor):
    """`ball_query_group_plain` in JAX's output order (idx, cnt, grouped)."""
    grouped, cnt, idx = ball_query_group_plain(radius, nsample, xyz, new_xyz)
    return idx, cnt, grouped


@counted("ball_query_point_grouped")
def ball_query_point_grouped(radius: float, nsample: int, xyz: torch.Tensor,
                             new_xyz: torch.Tensor):
    """B5g: xyz (B, N, 3), new_xyz (B, M, 3) f32 -> (idx (B, M, S) i32,
    cnt (B, M) i32, grouped_xyz (B, M, S, 3) = point − query); a query
    with no hit takes point 0 (ball_query.py:174-190)."""
    if xyz.device.type == "cpu":
        return ball_query_point_grouped_plain(radius, nsample, xyz, new_xyz)
    grouped, cnt, idx = launch(POINT_GROUPED_KERNEL, radius, nsample, xyz,
                               new_xyz)
    return idx, cnt, grouped


def ball_query_group_packed_plain(radius: float, nsample: int,
                                  xyz: torch.Tensor, new_xyz: torch.Tensor,
                                  emit_idx: bool = True):
    """Exact hits, quantised coordinates: the packed kernel's semantics."""
    idx, cnt = core.query_ball_point(radius, nsample, xyz, new_xyz)
    grouped = (core.group_point(core.quantize_coords(xyz), idx)
               - new_xyz.float()[:, :, None])
    return grouped, cnt, (idx if emit_idx else None)


@counted("ball_query_group_packed")
def ball_query_group_packed(radius: float, nsample: int, xyz: torch.Tensor,
                            new_xyz: torch.Tensor, emit_idx: bool = True):
    """As `ball_query_group`, with each grouped point taken from the
    cloud quantised to 10 bits per component over its bounding box:
    idx and cnt exact, coordinates within ext/2046 of exact."""
    if xyz.device.type == "cpu":
        return ball_query_group_packed_plain(radius, nsample, xyz, new_xyz,
                                             emit_idx)
    return launch(PACKED_KERNEL, radius, nsample, xyz, new_xyz, emit_idx)


# q² + p² − 2·inner, as the streaming kernel sums it
# (ball_query_stream.py:63-65): the expansion form of core.pairwise_sqdist
ball_query_idx_plain = core.query_ball_point


@counted("ball_query_idx")
def ball_query_idx(radius: float, nsample: int, xyz: torch.Tensor,
                   new_xyz: torch.Tensor):
    """xyz (B, N, 3), new_xyz (B, M, 3) f32 -> (idx (B, M, S) i32,
    cnt (B, M) i32 capped at S), for clouds of any size below 2^24."""
    N = xyz.shape[1]
    if N >= STREAM_MAX_POINTS:
        raise ValueError(
            f"ball_query_idx: N={N} exceeds the streaming tier's index "
            f"range (2^24), as query_ball_point_stream does")
    if xyz.device.type == "cpu":
        return ball_query_idx_plain(radius, nsample, xyz, new_xyz)
    _, cnt, idx = launch(IDX_KERNEL, radius, nsample, xyz, new_xyz)
    return idx, cnt


ball_query_point_plain = core.query_ball_point


@counted("ball_query_point")
def ball_query_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    """B5: xyz (B, N, 3), new_xyz (B, M, 3) f32 -> (idx (B, M, S) i32,
    cnt (B, M) i32 capped at S): exactly `core.query_ball_point`
    (ball_query.py:254), for any int32 N."""
    if xyz.device.type == "cpu":
        return ball_query_point_plain(radius, nsample, xyz, new_xyz)
    _, cnt, idx = launch(POINT_KERNEL, radius, nsample, xyz, new_xyz)
    return idx, cnt


ball_query_group_bucket_plain = core.query_ball_group_bucket_plain


@counted("ball_query_group_bucket")
def ball_query_group_bucket(radius: float, nsample: int, xyz: torch.Tensor,
                            new_xyz: torch.Tensor, emit_idx: bool = True):
    """The bucket-sampled tier: xyz (B, N, 3), new_xyz (B, M, 3) f32 ->
    (grouped_xyz (B, M, S, 3), cnt (B, M) i32, idx (B, M, S) i32 or None
    when not emit_idx).  Slot j holds the first hit among points
    [j·W, (j+1)·W), its offset rounded to bf16 (`core.
    query_ball_group_bucket_plain` states the semantics).  Raises
    ValueError unless ceil(N/128)·128 / S is a whole power of two."""
    core.bucket_width(xyz.shape[1], nsample)
    if xyz.device.type == "cpu":
        return ball_query_group_bucket_plain(radius, nsample, xyz, new_xyz,
                                             emit_idx)
    return launch(BUCKET_KERNEL, radius, nsample, xyz, new_xyz, emit_idx)
