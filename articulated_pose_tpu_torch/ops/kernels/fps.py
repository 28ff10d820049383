"""Farthest point sampling: CUDA kernels K1 (two-level) and B2 (one level).

- `fps2` (K1) replaces `articulated_pose_tpu/ops/pallas/fps.py::
  farthest_point_sample2_pallas` (body `_fps2_kernel`): N -> np1 -> np2
  in one launch, for the two-level SA pyramid.
- `fps` (B2) replaces `farthest_point_sample_pallas` (body `_fps_kernel`):
  one level, N -> npoint, run once per SA stage of any other pyramid.

Both launch `csrc/fps.cu`'s one kernel: each thread keeps its points in
registers, one barrier per pick, and a large cloud split over a
thread-block cluster of C CTAs.  `fps_plan` picks the variant (warps a
CTA, points a thread) and C from the shape, once, without the library;
its source says what bounds the kernel and how the design answers.  A
CPU tensor takes the `*_plain` version; a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          counted, ptr,
                                                          require_cuda,
                                                          stream_of)

# csrc/fps.cu's variants, in its FPS_VARIANTS order: name -> (warps a CTA,
# level-1 points a thread in registers (0: streamed from device memory,
# any N), level-2 points a thread)
VARIANTS = {
    "w1p4": (1, 4, 4),
    "w1p16": (1, 16, 16),
    "w4p8": (4, 8, 8),
    "w4p16": (4, 16, 16),
    "stream": (32, 0, 4),
}
# CTAs a cloud; above 8 the card's non-portable cluster sizes
CLUSTERS = (1, 2, 4, 8, 16)
# fps_plan's rule, read off the sweep of every (variant, C) at the
# paths' shapes on the card (python -m articulated_pose_tpu_torch.fps_sweep;
# PERF.md section 6): the fewest warps that hold the cloud step fastest.
# One warp and no barrier up to WARP_POINTS points, one CTA of four warps
# (one barrier a step) up to CTA_POINTS; a larger cloud takes a cluster
# of one-warp CTAs while CLUSTERS[-1] of them hold it, then of four-warp
# CTAs, then the streamed variant at CLUSTERS[-1]
WARP_POINTS = 512           # "w1p16"
CTA_POINTS = 2048           # "w4p16"


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fps_launch.argtypes = [I, I, P, I, I, I, I, P, P, P, P, P, P]
    lib.fps_launch.restype = I
    lib.fps_error_string.argtypes = [I]
    lib.fps_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("fps2", "fps.cu",
                    "articulated_pose_tpu/ops/pallas/fps.py:204", _bind)
SINGLE_KERNEL = CudaKernel("fps", "fps.cu",
                           "articulated_pose_tpu/ops/pallas/fps.py:69", _bind)


def fps2_plain(xyz: torch.Tensor, np1: int, np2: int):
    """FPS applied twice with a gather between: the kernel's semantics."""
    idx1 = core.farthest_point_sample(np1, xyz)
    xyz1 = core.gather_point(xyz.float(), idx1)
    idx2 = core.farthest_point_sample(np2, xyz1)
    xyz2 = core.gather_point(xyz1, idx2)
    return idx1, xyz1, idx2, xyz2


def fps_plain(xyz: torch.Tensor, npoint: int):
    """FPS followed by a gather: the single-level kernel's semantics."""
    idx = core.farthest_point_sample(npoint, xyz)
    return idx, core.gather_point(xyz.float(), idx)


def capacity(variant: str) -> Optional[int]:
    """Points a CTA of `variant` holds in registers (None: any)."""
    warps, per, _ = VARIANTS[variant]
    return warps * 32 * per if per else None


def fits(variant: str, n: int, cluster: int) -> bool:
    """Whether `variant` at `cluster` CTAs a cloud takes an n-point cloud."""
    cap = capacity(variant)
    return cap is None or -(-n // cluster) <= cap


def _fewest_ctas(N: int, points: int) -> int:
    """The smallest cluster size whose CTAs hold `points` each (may
    exceed CLUSTERS[-1])."""
    c = 1
    while c * points < N:
        c *= 2
    return c


def fps_plan(B: int, N: int, np1: int) -> Tuple[str, int]:
    """(variant, cluster) of the launch for B clouds of N points whose
    first level picks np1 (any number: the picks past the N-th take no
    step), by the rule above.  Needs no library, so the CPU tests reach
    it."""
    if B < 1 or N < 1 or np1 < 1:
        raise ValueError(f"fps_plan: need B, N and np1 > 0, got B={B}, "
                         f"N={N}, np1={np1}")
    if N <= WARP_POINTS:
        return ("w1p4" if N <= capacity("w1p4") else "w1p16"), 1
    if N <= CTA_POINTS:
        return ("w4p8" if N <= capacity("w4p8") else "w4p16"), 1
    for variant, points in (("w1p16", WARP_POINTS), ("w4p16", CTA_POINTS)):
        c = _fewest_ctas(N, points)
        if c <= CLUSTERS[-1]:
            return variant, c
    return "stream", CLUSTERS[-1]


def streams(variant: str, np1: int, np2: int) -> bool:
    """Whether a launch needs the scratch rows: level 1 streamed, or a
    level 2 larger than the variant's registers hold."""
    warps, per, per2 = VARIANTS[variant]
    return per == 0 or (np2 > 0 and np1 > warps * 32 * per2)


def launch(kernel: CudaKernel, xyz: torch.Tensor, np1: int, np2: int,
           variant: str, cluster: int):
    """One launch of csrc/fps.cu at (variant, cluster), counted on
    `kernel`: (idx1, xyz1, idx2, xyz2), the last two None when np2 = 0.
    A refused launch raises with the card's error text."""
    require_cuda("fps", xyz)
    B, N, _ = xyz.shape
    if B == 0 or N == 0 or np1 < 1 or np2 < 0:
        raise ValueError(f"fps: need B, N, np1 > 0 and np2 >= 0, got B={B}, "
                         f"N={N}, np1={np1}, np2={np2}")
    if variant not in VARIANTS or cluster not in CLUSTERS:
        raise ValueError(f"fps: unknown variant {variant!r} or cluster "
                         f"{cluster}")
    if not fits(variant, N, cluster):
        raise ValueError(f"fps: {variant} at cluster {cluster} holds "
                         f"{capacity(variant) * cluster} points, got N={N}")
    lib = kernel.lib()
    dev = xyz.device
    idx1 = torch.empty((B, np1), dtype=torch.int32, device=dev)
    xyz1 = torch.empty((B, np1, 3), dtype=torch.float32, device=dev)
    idx2 = xyz2 = None
    if np2:
        idx2 = torch.empty((B, np2), dtype=torch.int32, device=dev)
        xyz2 = torch.empty((B, np2, 3), dtype=torch.float32, device=dev)
    # the streamed levels' running minima: one row a cloud
    scratch = (torch.empty((B, N + np1), dtype=torch.int32, device=dev)
               if streams(variant, np1, np2) else None)
    with torch.cuda.device(dev), kernel.scope():
        rc = lib.fps_launch(list(VARIANTS).index(variant), cluster, ptr(xyz),
                            B, N, np1, np2, ptr(idx1), ptr(xyz1),
                            None if idx2 is None else ptr(idx2),
                            None if xyz2 is None else ptr(xyz2),
                            None if scratch is None else ptr(scratch),
                            stream_of(xyz))
    check_rc(kernel, rc, lib.fps_error_string)
    kernel.launches += 1
    return idx1, xyz1, idx2, xyz2


def step_floor(B: int, variant: str, cluster: int, seed: int = 1) -> float:
    """µs per pick of the launch (B clouds, `variant`, `cluster`) on a
    cloud of one point per thread: the step's merge with no points to
    speak of (the scan still updates every register slot).  (ms at up
    to 1024 picks − ms at one) over the picks between; needs a card."""
    from articulated_pose_tpu_torch.timing import cuda_time_ms

    n = cluster * VARIANTS[variant][0] * 32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xyz = torch.rand((B, n, 3), generator=gen, device="cuda")
    picks = min(n, 1024)
    many, _ = cuda_time_ms(lambda: launch(SINGLE_KERNEL, xyz, picks, 0,
                                          variant, cluster))
    one, _ = cuda_time_ms(lambda: launch(SINGLE_KERNEL, xyz, 1, 0, variant,
                                         cluster))
    return (many - one) * 1e3 / (picks - 1)


@counted("fps2")
def fps2(xyz: torch.Tensor, np1: int, np2: int):
    """xyz (B, N, 3) f32 -> (idx1 (B, np1) i32, xyz1 (B, np1, 3),
    idx2 (B, np2) i32 LOCAL to the np1 subset, xyz2 (B, np2, 3)).  np1
    may exceed N, and np2 np1: a level's picks past its point count are
    index 0, as the TPU kernel's are."""
    if xyz.device.type == "cpu":
        return fps2_plain(xyz, np1, np2)
    require_cuda("fps2", xyz)
    B, N, _ = xyz.shape
    if B == 0 or N == 0 or np1 < 1 or np2 < 1:
        raise ValueError(f"fps2: need B, N, np1 and np2 > 0, got B={B}, "
                         f"N={N}, np1={np1}, np2={np2}")
    return launch(KERNEL, xyz, np1, np2, *fps_plan(B, N, np1))


@counted("fps")
def fps(xyz: torch.Tensor, npoint: int):
    """xyz (B, N, 3) f32 -> (idx (B, npoint) i32, new_xyz (B, npoint, 3));
    npoint may exceed N (see `fps2`)."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    require_cuda("fps", xyz)
    B, N, _ = xyz.shape
    if B == 0 or N == 0 or npoint < 1:
        raise ValueError(f"fps: need B, N and npoint > 0, got B={B}, N={N}, "
                         f"npoint={npoint}")
    idx, new_xyz, _, _ = launch(SINGLE_KERNEL, xyz, npoint, 0,
                                *fps_plan(B, N, npoint))
    return idx, new_xyz
