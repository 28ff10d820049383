"""Fused ball query + centred grouping: CUDA kernel K2 and its plain version.

Replaces `articulated_pose_tpu/ops/pallas/ball_query_butterfly.py::
query_ball_group_pallas` (exact transposed body `_ballq_butterfly_kernel_t`,
the one the backbone runs).  The kernel (`csrc/ball_query.cu`) gives each
query one warp that scans the cloud in index order with ballot/popc slot
ranks and stops at nsample hits; its source says what bounds it.  A CPU
tensor takes `ball_query_group_plain`; a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          ptr, require_cuda,
                                                          stream_of)


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ball_query_group_launch.argtypes = [P, P, I, I, I, I, ctypes.c_float,
                                            P, P, P, P]
    lib.ball_query_group_launch.restype = I
    lib.ball_query_error_string.argtypes = [I]
    lib.ball_query_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel(
    "ball_query_group", "ball_query.cu",
    "articulated_pose_tpu/ops/pallas/ball_query_butterfly.py:422", _bind)


def ball_query_group_plain(radius: float, nsample: int, xyz: torch.Tensor,
                           new_xyz: torch.Tensor, emit_idx: bool = True):
    """query_ball_point + group_point − centre: the kernel's semantics."""
    idx, cnt = core.query_ball_point(radius, nsample, xyz, new_xyz)
    grouped = core.group_point(xyz.float(), idx) - new_xyz.float()[:, :, None]
    return grouped, cnt, (idx if emit_idx else None)


def ball_query_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, emit_idx: bool = True):
    """xyz (B, N, 3), new_xyz (B, M, 3) f32 -> (grouped_xyz (B, M, S, 3)
    = point − query, cnt (B, M) i32 capped at S, idx (B, M, S) i32 or
    None when not emit_idx)."""
    if xyz.device.type == "cpu":
        return ball_query_group_plain(radius, nsample, xyz, new_xyz, emit_idx)
    require_cuda("ball_query_group", xyz)
    require_cuda("ball_query_group", new_xyz)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B or new_xyz.device != xyz.device:
        raise ValueError("ball_query_group: xyz and new_xyz must share batch "
                         "size and device")
    if B * M == 0 or N == 0 or nsample < 1:
        raise ValueError(f"ball_query_group: empty problem (B={B}, N={N}, "
                         f"M={M}, nsample={nsample})")
    lib = KERNEL.lib()
    dev = xyz.device
    grouped = torch.empty((B, M, nsample, 3), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, M), dtype=torch.int32, device=dev)
    idx = (torch.empty((B, M, nsample), dtype=torch.int32, device=dev)
           if emit_idx else None)
    # r² rounded to f32 once, as the plain version and the reference do
    r2 = ctypes.c_float(float(np.float32(radius * radius)))
    with torch.cuda.device(dev):
        rc = lib.ball_query_group_launch(
            ptr(xyz), ptr(new_xyz), B, N, M, nsample, r2, ptr(grouped),
            ptr(cnt), ptr(idx) if emit_idx else None, stream_of(xyz))
    check_rc(KERNEL, rc, lib.ball_query_error_string)
    KERNEL.launches += 1
    return grouped, cnt, idx
