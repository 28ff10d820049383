"""Exact 3-nearest-neighbour search: CUDA kernel K3 and its plain version.

Replaces `articulated_pose_tpu/ops/pallas/three_nn.py::three_nn_pallas`
with `packed=False` (body `_three_nn_kernel`).  The kernel
(`csrc/three_nn.cu`) gives each query one thread that streams the
candidates from shared memory and keeps its best three in registers;
its source says what bounds it.  A CPU tensor takes the plain
`ops.core.three_nn`; a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          ptr, require_cuda,
                                                          stream_of)


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.three_nn_launch.argtypes = [P, P, I, I, I, P, P, P]
    lib.three_nn_launch.restype = I
    lib.three_nn_error_string.argtypes = [I]
    lib.three_nn_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("three_nn", "three_nn.cu",
                    "articulated_pose_tpu/ops/pallas/three_nn.py:111", _bind)

three_nn_plain = core.three_nn


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 (B, N, 3), xyz2 (B, M, 3) f32 -> (dist (B, N, 3) squared,
    ascending, idx (B, N, 3) i32), ties to the lowest index."""
    if xyz1.device.type == "cpu":
        return three_nn_plain(xyz1, xyz2)
    require_cuda("three_nn", xyz1)
    require_cuda("three_nn", xyz2)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    if xyz2.shape[0] != B or xyz2.device != xyz1.device:
        raise ValueError("three_nn: xyz1 and xyz2 must share batch size and "
                         "device")
    if B * N == 0 or M == 0:
        raise ValueError(f"three_nn: empty problem (B={B}, N={N}, M={M})")
    lib = KERNEL.lib()
    dev = xyz1.device
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.three_nn_launch(ptr(xyz1), ptr(xyz2), B, N, M, ptr(dist),
                                 ptr(idx), stream_of(xyz1))
    check_rc(KERNEL, rc, lib.three_nn_error_string)
    KERNEL.launches += 1
    return dist, idx
