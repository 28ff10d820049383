"""Two-level farthest point sampling: CUDA kernel K1 and its plain version.

Replaces `articulated_pose_tpu/ops/pallas/fps.py::farthest_point_sample2_pallas`
(body `_fps2_kernel`).  The kernel (`csrc/fps.cu`) runs one block per
cloud with the coordinates and the min-distance state in shared memory;
its source says what bounds it and how the design answers.  A CPU tensor
takes `fps2_plain`; a CUDA tensor takes the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from articulated_pose_tpu_torch.ops import core
from articulated_pose_tpu_torch.ops.kernels.build import (CudaKernel, check_rc,
                                                          ptr, require_cuda,
                                                          stream_of)

# Hopper's opt-in shared memory per block (232,448 bytes)
MAX_SMEM = 232448


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fps2_launch.argtypes = [P, I, I, I, I, P, P, P, P, P]
    lib.fps2_launch.restype = I
    lib.fps2_smem_bytes.argtypes = [I, I]
    lib.fps2_smem_bytes.restype = ctypes.c_size_t
    lib.fps2_error_string.argtypes = [I]
    lib.fps2_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("fps2", "fps.cu",
                    "articulated_pose_tpu/ops/pallas/fps.py:204", _bind)


def fps2_plain(xyz: torch.Tensor, np1: int, np2: int):
    """FPS applied twice with a gather between: the kernel's semantics."""
    idx1 = core.farthest_point_sample(np1, xyz)
    xyz1 = core.gather_point(xyz.float(), idx1)
    idx2 = core.farthest_point_sample(np2, xyz1)
    xyz2 = core.gather_point(xyz1, idx2)
    return idx1, xyz1, idx2, xyz2


def fps2(xyz: torch.Tensor, np1: int, np2: int):
    """xyz (B, N, 3) f32 -> (idx1 (B, np1) i32, xyz1 (B, np1, 3),
    idx2 (B, np2) i32 LOCAL to the np1 subset, xyz2 (B, np2, 3))."""
    if xyz.device.type == "cpu":
        return fps2_plain(xyz, np1, np2)
    require_cuda("fps2", xyz)
    B, N, _ = xyz.shape
    if not 1 <= np2 <= np1 <= N or B == 0:
        raise ValueError(f"fps2: need 1 <= np2 <= np1 <= N and B > 0, got "
                         f"B={B}, N={N}, np1={np1}, np2={np2}")
    lib = KERNEL.lib()
    smem = lib.fps2_smem_bytes(N, np1)
    if smem > MAX_SMEM:
        raise ValueError(
            f"fps2: N={N} needs {smem} B of shared memory per cloud, more "
            f"than a block can hold ({MAX_SMEM} B)")
    dev = xyz.device
    idx1 = torch.empty((B, np1), dtype=torch.int32, device=dev)
    xyz1 = torch.empty((B, np1, 3), dtype=torch.float32, device=dev)
    idx2 = torch.empty((B, np2), dtype=torch.int32, device=dev)
    xyz2 = torch.empty((B, np2, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fps2_launch(ptr(xyz), B, N, np1, np2, ptr(idx1), ptr(xyz1),
                             ptr(idx2), ptr(xyz2), stream_of(xyz))
    check_rc(KERNEL, rc, lib.fps2_error_string)
    KERNEL.launches += 1
    return idx1, xyz1, idx2, xyz2
