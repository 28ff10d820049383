"""Farthest point sampling: CUDA kernels K1 (two-level) and B2 (one level).

- `fps2` (K1) replaces `articulated_pose_tpu/ops/pallas/fps.py::
  farthest_point_sample2_pallas` (body `_fps2_kernel`): N -> np1 -> np2
  in one launch, for the two-level SA pyramid.
- `fps` (B2) replaces `farthest_point_sample_pallas` (body `_fps_kernel`):
  one level, N -> npoint, run once per SA stage of any other pyramid.

Both run `csrc/fps.cu`: one block per cloud in one of three variants,
picked here by N: the cloud and the min-distance state in shared memory
("smem", up to ~14k points), the state alone there with the coordinates
read from L2 ("smem_state", up to ~57k), or both in device memory
("global", any N).  Its source says what bounds it and how the design
answers.  A CPU tensor takes the `*_plain` version; a CUDA tensor takes
the kernel.
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
# csrc/fps.cu's variants, fastest first
VARIANTS = ("smem", "smem_state", "global")


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fps2_launch.argtypes = [I, P, I, I, I, I, P, P, P, P, P, P]
    lib.fps2_launch.restype = I
    lib.fps2_smem_bytes.argtypes = [I, I, I]
    lib.fps2_smem_bytes.restype = ctypes.c_size_t
    lib.fps2_error_string.argtypes = [I]
    lib.fps2_error_string.restype = ctypes.c_char_p


def _bind_single(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fps_launch.argtypes = [I, P, I, I, I, P, P, P, P]
    lib.fps_launch.restype = I
    _bind(lib)


KERNEL = CudaKernel("fps2", "fps.cu",
                    "articulated_pose_tpu/ops/pallas/fps.py:204", _bind)
SINGLE_KERNEL = CudaKernel("fps", "fps.cu",
                           "articulated_pose_tpu/ops/pallas/fps.py:69",
                           _bind_single)


def fps2_plain(xyz: torch.Tensor, np1: int, np2: int):
    """FPS applied twice with a gather between: the kernel's semantics."""
    idx1 = core.farthest_point_sample(np1, xyz)
    xyz1 = core.gather_point(xyz.float(), idx1)
    idx2 = core.farthest_point_sample(np2, xyz1)
    xyz2 = core.gather_point(xyz1, idx2)
    return idx1, xyz1, idx2, xyz2


def fps2_variant(n: int, np1: int) -> str:
    """The kernel variant fps2 launches for an N-point cloud (fps with
    np1 = 0): the first of VARIANTS whose shared memory fits a block
    ("global" needs none per point)."""
    lib = KERNEL.lib()
    for v, name in enumerate(VARIANTS[:-1]):
        if lib.fps2_smem_bytes(v, n, np1) <= MAX_SMEM:
            return name
    return VARIANTS[-1]


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
    variant = fps2_variant(N, np1)
    dev = xyz.device
    idx1 = torch.empty((B, np1), dtype=torch.int32, device=dev)
    xyz1 = torch.empty((B, np1, 3), dtype=torch.float32, device=dev)
    idx2 = torch.empty((B, np2), dtype=torch.int32, device=dev)
    xyz2 = torch.empty((B, np2, 3), dtype=torch.float32, device=dev)
    # the global variant's min-distance state: one row per cloud
    scratch = (torch.empty((B, N), dtype=torch.float32, device=dev)
               if variant == "global" else None)
    with torch.cuda.device(dev):
        rc = lib.fps2_launch(VARIANTS.index(variant), ptr(xyz), B, N, np1,
                             np2, ptr(idx1), ptr(xyz1), ptr(idx2), ptr(xyz2),
                             None if scratch is None else ptr(scratch),
                             stream_of(xyz))
    check_rc(KERNEL, rc, lib.fps2_error_string)
    KERNEL.launches += 1
    return idx1, xyz1, idx2, xyz2


def fps_plain(xyz: torch.Tensor, npoint: int):
    """FPS followed by a gather: the single-level kernel's semantics."""
    idx = core.farthest_point_sample(npoint, xyz)
    return idx, core.gather_point(xyz.float(), idx)


def fps_variant(n: int) -> str:
    """The kernel variant fps launches for an N-point cloud."""
    return fps2_variant(n, 0)


def fps(xyz: torch.Tensor, npoint: int):
    """xyz (B, N, 3) f32 -> (idx (B, npoint) i32, new_xyz (B, npoint, 3))."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    require_cuda("fps", xyz)
    B, N, _ = xyz.shape
    if not 1 <= npoint <= N or B == 0:
        raise ValueError(f"fps: need 1 <= npoint <= N and B > 0, got B={B}, "
                         f"N={N}, npoint={npoint}")
    lib = SINGLE_KERNEL.lib()
    variant = fps_variant(N)
    dev = xyz.device
    idx = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    new_xyz = torch.empty((B, npoint, 3), dtype=torch.float32, device=dev)
    scratch = (torch.empty((B, N), dtype=torch.float32, device=dev)
               if variant == "global" else None)
    with torch.cuda.device(dev):
        rc = lib.fps_launch(VARIANTS.index(variant), ptr(xyz), B, N, npoint,
                            ptr(idx), ptr(new_xyz),
                            None if scratch is None else ptr(scratch),
                            stream_of(xyz))
    check_rc(SINGLE_KERNEL, rc, lib.fps2_error_string)
    SINGLE_KERNEL.launches += 1
    return idx, new_xyz
