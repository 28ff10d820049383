"""3-nearest-neighbour search: three kernel entries over `csrc/three_nn.cu`.

- `three_nn` (K3) replaces `articulated_pose_tpu/ops/pallas/three_nn.py::
  three_nn_pallas` with `packed=False` (body `_three_nn_kernel`).
- `three_nn_stream` (B7) replaces `three_nn_stream.py::three_nn_stream`
  (body `_kernel`): the same function for any M.  It launches K3, which
  already streams the candidates through shared memory a tile at a time
  with a running best three; its own entry counts its launches.
- `three_nn_packed` (B9) replaces `three_nn_pallas(packed=True)` (body
  `_three_nn_key_kernel`): the 3 smallest int32 keys (truncated d²,
  index), `core.three_nn_packed` states the function.

One thread per query streams the candidates from shared memory and keeps
its best three in registers; the source says what bounds it.  A CPU
tensor takes the plain version; a CUDA tensor takes the kernel.
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
    for fn in (lib.three_nn_launch, lib.three_nn_packed_launch):
        fn.argtypes = [P, P, I, I, I, P, P, P]
        fn.restype = I
    lib.three_nn_error_string.argtypes = [I]
    lib.three_nn_error_string.restype = ctypes.c_char_p


KERNEL = CudaKernel("three_nn", "three_nn.cu",
                    "articulated_pose_tpu/ops/pallas/three_nn.py:111", _bind)
STREAM_KERNEL = CudaKernel(
    "three_nn_stream", "three_nn.cu",
    "articulated_pose_tpu/ops/pallas/three_nn_stream.py:95", _bind)
PACKED_KERNEL = CudaKernel(
    "three_nn_packed", "three_nn.cu",
    "articulated_pose_tpu/ops/pallas/three_nn.py:62", _bind)

three_nn_plain = core.three_nn
three_nn_stream_plain = core.three_nn
three_nn_packed_plain = core.three_nn_packed


def _launch(kernel: CudaKernel, packed: bool, xyz1: torch.Tensor,
            xyz2: torch.Tensor):
    require_cuda(kernel.name, xyz1)
    require_cuda(kernel.name, xyz2)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    if xyz2.shape[0] != B or xyz2.device != xyz1.device:
        raise ValueError(f"{kernel.name}: xyz1 and xyz2 must share batch "
                         "size and device")
    if B * N == 0 or M == 0:
        raise ValueError(f"{kernel.name}: empty problem (B={B}, N={N}, "
                         f"M={M})")
    lib = kernel.lib()
    launch = lib.three_nn_packed_launch if packed else lib.three_nn_launch
    dev = xyz1.device
    dist = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = launch(ptr(xyz1), ptr(xyz2), B, N, M, ptr(dist), ptr(idx),
                    stream_of(xyz1))
    check_rc(kernel, rc, lib.three_nn_error_string)
    kernel.launches += 1
    return dist, idx


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 (B, N, 3), xyz2 (B, M, 3) f32 -> (dist (B, N, 3) squared,
    ascending, idx (B, N, 3) i32), ties to the lowest index."""
    if xyz1.device.type == "cpu":
        return three_nn_plain(xyz1, xyz2)
    return _launch(KERNEL, False, xyz1, xyz2)


def three_nn_stream(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """As `three_nn`, for candidate sets of any size M.  The TPU
    wrapper's `block_m` is not taken: it sized the VMEM tile of
    candidates and does not change the result (the running best three
    merge by (distance, index), so ties across tiles still go to the
    lowest index); the kernel's shared-memory tile is fixed."""
    if xyz1.device.type == "cpu":
        return three_nn_stream_plain(xyz1, xyz2)
    return _launch(STREAM_KERNEL, False, xyz1, xyz2)


def three_nn_packed(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 (B, N, 3), xyz2 (B, M, 3) f32, M <= 65536 -> (dist (B, N, 3)
    d² truncated to its top 16 bits, idx (B, N, 3) i32), ordered by the
    key (truncated d², index); spare slots (M < 3) hold idx 65535 and
    dist NaN.  Raises ValueError for M > 65536."""
    M = xyz2.shape[1]
    if M > core.PACKED_MAX_CANDIDATES:
        raise ValueError(f"three_nn_packed: M={M} exceeds the key's 16-bit "
                         f"index (65536)")
    if xyz1.device.type == "cpu":
        return three_nn_packed_plain(xyz1, xyz2)
    return _launch(PACKED_KERNEL, True, xyz1, xyz2)
